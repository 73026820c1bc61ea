"""Train state: AdamW over the epi/sync/auxiliary subset, the rest frozen
(port of ``cvd_tpu/train/state.py``).

Mirrors train_epi_control.py:245-281: freeze everything, re-enable the
parameters whose state-dict name contains 'epi_modules', 'sync' or
'auxiliary', AdamW (betas, eps, weight decay), gradient-norm clipping over
the trainable set only, and a diffusers-style LR schedule (constant or
cosine, with warmup). Only the trainable parameters require grad, which is
what the JAX step's ``stop_gradient`` mask does (train_step.py:127-132):
no frozen weight gradient is ever computed.

The state is one a CUDA graph can replay a step of (``train/program.py``):
AdamW's learning rate is a 0-dim tensor on the weights' device, which
``LambdaLR`` refills between steps; AdamW's moments and step counts and
every trainable tensor's ``.grad`` exist from the start and are written in
place, never freed or replaced (a graph writes the memory it was captured
with). On a CUDA device AdamW is ``capturable``, so the eager and the
captured step run the same optimizer kernels; on the CPU (no capture there)
it takes the tensor learning rate one tensor at a time (torch refuses it
with ``capturable=False, foreach=True``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch import nn

TRAINABLE_SUBSTRINGS = ("epi_modules", "sync", "auxiliary")


def trainable_mask(names: Sequence[str], substrings=TRAINABLE_SUBSTRINGS) -> Dict[str, bool]:
    """{state-dict key: trainable?} — the port's keys are the reference's,
    so this is the JAX mask mapped through ``flax_path_to_torch_key``."""
    return {n: any(s in n for s in substrings) for n in names}


def lr_schedule(name: str, learning_rate: float, warmup_steps: int,
                total_steps: int) -> Callable[[int], float]:
    """count -> learning rate, counting from 0 as optax does: the first
    update uses ``schedule(0)`` (0 during a warmup)."""
    def warm(c):
        return learning_rate * c / warmup_steps

    if name == "constant":
        return lambda c: warm(c) if c < warmup_steps else learning_rate
    if name == "cosine":
        decay = max(total_steps - warmup_steps, 1)

        def cosine(c):
            if c < warmup_steps:
                return warm(c)
            frac = min(c - warmup_steps, decay) / decay
            return learning_rate * 0.5 * (1.0 + math.cos(math.pi * frac))

        return cosine
    raise ValueError(name)


@dataclasses.dataclass
class TrainState:
    """step, model, optimizer and LR schedule of one training run."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    lr_scheduler: torch.optim.lr_scheduler.LambdaLR
    trainable: List[str]
    max_grad_norm: float
    step: int = 0

    def trainable_params(self) -> List[torch.Tensor]:
        params = dict(self.model.named_parameters())
        return [params[n] for n in self.trainable]

    def zero_grad(self) -> None:
        """The gradients zeroed in place (made where a caller freed them)."""
        grads = []
        for p in self.trainable_params():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            else:
                grads.append(p.grad)
        torch._foreach_zero_(grads)

    def update(self) -> torch.Tensor:
        """Clip by global norm and take an AdamW step, on the device (nothing
        read back) -> the pre-clip gradient norm, a 0-dim tensor."""
        norm = torch.nn.utils.clip_grad_norm_(self.trainable_params(), self.max_grad_norm)
        self.optimizer.step()
        return norm

    def advance(self) -> None:
        """After an update: the schedule's next learning rate (into the lr
        tensor), and the step count."""
        self.lr_scheduler.step()
        self.step += 1

    def apply_gradients(self) -> torch.Tensor:
        """Clip by global norm, take an AdamW step, advance the schedule;
        returns the pre-clip gradient norm."""
        norm = self.update()
        self.advance()
        return norm

    def optimizer_tensors(self) -> List[torch.Tensor]:
        """AdamW's moments and step counts, and the learning-rate tensors:
        what a step writes besides the weights and their gradients."""
        out = [t for s in self.optimizer.state.values() for t in s.values()
               if isinstance(t, torch.Tensor)]
        for group in self.optimizer.param_groups:
            out += [v for k, v in group.items() if k != "params" and isinstance(v, torch.Tensor)]
        return out


def _prepare(optimizer: torch.optim.Optimizer) -> None:
    """AdamW's state as its first step would make it, and a zero ``.grad``
    for every parameter: made now, outside any capture (torch's
    ``Adam._init_group`` makes the same tensors lazily)."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            if not optimizer.state[p]:
                on_device = group["capturable"] or group["fused"]
                optimizer.state[p].update(
                    step=torch.zeros((), dtype=torch.float32,
                                     device=p.device if on_device else "cpu"),
                    exp_avg=torch.zeros_like(p, memory_format=torch.preserve_format),
                    exp_avg_sq=torch.zeros_like(p, memory_format=torch.preserve_format))


def create_train_state(
    model: nn.Module,
    learning_rate: float = 1e-4,
    adam_beta1: float = 0.9,
    adam_beta2: float = 0.999,
    adam_weight_decay: float = 1e-2,
    adam_epsilon: float = 1e-8,
    max_grad_norm: float = 1.0,
    scheduler: str = "constant",
    warmup_steps: int = 0,
    total_steps: int = 100_000,
    trainable_substrings=TRAINABLE_SUBSTRINGS,
    frozen_dtype: Optional[torch.dtype] = None,
) -> TrainState:
    """Cast in place (frozen floats to ``frozen_dtype``, trainable ones to
    f32 masters), then set ``requires_grad`` on the trainable set only;
    AdamW's state and the gradients made now (module docstring)."""
    mask = trainable_mask([n for n, _ in model.named_parameters()], trainable_substrings)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if not p.is_floating_point():
                continue
            dtype = torch.float32 if mask[name] else (frozen_dtype or p.dtype)
            if p.dtype != dtype:
                p.data = p.data.to(dtype)
            p.requires_grad_(mask[name])
    trainable = [n for n, keep in mask.items() if keep]
    params = dict(model.named_parameters())
    weights = [params[n] for n in trainable]
    device = weights[0].device if weights else torch.device("cpu")
    cuda = device.type == "cuda"
    lr = torch.tensor(learning_rate, dtype=torch.float32, device=device)
    # torch refuses a tensor lr with capturable=False and foreach=True
    optimizer = torch.optim.AdamW(weights, lr=lr, betas=(adam_beta1, adam_beta2),
                                  eps=adam_epsilon, weight_decay=adam_weight_decay,
                                  capturable=cuda, foreach=None if cuda else False)
    schedule = lr_schedule(scheduler, learning_rate, warmup_steps, total_steps)
    lr_scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda c: schedule(c) / learning_rate)
    _prepare(optimizer)
    return TrainState(model, optimizer, lr_scheduler, trainable, max_grad_norm)
