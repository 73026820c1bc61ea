"""Train state: AdamW over the epi/sync/auxiliary subset, the rest frozen
(port of ``cvd_tpu/train/state.py``).

Mirrors train_epi_control.py:245-281: freeze everything, re-enable the
parameters whose state-dict name contains 'epi_modules', 'sync' or
'auxiliary', AdamW (betas, eps, weight decay), gradient-norm clipping over
the trainable set only, and a diffusers-style LR schedule (constant or
cosine, with warmup). Only the trainable parameters require grad, which is
what the JAX step's ``stop_gradient`` mask does (train_step.py:127-132):
no frozen weight gradient is ever computed.
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

    def apply_gradients(self) -> float:
        """Clip by global norm, take an AdamW step, advance the schedule;
        returns the pre-clip gradient norm."""
        norm = torch.nn.utils.clip_grad_norm_(self.trainable_params(), self.max_grad_norm)
        self.optimizer.step()
        self.lr_scheduler.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
        return norm


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
    f32 masters), then set ``requires_grad`` on the trainable set only."""
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
    optimizer = torch.optim.AdamW(
        [params[n] for n in trainable], lr=learning_rate, betas=(adam_beta1, adam_beta2),
        eps=adam_epsilon, weight_decay=adam_weight_decay)
    schedule = lr_schedule(scheduler, learning_rate, warmup_steps, total_steps)
    lr_scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda c: schedule(c) / learning_rate)
    return TrainState(model, optimizer, lr_scheduler, trainable, max_grad_norm)
