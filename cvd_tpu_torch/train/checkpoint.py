"""Checkpoint and resume (port of ``cvd_tpu/train/checkpoint.py``).

Two formats:

* ``save`` / ``restore`` — the training state: trainable parameters,
  optimizer and LR-schedule state, step and epoch, in one ``torch.save``
  file (the counterpart of ``save_orbax`` / ``restore_orbax``). Frozen
  weights are not written: they come from the base model.
* ``save_reference_ckpt`` — the reference's ``{epoch, global_step,
  unet_trainable_dict}`` layout (train_epi_control.py:654-660), so a
  checkpoint loads into the PyTorch reference.
"""
from __future__ import annotations

import os
from typing import Tuple

import torch

from cvd_tpu_torch.train.state import TrainState


def _trainable_state(state: TrainState):
    params = dict(state.model.named_parameters())
    return {n: params[n].detach().cpu().clone() for n in state.trainable}


def save(path: str, state: TrainState, epoch: int = 0) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({
        "params": _trainable_state(state),
        "optimizer": state.optimizer.state_dict(),
        "lr_scheduler": state.lr_scheduler.state_dict(),
        "step": state.step,
        "epoch": epoch,
    }, path)


def restore(path: str, state: TrainState) -> Tuple[TrainState, int]:
    """Load a ``save`` file into ``state`` in place -> (state, epoch). A file
    written on the card reads on the CPU and the other way round: AdamW's
    numbers are loaded, its settings (``capturable``, ``foreach``, ...)
    stay the state's own, and every number goes into the state's live
    tensors in place (the weights, AdamW's moments, step counts and
    learning-rate tensor), so that a CUDA graph of the step still reads
    them. A file written before a first step holds no AdamW state: the
    live one is zeroed, as it starts."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    params = dict(state.model.named_parameters())
    if set(ckpt["params"]) != set(state.trainable):
        raise ValueError(f"{path}: trainable parameters differ from the model's")
    with torch.no_grad():
        for name, value in ckpt["params"].items():
            params[name].copy_(value)
        _load_optimizer(state.optimizer, ckpt["optimizer"])
    sched = {k: v for k, v in ckpt["lr_scheduler"].items() if k not in _SCHEDULER_VALUES}
    live = {k: getattr(state.lr_scheduler, k) for k in _SCHEDULER_VALUES}
    state.lr_scheduler.load_state_dict(sched)
    for k, values in live.items():
        setattr(state.lr_scheduler, k, [_as_live(v, s) for v, s in
                                        zip(values, ckpt["lr_scheduler"][k])])
    state.step = int(ckpt["step"])
    return state, int(ckpt["epoch"])


# AdamW's settings, which the state keeps; the schedule's learning rates,
# loaded in the state's own types
_SETTINGS = ("params", "capturable", "foreach", "fused", "differentiable", "param_names")
_SCHEDULER_VALUES = ("base_lrs", "_last_lr")


def _as_live(live, saved):
    """``saved``'s value in ``live``'s type: copied into a live tensor."""
    if isinstance(live, torch.Tensor):
        return live.copy_(torch.as_tensor(saved, dtype=live.dtype))
    return float(saved)


def _load_optimizer(optimizer: torch.optim.Optimizer, saved: dict) -> None:
    """``optimizer.state_dict()``'s numbers into ``optimizer``, in place."""
    if len(saved["param_groups"]) != len(optimizer.param_groups):
        raise ValueError("the checkpoint's optimizer has other parameter groups")
    for group, sgroup in zip(optimizer.param_groups, saved["param_groups"]):
        if len(group["params"]) != len(sgroup["params"]):
            raise ValueError("the checkpoint's optimizer has other parameters")
        for k, v in sgroup.items():
            number = isinstance(v, (int, float, torch.Tensor)) and not isinstance(v, bool)
            if k not in _SETTINGS:
                group[k] = _as_live(group[k], v) if number and k in group else v
        for p, index in zip(group["params"], sgroup["params"]):
            live = optimizer.state[p]
            kept = saved["state"].get(index)
            if kept is None:
                # written before a first step: AdamW's state as it starts
                for v in live.values():
                    v.zero_()
                continue
            for k, v in kept.items():
                if not isinstance(live.get(k), torch.Tensor):
                    raise ValueError(f"the checkpoint's optimizer state has {k!r}, "
                                     "which this state's AdamW does not keep")
                live[k].copy_(v)


def save_reference_ckpt(path: str, state: TrainState, epoch: int, global_step: int) -> None:
    """The trainable subset as a reference-format torch checkpoint."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"epoch": epoch, "global_step": global_step,
                "unet_trainable_dict": _trainable_state(state)}, path)
