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
    """Load a ``save`` file into ``state`` in place -> (state, epoch)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    params = dict(state.model.named_parameters())
    if set(ckpt["params"]) != set(state.trainable):
        raise ValueError(f"{path}: trainable parameters differ from the model's")
    with torch.no_grad():
        for name, value in ckpt["params"].items():
            params[name].copy_(value)
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.lr_scheduler.load_state_dict(ckpt["lr_scheduler"])
    state.step = int(ckpt["step"])
    return state, int(ckpt["epoch"])


def save_reference_ckpt(path: str, state: TrainState, epoch: int, global_step: int) -> None:
    """The trainable subset as a reference-format torch checkpoint."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"epoch": epoch, "global_step": global_step,
                "unet_trainable_dict": _trainable_state(state)}, path)
