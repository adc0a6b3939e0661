"""Train-state checkpoints: one ``torch.save`` file per saved step,
``<dir>/step_<step>.pt``, holding

  * ``model``: the model's ``state_dict`` in the reference key layout
    (BN running statistics included), so ``utils/weights.py::
    load_reference_pt`` reads it and a trained VQ-SEG or transformer
    feeds the sampler;
  * ``codebook`` (VQ states only): the phase counter, ``filled`` and the
    reservoir;
  * ``optimizer``: Adam's moments, update count and accumulation buffers;
  * ``disc`` and ``disc_optimizer`` (VQ-IMG states only): the
    discriminator's ``state_dict`` (BN running statistics included) and
    its Adam;
  * ``step``: micro-steps taken.

Restoring puts every part back, so a resumed run continues the phase
schedule and the accumulation where the saved one stopped.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

from ..models.codebook import CodebookState

_NAME = re.compile(r"^step_(\d+)\.pt$")


def checkpoint_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}.pt")


def latest_step(directory: str) -> Optional[int]:
    """The largest saved step in ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for m in map(_NAME.match, os.listdir(directory))
             if m]
    return max(steps) if steps else None


def save_checkpoint(directory: str, state) -> str:
    """Write ``state`` (a ``train.state.VQTrainState`` or
    ``TransformerTrainState``) at its step."""
    os.makedirs(directory, exist_ok=True)
    path = checkpoint_path(directory, state.step)
    payload = {"step": state.step, "model": state.model.state_dict(),
               "optimizer": state.opt.state_dict()}
    if hasattr(state, "vq_state"):
        vq = state.vq_state
        payload["codebook"] = {"counter": vq.counter, "filled": vq.filled,
                               "reservoir": vq.reservoir}
    if getattr(state, "disc", None) is not None:
        payload["disc"] = state.disc.state_dict()
        payload["disc_optimizer"] = state.disc_opt.state_dict()
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(directory: str, state):
    """Load the latest checkpoint of ``directory`` into ``state`` in place
    and return it."""
    step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    payload = torch.load(checkpoint_path(directory, step), map_location="cpu",
                         weights_only=True)
    state.model.load_state_dict(payload["model"], strict=True)
    if hasattr(state, "vq_state"):
        cb = payload["codebook"]
        state.vq_state = CodebookState(
            counter=cb["counter"], filled=cb["filled"],
            reservoir=cb["reservoir"].to(state.vq_state.reservoir.device))
    state.opt.load_state_dict(payload["optimizer"])
    if getattr(state, "disc", None) is not None:
        state.disc.load_state_dict(payload["disc"], strict=True)
        state.disc_opt.load_state_dict(payload["disc_optimizer"])
    state.step = payload["step"]
    return state
