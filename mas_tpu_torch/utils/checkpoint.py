"""Train-state checkpoints: one ``torch.save`` file per saved step,
``<dir>/step_<step>.pt``, holding

  * ``model``: the ``VQModel`` ``state_dict`` in the reference key layout
    (BN running statistics included), so ``utils/weights.py::
    load_reference_pt`` reads it and a trained VQ-SEG feeds the sampler;
  * ``codebook``: the phase counter, ``filled`` and the reservoir;
  * ``optimizer``: Adam's moments, update count and accumulation buffers;
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
    """Write ``state`` (a ``train.state.VQTrainState``) at its step."""
    os.makedirs(directory, exist_ok=True)
    path = checkpoint_path(directory, state.step)
    vq = state.vq_state
    payload = {"step": state.step, "model": state.model.state_dict(),
               "codebook": {"counter": vq.counter, "filled": vq.filled,
                            "reservoir": vq.reservoir},
               "optimizer": state.opt.state_dict()}
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
    cb = payload["codebook"]
    state.vq_state = CodebookState(
        counter=cb["counter"], filled=cb["filled"],
        reservoir=cb["reservoir"].to(state.vq_state.reservoir.device))
    state.opt.load_state_dict(payload["optimizer"])
    state.step = payload["step"]
    return state
