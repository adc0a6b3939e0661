"""Training loop of the VQ-SEG stage, as ``mas_tpu/train/loop.py::
run_pretrain_segmentation`` and its shared ``_loop``: build the state,
resume from the latest checkpoint when asked, then step, log scalars and
checkpoint.  Batches are dicts of numpy arrays or tensors; they are moved
to the device in the loop.  Image grids (``Visualizer``) are not ported
yet (ROADMAP A11).
"""

from __future__ import annotations

import itertools
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..utils.checkpoint import latest_step, restore_checkpoint, \
    save_checkpoint
from ..utils.config import SegLossConfig, TrainConfig, VQModelConfig
from ..utils.logging import Logger
from .state import VQTrainState, create_vq_train_state
from .steps import make_seg_train_step


def step_generator(seed: int, start: int, device) -> torch.Generator:
    """The run's random stream (reservoir sampling, k-means init), seeded
    from ``train.seed`` and the step the run starts at, so a resumed run
    does not replay the first run's draws."""
    mixed = np.random.SeedSequence([seed, start]).generate_state(1,
                                                                 np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed))


def _scalars(metrics: Dict) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items()
            if isinstance(v, (bool, int, float))
            or (torch.is_tensor(v) and v.numel() == 1)}


def _loop(cfg: TrainConfig, state: VQTrainState, step_fn: Callable,
          batches: Iterable, key: str, device, logger: Logger,
          on_step: Optional[Callable] = None) -> VQTrainState:
    """Step over ``batches[key]`` until ``total_steps``; log every
    ``log_period``, checkpoint every ``save_period`` and at the end.
    ``on_step(step, state, metrics)`` runs after every micro-step."""
    start = state.step
    if start >= cfg.total_steps:
        print(f"resume at step {start} >= total_steps {cfg.total_steps}; "
              "skipping train loop")
        return state
    generator = step_generator(cfg.seed, start, device)
    t0 = time.perf_counter()
    for i, batch in enumerate(batches):
        step_no = start + i
        if step_no >= cfg.total_steps:
            break
        x = torch.as_tensor(batch[key]).to(device, non_blocking=True)
        metrics = step_fn(state, x, generator)
        if on_step is not None:
            on_step(step_no + 1, state, metrics)
        if (step_no + 1) % cfg.log_period == 0:
            scalars = _scalars(metrics)     # waits for the device
            rate = cfg.log_period / max(time.perf_counter() - t0, 1e-9)
            t0 = time.perf_counter()
            logger.log(step_no + 1, steps_per_sec=rate, **scalars)
        if (step_no + 1) % cfg.save_period == 0 or \
                step_no + 1 == cfg.total_steps:
            save_checkpoint(cfg.checkpoint_dir, state)
    # a finite iterator may end before total_steps: keep that progress too
    if state.step > start and latest_step(cfg.checkpoint_dir) != state.step:
        save_checkpoint(cfg.checkpoint_dir, state)
    return state


def build_seg_state(train_cfg: TrainConfig, model_cfg: VQModelConfig,
                    device) -> VQTrainState:
    """Seeded initial state, restored from the latest checkpoint of
    ``checkpoint_dir`` when ``train.resume`` is set and one exists.  The
    seg stage accumulates at the undivided lr, as the reference does."""
    init = torch.Generator(device=device).manual_seed(train_cfg.seed)
    state = create_vq_train_state(model_cfg, train_cfg.optimizer, init,
                                  device, rescale_lr=False)
    if train_cfg.resume and latest_step(train_cfg.checkpoint_dir) is not None:
        restore_checkpoint(train_cfg.checkpoint_dir, state)
        print(f"resumed from step {state.step}")
    return state


def run_pretrain_segmentation(train_cfg: TrainConfig,
                              model_cfg: VQModelConfig,
                              batches: Iterable[Dict],
                              loss_cfg: SegLossConfig = SegLossConfig(),
                              device="cuda",
                              logger: Optional[Logger] = None,
                              on_step: Optional[Callable] = None
                              ) -> VQTrainState:
    """VQ-SEG stage.  Batches carry a dense ``mask`` [B, H, W, 159] or
    packed ``seg_packed`` int16 [B, H, W, 4] labels, expanded on the
    device."""
    state = build_seg_state(train_cfg, model_cfg, device)
    batches = iter(batches)
    first = next(batches, None)
    packed = first is not None and "seg_packed" in first
    step = make_seg_train_step(state.model, state.opt, loss_cfg,
                               from_packed_labels=packed)
    rest = (itertools.chain([first], batches) if first is not None
            else batches)
    return _loop(train_cfg, state, step, rest,
                 "seg_packed" if packed else "mask", device,
                 logger or Logger(), on_step)
