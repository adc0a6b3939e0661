"""Training loops of the VQ-SEG and VQ-IMG stages and of the transformer,
as ``mas_tpu/train/loop.py::run_pretrain_segmentation``,
``run_pretrain_image`` and ``run_train_transformer`` with their shared
``_loop``: build the state, resume from the latest checkpoint when asked,
then step, log scalars (and input / reconstruction grids: RGB for VQ-IMG,
the colorized panoptic group for VQ-SEG) and checkpoint; and ``run_show``,
the VQ-SEG visual eval; and ``tokenize_batches``, which turns pixel
batches into the transformer's tokens with the two frozen VQ encoders.
Batches are dicts of numpy arrays or tensors; they are moved to the
device in the loop.

Under data parallelism (``parallel/``) every rank runs the loop on its
own rows from the same seeded state and generator; only rank 0 logs,
renders image grids and writes checkpoints, and every rank waits for its
write (``parallel.distributed.barrier``); every rank resumes from the
same checkpoint.  Under tensor parallelism (``mesh.model`` > 1) the ranks
of a model group read the same rows and hold shards of one transformer:
it is seeded whole and sharded, a checkpoint holds the full tree (the
shards and Adam's moments gathered over the model group first) and a
resume shards it again.  The VQ stages replicate their models over the
model axis.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import (Callable, Dict, Iterable, Iterator, List, Optional,
                    Tuple)

import numpy as np
import torch

from ..data.segmap import one_hot_seg_packed
from ..losses.face_loss import FaceNet, load_face_params_from_torch
from ..losses.lpips import LPIPS, load_lpips_params_from_torch
from ..models.vqvae import VQModel
from ..parallel.collectives import broadcast_, model_parts
from ..parallel.distributed import (barrier, is_primary, model_shard, rank,
                                    world_size)
from ..parallel.mesh import batch_is_sharded
from ..parallel.sharding import gather_state, shard_state, split_dim
from ..utils.checkpoint import latest_step, restore_checkpoint, \
    save_checkpoint
from ..utils.config import (SegLossConfig, TrainConfig, TransformerConfig,
                            VQGANLossConfig, VQModelConfig)
from ..utils.logging import Logger, Visualizer
from ..utils.weights import init_random_, load_reference_pt
from .state import (TransformerTrainState, VQTrainState,
                    create_transformer_train_state, create_vq_train_state)
from .steps import (make_img_train_step, make_seg_eval_step,
                    make_seg_train_step, make_transformer_train_step,
                    to_float_image)


def step_generator(seed: int, start: int, device) -> torch.Generator:
    """The run's random stream (reservoir sampling, k-means init, CFG
    dropout), seeded
    from ``train.seed`` and the step the run starts at, so a resumed run
    does not replay the first run's draws."""
    mixed = np.random.SeedSequence([seed, start]).generate_state(1,
                                                                 np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed))


def _scalars(metrics: Dict) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items()
            if isinstance(v, (bool, int, float))
            or (torch.is_tensor(v) and v.numel() == 1)}


def _loop(cfg: TrainConfig, state, step_fn: Callable, batches: Iterable,
          to_step_args: Callable[[Dict], Tuple], device, logger: Logger,
          on_step: Optional[Callable] = None,
          image_fn: Optional[Callable] = None):
    """Step ``step_fn(state, *to_step_args(batch), generator)`` until
    ``total_steps``; log every ``log_period`` (and call ``image_fn(step,
    state, batch)`` there), checkpoint every ``save_period`` and at the
    end.  ``on_step(step, state, metrics)`` runs after every micro-step."""
    start = state.step
    if start >= cfg.total_steps:
        print(f"resume at step {start} >= total_steps {cfg.total_steps}; "
              "skipping train loop")
        return state
    data, _ = cfg.mesh.shape(world_size())
    generator = step_generator(cfg.seed, start, device)
    saved = None
    t0 = time.perf_counter()
    for i, batch in enumerate(batches):
        step_no = start + i
        if step_no >= cfg.total_steps:
            break
        args = [torch.as_tensor(a).to(device, non_blocking=True)
                for a in to_step_args(batch)]
        if not batch_is_sharded(args[0].shape[0], data, data,
                                cfg.allow_replicated_batch):
            args = [broadcast_(a) for a in args]     # rank 0's rows
        metrics = step_fn(state, *args, generator)
        if on_step is not None:
            on_step(step_no + 1, state, metrics)
        if (step_no + 1) % cfg.log_period == 0:
            scalars = _scalars(metrics)     # waits for the device
            rate = cfg.log_period / max(time.perf_counter() - t0, 1e-9)
            t0 = time.perf_counter()
            logger.log(step_no + 1, steps_per_sec=rate, **scalars)
            if image_fn is not None and is_primary():
                image_fn(step_no + 1, state, batch)
        if (step_no + 1) % cfg.save_period == 0 or \
                step_no + 1 == cfg.total_steps:
            saved = _save(cfg.checkpoint_dir, state)
    # a finite iterator may end before total_steps: keep that progress too
    if state.step > start and saved != state.step:
        _save(cfg.checkpoint_dir, state)
    return state


class _Whole:
    """Stands for a model or an optimizer in a checkpoint: its gathered
    ``state_dict``."""

    def __init__(self, state: Dict):
        self._state = state

    def state_dict(self) -> Dict:
        return self._state


def _gathered(state):
    """``state`` with a tensor-parallel transformer's parameters and Adam
    moments gathered over the model group into the full tree (every rank
    takes part); ``state`` itself otherwise."""
    model = state.model
    if getattr(model, "shard", (0, 1))[1] == 1:
        return state
    cfg = model.cfg

    def whole(tensors):
        keys = [k for k in tensors if split_dim(k) is not None]
        return gather_state(model_parts(tensors, keys), cfg)

    opt = dict(state.opt.state_dict())
    opt.update({k: whole(opt[k]) for k in ("mu", "nu", "acc")})
    return dataclasses.replace(state, model=_Whole(whole(model.state_dict())),
                               opt=_Whole(opt))


def _save(directory: str, state) -> int:
    """Rank 0 writes ``state``'s checkpoint (a half-way gradient
    accumulation averaged over the data group first, shards gathered)
    while the others wait."""
    for opt in (state.opt, getattr(state, "disc_opt", None)):
        if opt is not None:
            opt.sync_accumulation()
    whole = _gathered(state)
    if is_primary():
        save_checkpoint(directory, whole)
    barrier()
    return state.step


def _maybe_resume(train_cfg: TrainConfig, state):
    """Restore ``state`` from the latest checkpoint of ``checkpoint_dir``
    when ``train.resume`` is set and one exists (a tensor-parallel
    transformer its shard of it)."""
    if train_cfg.resume and latest_step(train_cfg.checkpoint_dir) is not None:
        shard = getattr(state.model, "shard", (0, 1))
        restore_checkpoint(
            train_cfg.checkpoint_dir, state,
            (lambda full: shard_state(full, state.model.cfg, *shard))
            if shard[1] > 1 else None)
        print(f"resumed from step {state.step}")
    return state


def build_seg_state(train_cfg: TrainConfig, model_cfg: VQModelConfig,
                    device) -> VQTrainState:
    """Seeded initial state, or the latest checkpoint's (``_maybe_resume``).
    The seg stage accumulates at the undivided lr, as the reference does."""
    init = torch.Generator(device=device).manual_seed(train_cfg.seed)
    return _maybe_resume(train_cfg, create_vq_train_state(
        model_cfg, train_cfg.optimizer, init, device, rescale_lr=False))


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
    device.  Every ``logger.image_period`` steps at a log step, the first
    4 seg maps and their eval-mode reconstructions go to the logger,
    colorized (``Visualizer``, panoptic group; the reconstruction as
    logits), unquantized during the codebook's pass-through window."""
    state = build_seg_state(train_cfg, model_cfg, device)
    batches = iter(batches)
    first = next(batches, None)
    packed = first is not None and "seg_packed" in first
    step = make_seg_train_step(state.model, state.opt, loss_cfg,
                               from_packed_labels=packed)
    rest = (itertools.chain([first], batches) if first is not None
            else batches)
    key = "seg_packed" if packed else "mask"
    logger = logger or Logger(process_index=rank())
    viz = Visualizer(logger.log_dir) if is_primary() else None

    def image_fn(step_no, st, batch):
        if step_no % logger.image_period:
            return
        seg = torch.as_tensor(batch[key][:4]).to(device)
        if packed:
            seg = one_hot_seg_packed(seg)
        quantize = st.vq_state.counter >= model_cfg.codebook.q_init
        st.model.eval()
        with torch.no_grad():
            recon = st.model.reconstruct(seg, quantize=quantize)
        logger.log(step_no,
                   img=viz.colorize(seg.cpu().numpy())["panoptic"],
                   img_rec=viz.colorize(recon.cpu().numpy(),
                                        logits=True)["panoptic"])

    return _loop(train_cfg, state, step, rest, lambda b: (b[key],), device,
                 logger, on_step, image_fn)


def build_img_state(train_cfg: TrainConfig, model_cfg: VQModelConfig,
                    device) -> VQTrainState:
    """Seeded initial VQ-IMG state (VQ model, discriminator, both Adams at
    the lr divided by their accumulation, as the reference's image stage),
    or the latest checkpoint's (``_maybe_resume``)."""
    init = torch.Generator(device=device).manual_seed(train_cfg.seed)
    return _maybe_resume(train_cfg, create_vq_train_state(
        model_cfg, train_cfg.optimizer, init, device,
        disc_opt_cfg=train_cfg.disc_optimizer))


def frozen_tower(cls, path: Optional[str], load: Callable, seed: int,
                 device) -> torch.nn.Module:
    """``cls()`` on ``device``, in eval mode with no gradient to its
    weights: from the torch checkpoint ``path`` (through ``load``), or a
    seeded random init where ``path`` is empty."""
    with torch.device(device):
        tower = cls()
    if path:
        tower.load_state_dict(load(path), strict=True)
    else:
        init_random_(tower, torch.Generator(device=device).manual_seed(seed))
    return tower.eval().requires_grad_(False)


def frozen_lpips(device, path: Optional[str] = None) -> LPIPS:
    """The LPIPS tower of the VQGAN loss and of eval: from ``path``, or
    seeded random (seed 1)."""
    return frozen_tower(LPIPS, path, load_lpips_params_from_torch, 1, device)


def frozen_towers(loss_cfg: VQGANLossConfig, device,
                  lpips_params_path: Optional[str] = None,
                  face_params_path: Optional[str] = None):
    """(LPIPS, FaceNet or None) on ``device`` (``frozen_tower``; FaceNet
    seeded 2 where its path is absent)."""
    face = (frozen_tower(FaceNet, face_params_path,
                         load_face_params_from_torch, 2, device)
            if loss_cfg.face_loss else None)
    return frozen_lpips(device, lpips_params_path), face


def run_pretrain_image(train_cfg: TrainConfig, model_cfg: VQModelConfig,
                       batches: Iterable[Dict],
                       loss_cfg: VQGANLossConfig = VQGANLossConfig(),
                       lpips_params_path: Optional[str] = None,
                       face_params_path: Optional[str] = None,
                       device="cuda", logger: Optional[Logger] = None,
                       on_step: Optional[Callable] = None) -> VQTrainState:
    """VQ-IMG stage.  Batches carry ``image`` [B, H, W, 3] (uint8 or
    float) and padded ``bbox_obj`` / ``bbox_face`` [B, M, 4].  Every
    ``logger.image_period`` steps at a log step, the first 4 images and
    their eval-mode reconstructions go to the logger, unquantized during
    the codebook's pass-through window, as the train step decodes
    them."""
    state = build_img_state(train_cfg, model_cfg, device)
    lpips, face = frozen_towers(loss_cfg, device, lpips_params_path,
                                face_params_path)
    step = make_img_train_step(state.model, state.disc, state.opt,
                               state.disc_opt, loss_cfg, lpips, face)
    logger = logger or Logger(process_index=rank())

    def image_fn(step_no, st, batch):
        if step_no % logger.image_period:
            return
        images = to_float_image(torch.as_tensor(batch["image"][:4])
                                .to(device))
        quantize = st.vq_state.counter >= model_cfg.codebook.q_init
        st.model.eval()
        with torch.no_grad():
            recon = st.model.reconstruct(images, quantize=quantize)
        logger.log(step_no, img=images.cpu().numpy(),
                   img_rec=recon.clamp(0.0, 1.0).cpu().numpy())

    return _loop(train_cfg, state, step, batches,
                 lambda b: (b["image"], b["bbox_obj"], b["bbox_face"]),
                 device, logger, on_step, image_fn)


def build_transformer_state(train_cfg: TrainConfig,
                            model_cfg: TransformerConfig,
                            device) -> TransformerTrainState:
    """Seeded initial state, or the latest checkpoint's (``_maybe_resume``);
    this rank's shard of it under tensor parallelism."""
    init = torch.Generator(device=device).manual_seed(train_cfg.seed)
    return _maybe_resume(train_cfg, create_transformer_train_state(
        model_cfg, train_cfg.optimizer, init, device, model_shard()))


def token_args(cfg: TransformerConfig) -> Callable[[Dict], Tuple]:
    """batch -> (text, seg, image) tokens, each checked to hold the
    transformer's number of tokens a row: a VQ model whose token grid
    does not match ``seg_tokens_per_dim`` / ``image_tokens_per_dim``
    raises here, before an embedding reads out of range."""
    def args(batch):
        for key, n in (("text", cfg.text_length), ("seg", cfg.seg_length),
                       ("image", cfg.image_length)):
            if tuple(batch[key].shape[1:]) != (n,):
                raise ValueError(
                    f"{key} tokens of shape {tuple(batch[key].shape)}, the "
                    f"transformer takes [batch, {n}]")
        return batch["text"], batch["seg"], batch["image"]

    return args


def run_train_transformer(train_cfg: TrainConfig,
                          model_cfg: TransformerConfig,
                          batches: Iterable[Dict], device="cuda",
                          logger: Optional[Logger] = None,
                          on_step: Optional[Callable] = None
                          ) -> TransformerTrainState:
    """Transformer stage.  Batches carry ``text``, ``seg`` and ``image``
    tokens (``data/dataset.py::SyntheticTokenBatches``, or pixels through
    ``tokenize_batches``)."""
    state = build_transformer_state(train_cfg, model_cfg, device)
    step = make_transformer_train_step(state.model, state.opt,
                                       train_cfg.uncond_p,
                                       train_cfg.start_uncond)
    return _loop(train_cfg, state, step, batches, token_args(model_cfg),
                 device, logger or Logger(process_index=rank()), on_step)


def tokenize_batches(pixel_batches: Iterable[Dict], vq_seg: VQModel,
                     vq_img: VQModel,
                     text_tokenizer: Callable[[list], np.ndarray],
                     device) -> Iterator[Dict]:
    """Pixel batches (``mask`` [B, H, W, 159], ``image`` [B, H, W, 3],
    ``caption``) -> token batches of the transformer stage, as
    ``mas_tpu/train/loop.py::tokenize_batches``: the two frozen VQ
    encoders' ``encode_tokens`` on ``device`` (kernels B4 and B5 on
    CUDA), the captions through ``text_tokenizer``.  ``text`` is int32
    numpy [B, text_length]; ``seg`` and ``image`` are int32 tensors
    [B, h * w] on ``device``."""
    for batch in pixel_batches:
        with torch.inference_mode():
            seg = vq_seg.encode_tokens(
                torch.as_tensor(batch["mask"]).to(device, non_blocking=True))
            img = vq_img.encode_tokens(to_float_image(
                torch.as_tensor(batch["image"]).to(device,
                                                   non_blocking=True)))
        b = seg.shape[0]
        # clones out of inference mode: the step's embeddings save them
        yield {"text": text_tokenizer(batch.get("caption", [""] * b)),
               "seg": seg.reshape(b, -1).clone(),
               "image": img.reshape(b, -1).clone()}


def run_show(train_cfg: TrainConfig, model_cfg: VQModelConfig,
             batches: Iterable[Dict], n_samples: int = 40,
             out_dir: str = "results", device="cuda") -> List[str]:
    """VQ-SEG visual eval (``mas_tpu/train/loop.py::run_show``): the model
    from the latest checkpoint of ``train.checkpoint_dir`` (seeded random
    weights where there is none), then for each batch the eval forward
    and a ``Visualizer`` panel [image | seg groups | reconstruction
    groups] in ``out_dir``, until ``n_samples`` seg maps are shown.  An
    all-zero image stands in where a batch has no ``image``.  Returns the
    panels' paths; under data parallelism rank 0 alone writes them."""
    with torch.device(device):
        model = VQModel(model_cfg).eval()
    step_no = latest_step(train_cfg.checkpoint_dir)
    if step_no is None:
        init_random_(model, torch.Generator(device=device)
                     .manual_seed(train_cfg.seed))
    else:
        model.load_state_dict(load_reference_pt(train_cfg.checkpoint_dir))
        print(f"resumed from step {step_no}")
    eval_step = make_seg_eval_step(model)
    viz = Visualizer(out_dir) if is_primary() else None
    done, paths = 0, []
    for batch in batches:
        seg = torch.as_tensor(batch["mask"]).to(device)
        recon, _ = eval_step(seg)
        rgb = batch.get("image")
        if rgb is None:
            rgb = np.zeros(tuple(seg.shape[:3]) + (3,), np.float32)
        if viz is not None:     # rank 0 writes the panels
            paths.append(viz(done,
                             image=np.asarray(torch.as_tensor(rgb).cpu()),
                             seg=seg.cpu().numpy(),
                             seg_rec=recon.cpu().numpy()))
        done += seg.shape[0]
        if done >= n_samples:
            break
    return paths
