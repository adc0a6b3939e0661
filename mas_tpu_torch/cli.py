"""Command-line entry point of the PyTorch port: ``--mode sample``,
``eval``, ``show``, ``export``, ``pretrain_segmentation``,
``pretrain_image``, ``train_transformer`` and ``preprocess_dataset``.

``sample`` is the counterpart of ``mas_tpu/cli.py::_run_sample``: it
tokenizes the config's captions, samples image tokens with guidance and
top-k, decodes them with VQ-IMG and writes the image grid.  Without
checkpoints the weights are seeded random, as the JAX ``--mode sample``
does.  ``transformer_checkpoint`` / ``vq_checkpoint`` may name a
reference-layout ``.pt``, as ``--mode export`` of either package writes
it, or a training ``checkpoint_dir`` of the port (its latest
``step_*.pt``), or one such file.

``eval`` scores a VQ model (``eval.py::evaluate_vq_model``: L1, MSE, PSNR,
LPIPS for a 3-channel model, codebook stats) over ``n_eval_batches``
(default 8) and prints one JSON line; it takes ``train.checkpoint_dir``
when ``train.resume`` is true, seeded random weights otherwise.  ``show``
writes colorized VQ-SEG reconstruction panels of ``n_samples`` (default
40) seg maps to ``results/`` from the latest checkpoint of
``train.checkpoint_dir`` (``train/loop.py::run_show``) and prints their
paths.  ``export`` writes the reference-layout ``.pt`` (``output``,
default ``exported.pt``) of a ``model`` + ``checkpoint`` or a
``transformer`` + ``transformer_checkpoint`` section (seeded random
weights where no checkpoint is named) and prints its path.

``pretrain_segmentation`` trains VQ-SEG, ``pretrain_image`` VQ-IMG (the
VQGAN, with the config's ``loss`` section and the LPIPS and face towers
from the torch checkpoints ``lpips_weights`` / ``face_weights``, seeded
random where those are null) and ``train_transformer`` the transformer
(``train/loop.py``) on the config's ``data`` section (``data_iter``:
``kind`` synthetic, webdataset or local_npz).  With ``kind: webdataset``
the transformer trains on pixel shards tokenized on the fly by the frozen
encoders of the ``vq_seg`` and ``vq_img`` sections (each a ``model`` and
an optional ``checkpoint``; seeded random weights without one).
``preprocess_dataset`` runs the data factory of the ``preprocess``
section (``data/preprocess.py::run_preprocessor``): annotate raw images
or tar shards and write npz files or processed shards; a
``torchscript`` annotator runs on ``--device``.

As in ``mas_tpu/cli.py::main``, every mode builds a ``TrainConfig`` from
the whole ``train`` section (a mode that does not train validates as
``pretrain_segmentation``), and a mode whose config has no ``model`` or
``transformer`` section takes ``vq_seg_config()`` (``vq_img_config()``
for ``pretrain_image``) or ``TransformerConfig()``.  ``run`` (``python
-m mas_tpu_torch``) appends the traceback of a failed run to
``error.log`` in the working directory and re-raises.

Usage:
    python -m mas_tpu_torch.cli --config configs/sample_256.json --device cuda
    python -m mas_tpu_torch.cli --config configs/seg_256.json \
        --mode pretrain_segmentation --device cuda
    python -m mas_tpu_torch.cli --config configs/img_512.json \
        --mode pretrain_image --device cuda
    python -m mas_tpu_torch.cli --config configs/transformer_512.json \
        --mode train_transformer --device cuda
    python -m mas_tpu_torch --config configs/eval_256.json --device cuda
    python -m mas_tpu_torch --config configs/show_256.json --device cuda
    python -m mas_tpu_torch --config configs/export_vq.json --device cuda
    python -m mas_tpu_torch --config configs/preprocess_web.json

``--device`` is explicit; nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, Optional

import numpy as np
import torch

from .data.tokenizer import HashWordTokenizer
from .models.sampler import sample_images
from .models.transformer import MakeAScene
from .models.vqvae import VQModel
from .utils.config import (ConfigError, SegLossConfig, TrainConfig,
                           TransformerConfig, VQGANLossConfig, VQModelConfig,
                           vq_img_config, vq_seg_config)
from .utils.logging import make_grid, save_image
from .utils.weights import init_random_, load_reference_pt, serving_state

# TrainConfig validates these modes; the others reuse its generic fields
TRAIN_CONFIG_MODES = ("pretrain_segmentation", "pretrain_image",
                      "train_transformer")


def load_transformer(cfg: TransformerConfig, checkpoint: Optional[str],
                     device, generator: torch.Generator,
                     fp32_params: bool = False) -> MakeAScene:
    """MakeAScene on ``device`` from a reference ``.pt`` or a port
    checkpoint dir (``load_reference_pt``), or seeded random weights when
    ``checkpoint`` is empty; ``fp32_params`` keeps fp32 weights in a bf16
    model (export)."""
    with torch.device(device):
        model = MakeAScene(cfg, fp32_params=fp32_params).eval()
    if checkpoint:
        model.load_state_dict(
            serving_state(load_reference_pt(checkpoint), "transformer"))
    else:
        init_random_(model, generator)
    return model


def load_vq(cfg: VQModelConfig, checkpoint: Optional[str], device,
            generator: torch.Generator, fp32_params: bool = False) -> VQModel:
    """VQModel on ``device`` (see ``load_transformer``)."""
    with torch.device(device):
        model = VQModel(cfg, fp32_params=fp32_params).eval()
    if checkpoint:
        model.load_state_dict(serving_state(load_reference_pt(checkpoint),
                                            "vq"))
    else:
        init_random_(model, generator)
    return model


def prompt_tokens(raw: Dict[str, Any], cfg: TransformerConfig,
                  batch_size: int):
    """(text [B, text_length], seg [B, seg_length]) int64 numpy arrays from
    the config's ``captions`` and ``seg_tokens_file``."""
    captions = raw.get("captions") or []
    b = len(captions) or batch_size
    if captions:
        tok = HashWordTokenizer(
            vocab_size=cfg.text_vocab_size - cfg.text_length,
            text_length=cfg.text_length)
        text = tok(captions)
    else:
        # all-pad text = unconditional sampling
        text = np.zeros((b, cfg.text_length), np.int32)
    if raw.get("seg_tokens_file"):
        seg = np.load(raw["seg_tokens_file"])
        if hasattr(seg, "files"):
            seg = seg[seg.files[0]]
        seg = np.asarray(seg).reshape(b, cfg.seg_length)
    else:
        seg = np.zeros((b, cfg.seg_length), np.int32)
    return text.astype(np.int64), seg.astype(np.int64)


def run_sample(raw: Dict[str, Any], train_cfg: TrainConfig, device) -> str:
    tcfg = TransformerConfig.from_dict(raw["transformer"])
    vcfg = VQModelConfig.from_dict(raw["model"])
    generator = torch.Generator(device=device).manual_seed(train_cfg.seed)
    transformer = load_transformer(tcfg, raw.get("transformer_checkpoint"),
                                   device, generator)
    vq = load_vq(vcfg, raw.get("vq_checkpoint"), device, generator)
    text, seg = prompt_tokens(raw, tcfg, train_cfg.batch_size)
    imgs = sample_images(
        transformer, vq, torch.from_numpy(text).to(device),
        torch.from_numpy(seg).to(device), generator,
        guidance_scale=raw.get("guidance_scale", 3.0),
        temperature=raw.get("temperature", 1.0), top_k=raw.get("top_k", 0))
    out = raw.get("output", "samples.jpg")
    save_image(make_grid(np.clip(imgs.cpu().numpy(), 0, 1)), out)
    return out


def data_iter(data_cfg: Dict[str, Any], batch_size: int, model_cfg):
    """The host batch iterator of the config's ``data`` section, as
    ``mas_tpu/cli.py::_data_iter``.  ``kind: synthetic`` (the default)
    gives seeded random RGB images and boxes for a 3-channel
    ``VQModelConfig`` (VQ-IMG), seg maps for another one (VQ-SEG), tokens
    for a ``TransformerConfig``.  ``webdataset`` (``shards``: a dir of
    processed ``.tar`` shards, a path, a ``pipe:`` URL or a list;
    ``resolution`` 512) makes one pass over this process's shards;
    ``local_npz`` (``image_dir``, ``preprocessed_dir``, ``resolution``
    256) loops over shuffled epochs, each a ``default_rng(seed)``
    permutation.  Both give image, box and caption batches, with seg maps
    unless the model is a 3-channel VQ model, ``max_boxes`` (6) boxes a
    sample, ``prefetch`` (2) batches ahead on a thread."""
    from .data.dataset import (PreprocessedLocalDataset,
                               PreprocessedWebDataset, SyntheticImgBatches,
                               SyntheticSegBatches, SyntheticTokenBatches,
                               batch_iterator)
    from .data.prefetch import prefetch

    kind = data_cfg.get("kind", "synthetic")
    seed = data_cfg.get("seed", 0)
    if kind == "synthetic":
        if isinstance(model_cfg, TransformerConfig):
            return iter(SyntheticTokenBatches(batch_size, model_cfg, seed))
        res = data_cfg.get("resolution", model_cfg.resolution)
        if model_cfg.in_channels == 3:
            return iter(SyntheticImgBatches(batch_size, res, seed=seed))
        return iter(SyntheticSegBatches(batch_size, res, seed))
    need_seg = not (isinstance(model_cfg, VQModelConfig)
                    and model_cfg.in_channels == 3)
    # this process's index and the process count: ROADMAP A12 sets them
    # from torch.distributed (the JAX package reads jax.process_index())
    index, count = 0, 1
    if kind == "webdataset":
        samples = PreprocessedWebDataset(
            data_cfg["shards"], resolution=data_cfg.get("resolution", 512),
            process_index=index, process_count=count, need_seg=need_seg)
    elif kind == "local_npz":
        samples = _epochs(PreprocessedLocalDataset(
            data_cfg["image_dir"], data_cfg["preprocessed_dir"],
            resolution=data_cfg.get("resolution", 256), seed=seed),
            seed, index, count)
    else:
        raise ConfigError(f"unknown data kind {kind!r}")
    return prefetch(batch_iterator(samples, batch_size,
                                   max_boxes=data_cfg.get("max_boxes", 6),
                                   need_seg=need_seg),
                    size=data_cfg.get("prefetch", 2))


def _epochs(ds, seed: int, index: int, count: int):
    """Infinite shuffled epochs of a map-style dataset, strided across
    processes: every process permutes with the same seed, so the strides
    partition each epoch."""
    rng = np.random.default_rng(seed)
    while True:
        for i in rng.permutation(len(ds))[index::count]:
            yield ds[int(i)]


def run_pretrain_segmentation(raw: Dict[str, Any], train_cfg: TrainConfig,
                              device, on_step=None):
    from .train.loop import run_pretrain_segmentation as run

    model_cfg = (VQModelConfig.from_dict(raw["model"]) if "model" in raw
                 else vq_seg_config())
    loss_cfg = SegLossConfig.from_dict(raw.get("loss", {}))
    batches = data_iter(raw.get("data", {}), train_cfg.batch_size, model_cfg)
    return run(train_cfg, model_cfg, batches, loss_cfg, device,
               on_step=on_step)


def run_pretrain_image(raw: Dict[str, Any], train_cfg: TrainConfig,
                       device, on_step=None):
    from .train.loop import run_pretrain_image as run

    model_cfg = (VQModelConfig.from_dict(raw["model"]) if "model" in raw
                 else vq_img_config())
    loss_cfg = VQGANLossConfig.from_dict(raw.get("loss", {}))
    batches = data_iter(raw.get("data", {}), train_cfg.batch_size, model_cfg)
    return run(train_cfg, model_cfg, batches, loss_cfg,
               raw.get("lpips_weights"), raw.get("face_weights"), device,
               on_step=on_step)


def run_train_transformer(raw: Dict[str, Any], train_cfg: TrainConfig,
                          device, on_step=None):
    from .train.loop import run_train_transformer as run

    model_cfg = (TransformerConfig.from_dict(raw["transformer"])
                 if "transformer" in raw else TransformerConfig())
    data_cfg = raw.get("data", {})
    batches = data_iter(data_cfg, train_cfg.batch_size, model_cfg)
    if data_cfg.get("kind") == "webdataset":
        # pixels -> tokens through the two frozen VQ encoders of the
        # sections vq_seg / vq_img = {model, checkpoint}
        from .train.loop import tokenize_batches

        generator = torch.Generator(device=device).manual_seed(
            train_cfg.seed)
        vq_seg, vq_img = (load_vq(VQModelConfig.from_dict(raw[k]["model"]),
                                  raw[k].get("checkpoint"), device, generator)
                          for k in ("vq_seg", "vq_img"))
        tok = HashWordTokenizer(
            vocab_size=model_cfg.text_vocab_size - model_cfg.text_length,
            text_length=model_cfg.text_length)
        batches = tokenize_batches(batches, vq_seg, vq_img, tok, device)
    return run(train_cfg, model_cfg, batches, device, on_step=on_step)


def _vq_config(raw: Dict[str, Any]) -> VQModelConfig:
    return (VQModelConfig.from_dict(raw["model"]) if "model" in raw
            else vq_seg_config())


def run_eval(raw: Dict[str, Any], train_cfg: TrainConfig,
             device) -> Dict[str, float]:
    """``mas_tpu/cli.py::_run_eval``: the VQ model from
    ``train.checkpoint_dir`` when ``train.resume`` is true (seeded random
    otherwise), ``n_eval_batches`` (default 8) of the ``data`` section,
    and for a 3-channel model LPIPS from ``lpips_weights`` (seeded random
    where null)."""
    from .eval import evaluate_vq_model
    from .train.loop import frozen_lpips

    model_cfg = _vq_config(raw)
    generator = torch.Generator(device=device).manual_seed(train_cfg.seed)
    model = load_vq(model_cfg, train_cfg.checkpoint_dir
                    if train_cfg.resume else None, device, generator)
    batches = data_iter(raw.get("data", {}), train_cfg.batch_size, model_cfg)
    lpips_apply = None
    if model_cfg.in_channels == 3:
        lpips_apply = frozen_lpips(device, raw.get("lpips_weights"))
    return evaluate_vq_model(model, batches,
                             n_batches=raw.get("n_eval_batches", 8),
                             lpips_apply=lpips_apply)


def run_show(raw: Dict[str, Any], train_cfg: TrainConfig, device):
    from .train.loop import run_show as run

    model_cfg = _vq_config(raw)
    batches = data_iter(raw.get("data", {}), train_cfg.batch_size, model_cfg)
    return run(train_cfg, model_cfg, batches,
               n_samples=raw.get("n_samples", 40), device=device)


def run_export(raw: Dict[str, Any], train_cfg: TrainConfig, device) -> str:
    """``mas_tpu/cli.py::_run_export``: a ``transformer`` section (with
    ``transformer_checkpoint``) or a ``model`` section (with
    ``checkpoint``) -> the reference-layout ``.pt`` at ``output``.  The
    model keeps fp32 weights, so a checkpoint exports bitwise."""
    from .utils.export import export_state

    generator = torch.Generator(device=device).manual_seed(train_cfg.seed)
    if "transformer" in raw:
        model = load_transformer(
            TransformerConfig.from_dict(raw["transformer"]),
            raw.get("transformer_checkpoint"), device, generator,
            fp32_params=True)
    elif "model" in raw:
        model = load_vq(VQModelConfig.from_dict(raw["model"]),
                        raw.get("checkpoint"), device, generator,
                        fp32_params=True)
    else:
        raise ConfigError(
            "export mode needs a 'transformer' or 'model' section")
    out = raw.get("output", "exported.pt")
    torch.save(export_state(model), out)
    return out


_TRAIN_MODES = {"pretrain_segmentation": run_pretrain_segmentation,
                "pretrain_image": run_pretrain_image,
                "train_transformer": run_train_transformer}


def main(argv=None, on_step=None) -> int:
    """Run the config's mode; ``on_step(step, state, metrics)`` runs after
    every micro-step of a training mode (``train/loop.py::_loop``)."""
    ap = argparse.ArgumentParser(prog="mas_tpu_torch",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True, help="JSON config path")
    ap.add_argument("--mode", default=None,
                    help="override the config's train.mode")
    ap.add_argument("--device", default="cuda",
                    help="torch device, e.g. cuda, cuda:1 or cpu")
    args = ap.parse_args(argv)
    with open(args.config) as f:
        raw = json.load(f)
    train_raw = dict(raw.get("train", {}))
    mode = args.mode or train_raw.get("mode", "pretrain_segmentation")
    train_raw["mode"] = (mode if mode in TRAIN_CONFIG_MODES
                         else TRAIN_CONFIG_MODES[0])
    train_cfg = TrainConfig.from_dict(train_raw)
    device = torch.device(args.device)
    if mode in _TRAIN_MODES:
        state = _TRAIN_MODES[mode](raw, train_cfg, device, on_step)
        print(f"trained to step {state.step}")
    elif mode == "sample":
        print(run_sample(raw, train_cfg, device))
    elif mode == "eval":
        print(json.dumps(run_eval(raw, train_cfg, device)))
    elif mode == "show":
        print("\n".join(run_show(raw, train_cfg, device)))
    elif mode == "export":
        print(run_export(raw, train_cfg, device))
    elif mode == "preprocess_dataset":
        from .data.preprocess import run_preprocessor

        run_preprocessor(raw.get("preprocess", {}), device)
    else:
        raise ConfigError(f"unknown mode {mode!r}")
    return 0


def run(argv=None) -> int:
    """``main`` with the reference's failure handling: append the
    traceback to ``error.log`` and re-raise (``mas_tpu/cli.py::run``)."""
    try:
        return main(argv)
    except Exception:
        import traceback

        with open("error.log", "a") as f:
            f.write(traceback.format_exc() + "\n")
        raise


if __name__ == "__main__":
    sys.exit(run())
