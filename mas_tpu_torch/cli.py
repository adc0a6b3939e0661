"""Command-line entry point of the PyTorch port: ``--mode sample`` and
``--mode pretrain_segmentation``.

``sample`` is the counterpart of ``mas_tpu/cli.py::_run_sample``: it
tokenizes the config's captions, samples image tokens with guidance and
top-k, decodes them with VQ-IMG and writes the image grid.  Without
checkpoints the weights are seeded random, as the JAX ``--mode sample``
does.  ``transformer_checkpoint`` / ``vq_checkpoint`` may name a
reference-layout ``.pt``, as the JAX package's ``--mode export`` writes
it, or a checkpoint of the port's VQ-SEG training.

``pretrain_segmentation`` trains VQ-SEG (``train/loop.py``) on the
config's ``data`` section; only ``kind: synthetic`` is ported (ROADMAP
A13).  Every other mode raises: it is not ported yet (ROADMAP A9-A11).

Usage:
    python -m mas_tpu_torch.cli --config configs/sample_256.json --device cuda
    python -m mas_tpu_torch.cli --config configs/seg_256.json \
        --mode pretrain_segmentation --device cuda

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
                           TransformerConfig, VQModelConfig)
from .utils.logging import make_grid, save_image
from .utils.weights import init_random_, load_reference_pt, serving_state

# the train-section keys sampling reads; the rest configure training
_SAMPLE_TRAIN_KEYS = {"mode", "batch_size", "seed"}


def load_transformer(cfg: TransformerConfig, checkpoint: Optional[str],
                     device, generator: torch.Generator) -> MakeAScene:
    """MakeAScene on ``device`` from a reference ``.pt``, or seeded random
    weights when ``checkpoint`` is empty."""
    with torch.device(device):
        model = MakeAScene(cfg).eval()
    if checkpoint:
        model.load_state_dict(
            serving_state(load_reference_pt(checkpoint), "transformer"))
    else:
        init_random_(model, generator)
    return model


def load_vq(cfg: VQModelConfig, checkpoint: Optional[str], device,
            generator: torch.Generator) -> VQModel:
    """VQ-IMG decode side on ``device`` (see ``load_transformer``)."""
    with torch.device(device):
        model = VQModel(cfg).eval()
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


def run_sample(raw: Dict[str, Any], device) -> str:
    train = dict(raw.get("train", {}))
    tcfg = TransformerConfig.from_dict(raw["transformer"])
    vcfg = VQModelConfig.from_dict(raw["model"])
    generator = torch.Generator(device=device).manual_seed(
        int(train.get("seed", 0)))
    transformer = load_transformer(tcfg, raw.get("transformer_checkpoint"),
                                   device, generator)
    vq = load_vq(vcfg, raw.get("vq_checkpoint"), device, generator)
    text, seg = prompt_tokens(raw, tcfg, int(train.get("batch_size", 4)))
    imgs = sample_images(
        transformer, vq, torch.from_numpy(text).to(device),
        torch.from_numpy(seg).to(device), generator,
        guidance_scale=raw.get("guidance_scale", 3.0),
        temperature=raw.get("temperature", 1.0), top_k=raw.get("top_k", 0))
    out = raw.get("output", "samples.jpg")
    save_image(make_grid(np.clip(imgs.cpu().numpy(), 0, 1)), out)
    return out


def data_iter(data_cfg: Dict[str, Any], batch_size: int,
              model_cfg: VQModelConfig):
    """The host batch iterator of the config's ``data`` section for VQ-SEG
    training, as ``mas_tpu/cli.py::_data_iter``; the port has the
    synthetic kind."""
    from .data.dataset import SyntheticSegBatches

    kind = data_cfg.get("kind", "synthetic")
    if kind != "synthetic":
        raise NotImplementedError(
            f"data kind {kind!r} is not ported to mas_tpu_torch "
            "(ROADMAP A13); only 'synthetic' is")
    res = data_cfg.get("resolution", model_cfg.resolution)
    return iter(SyntheticSegBatches(batch_size, res, data_cfg.get("seed", 0)))


def run_pretrain_segmentation(raw: Dict[str, Any], train_raw: Dict[str, Any],
                              device):
    from .train.loop import run_pretrain_segmentation as run

    train_cfg = TrainConfig.from_dict(train_raw)
    model_cfg = VQModelConfig.from_dict(raw["model"])
    loss_cfg = SegLossConfig.from_dict(raw.get("loss", {}))
    batches = data_iter(raw.get("data", {}), train_cfg.batch_size, model_cfg)
    return run(train_cfg, model_cfg, batches, loss_cfg, device)


def main(argv=None) -> int:
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
    train = dict(raw.get("train", {}))
    mode = args.mode or train.get("mode", "pretrain_segmentation")
    device = torch.device(args.device)
    if mode == "pretrain_segmentation":
        train["mode"] = mode
        state = run_pretrain_segmentation(raw, train, device)
        print(f"trained to step {state.step}")
        return 0
    if mode != "sample":
        raise NotImplementedError(
            f"mode {mode!r} is not ported to mas_tpu_torch yet (ROADMAP "
            "A9-A11); only 'sample' and 'pretrain_segmentation' are")
    unknown = set(train) - _SAMPLE_TRAIN_KEYS
    if unknown:
        raise ConfigError(f"train keys {sorted(unknown)} configure training, "
                          "which mas_tpu_torch does not port yet")
    print(run_sample(raw, device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
