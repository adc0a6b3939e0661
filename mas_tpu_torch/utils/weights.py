"""Weight bridge: JAX parameter trees and reference ``.pt`` files -> the
port's ``state_dict``.

The port's modules use the reference ``state_dict`` keys, which are what
``mas_tpu/utils/torch_export.py`` writes, so both sources land in one
layout:

  * ``transformer_from_flax`` / ``vq_from_flax`` take the flax variables as
    nested dicts of numpy arrays (``jax.tree.map(np.asarray, ...)``) and
    apply the exporter's transforms: conv kernels HWIO -> OIHW, linear
    kernels [in, out] -> [out, in], flax ``scale`` -> ``weight``;
  * ``load_reference_pt`` reads a ``.pt`` written by the JAX package's
    ``--mode export`` (or a reference checkpoint).

The encoder's and decoder's ``nn.Sequential`` indices are replayed from
the config (``models/vqvae.py::encoder_layout``/``decoder_layout``), the
same replay as ``mas_tpu/utils/torch_import.py``.  The BN on
``quant_conv`` takes its running statistics from the ``batch_stats``
collection; ``num_batches_tracked`` is written as 0, as the exporter does.
The reference transformer's derived ``transformer.mask`` buffer (the port
builds the mask from indices) is set aside by ``serving_state``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..models.codebook import Codebook, codebook_init_embedding
from ..models.vqvae import decoder_layout, encoder_layout
from .config import TransformerConfig, VQModelConfig

State = Dict[str, torch.Tensor]

DERIVED_TRANSFORMER_KEYS = ("transformer.mask",)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _conv(out: State, prefix: str, p: Mapping[str, Any]) -> None:
    out[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        out[f"{prefix}.bias"] = _t(p["bias"])


def _norm(out: State, prefix: str, p: Mapping[str, Any]) -> None:
    out[f"{prefix}.weight"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])


def _linear(out: State, prefix: str, p: Mapping[str, Any]) -> None:
    out[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).transpose(1, 0))
    out[f"{prefix}.bias"] = _t(p["bias"])


def _resnet(out: State, prefix: str, p: Mapping[str, Any]) -> None:
    _norm(out, f"{prefix}.norm1", p["norm1"])
    _conv(out, f"{prefix}.conv1", p["conv1"])
    _norm(out, f"{prefix}.norm2", p["norm2"])
    _conv(out, f"{prefix}.conv2", p["conv2"])
    if "nin_shortcut" in p:
        _conv(out, f"{prefix}.nin_shortcut", p["nin_shortcut"])


def _attn(out: State, prefix: str, p: Mapping[str, Any]) -> None:
    _norm(out, f"{prefix}.norm", p["norm"])
    for name in ("q", "k", "v", "proj_out"):
        _conv(out, f"{prefix}.{name}", p[name])


def _sequential(out: State, torch_prefix: str, plan,
                params: Mapping[str, Any]) -> None:
    for idx, (kind, name) in enumerate(plan):
        prefix = f"{torch_prefix}.{idx}"
        if kind == "conv":
            _conv(out, prefix, params[name])
        elif kind == "resnet":
            _resnet(out, prefix, params[name])
        elif kind == "attn":
            _attn(out, prefix, params[name])
        elif kind in ("down", "up"):
            _conv(out, f"{prefix}.conv", params[name]["conv"])
        elif kind == "norm":
            _norm(out, prefix, params[name])


def vq_from_flax(variables: Mapping[str, Any], cfg: VQModelConfig) -> State:
    """flax VQModel variables (numpy; ``params`` and ``batch_stats``) ->
    the ``state_dict`` of ``models.vqvae.VQModel``."""
    params = variables["params"]
    stats = variables["batch_stats"]["quant_bn"]
    out: State = {}
    _sequential(out, "encoder.model", encoder_layout(cfg), params["encoder"])
    _sequential(out, "decoder.model", decoder_layout(cfg), params["decoder"])
    _conv(out, "quant_conv.0", params["quant_conv"])
    _norm(out, "quant_conv.1", params["quant_bn"])
    out["quant_conv.1.running_mean"] = _t(stats["mean"])
    out["quant_conv.1.running_var"] = _t(stats["var"])
    out["quant_conv.1.num_batches_tracked"] = torch.zeros((),
                                                          dtype=torch.long)
    _conv(out, "post_quant_conv", params["post_quant_conv"])
    out["quantize.embedding.weight"] = _t(params["codebook_embedding"])
    return out


def transformer_from_flax(params: Mapping[str, Any],
                          cfg: TransformerConfig) -> State:
    """flax MakeAScene params (numpy, unrolled ``layer_{i}`` form) -> the
    ``state_dict`` of ``models.transformer.MakeAScene``."""
    p = params["params"] if "params" in params else params
    if "layer_0" not in p:
        raise ValueError("expected the unrolled tree with 'layer_0'.. keys "
                         "(unstack a scan_layers tree first)")
    out: State = {}
    for name in ("image_token_embedding", "seg_token_embedding",
                 "text_token_embedding", "text_pos_embeddings",
                 "seg_row_embeddings", "seg_col_embeddings",
                 "image_row_embeddings", "image_col_embeddings"):
        out[f"{name}.weight"] = _t(p[name]["embedding"])
    for i in range(cfg.num_layers):
        layer = p[f"layer_{i}"]
        t = f"transformer.layers.{i}"
        _norm(out, f"{t}.ln_in", layer["ln_in"])
        _norm(out, f"{t}.ln_out", layer["ln_out"])
        _linear(out, f"{t}.attn.qkv", layer["attn"]["qkv"])
        _linear(out, f"{t}.attn.out_proj", layer["attn"]["out_proj"])
        _linear(out, f"{t}.mlp.lin1", layer["mlp"]["lin1"])
        _linear(out, f"{t}.mlp.lin2", layer["mlp"]["lin2"])
        if "first_ln_sandwich" in layer:
            _norm(out, f"{t}.first_ln_sandwich", layer["first_ln_sandwich"])
            _norm(out, f"{t}.second_ln_sandwich",
                  layer["second_ln_sandwich"])
    _norm(out, "transformer.final_ln", p["final_ln"])
    _norm(out, "to_logits.0", p["logits_ln"])
    _linear(out, "to_logits.1", p["logits_dense"])
    return out


def load_reference_pt(path: str) -> State:
    """Read a reference-layout ``.pt`` state_dict (as ``--mode export`` of
    the JAX package writes it).  An orbax checkpoint directory cannot be
    read without jax and raises."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (an orbax checkpoint?); reading it needs "
            "jax.  Convert it first with the JAX package: "
            "python -m mas_tpu.cli --mode export (see configs/export_vq.json)")
    state = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("model", "state_dict"):
        if isinstance(state, dict) and isinstance(state.get(key), dict):
            state = state[key]
            break
    return state


def serving_state(state: Mapping[str, torch.Tensor], kind: str) -> State:
    """The keys a port model loads: every key of a VQ checkpoint
    (``kind='vq'``); all but the derived mask buffer of a transformer one
    (``kind='transformer'``)."""
    if kind == "vq":
        return dict(state)
    if kind == "transformer":
        return {k: v for k, v in state.items()
                if k not in DERIVED_TRANSFORMER_KEYS}
    raise ValueError(f"kind must be 'vq' or 'transformer', got {kind!r}")


def init_random_(module: torch.nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights for serving without a checkpoint, with the JAX
    package's initializer families (not its values): linear and embedding
    weights N(0, 0.02), conv kernels lecun-normal N(0, 1/fan_in), the
    codebook U(-1/K, 1/K), zero biases; norms keep ones/zeros."""
    init = torch.nn.init
    codebooks = {id(m.embedding) for m in module.modules()
                 if isinstance(m, Codebook)}
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.Embedding) and id(m) in codebooks:
                m.weight.copy_(codebook_init_embedding(
                    m.num_embeddings, m.embedding_dim, generator,
                    m.weight.device))
            elif isinstance(m, torch.nn.Embedding):
                init.normal_(m.weight, 0.0, 0.02, generator=generator)
            elif isinstance(m, torch.nn.Linear):
                init.normal_(m.weight, 0.0, 0.02, generator=generator)
                init.zeros_(m.bias)
            elif isinstance(m, torch.nn.Conv2d):
                fan_in = m.weight[0].numel()
                init.normal_(m.weight, 0.0, fan_in ** -0.5,
                             generator=generator)
                init.zeros_(m.bias)
