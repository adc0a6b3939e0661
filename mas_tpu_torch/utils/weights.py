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

The decoder's ``nn.Sequential`` indices are replayed from the config
(``models/vqvae.py::decoder_layout``), the same replay as
``mas_tpu/utils/torch_import.py::_decoder_layout``.  Keys of parts this
slice does not port (the VQ encoder and ``quant_conv``, ROADMAP A7) and the
reference transformer's derived ``transformer.mask`` buffer (the port
builds the mask from indices) are set aside by ``serving_state``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..models.codebook import Codebook
from ..models.vqvae import decoder_layout
from .config import TransformerConfig, VQModelConfig

State = Dict[str, torch.Tensor]

# key prefixes of reference checkpoints that the serving slice does not use
UNPORTED_VQ_PREFIXES = ("encoder.", "quant_conv.")
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


def vq_from_flax(variables: Mapping[str, Any], cfg: VQModelConfig) -> State:
    """flax VQModel variables (numpy) -> the decode-side ``state_dict`` of
    ``models.vqvae.VQModel``."""
    params = variables["params"] if "params" in variables else variables
    dec = params["decoder"]
    out: State = {}
    for idx, (kind, name) in enumerate(decoder_layout(cfg)):
        prefix = f"decoder.model.{idx}"
        if kind == "conv":
            _conv(out, prefix, dec[name])
        elif kind == "resnet":
            _resnet(out, prefix, dec[name])
        elif kind == "attn":
            _attn(out, prefix, dec[name])
        elif kind == "up":
            _conv(out, f"{prefix}.conv", dec[name]["conv"])
        elif kind == "norm":
            _norm(out, prefix, dec[name])
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
    """Set aside the keys the serving slice does not load: encode-side VQ
    keys (``kind='vq'``) or the derived mask buffer (``kind=
    'transformer'``)."""
    if kind == "vq":
        return {k: v for k, v in state.items()
                if not k.startswith(UNPORTED_VQ_PREFIXES)}
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
                k = m.num_embeddings
                init.uniform_(m.weight, -1.0 / k, 1.0 / k,
                              generator=generator)
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
