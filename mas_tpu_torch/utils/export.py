"""A port model -> the reference-layout ``.pt`` that the JAX package's
``--mode export`` writes (``mas_tpu/utils/torch_export.py``:
``export_vqbase_state`` / ``export_transformer_state`` +
``save_torch_checkpoint``).

The port's modules already use the reference ``state_dict`` keys, so the
export is the model's ``state_dict`` in the reference's types: a flat dict
of CPU tensors, every floating tensor fp32 (a bf16 serving model's
convolutions and linears are cast back; a model built with
``fp32_params=True`` gives its weights bitwise), and the BN's
``num_batches_tracked`` an int64 zero, as the JAX exporter writes it.
Nothing else goes in: the port's transformer holds no derived
``transformer.mask`` buffer (it builds the mask from indices), and the
optimizer, codebook-reservoir and discriminator entries live in the
training checkpoint beside ``model``, not in the model.
"""

from __future__ import annotations

from typing import Dict

import torch

from .config import TransformerConfig

State = Dict[str, torch.Tensor]


def export_state(model: torch.nn.Module) -> State:
    """``model.state_dict()`` as the reference layout holds it.  A
    grouped-query transformer has none (the reference qkv is square) and
    raises, as ``mas_tpu/utils/torch_export.py::export_transformer_state``
    does."""
    cfg = getattr(model, "cfg", None)
    if (isinstance(cfg, TransformerConfig)
            and cfg.kv_heads != cfg.num_attn_heads):
        raise ValueError(
            f"GQA (kv_heads={cfg.kv_heads} < heads={cfg.num_attn_heads}) "
            "has no reference-layout equivalent (the reference qkv is "
            "square); export requires an MHA config")
    out: State = {}
    for key, value in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            out[key] = torch.zeros((), dtype=torch.int64)
        else:
            dtype = torch.float32 if value.is_floating_point() else None
            out[key] = value.detach().to("cpu", dtype, copy=True)
    return out
