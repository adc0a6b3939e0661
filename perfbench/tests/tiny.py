"""Cells at a size a CPU test run holds: the real cells' traffic and
checks over a tiny transformer and VQ decoder, with limits of their own.

The limits are set as the cells' are, from readings at this size on the
CPU over seeds 100-109 (``calibrate.readings``; largest program reading,
smallest control, half-batch or altered-token reading): ``logit_err``
0.0442, control 0.169; ``image_rel_err`` 0.0194, control 0.175;
``token_err`` 0 (a sound sampling head reads at most 1 by construction),
the runner-up token 13.5; ``loss_gap`` 1.35e-4, half batch 1.02e-3;
``grad_gap`` 2.54e-3, control 1.52e-2; ``change_gap`` 4.21e-2 (small
leaves of a tiny model), half batch 0.153."""

from __future__ import annotations

import copy

from perfbench import spec

TRANSFORMER = {
    "num_layers": 2, "hidden_dim": 128, "num_attn_heads": 2,
    "image_vocab_size": 64, "seg_vocab_size": 32, "text_vocab_size": 72,
    "image_tokens_per_dim": 4, "seg_tokens_per_dim": 4, "text_length": 8,
    "cogview_sandwich_layernorm": True, "prefix_bidirectional": True,
    "compute_dtype": "bfloat16"}
MODEL = {
    "in_channels": 3, "out_channels": 3, "channels": [32, 32, 64],
    "num_res_blocks": 1, "resolution": 8, "attn_resolutions": [4],
    "z_channels": 32, "embed_dim": 32, "compute_dtype": "bfloat16",
    "codebook": {"codebook_size": 64, "codebook_dim": 32}}


LIMITS = {"logit_err": 0.1, "image_rel_err": 0.06, "token_err": 2.0,
          "loss_gap": 4e-4, "grad_gap": 7e-3, "change_gap": 0.1}


def cell(name: str, **over) -> spec.Cell:
    """Cell ``name`` of BENCHMARK.json at the tiny size; ``over`` replaces
    traffic keys."""
    c = copy.deepcopy(spec.cell(name))
    t = dict(TRANSFORMER, **{k: v for k, v in c.config["transformer"].items()
                             if k in ("kv_cache_dtype", "remat",
                                      "remat_policy")})
    c.config["transformer"] = t
    if "model" in c.config:
        c.config["model"] = dict(MODEL)
    if "train" in c.config:
        c.config["train"]["batch_size"] = 4
    c.traffic.update(over)
    if "batch" in c.traffic:
        c.traffic["batch"] = min(c.traffic["batch"], 2)
    c.traffic["caption_tokens"] = [1, 6]
    c.check["limits"] = {k: LIMITS[k] for k in c.limits}
    for key in ("prompt_batches", "pool_batches"):
        if key in c.traffic:
            c.traffic[key] = 4
    return c
