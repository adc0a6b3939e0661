"""Plain reference of the VQ-IMG decoder path (``decode_code``: codebook
lookup, ``post_quant_conv``, the decoder), fp32 NCHW, for the checks that
decide ``correct``.

Written from the reference's VQBASE decoder (CasualGANPapers/Make-A-Scene,
taming-transformers' layout): conv3x3 -> ResnetBlock, AttnBlock,
ResnetBlock -> per stage from the widest, num_res_blocks + 1 ResnetBlocks
(an AttnBlock after each at the attention resolutions) and a nearest 2x
Upsample with its conv3x3 -> GroupNorm(32, eps 1e-6), swish -> conv3x3.
A ResnetBlock is GN-swish-conv3x3 twice, with a 1x1 shortcut where the
width changes.  Parameters carry the reference ``state_dict`` keys
(``decoder.model.{i}.*``, ``post_quant_conv.*``,
``quantize.embedding.weight``); nothing is imported from the program.

``plan`` lists the decoder's layers with their shapes; ``counts`` walks
the same list to count the decoder's operations.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch
from torch.nn import functional as F

from .precision import Rounding, exact

Params = Dict[str, torch.Tensor]
GN_GROUPS, GN_EPS = 32, 1e-6


@dataclass(frozen=True)
class Layer:
    kind: str        # conv, resnet, attn, up, norm, skip
    index: int       # position in the decoder's Sequential
    cin: int
    cout: int
    res: int         # side of its input


def plan(m: dict) -> List[Layer]:
    """The decoder's layers, in order, for the config's ``model`` section."""
    ch_mult = m["channels"][1:]
    n = len(ch_mult)
    res = m["resolution"] // 2 ** (n - 1)
    block_in = ch_mult[-1]
    kinds: List[Tuple[str, int, int, int]] = [
        ("conv", m["z_channels"], block_in, res),
        ("resnet", block_in, block_in, res), ("attn", block_in, block_in, res),
        ("resnet", block_in, block_in, res)]
    for i in reversed(range(n)):
        for _ in range(m["num_res_blocks"] + 1):
            kinds.append(("resnet", block_in, ch_mult[i], res))
            block_in = ch_mult[i]
            if res in m["attn_resolutions"]:
                kinds.append(("attn", block_in, block_in, res))
        if i > 0:
            kinds.append(("up", block_in, block_in, res))
            res *= 2
    kinds += [("norm", block_in, block_in, res), ("skip", block_in, block_in,
                                                  res),
              ("conv", block_in, m["out_channels"], res)]
    return [Layer(k, i, cin, cout, r) for i, (k, cin, cout, r)
            in enumerate(kinds)]


# (name, shape, mean, std, role): role "conv" is a convolution's tensor
# (served in the compute dtype), "fp32" a norm's or the codebook's
Spec = List[Tuple[str, Tuple[int, ...], float, float, str]]


def param_spec(m: dict) -> Spec:
    spec: Spec = []

    def conv(name, cin, cout, k):
        spec.append((f"{name}.weight", (cout, cin, k, k), 0.0,
                     1.0 / math.sqrt(cin * k * k), "conv"))
        spec.append((f"{name}.bias", (cout,), 0.0, 0.02, "conv"))

    def norm(name, c):
        spec.append((f"{name}.weight", (c,), 1.0, 0.1, "fp32"))
        spec.append((f"{name}.bias", (c,), 0.0, 0.02, "fp32"))

    cb = m["codebook"]
    spec.append(("quantize.embedding.weight",
                 (cb["codebook_size"], cb["codebook_dim"]), 0.0, 1.0, "fp32"))
    conv("post_quant_conv", m["embed_dim"], m["z_channels"], 1)
    for L in plan(m):
        p = f"decoder.model.{L.index}"
        if L.kind == "conv":
            conv(p, L.cin, L.cout, 3)
        elif L.kind == "resnet":
            norm(f"{p}.norm1", L.cin)
            conv(f"{p}.conv1", L.cin, L.cout, 3)
            norm(f"{p}.norm2", L.cout)
            conv(f"{p}.conv2", L.cout, L.cout, 3)
            if L.cin != L.cout:
                conv(f"{p}.nin_shortcut", L.cin, L.cout, 1)
        elif L.kind == "attn":
            norm(f"{p}.norm", L.cin)
            for part in ("q", "k", "v", "proj_out"):
                conv(f"{p}.{part}", L.cin, L.cin, 1)
        elif L.kind == "up":
            conv(f"{p}.conv", L.cin, L.cin, 3)
        elif L.kind == "norm":
            norm(p, L.cin)
    return spec


def _conv(x, P, name, r: Rounding):
    w = P[f"{name}.weight"]
    return F.conv2d(r(x), r(w), P[f"{name}.bias"], padding=w.shape[-1] // 2)


def _gn(x, P, name):
    return F.group_norm(x, GN_GROUPS, P[f"{name}.weight"], P[f"{name}.bias"],
                        GN_EPS)


def _swish(x):
    return x * torch.sigmoid(x)


def _resnet(x, P, p, L: Layer, r):
    h = _conv(_swish(_gn(x, P, f"{p}.norm1")), P, f"{p}.conv1", r)
    h = _conv(_swish(_gn(h, P, f"{p}.norm2")), P, f"{p}.conv2", r)
    if L.cin != L.cout:
        x = _conv(x, P, f"{p}.nin_shortcut", r)
    return x + h


def _attn(x, P, p, r):
    b, c, hh, ww = x.shape
    hn = _gn(x, P, f"{p}.norm")
    seq = lambda t: t.reshape(b, c, hh * ww).transpose(1, 2)
    q, k, v = (seq(_conv(hn, P, f"{p}.{n}", r)) for n in "qkv")
    att = torch.softmax((r(q) @ r(k).transpose(1, 2)) * c ** -0.5, dim=-1)
    out = (r(att) @ r(v)).transpose(1, 2).reshape(b, c, hh, ww)
    return x + _conv(out, P, f"{p}.proj_out", r)


def decode_code(P: Params, m: dict, indices: torch.Tensor,
                r: Rounding = exact) -> torch.Tensor:
    """Token indices [B, h, w] -> NHWC fp32 images."""
    z = P["quantize.embedding.weight"][indices.long()].permute(0, 3, 1, 2)
    x = _conv(z, P, "post_quant_conv", r)
    for L in plan(m):
        p = f"decoder.model.{L.index}"
        if L.kind == "conv":
            x = _conv(x, P, p, r)
        elif L.kind == "resnet":
            x = _resnet(x, P, p, L, r)
        elif L.kind == "attn":
            x = _attn(x, P, p, r)
        elif L.kind == "up":
            x = _conv(F.interpolate(x, scale_factor=2.0, mode="nearest"), P,
                      f"{p}.conv", r)
        elif L.kind == "norm":
            x = _swish(_gn(x, P, p))
    return x.permute(0, 2, 3, 1).contiguous()
