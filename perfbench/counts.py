"""Operations, bytes, bounds and peaks: the yardstick's arithmetic.

Peaks: one NVIDIA H100 SXM, dense rates, as NVIDIA's data sheet gives
them at 700 W: 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s fp32
outside them, 3.35 TB/s of HBM.

A kernel's bound is the larger of its operations over the peak for its
type and its bytes over the bandwidth, each input byte read once and
each output byte written once.  The B1, B2 and B6 bounds are copied from
``PERF.md`` section 6's kernel table (PR 16's tree): B2 at q [128, 16, 1,
64] bf16 over an int4 cache, index 511 -> 0.0227 ms; B1 at [8, 16, 1408,
64] bf16, prefix 384 -> 0.0353 ms; B6 -> 0.0883 ms.

Model operations count a linear as 2 x rows x weights, attention over
the positions each row attends (QK^T and PV: 4 d per pair and head), a
convolution as 2 Cin Cout k^2 Hout Wout; training is three forwards.
"""

from __future__ import annotations

from .reference import vqvae
from .reference.transformer import Geometry

BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
HBM_BYTES_S = 3.35e12


def bound_s(flops: float, nbytes: float, peak: float = BF16_FLOPS) -> float:
    return max(flops / peak, nbytes / HBM_BYTES_S)


def attended_pairs(t: int, prefix: int) -> int:
    """(query, key) pairs of a bidirectional prefix and causal rest."""
    rest = t * (t + 1) // 2 - prefix * (prefix + 1) // 2
    return prefix * prefix + rest


def b1_bound_s(b: int, h: int, t: int, d: int, prefix: int) -> float:
    """Flash attention forward, bf16: QK^T and PV over attended pairs;
    q, k, v, out in bf16 and the fp32 log-sum-exp."""
    flops = 4.0 * b * h * d * attended_pairs(t, prefix)
    nbytes = 4 * b * h * t * d * 2 + b * h * t * 4
    return bound_s(flops, nbytes)


def b6_bound_s(b: int, h: int, t: int, d: int, prefix: int) -> float:
    """Flash attention backward, bf16: S again, dV, dP, dQ, dK (10 d a
    pair and head); reads q, k, v, out, dout, lse, writes dq, dk, dv."""
    flops = 10.0 * b * h * d * attended_pairs(t, prefix)
    nbytes = 8 * b * h * t * d * 2 + b * h * t * 4
    return bound_s(flops, nbytes)


def b2_bound_s(rows: int, heads: int, d: int, index: int,
               bits: int = 4) -> float:
    """Decode read of a quantized cache: q and out bf16, k and v values
    (``bits`` a value) and their fp32 scales at positions <= index."""
    positions = index + 1
    per_position = 2 * (d * bits // 8 + 4)
    nbytes = rows * heads * (positions * per_position + 2 * d * 2)
    flops = 4.0 * rows * heads * d * positions
    return bound_s(flops, nbytes)


def _layer_weights(g: Geometry) -> int:
    d = g.hidden
    return 3 * d * d + d * d + 2 * 4 * d * d


def forward_flops(g: Geometry, rows: int, t: int, logit_rows: int) -> float:
    """One full-sequence forward of ``rows`` sequences of ``t`` tokens,
    logits at ``logit_rows`` positions of each."""
    linear = 2.0 * rows * t * g.layers * _layer_weights(g)
    attn = 4.0 * rows * g.layers * g.hidden * attended_pairs(t, min(
        t, g.prefix))
    head = 2.0 * rows * logit_rows * g.hidden * g.image_vocab
    return linear + attn + head


def decode_flops(g: Geometry, rows: int, steps: int) -> float:
    """``steps`` decode steps of ``rows`` rows from the prefix on: step s
    attends over prefix + s + 1 positions."""
    linear = 2.0 * rows * steps * (g.layers * _layer_weights(g)
                                   + g.hidden * g.image_vocab)
    positions = steps * (g.prefix + 1) + steps * (steps - 1) // 2
    attn = 4.0 * rows * g.layers * g.hidden * positions
    return linear + attn


def vq_decode_flops(m: dict, images: int) -> float:
    """``decode_code`` of ``images``: every convolution, and the attention
    blocks' two products."""
    total = 2.0 * m["embed_dim"] * m["z_channels"] * (
        m["resolution"] // 2 ** (len(m["channels"]) - 2)) ** 2
    for L in vqvae.plan(m):
        hw = L.res * L.res
        if L.kind == "conv":
            total += 2.0 * L.cin * L.cout * 9 * hw
        elif L.kind == "resnet":
            total += 2.0 * (L.cin * L.cout + L.cout * L.cout) * 9 * hw
            if L.cin != L.cout:
                total += 2.0 * L.cin * L.cout * hw
        elif L.kind == "attn":
            total += 4 * 2.0 * L.cin * L.cin * hw + 2 * 2.0 * hw * hw * L.cin
        elif L.kind == "up":
            total += 2.0 * L.cin * L.cin * 9 * (4 * hw)
    return total * images


def serve_batch_flops(g: Geometry, m: dict, prompts: int,
                      guidance: bool = True) -> float:
    """One ``sample_images`` batch: prefill, the decode loop, the VQ
    decode of every image."""
    rows = prompts * (2 if guidance else 1)
    return (forward_flops(g, rows, g.prefix, 1)
            + decode_flops(g, rows, g.image_length - 1)
            + vq_decode_flops(m, prompts))


def train_step_flops(g: Geometry, batch: int) -> float:
    """Three forwards of the batch (remat's recompute not counted)."""
    t = g.prefix + g.image_length
    return 3.0 * forward_flops(g, batch, t, g.image_length)
