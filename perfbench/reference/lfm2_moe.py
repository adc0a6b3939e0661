"""Plain reference of LFM2-MoE's hybrid block as the Make-A-Scene stage-2
transformer, fp32, for the checks that decide ``correct`` and for the
port's CPU tests.

The block (LiquidAI/LFM2-8B-A1B, ``config.json``, ``model_type``
``lfm2_moe``), written from its layer equations with nothing imported from
the program; the token interface is Make-A-Scene's (``transformer.py``'s
``embed``: text, seg and image embeddings with learned positions, the text
pad remap) and the head a Linear over the image codes.  Each layer, on x
[B, T, D]:

  * h = RMSNorm(x) = x / sqrt(mean(x^2) + eps) * w;
  * conv: [B | C | u] = h W_in; v = B * u; c_t = sum_{j=0..K-1} k_j v_{t -
    K + 1 + j} (depthwise, causal, v before the sequence 0, no bias);
    y = (C * c) W_out;
  * attention: q = h W_q, k = h W_k, v = h W_v; q and k RMSNormed over
    each head's d dims; rotate-half RoPE at theta and the sequence index;
    query head h reads kv head h // (H / KV), scale 1 / sqrt(d), masked
    bidirectionally over the prefix and causally after it; y = ctx W_o;
  * x += y; g = RMSNorm(x); dense layers: W2 (silu(g W1) * g W3); MoE
    layers: s = sigmoid(g W_r); the top-k of s + expert_bias chosen;
    weights s_e / (sum of the chosen s + 1e-6) (``norm_topk_prob``) times
    the routed scaling factor; the sum of the chosen experts' SwiGLU
    outputs, weighted.  Every expert is computed for every token (a dense
    loop) and weighted by zero where it is not chosen;
  * after the last layer RMSNorm, then the Linear head (with its bias).

Departures from LFM2-8B-A1B: the token interface and head above replace
its 65,536-word vocabulary, tied embedding and its ``embedding_norm`` is
here ``transformer.final_ln``; the sequence is [text 128 | seg 256 |
image 256] under Make-A-Scene's mask, not causal throughout.  Serving,
``serve_logits`` runs whole sequences teacher-forced; the configuration
states an int4 cache, so at image positions the attention layers attend
over keys and values quantized as such a cache holds them (k after its
norm and RoPE; one fp32 scale a position and kv head, ``max |x| / 7``,
round half to even), the prefix over exact ones, as its prefill does.
Every matrix product goes through ``precision``'s rounding: exact for the
reference, fp8 for its control.  The caller sets TF32 off
(``precision.fp32_only``).

Routing: two fp32 computations of the same layer can choose different
experts where two biased scores lie within their rounding of each other,
and one choice moves a position's logits as a fault would.  So ``hidden``
and ``serve_logits`` take the experts another router chose (``routes``)
and compute the rest exactly with them, and report each choice's
deficit: by how much the least biased score of the chosen falls short of
the reference's own k-th largest.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch
from torch.nn import functional as F

from .precision import Rounding, exact
from .transformer import _mask, embed, int4_cache_values

Params = Dict[str, torch.Tensor]
Spec = List[Tuple[str, Tuple[int, ...], float, float, str]]


@dataclass(frozen=True)
class Geometry:
    layer_types: Tuple[str, ...]
    hidden: int
    heads: int
    kv_heads: int
    dense_width: int
    expert_width: int
    experts: int
    top_k: int
    dense_layers: int
    use_expert_bias: bool
    norm_topk_prob: bool
    routed_scale: float
    conv_taps: int
    rope_theta: float
    eps: float
    image_vocab: int
    seg_vocab: int
    text_vocab: int
    image_side: int
    seg_side: int
    text_length: int

    @classmethod
    def of(cls, t: dict, b: dict) -> "Geometry":
        """From a configuration's ``transformer`` and ``block`` sections."""
        if t.get("kv_cache_layout", "lane") != "lane" or t.get(
                "kv_scale_dtype", "float32") != "float32":
            raise ValueError("the reference models a lane cache with fp32 "
                             "scales")
        return cls(tuple(b["layer_types"]), t["hidden_dim"],
                   t["num_attn_heads"], t.get("num_kv_heads") or
                   t["num_attn_heads"], b["intermediate_size"],
                   b["moe_intermediate_size"], b["num_experts"],
                   b["num_experts_per_tok"], b["num_dense_layers"],
                   b.get("use_expert_bias", True),
                   b.get("norm_topk_prob", True),
                   float(b.get("routed_scaling_factor", 1.0)),
                   b.get("conv_L_cache", 3), float(b.get("rope_theta", 1e6)),
                   float(b.get("norm_eps", 1e-5)), t["image_vocab_size"],
                   t["seg_vocab_size"], t["text_vocab_size"],
                   t["image_tokens_per_dim"], t["seg_tokens_per_dim"],
                   t["text_length"])

    @property
    def layers(self) -> int:
        return len(self.layer_types)

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def prefix(self) -> int:
        return self.text_length + self.seg_side ** 2

    @property
    def image_length(self) -> int:
        return self.image_side ** 2

    @property
    def moe_layers(self) -> Tuple[int, ...]:
        return tuple(range(self.dense_layers, self.layers))


def param_spec(g: Geometry) -> Spec:
    """(name, shape, mean, std, role): role "dense" is a product's or
    embedding's tensor (served in the compute dtype), "fp32" a norm's, the
    router's or the expert bias.  Linears and embeddings N(0, 0.02), norms
    N(1, 0.1), the conv N(0, 1 / fan_in) at fan_in K, the expert bias N(0,
    0.02)."""
    d, hd = g.hidden, g.head_dim
    spec: Spec = []

    def dense(name, *shape, std=0.02):
        spec.append((name, shape, 0.0, std, "dense"))

    def norm(name, n=d):
        spec.append((f"{name}.weight", (n,), 1.0, 0.1, "fp32"))

    for name, rows in (("image_token_embedding", g.image_vocab),
                       ("seg_token_embedding", g.seg_vocab),
                       ("text_token_embedding", g.text_vocab),
                       ("text_pos_embeddings", g.text_length),
                       ("seg_row_embeddings", g.seg_side),
                       ("seg_col_embeddings", g.seg_side),
                       ("image_row_embeddings", g.image_side),
                       ("image_col_embeddings", g.image_side)):
        dense(f"{name}.weight", rows, d)
    for i, kind in enumerate(g.layer_types):
        p = f"transformer.layers.{i}."
        norm(p + "operator_norm")
        if kind == "conv":
            dense(p + "conv.in_proj.weight", 3 * d, d)
            dense(p + "conv.conv.weight", d, 1, g.conv_taps,
                  std=1.0 / math.sqrt(g.conv_taps))
            dense(p + "conv.out_proj.weight", d, d)
        else:
            a = p + "self_attn."
            dense(a + "q_proj.weight", g.heads * hd, d)
            dense(a + "k_proj.weight", g.kv_heads * hd, d)
            dense(a + "v_proj.weight", g.kv_heads * hd, d)
            dense(a + "out_proj.weight", d, g.heads * hd)
            norm(a + "q_layernorm", hd)
            norm(a + "k_layernorm", hd)
        norm(p + "ffn_norm")
        f = p + "feed_forward."
        if i < g.dense_layers:
            dense(f + "w1.weight", g.dense_width, d)
            dense(f + "w3.weight", g.dense_width, d)
            dense(f + "w2.weight", d, g.dense_width)
        else:
            spec.append((f + "gate", (g.experts, d), 0.0, 0.02, "fp32"))
            spec.append((f + "expert_bias", (g.experts,), 0.0, 0.02, "fp32"))
            dense(f + "experts.w1", g.experts, g.expert_width, d)
            dense(f + "experts.w3", g.experts, g.expert_width, d)
            dense(f + "experts.w2", g.experts, d, g.expert_width)
    norm("transformer.final_ln")
    dense("to_logits.weight", g.image_vocab, d)
    dense("to_logits.bias", g.image_vocab)
    return spec


def rms_norm(x, w, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _mm(x, w, r: Rounding):
    """x [..., n] times w [m, n] transposed."""
    return r(x) @ r(w).t()


def _rope(x, theta: float):
    """x [B, H, T, d] at positions 0 .. T - 1, rotate-half."""
    t, d = x.shape[-2], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                       device=x.device) / d)
    ang = torch.arange(t, dtype=torch.float64, device=x.device)[:, None] * inv
    ang = torch.cat([ang, ang], dim=-1)
    cos, sin = ang.cos().float(), ang.sin().float()
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + rot * sin


def _conv(P, p, h, g: Geometry, r: Rounding):
    d = g.hidden
    bx, cx, ux = _mm(h, P[p + "conv.in_proj.weight"], r).split(d, dim=-1)
    v = bx * ux
    k = P[p + "conv.conv.weight"][:, 0]                        # [D, K]
    taps = k.shape[1]
    padded = F.pad(v, (0, 0, taps - 1, 0))
    c = sum(k[:, j] * padded[:, j:j + v.shape[1]] for j in range(taps))
    return _mm(cx * c, P[p + "conv.out_proj.weight"], r)


def _attend(q, k, v, mask, r: Rounding):
    s = (r(q) @ r(k).transpose(-1, -2)) / math.sqrt(q.shape[-1])
    p = torch.softmax(s.masked_fill(~mask, -1e30), dim=-1)
    return r(p) @ r(v)


def _attention(P, p, h, g: Geometry, int4_cache: bool, r: Rounding):
    b, t, _ = h.shape
    hd, a = g.head_dim, p + "self_attn."

    def heads(name, n):
        z = _mm(h, P[a + name + "_proj.weight"], r)
        return z.view(b, t, n, hd).transpose(1, 2)

    q = _rope(rms_norm(heads("q", g.heads), P[a + "q_layernorm.weight"],
                       g.eps), g.rope_theta)
    k = _rope(rms_norm(heads("k", g.kv_heads), P[a + "k_layernorm.weight"],
                       g.eps), g.rope_theta)
    v = heads("v", g.kv_heads)
    rep = g.heads // g.kv_heads
    k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    mask = _mask(g, t, h.device)
    ctx = _attend(q, k, v, mask, r)
    if int4_cache and t > g.prefix:
        rows = _attend(q[:, :, g.prefix:], int4_cache_values(k),
                       int4_cache_values(v), mask[g.prefix:], r)
        ctx = torch.cat([ctx[:, :, :g.prefix], rows], dim=2)
    return _mm(ctx.transpose(1, 2).reshape(b, t, -1),
               P[a + "out_proj.weight"], r)


def route(P, f, gx, g: Geometry, chosen=None):
    """(chosen experts [..., k], their weights [..., k], the deficit [...])
    of the normed g.  ``chosen``: the experts another router chose, taken
    as they are; the deficit is by how much the least biased score among
    them falls short of the k-th largest (0 where they are the top k, or
    tie with it).  Without ``chosen`` the top k of the biased scores."""
    s = torch.sigmoid(gx @ P[f + "gate"].t())
    biased = s + P[f + "expert_bias"] if g.use_expert_bias else s
    kth = torch.topk(biased, g.top_k, dim=-1).values[..., -1]
    idx = (torch.topk(biased, g.top_k, dim=-1).indices if chosen is None
           else chosen.to(device=gx.device, dtype=torch.long))
    deficit = (kth - biased.gather(-1, idx).amin(-1)).clamp_min(0.0)
    w = s.gather(-1, idx)
    if g.norm_topk_prob:
        w = w / (w.sum(-1, keepdim=True) + 1e-6)
    return idx, w * g.routed_scale, deficit


def _moe(P, f, gx, g: Geometry, r: Rounding, chosen=None):
    idx, w, deficit = route(P, f, gx, g, chosen)
    dense_w = torch.zeros(*gx.shape[:-1], g.experts, device=gx.device)
    dense_w.scatter_(-1, idx, w)
    out = torch.zeros_like(gx)
    for e in range(g.experts):
        h = F.silu(_mm(gx, P[f + "experts.w1"][e], r)) * _mm(
            gx, P[f + "experts.w3"][e], r)
        out = out + dense_w[..., e:e + 1] * _mm(h, P[f + "experts.w2"][e], r)
    return out, idx, deficit


def hidden(P: Params, g: Geometry, text, seg, img, int4_cache: bool = False,
           r: Rounding = exact, routes=None):
    """(the final hidden states [B, T, D] after the final RMSNorm, the
    experts chosen [B, T, MoE layers, k], the routing deficits [B, T, MoE
    layers]) of [text | seg | img].  ``routes`` [B, T, MoE layers, k]:
    the experts to take at each position and MoE layer (another router's
    choices), else the reference's own."""
    x = embed(P, g, text, seg, img)
    chosen, deficits = [], []
    for i, kind in enumerate(g.layer_types):
        p = f"transformer.layers.{i}."
        h = rms_norm(x, P[p + "operator_norm.weight"], g.eps)
        x = x + (_conv(P, p, h, g, r) if kind == "conv"
                 else _attention(P, p, h, g, int4_cache, r))
        gx = rms_norm(x, P[p + "ffn_norm.weight"], g.eps)
        f = p + "feed_forward."
        if i < g.dense_layers:
            x = x + _mm(F.silu(_mm(gx, P[f + "w1.weight"], r))
                        * _mm(gx, P[f + "w3.weight"], r),
                        P[f + "w2.weight"], r)
        else:
            j = len(chosen)
            y, idx, deficit = _moe(P, f, gx, g, r, None if routes is None
                                   else routes[:, :, j])
            x = x + y
            chosen.append(idx)
            deficits.append(deficit)
    h = rms_norm(x, P["transformer.final_ln.weight"], g.eps)
    if not chosen:
        return h, None, None
    return h, torch.stack(chosen, dim=2), torch.stack(deficits, dim=-1)


def logits(P: Params, g: Geometry, h, r: Rounding = exact):
    return _mm(h, P["to_logits.weight"], r) + P["to_logits.bias"]


def serve_logits(P: Params, g: Geometry, text, seg, tokens, guidance: float,
                 r: Rounding = exact, routes=None):
    """(guided logits [B, n, vocab] that chose ``tokens`` [B, n], the cond
    and uncond halves' experts chosen [2, B, T, MoE layers, k], their
    routing deficits [2, B, T, MoE layers]): position i's logits, from the
    prefix and tokens[:, :i], chose tokens[:, i].  The unconditional half
    takes all-pad text; the int4 cache is modelled.  ``routes`` [2, B, T,
    MoE layers, k]: the halves' experts as another router chose them at
    each sequence position (T = prefix + n - 1)."""
    img = tokens[:, :-1]
    n = tokens.shape[1]
    out, chosen, deficits = [], [], []
    for half, t_in in enumerate((text, torch.zeros_like(text))):
        h, idx, deficit = hidden(P, g, t_in, seg, img, int4_cache=True, r=r,
                                 routes=None if routes is None
                                 else routes[half])
        out.append(logits(P, g, h[:, g.prefix - 1:g.prefix - 1 + n], r))
        chosen.append(idx)
        deficits.append(deficit)
    cond, uncond = out
    return (uncond + guidance * (cond - uncond), torch.stack(chosen),
            torch.stack(deficits))
