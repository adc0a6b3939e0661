"""Plain reference of Granite 4.0-H's hybrid block as the Make-A-Scene
stage-2 transformer, fp32, for the checks that decide ``correct`` and for
the port's CPU tests.

The block (ibm-granite/granite-4.0-h-small, ``config.json``,
``model_type`` ``granitemoehybrid``), written from its layer equations
with nothing imported from the program; the token interface is
Make-A-Scene's (``transformer.py``'s ``embed``) and the head a Linear over
the image codes.  On the summed embeddings times ``embedding_multiplier``,
each layer, on x [B, T, D]:

  * h = RMSNorm(x) = x / sqrt(mean(x^2) + eps) * w;
  * Mamba2 (one group): [z | xBC | dt] = h W_in; xBC = silu(causal
    depthwise conv of K taps + bias); x [H, P], B [N], C [N] from xBC;
    Δ = softplus(dt + dt_bias), A = -exp(A_log); per position, in order,
    S_t = exp(Δ_t A) S_{t-1} + Δ_t x_t ⊗ B_t and y_t = S_t C_t + D x_t:
    the recurrence as defined, not a chunked form; y = RMSNorm(y *
    silu(z)) over the H P channels; y W_out.  The recurrence is causal
    over the prefix too;
  * attention: GQA, q = h W_q, k = h W_k, v = h W_v, no positions and no
    q/k norm (``position_embedding_type`` "nope"), scores times
    ``attention_multiplier``, masked bidirectionally over the prefix and
    causally after it; y = ctx W_o;
  * x += m y (m the ``residual_multiplier``); g = RMSNorm(x); the router's
    logits g W_r; the k largest chosen and weighted by a softmax over
    them; the sum of the chosen experts' SwiGLU outputs, weighted, plus a
    shared SwiGLU expert; x += m (routed + shared).  Every expert is
    computed for every token (a dense loop) and weighted by zero where it
    is not chosen;
  * after the last layer RMSNorm, the Linear head (with its bias), the
    logits over ``logits_scaling``.

Departures from Granite-4.0-H-Small: the token interface and head above
replace its 100,352-word tied embedding; the sequence is [text 128 | seg
256 | image 256] under Make-A-Scene's mask, not causal throughout; the
layers are the configuration's (a period of the published pattern); the
weights' names are the port's (``experts.w1``/``w3`` are the two halves of
HF's ``input_linear``, ``w2`` its ``output_linear``; the shared expert
likewise); the Mamba2 state and its products are fp32 where HF's torch
path runs the model's dtype.  Serving, ``serve_logits`` runs whole
sequences teacher-forced; the configuration states an int4 cache, so at
image positions the attention layer attends over keys and values
quantized as such a cache holds them (one fp32 scale a position and kv
head, ``max |x| / 7``, round half to even), the prefix over exact ones,
as its prefill does.  Every matrix product of a projection, an expert or
attention goes through ``precision``'s rounding: exact for the
reference, fp8 for its control; the recurrence stays fp32.  The caller
sets TF32 off (``precision.fp32_only``).  The reference runs the rows it
is given at once: its callers give it one prompt's two halves at a time.

Routing: two fp32 computations of the same layer can choose different
experts where two logits lie within their rounding of each other, and
one choice moves a position's logits as a fault would.  So ``hidden`` and
``serve_logits`` take the experts another router chose (``routes``) and
compute the rest exactly with them, and report each choice's deficit: by
how much the least logit of the chosen falls short of the reference's own
k-th largest.
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
    expert_width: int
    shared_width: int
    experts: int
    top_k: int
    ssm_heads: int
    ssm_head_dim: int
    state: int
    conv_taps: int
    attention_multiplier: float
    embedding_multiplier: float
    residual_multiplier: float
    logits_scaling: float
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
        if b.get("mamba_n_groups", 1) != 1 or b.get(
                "position_embedding_type", "nope") != "nope":
            raise ValueError("the reference is written for one group and "
                             "no positions")
        return cls(tuple(b["layer_types"]), t["hidden_dim"],
                   t["num_attn_heads"], t.get("num_kv_heads") or
                   t["num_attn_heads"], b["intermediate_size"],
                   b["shared_intermediate_size"], b["num_local_experts"],
                   b["num_experts_per_tok"], b["mamba_n_heads"],
                   b["mamba_d_head"], b["mamba_d_state"],
                   b.get("mamba_d_conv", 4),
                   float(b.get("attention_multiplier", 0.0078125)),
                   float(b.get("embedding_multiplier", 12.0)),
                   float(b.get("residual_multiplier", 0.22)),
                   float(b.get("logits_scaling", 16.0)),
                   float(b.get("rms_norm_eps", 1e-5)), t["image_vocab_size"],
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
    def inner(self) -> int:
        return self.ssm_heads * self.ssm_head_dim

    @property
    def conv_channels(self) -> int:
        return self.inner + 2 * self.state

    @property
    def prefix(self) -> int:
        return self.text_length + self.seg_side ** 2

    @property
    def image_length(self) -> int:
        return self.image_side ** 2

    @property
    def moe_layers(self) -> Tuple[int, ...]:
        return tuple(range(self.layers))


def param_spec(g: Geometry) -> Spec:
    """(name, shape, mean, std, role): role "dense" is a product's, conv's
    or embedding's tensor (served in the compute dtype), "fp32" a norm's,
    the router's or a Mamba2 head's D; "a_log" and "dt_bias" Mamba2's
    published initialisation of A_log (log U[1, 16]) and dt_bias (the
    softplus inverse of a Δ log-uniform in [0.001, 0.1]), drawn uniform
    (mean and std unused).  Linears and embeddings N(0, 0.02), norms N(1,
    0.1), the conv N(0, 1 / fan_in) at fan_in K and its bias N(0,
    1 / (3 fan_in)) (the variance of PyTorch's default U(±1 / sqrt(fan_in))),
    the router N(0, 0.02), D 1."""
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
        if kind == "mamba":
            m, ch, h = p + "mamba.", g.conv_channels, g.ssm_heads
            dense(m + "in_proj.weight", g.inner + ch + h, d)
            dense(m + "conv1d.weight", ch, 1, g.conv_taps,
                  std=1.0 / math.sqrt(g.conv_taps))
            dense(m + "conv1d.bias", ch, std=1.0 / math.sqrt(3 * g.conv_taps))
            spec.append((m + "dt_bias", (h,), 0.0, 0.0, "dt_bias"))
            spec.append((m + "A_log", (h,), 0.0, 0.0, "a_log"))
            spec.append((m + "D", (h,), 1.0, 0.0, "fp32"))
            norm(m + "norm", g.inner)
            dense(m + "out_proj.weight", d, g.inner)
        else:
            a = p + "self_attn."
            dense(a + "q_proj.weight", g.heads * hd, d)
            dense(a + "k_proj.weight", g.kv_heads * hd, d)
            dense(a + "v_proj.weight", g.kv_heads * hd, d)
            dense(a + "out_proj.weight", d, g.heads * hd)
        norm(p + "ffn_norm")
        f = p + "feed_forward."
        spec.append((f + "gate", (g.experts, d), 0.0, 0.02, "fp32"))
        dense(f + "experts.w1", g.experts, g.expert_width, d)
        dense(f + "experts.w3", g.experts, g.expert_width, d)
        dense(f + "experts.w2", g.experts, d, g.expert_width)
        dense(f + "shared.w1.weight", g.shared_width, d)
        dense(f + "shared.w3.weight", g.shared_width, d)
        dense(f + "shared.w2.weight", d, g.shared_width)
    norm("transformer.final_ln")
    dense("to_logits.weight", g.image_vocab, d)
    dense("to_logits.bias", g.image_vocab)
    return spec


def draw(shape, mean: float, std: float, role: str,
         gen: torch.Generator, device) -> torch.Tensor:
    """One tensor of ``param_spec`` from ``gen`` (fp32)."""
    if role == "a_log":
        u = torch.rand(shape, generator=gen, device=device)
        return torch.log(1.0 + 15.0 * u)
    if role == "dt_bias":
        u = torch.rand(shape, generator=gen, device=device)
        lo, hi = math.log(1e-3), math.log(1e-1)
        dt = torch.exp(u * (hi - lo) + lo).clamp_min(1e-4)
        return dt + torch.log(-torch.expm1(-dt))
    return torch.randn(shape, generator=gen, device=device) * std + mean


def rms_norm(x, w, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _mm(x, w, r: Rounding):
    """x [..., n] times w [m, n] transposed."""
    return r(x) @ r(w).t()


def _mamba(P, p, h, g: Geometry, r: Rounding):
    """(y [B, T, D], the state after the last position [B, H, P, N])."""
    b, t, _ = h.shape
    m = p + "mamba."
    z, xbc, dt = _mm(h, P[m + "in_proj.weight"], r).split(
        [g.inner, g.conv_channels, g.ssm_heads], dim=-1)
    w = P[m + "conv1d.weight"][:, 0]                           # [C, K]
    taps = w.shape[1]
    padded = F.pad(xbc, (0, 0, taps - 1, 0))
    conv = F.silu(sum(w[:, j] * padded[:, j:j + t] for j in range(taps))
                  + P[m + "conv1d.bias"])
    x, bs, cs = conv.split([g.inner, g.state, g.state], dim=-1)
    x = x.reshape(b, t, g.ssm_heads, g.ssm_head_dim)
    delta = F.softplus(dt + P[m + "dt_bias"])                  # [B, T, H]
    a = -torch.exp(P[m + "A_log"])
    d = P[m + "D"]
    s = x.new_zeros(b, g.ssm_heads, g.ssm_head_dim, g.state)
    ys = []
    for i in range(t):
        s = (torch.exp(delta[:, i] * a)[..., None, None] * s
             + (delta[:, i, :, None] * x[:, i])[..., None]
             * bs[:, i, None, None, :])
        ys.append((s * cs[:, i, None, None, :]).sum(-1)
                  + d[:, None] * x[:, i])
    y = torch.stack(ys, dim=1).reshape(b, t, g.inner)
    y = rms_norm(y * F.silu(z), P[m + "norm.weight"], g.eps)
    return _mm(y, P[m + "out_proj.weight"], r), s


def _attend(q, k, v, mask, scale: float, r: Rounding):
    s = (r(q) @ r(k).transpose(-1, -2)) * scale
    p = torch.softmax(s.masked_fill(~mask, -1e30), dim=-1)
    return r(p) @ r(v)


def _attention(P, p, h, g: Geometry, int4_cache: bool, r: Rounding):
    b, t, _ = h.shape
    hd, a = g.head_dim, p + "self_attn."

    def heads(name, n):
        z = _mm(h, P[a + name + "_proj.weight"], r)
        return z.view(b, t, n, hd).transpose(1, 2)

    q, k, v = heads("q", g.heads), heads("k", g.kv_heads), heads(
        "v", g.kv_heads)
    rep = g.heads // g.kv_heads
    k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    mask = _mask(g, t, h.device)
    ctx = _attend(q, k, v, mask, g.attention_multiplier, r)
    if int4_cache and t > g.prefix:
        rows = _attend(q[:, :, g.prefix:], int4_cache_values(k),
                       int4_cache_values(v), mask[g.prefix:],
                       g.attention_multiplier, r)
        ctx = torch.cat([ctx[:, :, :g.prefix], rows], dim=2)
    return _mm(ctx.transpose(1, 2).reshape(b, t, -1),
               P[a + "out_proj.weight"], r)


def route(P, f, gx, g: Geometry, chosen=None):
    """(chosen experts [..., k], their weights [..., k], the deficit [...])
    of the normed g.  ``chosen``: the experts another router chose, taken
    as they are and weighted by a softmax over their logits; the deficit
    is by how much the least logit among them falls short of the k-th
    largest (0 where they are the top k, or tie with it).  Without
    ``chosen`` the top k of the logits."""
    logits = gx @ P[f + "gate"].t()
    top = torch.topk(logits, g.top_k, dim=-1)
    idx = (top.indices if chosen is None
           else chosen.to(device=gx.device, dtype=torch.long))
    picked = logits.gather(-1, idx)
    deficit = (top.values[..., -1] - picked.amin(-1)).clamp_min(0.0)
    return idx, torch.softmax(picked, dim=-1), deficit


def _swiglu(x, w1, w3, w2, r: Rounding):
    return _mm(F.silu(_mm(x, w1, r)) * _mm(x, w3, r), w2, r)


def _moe(P, f, gx, g: Geometry, r: Rounding, chosen=None):
    idx, w, deficit = route(P, f, gx, g, chosen)
    dense_w = torch.zeros(*gx.shape[:-1], g.experts, device=gx.device)
    dense_w.scatter_(-1, idx, w)
    out = _swiglu(gx, P[f + "shared.w1.weight"], P[f + "shared.w3.weight"],
                  P[f + "shared.w2.weight"], r)
    for e in range(g.experts):
        out = out + dense_w[..., e:e + 1] * _swiglu(
            gx, P[f + "experts.w1"][e], P[f + "experts.w3"][e],
            P[f + "experts.w2"][e], r)
    return out, idx, deficit


def hidden(P: Params, g: Geometry, text, seg, img, int4_cache: bool = False,
           r: Rounding = exact, routes=None):
    """(the final hidden states [B, T, D] after the final RMSNorm, the
    experts chosen [B, T, layers, k], the routing deficits [B, T, layers],
    each Mamba2 layer's state after the last position [B, H, P, N]) of
    [text | seg | img].  ``routes`` [B, T, layers, k]: the experts to take
    at each position and layer (another router's choices), else the
    reference's own."""
    x = embed(P, g, text, seg, img) * g.embedding_multiplier
    m = g.residual_multiplier
    chosen, deficits, states = [], [], []
    for i, kind in enumerate(g.layer_types):
        p = f"transformer.layers.{i}."
        h = rms_norm(x, P[p + "operator_norm.weight"], g.eps)
        if kind == "mamba":
            y, s = _mamba(P, p, h, g, r)
            states.append(s)
        else:
            y = _attention(P, p, h, g, int4_cache, r)
        x = x + m * y
        gx = rms_norm(x, P[p + "ffn_norm.weight"], g.eps)
        y, idx, deficit = _moe(P, p + "feed_forward.", gx, g, r,
                               None if routes is None else routes[:, :, i])
        x = x + m * y
        chosen.append(idx)
        deficits.append(deficit)
    h = rms_norm(x, P["transformer.final_ln.weight"], g.eps)
    return (h, torch.stack(chosen, dim=2), torch.stack(deficits, dim=-1),
            states)


def logits(P: Params, g: Geometry, h, r: Rounding = exact):
    return (_mm(h, P["to_logits.weight"], r)
            + P["to_logits.bias"]) / g.logits_scaling


def serve_logits(P: Params, g: Geometry, text, seg, tokens, guidance: float,
                 r: Rounding = exact, routes=None):
    """(guided logits [B, n, vocab] that chose ``tokens`` [B, n], the cond
    and uncond halves' experts chosen [2, B, T, layers, k], their routing
    deficits [2, B, T, layers]): position i's logits, from the prefix and
    tokens[:, :i], chose tokens[:, i].  The unconditional half takes
    all-pad text; the int4 cache is modelled.  ``routes`` [2, B, T,
    layers, k]: the halves' experts as another router chose them at each
    sequence position (T = prefix + n - 1)."""
    img = tokens[:, :-1]
    n = tokens.shape[1]
    out, chosen, deficits = [], [], []
    for half, t_in in enumerate((text, torch.zeros_like(text))):
        h, idx, deficit, _ = hidden(P, g, t_in, seg, img, int4_cache=True,
                                    r=r, routes=None if routes is None
                                    else routes[half])
        out.append(logits(P, g, h[:, g.prefix - 1:g.prefix - 1 + n], r))
        chosen.append(idx)
        deficits.append(deficit)
    cond, uncond = out
    return (uncond + guidance * (cond - uncond), torch.stack(chosen),
            torch.stack(deficits))
