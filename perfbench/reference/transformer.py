"""Plain reference of the Make-A-Scene transformer, fp32, for the checks
that decide ``correct``.

Written from the reference's architecture (CasualGANPapers/Make-A-Scene,
``models/transformer.py``: CogView-style pre-LN layers with sandwich
LayerNorms, a tanh-GELU MLP, a bidirectional text+seg prefix and causal
image tokens, factorized row/col positions, the text pad remap ``0 ->
text_vocab - text_length + position``), with no kernel, cache or batching
of the program and nothing imported from it.  Parameters carry the
reference ``state_dict`` keys, so the benchmark hands the same tensors to
the program and to this code.

Serving: ``serve_logits`` runs the whole sequence at once, teacher-forced.
The configuration states an int4 cache: every image position attends
over keys and values quantized as such a cache holds them (one fp32
scale a position and head, ``max |x| / 7``, values rounded half to even
and clamped to [-7, 7]); the prefix attends over exact ones, as its
prefill does.  Training: ``train_steps`` takes Adam steps over the
batch, one sequence at a time.

Every matrix product goes through ``precision``'s rounding: exact for the
reference, fp8 for its control.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import torch
from torch.nn import functional as F

from .precision import Rounding, exact

Params = Dict[str, torch.Tensor]
LN_EPS = 1e-5
NEG_INF = -1e30

# (name, shape, mean, std, role): role "dense" is a linear or embedding
# tensor (served in the compute dtype), "norm" a LayerNorm's (fp32)
Spec = List[Tuple[str, Tuple[int, ...], float, float, str]]


@dataclass(frozen=True)
class Geometry:
    layers: int
    hidden: int
    heads: int
    image_vocab: int
    seg_vocab: int
    text_vocab: int
    image_side: int
    seg_side: int
    text_length: int

    @classmethod
    def of(cls, t: dict) -> "Geometry":
        plain = {"rudalle_relax": False, "cogview_layernorm_prescale": False,
                 "ln_matmul_fold": False,
                 "cogview_sandwich_layernorm": True,
                 "prefix_bidirectional": True, "kv_cache_layout": "lane",
                 "kv_scale_dtype": "float32"}
        for key, value in plain.items():
            if t.get(key, value) != value:
                raise ValueError(f"the reference is written for {key} = "
                                 f"{value!r}, the config has {t[key]!r}")
        if t.get("num_kv_heads", 0) not in (0, t["num_attn_heads"]):
            raise ValueError("the reference is written for multi-head "
                             "attention (num_kv_heads 0)")
        return cls(t["num_layers"], t["hidden_dim"], t["num_attn_heads"],
                   t["image_vocab_size"], t["seg_vocab_size"],
                   t["text_vocab_size"], t["image_tokens_per_dim"],
                   t["seg_tokens_per_dim"], t["text_length"])

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def prefix(self) -> int:
        return self.text_length + self.seg_side ** 2

    @property
    def image_length(self) -> int:
        return self.image_side ** 2


def param_spec(g: Geometry) -> Spec:
    d = g.hidden
    spec: Spec = []

    def dense(name, *shape):
        spec.append((name, shape, 0.0, 0.02, "dense"))

    def ln(name):
        spec.append((f"{name}.weight", (d,), 1.0, 0.1, "norm"))
        spec.append((f"{name}.bias", (d,), 0.0, 0.02, "norm"))

    def linear(name, d_in, d_out):
        dense(f"{name}.weight", d_out, d_in)
        dense(f"{name}.bias", d_out)

    for name, rows in (("image_token_embedding", g.image_vocab),
                       ("seg_token_embedding", g.seg_vocab),
                       ("text_token_embedding", g.text_vocab),
                       ("text_pos_embeddings", g.text_length),
                       ("seg_row_embeddings", g.seg_side),
                       ("seg_col_embeddings", g.seg_side),
                       ("image_row_embeddings", g.image_side),
                       ("image_col_embeddings", g.image_side)):
        dense(f"{name}.weight", rows, d)
    for i in range(g.layers):
        p = f"transformer.layers.{i}."
        for norm in ("ln_in", "ln_out", "first_ln_sandwich",
                     "second_ln_sandwich"):
            ln(p + norm)
        linear(p + "attn.qkv", d, 3 * d)
        linear(p + "attn.out_proj", d, d)
        linear(p + "mlp.lin1", d, 4 * d)
        linear(p + "mlp.lin2", 4 * d, d)
    ln("transformer.final_ln")
    ln("to_logits.0")
    linear("to_logits.1", d, g.image_vocab)
    return spec


def leaves(name: str, t: torch.Tensor) -> List[Tuple[str, torch.Tensor]]:
    """The reference's own leaves of a tensor: the fused qkv projection is
    its q, k and v projections (rows [q | k | v]); every other tensor is
    one leaf."""
    if ".attn.qkv." in name:
        return [(f"{name}[{part}]", chunk)
                for part, chunk in zip("qkv", t.chunk(3, dim=0))]
    return [(name, t)]


def _ln(x, P, name):
    return F.layer_norm(x, x.shape[-1:], P[f"{name}.weight"],
                        P[f"{name}.bias"], LN_EPS)


def _linear(x, P, name, r: Rounding):
    return r(x) @ r(P[f"{name}.weight"]).t() + P[f"{name}.bias"]


def embed(P: Params, g: Geometry, text, seg, img) -> torch.Tensor:
    """[text | seg | img] tokens -> [B, T, D]; text id 0 is the pad,
    remapped to ``text_vocab - text_length + position``."""
    dev = text.device
    tpos = torch.arange(g.text_length, device=dev)
    text = torch.where(text == 0, tpos + (g.text_vocab - g.text_length),
                       text)
    e_text = (P["text_token_embedding.weight"][text]
              + P["text_pos_embeddings.weight"][tpos])
    spos = torch.arange(seg.shape[1], device=dev)
    e_seg = (P["seg_token_embedding.weight"][seg]
             + P["seg_row_embeddings.weight"][spos // g.seg_side]
             + P["seg_col_embeddings.weight"][spos % g.seg_side])
    ipos = torch.arange(img.shape[1], device=dev)
    e_img = (P["image_token_embedding.weight"][img]
             + P["image_row_embeddings.weight"][ipos // g.image_side]
             + P["image_col_embeddings.weight"][ipos % g.image_side])
    return torch.cat([e_text, e_seg, e_img], dim=1)


def int4_cache_values(x: torch.Tensor) -> torch.Tensor:
    """x [B, H, T, d] as an int4 cache holds it, dequantized: one scale a
    position, ``max |x| / 7`` over d, values rounded and clamped."""
    amax = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8)
    scale = amax / torch.full_like(amax, 7.0)
    return torch.clamp(torch.round(x / scale), -7.0, 7.0) * scale


def _attend(q, k, v, mask, r: Rounding):
    d = q.shape[-1]
    s = (r(q) @ r(k).transpose(-1, -2)) / math.sqrt(d)
    p = torch.softmax(s.masked_fill(~mask, NEG_INF), dim=-1)
    return r(p) @ r(v)


def _mask(g: Geometry, t: int, device) -> torch.Tensor:
    pos = torch.arange(t, device=device)
    qp, kp = pos[:, None], pos[None, :]
    return (kp <= qp) | ((qp < g.prefix) & (kp < g.prefix))


def hidden(P: Params, g: Geometry, text, seg, img, int4_cache: bool = False,
           r: Rounding = exact) -> torch.Tensor:
    """The final hidden states [B, T, D] (after ``final_ln``) of the
    sequence [text | seg | img]; ``int4_cache``: image positions attend
    over int4-cache values (the prefix over exact ones)."""
    x = embed(P, g, text, seg, img)
    b, t, d = x.shape
    h, hd = g.heads, g.head_dim
    mask = _mask(g, t, x.device)
    for i in range(g.layers):
        p = f"transformer.layers.{i}."
        qkv = _linear(_ln(x, P, p + "ln_in"), P, p + "attn.qkv", r)
        q, k, v = (z.view(b, t, h, hd).transpose(1, 2)
                   for z in qkv.split(d, dim=-1))
        ctx = _attend(q, k, v, mask, r)
        if int4_cache and t > g.prefix:
            img_rows = _attend(q[:, :, g.prefix:], int4_cache_values(k),
                               int4_cache_values(v), mask[g.prefix:], r)
            ctx = torch.cat([ctx[:, :, :g.prefix], img_rows], dim=2)
        a = _linear(ctx.transpose(1, 2).reshape(b, t, d), P,
                    p + "attn.out_proj", r)
        x = x + _ln(a, P, p + "first_ln_sandwich")
        m = F.gelu(_linear(_ln(x, P, p + "ln_out"), P, p + "mlp.lin1", r),
                   approximate="tanh")
        m = _linear(m, P, p + "mlp.lin2", r)
        x = x + _ln(m, P, p + "second_ln_sandwich")
    return _ln(x, P, "transformer.final_ln")


def logits(P: Params, g: Geometry, h: torch.Tensor,
           r: Rounding = exact) -> torch.Tensor:
    return _linear(_ln(h, P, "to_logits.0"), P, "to_logits.1", r)


def serve_logits(P: Params, g: Geometry, text, seg, tokens, guidance: float,
                 r: Rounding = exact) -> torch.Tensor:
    """Guided logits [B, n, vocab] that chose ``tokens`` [B, n]: position
    i's logits, from the prefix and tokens[:, :i], chose tokens[:, i].
    The unconditional half takes all-pad text; the program's int4 cache
    is modelled (``hidden``)."""
    img = tokens[:, :-1]
    n = tokens.shape[1]
    out = []
    for t_in in (text, torch.zeros_like(text)):
        h = hidden(P, g, t_in, seg, img, int4_cache=True, r=r)
        out.append(logits(P, g, h[:, g.prefix - 1:g.prefix - 1 + n], r))
    cond, uncond = out
    return uncond + guidance * (cond - uncond)


def loss(P: Params, g: Geometry, text, seg, img, batch: int,
         r: Rounding = exact) -> torch.Tensor:
    """These sequences' share of the batch's mean cross-entropy of the
    image tokens (the batch holds ``batch`` sequences)."""
    h = hidden(P, g, text, seg, img, r=r)
    n = g.image_length
    lg = logits(P, g, h[:, -n - 1:-1], r)
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]), img.reshape(-1),
                           reduction="sum") / (batch * n)


@dataclass
class Adam:
    """optax's adam: bias-corrected moments, update m^ / (sqrt(v^) + eps)."""
    lr: float
    b1: float
    b2: float
    eps: float


def train_steps(P: Params, g: Geometry, batches: Sequence, drops: Sequence,
                adam: Adam, r: Rounding = exact, rows: slice = slice(None)):
    """Adam steps from parameters ``P`` (fp32, updated in place) on
    ``batches`` of (text, seg, img); ``drops[i]``: step i's batch takes
    all-pad text (CFG dropout).  The loss of each step is the mean over
    the batch's ``rows``.  Returns (losses, the first step's gradients
    from Adam's first moment, {name: tensor} as ``P``)."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in P.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first = [], None
    for step, ((text, seg, img), drop) in enumerate(zip(batches, drops), 1):
        text, seg, img = text[rows], seg[rows], img[rows]
        if drop:
            text = torch.zeros_like(text)
        total = 0.0
        for i in range(text.shape[0]):
            part = loss(params, g, text[i:i + 1], seg[i:i + 1],
                        img[i:i + 1], text.shape[0], r)
            part.backward()
            total += part.item()
        losses.append(total)
        bc1, bc2 = 1 - adam.b1 ** step, 1 - adam.b2 ** step
        with torch.no_grad():
            for k, p in params.items():
                grad = p.grad if p.grad is not None else torch.zeros_like(p)
                mu[k].mul_(adam.b1).add_(grad, alpha=1 - adam.b1)
                nu[k].mul_(adam.b2).add_(grad.square(), alpha=1 - adam.b2)
                p.sub_(adam.lr * (mu[k] / bc1)
                       / ((nu[k] / bc2).sqrt() + adam.eps))
                p.grad = None
        if step == 1:
            first = {k: m / (1 - adam.b1) for k, m in mu.items()}
    return losses, first, {k: p.detach() for k, p in params.items()}
