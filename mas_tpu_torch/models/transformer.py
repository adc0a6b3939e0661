"""MakeAScene autoregressive transformer: training forward, prefill and
decode.

Counterpart of ``mas_tpu/models/transformer.py``: token sequence
[text | seg | image]; three token embeddings, text positions and
factorized row/col positions for the seg and image grids; the text pad
remap ``0 -> text_vocab_size - text_length + position``; pre-LN layers
with CogView sandwich LayerNorms and a tanh-GELU MLP; ``to_logits`` =
LayerNorm + Linear.

Attention is the plain masked softmax with fp32 statistics.  CogView's
PB-relax (``cogview_pb_relax``) subtracts an alpha-scaled max, a per-row
constant that softmax cancels exactly, so it is not computed.

Variants, as in the JAX package:
  * grouped-query attention (``num_kv_heads``): the ``qkv`` projection is
    ``hidden + 2 kv_heads hd`` wide, sliced [q | k | v]; for attention over
    the sequence k and v are expanded to the query heads with
    ``repeat_interleave`` (JAX's ``jnp.repeat``: head h = kv g + g', and
    autograd sums dK/dV back over each group); the caches keep the
    kv_heads tensors and B2/B9 read each kv head once for its g query rows;
  * ``rudalle_relax``: the relaxed scores fold into the operands (q over
    sigma^2 = var(k), unbiased, over the whole tensor; v over its detached
    max), so B1/B6 run it exactly (``rudalle_attention``); decoding takes
    the same statistics over the cache's positions <= index
    (``rudalle_decode_attention``, then B9); the context, the MLP and the
    final LN's input are rescaled by detached maxima where JAX rescales
    them, global or per row as there;
  * ``cogview_layernorm_prescale``: the inputs of ln_in, the first
    sandwich LN and ln_out divided by their detached per-position max;
  * ``ln_matmul_fold``: ln_in and ln_out folded into the qkv and lin1
    products (``ops/norms.py::folded_ln_dense``), except ln_in of a decode
    step, as in JAX;
  * ``scan_layers``: the layers always run unrolled; only the stacked
    checkpoint tree differs (``utils/weights.py``).

Kernels: the full-sequence attention (``forward`` and ``prefill``) is B1,
with B6 as its backward, through ``ops/attention.py::
FlashAttentionFunction`` (the fused projection, no copy) or
``FlashAttentionQKVFunction`` (grouped-query and rudalle_relax).  Each
decode step writes the new token's k/v and reads the cache, by the cache's
kind (``allocate_caches``):
  * float (``kv_cache_dtype: "compute"``): an in-place ``index_copy_``,
    then B9 (``ops/decode_attention.py``);
  * int8/int4 lane caches: B3 (``ops/decode_cache.py``), then B2
    (``ops/quant.py``);
  * int8/int4 packed cache (``kv_cache_layout: "packed"``): B10, then B2
    over strided views of the packed buffer (``ops/decode_cache.py``).
With ``layernorm_impl: "pallas"`` every LayerNorm of at least 4096 rows is
B7 (``ops/layer_norm.py``).  CPU tensors take the kernels' plain twins.

Parameters use the reference ``state_dict`` keys
(``transformer.layers.{i}.attn.qkv`` ...), the layout the JAX package's
``utils/torch_export.py`` writes.  Linear and embedding layers compute in
the compute dtype, casting weight, bias and input at use, as flax
``Dense(dtype=...)`` and ``Embed(dtype=...)`` do.  A model built for
training (``fp32_params=True``) keeps those parameters in fp32, as the JAX
package does; a serving model casts them to the compute dtype once, which
makes the cast at use a no-op.  LayerNorm parameters stay fp32 and
LayerNorm statistics are fp32.

``remat`` recomputes in the backward pass what the JAX package's
``nn.remat`` recomputes: the MLP (``remat_policy: "mlp"``), the whole
layer (``"nothing"``), or the whole layer with the outputs of its matrix
products saved (``"dots"``).

Tensor parallelism (``shard=(index, size)``, a model rank of
``parallel/``; ``parallel/sharding.py`` holds the layout): the attention
runs on H / size query heads and their kv heads (B1/B6 and the decode
kernels at those shapes), the MLP on 4 hidden / size columns, the logits
on image_vocab / size words, so every entry point returns this rank's
slice of the vocabulary.  Replicated activations enter the column-
parallel products through ``copy_to_model`` (their gradients are summed
over the model group); the row-parallel products are summed over the
group in fp32 (``reduce_from_model``: bf16 operands' fp32 products,
``_ProductFP32``), then take their bias.  rudalle_relax's whole-tensor
statistics (sigma of k, the maxima of v, the context and the MLP's
hidden activations) span the group.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple, Union

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils import checkpoint

from ..ops import attention, decode_attention, decode_cache, quant
from ..ops.decode_attention import FloatCache
from ..ops.decode_cache import PackedQuantCache
from ..ops.norms import folded_ln_dense, layer_norm
from ..ops.quant import QuantCache
from ..parallel.collectives import (copy_to_model, max_over_model,
                                    reduce_from_model)
from ..parallel.sharding import check_shardable, kv_heads_of, shard_state
from ..utils.config import TransformerConfig
from .vqvae import compute_dtype

# per layer: (k, v) float or lane caches, or (packed cache, None), as the
# JAX package's caches are
LayerCache = Union[Tuple[FloatCache, FloatCache],
                   Tuple[QuantCache, QuantCache],
                   Tuple[PackedQuantCache, None]]
KVCache = List[LayerCache]

_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat_policy: "dots"`` (JAX's
    ``dots_saveable``): keep the matmul outputs, recompute the rest."""
    policy = checkpoint.CheckpointPolicy
    return policy.MUST_SAVE if op in _DOTS else policy.PREFER_RECOMPUTE


class _ProductFP32(torch.autograd.Function):
    """x W^T in fp32: cuBLAS's fp32 result of bf16 operands on the card
    (``torch.mm(..., out_dtype=torch.float32)``), the fp32 product of the
    operands elsewhere (bf16 values multiply exactly in fp32).  The
    backward is ``F.linear``'s, in the operands' dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        x2 = x.reshape(-1, x.shape[-1])
        if x.is_cuda and x.dtype == torch.bfloat16:
            y = torch.mm(x2, w.t(), out_dtype=torch.float32)
        else:
            y = x2.float() @ w.float().t()
        return y.view(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        gw = g.reshape(-1, g.shape[-1]).t() @ x.reshape(-1, x.shape[-1])
        return g @ w, gw


class Dense(nn.Linear):
    """``nn.Linear`` that computes in ``compute_dtype``: weight, bias and
    input are cast at use (a no-op where they already have that dtype).
    With ``ln`` (a ``LayerNorm``) it computes ``Dense(ln(x))`` with the
    LayerNorm folded into the product (``ln_matmul_fold``).

    ``parallel``: "column" — this rank's output columns of a replicated
    input, which enters through ``copy_to_model`` (from output row
    ``shared_from`` on, the weight rows are every rank's alike and
    their gradients are summed over the model group too); "row" — this
    rank's input rows: the fp32 partial products are summed over the
    model group, then the bias is added; "" — the whole product."""

    def __init__(self, d_in: int, d_out: int, compute_dtype: torch.dtype,
                 parallel: str = "", shared_from: Optional[int] = None):
        super().__init__(d_in, d_out)
        self.compute_dtype = compute_dtype
        self.parallel = parallel
        self.shared_from = shared_from

    def _params(self):
        w, b = self.weight, self.bias
        s = self.shared_from
        if s is not None:
            w = torch.cat([w[:s], copy_to_model(w[s:])])
            b = torch.cat([b[:s], copy_to_model(b[s:])])
        return w, b

    def forward(self, x: torch.Tensor, ln=None) -> torch.Tensor:
        dt = self.compute_dtype
        if self.parallel == "row":
            y = reduce_from_model(_ProductFP32.apply(x.to(dt),
                                                     self.weight.to(dt)))
            return (y + self.bias.float()).to(dt)
        w, b = self._params()
        if self.parallel == "column":
            x = copy_to_model(x)
        if ln is not None:
            ln_w, ln_b = ln.weight, ln.bias
            if self.parallel == "column":
                ln_w, ln_b = copy_to_model(ln_w), copy_to_model(ln_b)
            return folded_ln_dense(x, ln_w, ln_b, w, b, ln.eps, dt)
        return F.linear(x.to(dt), w.to(dt), b.to(dt))


class Embed(nn.Embedding):
    """``nn.Embedding`` whose rows come out in ``compute_dtype``."""

    def __init__(self, num: int, dim: int, compute_dtype: torch.dtype):
        super().__init__(num, dim)
        self.compute_dtype = compute_dtype

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return F.embedding(idx, self.weight).to(self.compute_dtype)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, impl: str = "jnp", eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.impl = impl
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps, self.impl)


def _detached_max(t: torch.Tensor, dim=None,
                  sharded: bool = False) -> torch.Tensor:
    """The max of ``t`` (over ``dim``, kept; else over all of it) with no
    gradient, as JAX's ``_detached_max``; ``sharded``: ``t`` is this
    rank's shard of a tensor split over the model group."""
    m = t.amax() if dim is None else t.amax(dim=dim, keepdim=True)
    m = m.detach()
    return max_over_model(m) if sharded else m


def _std(k: torch.Tensor, shards: int) -> torch.Tensor:
    """std (unbiased) of every element of k, fp32, with its gradient; k is
    this rank's equal share of a tensor split over ``shards`` model ranks
    (rudalle_relax is multi-head, so its kv heads split)."""
    kf = k.float()
    if shards == 1:
        return kf.std()
    n = kf.numel() * shards
    mean = reduce_from_model(kf.sum()) / n
    dev = kf - copy_to_model(mean)
    var = reduce_from_model(dev.square().sum()) / (n - 1.0)
    return copy_to_model(var.sqrt())


def rudalle_attention(q, k, v, prefix_length: int,
                      shards: int = 1) -> torch.Tensor:
    """rudalle_relax over the sequence through B1/B6
    (``mas_tpu/models/transformer.py::rudalle_relax_attention_fused``):
    the midpoint shift is a row constant and sigma a positive scalar, and
    the -65504 mask underflows to 0, so the distribution is the masked
    softmax of q k^T / (sqrt(d) sigma^2).  sigma = std(k) (unbiased, over
    the whole tensor: every row of the batch, both guidance halves
    included, every kv head of the model group) keeps its gradient; v is
    divided by its detached max.  q, k, v [B, H, T, d]; returns the
    context [B, H, T, d] in fp32; ``shards``: as ``_std``'s."""
    sigma = _std(k, shards)
    qs = (q.float() / (sigma * sigma)).to(q.dtype)
    vs = (v.float() / _detached_max(v.float(), sharded=shards > 1)
          ).to(v.dtype)
    return attention.FlashAttentionQKVFunction.apply(
        qs, k, vs, prefix_length).float()


def rudalle_decode_attention(q, k_cache: FloatCache, v_cache: FloatCache,
                             index: torch.Tensor,
                             shards: int = 1) -> torch.Tensor:
    """rudalle_relax for one token over float caches
    (``mas_tpu/models/transformer.py::_rudalle_decode_attention``): sigma
    (unbiased) and max(v) over the positions <= index of every (b, h) row,
    the first d columns only, as masked reductions on the device (no host
    value of ``index``); then B9 on q / sigma^2, its output divided by
    max(v), by the argument of ``rudalle_attention``.  q [B, H, 1, d];
    returns [B, H, 1, d] in fp32.  Under tensor parallelism (``shards``:
    as ``_std``'s) the caches hold this rank's heads and the statistics
    span the model group."""
    b, h, _, d = q.shape
    kd = k_cache.data[..., :d].float()
    vd = v_cache.data[..., :d].float()
    valid = (torch.arange(kd.shape[2], device=q.device)
             <= index.to(q.device))[:, None]
    n = (index.to(q.device).float() + 1.0) * (b * h * d * shards)
    total = reduce_from_model if shards > 1 else (lambda t: t)
    mean = total(torch.where(valid, kd, 0.0).sum()) / n
    var = total(torch.where(valid, (kd - mean).square(), 0.0).sum()) \
        / (n - 1.0)
    sigma = var.sqrt()
    v_scale = _detached_max(torch.where(valid, vd, -3.0e38),
                            sharded=shards > 1)
    qs = (q.float() / (sigma * sigma)[:, None, None, None]).to(q.dtype)
    ctx = decode_attention.decode_attention_float(qs, k_cache, v_cache,
                                                  index)
    return ctx.float() / v_scale


class SelfAttention(nn.Module):
    """Attention of ``num_attn_heads`` / size query heads, model rank
    ``index`` of ``size`` (``parallel/sharding.py``; all of them at size
    1): ``heads`` query heads attending with ``kv_heads`` kv heads."""

    def __init__(self, cfg: TransformerConfig, index: int = 0,
                 size: int = 1):
        super().__init__()
        self.cfg = cfg
        self.shards = size
        dt = compute_dtype(cfg.compute_dtype)
        hd = cfg.head_dim
        self.heads = cfg.num_attn_heads // size
        kv = kv_heads_of(cfg, index, size)
        self.kv_heads = len(kv)
        split = cfg.kv_heads % size == 0
        # the kv heads of a rank's projection, and which of them it reads
        # when they do not split (every rank holds all of them)
        self.kv_stored = self.kv_heads if split else cfg.kv_heads
        self.kv_select = None if split else kv
        width = (self.heads + 2 * self.kv_stored) * hd
        self.qkv = Dense(cfg.hidden_dim, width, dt,
                         "column" if size > 1 else "",
                         None if split else self.heads * hd)
        self.out_proj = Dense(self.heads * hd, cfg.hidden_dim, dt,
                              "row" if size > 1 else "")

    def _qkv(self, x: torch.Tensor, ln=None):
        """[B, T, D] -> the projection [B, T, (H + 2 KV) hd] and its q [B,
        H, T, hd], k and v [B, KV, T, hd] (this rank's heads) as views,
        sliced [q | k | v] as JAX's ``_qkv``; ``ln`` folds a LayerNorm into
        the product."""
        hd = self.cfg.head_dim
        b, t, _ = x.shape
        proj = self.qkv(x, ln)
        kvd = self.kv_stored * hd
        q, k, v = proj.split([self.heads * hd, kvd, kvd], dim=-1)
        heads = (self.heads, self.kv_stored, self.kv_stored)
        q, k, v = (z.view(b, t, n, hd).transpose(1, 2)
                   for z, n in zip((q, k, v), heads))
        if self.kv_select is not None:
            k, v = k[:, self.kv_select], v[:, self.kv_select]
        return proj, (q, k, v)

    def _context(self, ctx: torch.Tensor) -> torch.Tensor:
        """[B, H, T, hd] -> [B, T, H hd]; rudalle_relax divides it by its
        detached max (global, over the whole tensor) in fp32."""
        cfg = self.cfg
        b, h, t, hd = ctx.shape
        ctx = ctx.transpose(1, 2).reshape(b, t, h * hd)
        if cfg.rudalle_relax:
            ctx = (ctx / _detached_max(ctx, sharded=self.shards > 1)).to(
                compute_dtype(cfg.compute_dtype))
        return ctx

    def forward(self, x: torch.Tensor, prefix_length: int, ln=None):
        """Full-sequence attention; returns (out, (k, v) [B, KV, T, hd]).
        ``ln``: ln_in folded into the projection (x un-normalized)."""
        cfg = self.cfg
        b, t, _ = x.shape
        proj, (q, k, v) = self._qkv(x, ln)
        g = self.heads // self.kv_heads
        if cfg.rudalle_relax:
            ctx = rudalle_attention(q, k, v, prefix_length, self.shards)
        elif g == 1 and self.kv_select is None:
            # the fused projection's view: no copy
            ctx = attention.FlashAttentionFunction.apply(
                proj.view(b, t, 3, self.heads, cfg.head_dim),
                prefix_length)
        else:
            ctx = attention.FlashAttentionQKVFunction.apply(
                q, k.repeat_interleave(g, dim=1),
                v.repeat_interleave(g, dim=1), prefix_length)
        return self.out_proj(self._context(ctx)), (k, v)

    def decode(self, x: torch.Tensor, k_cache, v_cache,
               index: torch.Tensor) -> torch.Tensor:
        """x [B, 1, D]; writes this token's k/v at ``index`` in place, then
        attends over positions <= index.  The caches are a float pair, a
        lane-quantized pair, or one packed cache with ``v_cache`` None
        (``mas_tpu/models/transformer.py::SelfAttention.decode``), of
        kv_heads heads."""
        _, (q, k, v) = self._qkv(x)
        k, v = k[:, :, 0], v[:, :, 0]
        if isinstance(k_cache, PackedQuantCache):
            decode_cache.write_packed_kv(k_cache, k, v, index)
            ctx = decode_cache.decode_attention_packed(q, k_cache, index)
        elif isinstance(k_cache, QuantCache):
            decode_cache.write_quant_kv(k_cache, v_cache, k, v, index)
            ctx = quant.decode_attention_quant(q, k_cache, v_cache, index)
        else:
            decode_attention.write_float_kv(k_cache, v_cache, k, v, index)
            if self.cfg.rudalle_relax:
                ctx = rudalle_decode_attention(q, k_cache, v_cache, index,
                                               self.shards)
            else:
                ctx = decode_attention.decode_attention_float(
                    q, k_cache, v_cache, index)
        return self.out_proj(self._context(ctx))


class MLP(nn.Module):
    """lin1 column-parallel, lin2 row-parallel over ``size`` model ranks:
    4 hidden / size hidden units a rank."""

    def __init__(self, cfg: TransformerConfig, size: int = 1):
        super().__init__()
        dt = compute_dtype(cfg.compute_dtype)
        self.rudalle = cfg.rudalle_relax
        self.shards = size
        width = 4 * cfg.hidden_dim // size
        tp = size > 1
        self.lin1 = Dense(cfg.hidden_dim, width, dt, "column" if tp else "")
        self.lin2 = Dense(width, cfg.hidden_dim, dt, "row" if tp else "")

    def forward(self, x: torch.Tensor, ln=None) -> torch.Tensor:
        h = F.gelu(self.lin1(x, ln), approximate="tanh")
        if not self.rudalle:
            return self.lin2(h)
        # rudalle_relax: the input over a quarter of its detached max (one
        # number for the tensor, every rank's units), the output (whole
        # after lin2's sum) over its per-row max
        scale = _detached_max(h, sharded=self.shards > 1) / 4.0
        y = self.lin2(h / scale)
        return (y / _detached_max(y, -1)) * scale


class TransformerLayer(nn.Module):
    """Pre-LN block with optional CogView sandwich LayerNorms."""

    def __init__(self, cfg: TransformerConfig, index: int = 0,
                 size: int = 1):
        super().__init__()
        self.sandwich = cfg.cogview_sandwich_layernorm
        self.prescale = cfg.cogview_layernorm_prescale
        self.fold = cfg.ln_matmul_fold
        self.remat_mlp = cfg.remat and cfg.remat_policy == "mlp"
        ln = functools.partial(LayerNorm, cfg.hidden_dim, cfg.layernorm_impl)
        self.ln_in = ln()
        self.ln_out = ln()
        if self.sandwich:
            self.first_ln_sandwich = ln()
            self.second_ln_sandwich = ln()
        self.attn = SelfAttention(cfg, index, size)
        self.mlp = MLP(cfg, size)

    def _prescaled(self, t):
        """cogview_layernorm_prescale: t over its detached per-position
        max (before ln_in, the first sandwich LN and ln_out)."""
        return t / _detached_max(t, -1) if self.prescale else t

    def _post_attn(self, x, a):
        if self.sandwich:
            a = self.first_ln_sandwich(self._prescaled(a))
        x = x + a
        t = self._prescaled(x)
        args = (t, self.ln_out) if self.fold else (self.ln_out(t),)
        if self.remat_mlp and torch.is_grad_enabled():
            m = checkpoint.checkpoint(self.mlp, *args, use_reentrant=False)
        else:
            m = self.mlp(*args)
        if self.sandwich:
            m = self.second_ln_sandwich(m)
        return x + m

    def forward(self, x, prefix_length: int):
        t = self._prescaled(x)
        if self.fold:
            a, kv = self.attn(t, prefix_length, self.ln_in)
        else:
            a, kv = self.attn(self.ln_in(t), prefix_length)
        return self._post_attn(x, a), kv

    def decode(self, x, k_cache, v_cache, index):
        a = self.attn.decode(self.ln_in(self._prescaled(x)), k_cache,
                             v_cache, index)
        return self._post_attn(x, a)


class _Stack(nn.Module):
    """Holds ``layers`` and ``final_ln`` under the reference ``transformer.``
    prefix."""

    def __init__(self, cfg: TransformerConfig, index: int, size: int):
        super().__init__()
        self.layers = nn.ModuleList(
            [TransformerLayer(cfg, index, size)
             for _ in range(cfg.num_layers)])
        self.final_ln = LayerNorm(cfg.hidden_dim, cfg.layernorm_impl)


class MakeAScene(nn.Module):
    """Embeddings + layers + final LN + to_logits.

    ``fp32_params``: keep Linear and Embedding parameters in fp32 (the
    training path: Adam's updates are far below a bf16 ulp of a weight);
    otherwise they are cast to the compute dtype once (serving).
    ``shard``: (model index, model size) of a tensor-parallel rank
    (``parallel.distributed.model_shard``); its logits are its slice of
    the vocabulary."""

    def __init__(self, cfg: TransformerConfig, fp32_params: bool = False,
                 shard: Tuple[int, int] = (0, 1)):
        super().__init__()
        index, size = shard
        if size > 1:
            check_shardable(cfg, size)
        self.cfg = cfg
        self.shard = (index, size)
        self.dtype = compute_dtype(cfg.compute_dtype)
        d = cfg.hidden_dim
        emb = functools.partial(Embed, compute_dtype=self.dtype)
        self.image_token_embedding = emb(cfg.image_vocab_size, d)
        self.seg_token_embedding = emb(cfg.seg_vocab_size, d)
        self.text_token_embedding = emb(cfg.text_vocab_size, d)
        self.text_pos_embeddings = emb(cfg.text_length, d)
        self.seg_row_embeddings = emb(cfg.seg_tokens_per_dim, d)
        self.seg_col_embeddings = emb(cfg.seg_tokens_per_dim, d)
        self.image_row_embeddings = emb(cfg.image_tokens_per_dim, d)
        self.image_col_embeddings = emb(cfg.image_tokens_per_dim, d)
        self.transformer = _Stack(cfg, index, size)
        self.to_logits = nn.Sequential(
            LayerNorm(d, cfg.layernorm_impl),
            Dense(d, cfg.image_vocab_size // size, self.dtype,
                  "column" if size > 1 else ""))
        if not fp32_params:
            for m in self.modules():
                if isinstance(m, (nn.Linear, nn.Embedding)):
                    m.to(self.dtype)

    @classmethod
    def sharded(cls, cfg: TransformerConfig, full: dict,
                shard: Tuple[int, int],
                fp32_params: bool = False) -> "MakeAScene":
        """Model rank ``shard`` of a model whose full ``state_dict`` (one
        process's layout) is ``full``; built on the current default
        device."""
        model = cls(cfg, fp32_params, shard)
        model.load_state_dict(shard_state(full, cfg, *shard))
        return model

    # --- embeddings ---------------------------------------------------------

    def _pos(self, n: int, offset: int = 0) -> torch.Tensor:
        return torch.arange(offset, offset + n,
                            device=self.text_pos_embeddings.weight.device)

    def embed_text(self, text_tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        pos = self._pos(cfg.text_length)
        remap = pos + (cfg.text_vocab_size - cfg.text_length)
        toks = torch.where(text_tokens == 0, remap[None, :],
                           text_tokens.long())
        return self.text_token_embedding(toks) + self.text_pos_embeddings(pos)

    def embed_seg(self, seg_tokens: torch.Tensor) -> torch.Tensor:
        n = self.cfg.seg_tokens_per_dim
        pos = self._pos(seg_tokens.shape[-1])
        return (self.seg_token_embedding(seg_tokens.long())
                + self.seg_row_embeddings(pos // n)
                + self.seg_col_embeddings(pos % n))

    def embed_image(self, img_tokens: torch.Tensor,
                    past_length: int = 0) -> torch.Tensor:
        n = self.cfg.image_tokens_per_dim
        pos = self._pos(img_tokens.shape[-1], past_length)
        return (self.image_token_embedding(img_tokens.long())
                + self.image_row_embeddings(pos // n)
                + self.image_col_embeddings(pos % n))

    def embed_prefix(self, text_tokens, seg_tokens) -> torch.Tensor:
        return torch.cat([self.embed_text(text_tokens),
                          self.embed_seg(seg_tokens)], dim=1)

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        return self.to_logits(h).float()

    def _final_ln(self, x: torch.Tensor) -> torch.Tensor:
        """The final LN; rudalle_relax first divides by the detached
        per-position max (JAX's ``_final_ln``)."""
        if self.cfg.rudalle_relax:
            x = x / _detached_max(x, -1)
        return self.transformer.final_ln(x)

    def _backbone(self, x: torch.Tensor, keep_kv: bool = False):
        """Layers + final LN -> (h, per-layer (k, v) when ``keep_kv``)."""
        cfg = self.cfg
        remat = (cfg.remat and cfg.remat_policy != "mlp"
                 and torch.is_grad_enabled())
        context = (functools.partial(
            checkpoint.create_selective_checkpoint_contexts, _save_dots)
            if cfg.remat_policy == "dots" else checkpoint.noop_context_fn)
        kvs = []
        for layer in self.transformer.layers:
            if remat:
                x, kv = checkpoint.checkpoint(
                    layer, x, cfg.effective_prefix, use_reentrant=False,
                    context_fn=context)
            else:
                x, kv = layer(x, cfg.effective_prefix)
            if keep_kv:
                kvs.append(kv)
        return self._final_ln(x), kvs

    # --- entry points -------------------------------------------------------

    def forward(self, text_tokens, seg_tokens, img_tokens) -> torch.Tensor:
        """Full-sequence forward -> logits [B, image_length, vocab] for the
        image positions (shifted by one)."""
        cfg = self.cfg
        emb = torch.cat([self.embed_prefix(text_tokens, seg_tokens),
                         self.embed_image(img_tokens)], dim=1)
        h, _ = self._backbone(emb)
        return self._logits(h[:, -cfg.image_length - 1:-1, :])

    def prefill(self, text_tokens, seg_tokens):
        """Run the text+seg prefix -> (logits [B, vocab] for the first image
        token, per-layer (k, v) [B, kv_heads, prefix, hd])."""
        h, kvs = self._backbone(self.embed_prefix(text_tokens, seg_tokens),
                                keep_kv=True)
        return self._logits(h[:, -1:, :])[:, 0], kvs

    def allocate_caches(self, prefill_kv: Sequence, batch: int) -> KVCache:
        """Full-length caches of this rank's kv heads seeded with the
        prefill's
        k/v: float caches in the compute dtype (``kv_cache_dtype:
        "compute"``), else the quantized prefix in lane caches (scales in
        ``kv_scale_dtype``) or, with ``kv_cache_layout: "packed"``, in one
        packed cache per layer.  They are allocated once and written in
        place by ``decode_step``."""
        cfg = self.cfg
        total = cfg.total_length
        if cfg.kv_cache_dtype == "compute":
            return [(FloatCache.seeded(k, total), FloatCache.seeded(v, total))
                    for k, v in prefill_kv]
        bits = 4 if cfg.kv_cache_dtype == "int4" else 8
        if cfg.kv_cache_layout == "packed":
            return [(decode_cache.seed_packed_cache(k, v, total, bits), None)
                    for k, v in prefill_kv]
        device = self.text_pos_embeddings.weight.device
        scale_dtype = (torch.bfloat16 if cfg.kv_scale_dtype == "bfloat16"
                       else torch.float32)
        caches = []
        for k, v in prefill_kv:
            pair = []
            for t in (k, v):
                c = QuantCache.empty(batch, t.shape[1], cfg.total_length,
                                     cfg.head_dim, bits, device, scale_dtype)
                seeded = quant.quantize_kv(t, bits, scale_dtype)
                c.q[:, :, :t.shape[2]] = seeded.q
                c.scale[:, :, :t.shape[2]] = seeded.scale
                pair.append(c)
            caches.append(tuple(pair))
        return caches

    def decode_step(self, img_token: torch.Tensor, step: int,
                    caches: KVCache) -> torch.Tensor:
        """img_token [B, 1] generated at image position ``step``; writes its
        k/v at prefix + step into ``caches`` (in place) and returns the
        logits [B, vocab] for position step + 1."""
        cfg = self.cfg
        x = self.embed_image(img_token, past_length=step)
        index = torch.full((1,), cfg.prefix_length + step, dtype=torch.int32,
                           device=x.device)
        for layer, (k_cache, v_cache) in zip(self.transformer.layers, caches):
            x = layer.decode(x, k_cache, v_cache, index)
        return self._logits(self._final_ln(x))[:, 0]
