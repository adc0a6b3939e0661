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

Kernels: the full-sequence attention (``forward`` and ``prefill``) is B1,
with B6 as its backward, through ``ops/attention.py::
FlashAttentionFunction``.  Each decode step writes the new token's k/v and
reads the cache, by the cache's kind (``allocate_caches``):
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
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple, Union

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils import checkpoint

from ..ops import attention, decode_attention, decode_cache, quant
from ..ops.decode_attention import FloatCache
from ..ops.decode_cache import PackedQuantCache
from ..ops.norms import layer_norm
from ..ops.quant import QuantCache
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


class Dense(nn.Linear):
    """``nn.Linear`` that computes in ``compute_dtype``: weight, bias and
    input are cast at use (a no-op where they already have that dtype)."""

    def __init__(self, d_in: int, d_out: int, compute_dtype: torch.dtype):
        super().__init__(d_in, d_out)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


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


class SelfAttention(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        dt = compute_dtype(cfg.compute_dtype)
        self.qkv = Dense(cfg.hidden_dim, 3 * cfg.hidden_dim, dt)
        self.out_proj = Dense(cfg.hidden_dim, cfg.hidden_dim, dt)

    def _qkv(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, D] -> the fused projection viewed [B, T, 3, H, hd]."""
        cfg = self.cfg
        b, t, _ = x.shape
        return self.qkv(x).view(b, t, 3, cfg.num_attn_heads, cfg.head_dim)

    def forward(self, x: torch.Tensor, prefix_length: int):
        """Full-sequence attention; returns (out, (k, v) [B, H, T, hd])."""
        b, t, d = x.shape
        qkv = self._qkv(x)
        ctx = attention.FlashAttentionFunction.apply(qkv, prefix_length)
        ctx = ctx.transpose(1, 2).reshape(b, t, d)
        _, k, v = attention.split_qkv(qkv)
        return self.out_proj(ctx), (k, v)

    def decode(self, x: torch.Tensor, k_cache, v_cache,
               index: torch.Tensor) -> torch.Tensor:
        """x [B, 1, D]; writes this token's k/v at ``index`` in place, then
        attends over positions <= index.  The caches are a float pair, a
        lane-quantized pair, or one packed cache with ``v_cache`` None
        (``mas_tpu/models/transformer.py::SelfAttention.decode``)."""
        b = x.shape[0]
        q, k, v = attention.split_qkv(self._qkv(x))
        k, v = k[:, :, 0], v[:, :, 0]
        if isinstance(k_cache, PackedQuantCache):
            decode_cache.write_packed_kv(k_cache, k, v, index)
            ctx = decode_cache.decode_attention_packed(q, k_cache, index)
        elif isinstance(k_cache, QuantCache):
            decode_cache.write_quant_kv(k_cache, v_cache, k, v, index)
            ctx = quant.decode_attention_quant(q, k_cache, v_cache, index)
        else:
            decode_attention.write_float_kv(k_cache, v_cache, k, v, index)
            ctx = decode_attention.decode_attention_float(q, k_cache, v_cache,
                                                          index)
        return self.out_proj(ctx.reshape(b, 1, self.cfg.hidden_dim))


class MLP(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        dt = compute_dtype(cfg.compute_dtype)
        self.lin1 = Dense(cfg.hidden_dim, 4 * cfg.hidden_dim, dt)
        self.lin2 = Dense(4 * cfg.hidden_dim, cfg.hidden_dim, dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin2(F.gelu(self.lin1(x), approximate="tanh"))


class TransformerLayer(nn.Module):
    """Pre-LN block with optional CogView sandwich LayerNorms."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.sandwich = cfg.cogview_sandwich_layernorm
        self.remat_mlp = cfg.remat and cfg.remat_policy == "mlp"
        ln = functools.partial(LayerNorm, cfg.hidden_dim, cfg.layernorm_impl)
        self.ln_in = ln()
        self.ln_out = ln()
        if self.sandwich:
            self.first_ln_sandwich = ln()
            self.second_ln_sandwich = ln()
        self.attn = SelfAttention(cfg)
        self.mlp = MLP(cfg)

    def _post_attn(self, x, a):
        if self.sandwich:
            a = self.first_ln_sandwich(a)
        x = x + a
        if self.remat_mlp and torch.is_grad_enabled():
            m = checkpoint.checkpoint(self.mlp, self.ln_out(x),
                                      use_reentrant=False)
        else:
            m = self.mlp(self.ln_out(x))
        if self.sandwich:
            m = self.second_ln_sandwich(m)
        return x + m

    def forward(self, x, prefix_length: int):
        a, kv = self.attn(self.ln_in(x), prefix_length)
        return self._post_attn(x, a), kv

    def decode(self, x, k_cache, v_cache, index):
        a = self.attn.decode(self.ln_in(x), k_cache, v_cache, index)
        return self._post_attn(x, a)


class _Stack(nn.Module):
    """Holds ``layers`` and ``final_ln`` under the reference ``transformer.``
    prefix."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.layers = nn.ModuleList(
            [TransformerLayer(cfg) for _ in range(cfg.num_layers)])
        self.final_ln = LayerNorm(cfg.hidden_dim, cfg.layernorm_impl)


class MakeAScene(nn.Module):
    """Embeddings + layers + final LN + to_logits.

    ``fp32_params``: keep Linear and Embedding parameters in fp32 (the
    training path: Adam's updates are far below a bf16 ulp of a weight);
    otherwise they are cast to the compute dtype once (serving)."""

    def __init__(self, cfg: TransformerConfig, fp32_params: bool = False):
        super().__init__()
        self.cfg = cfg
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
        self.transformer = _Stack(cfg)
        self.to_logits = nn.Sequential(
            LayerNorm(d, cfg.layernorm_impl),
            Dense(d, cfg.image_vocab_size, self.dtype))
        if not fp32_params:
            for m in self.modules():
                if isinstance(m, (nn.Linear, nn.Embedding)):
                    m.to(self.dtype)

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
        return self.transformer.final_ln(x), kvs

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
        token, per-layer (k, v) [B, H, prefix, hd])."""
        h, kvs = self._backbone(self.embed_prefix(text_tokens, seg_tokens),
                                keep_kv=True)
        return self._logits(h[:, -1:, :])[:, 0], kvs

    def allocate_caches(self, prefill_kv: Sequence, batch: int) -> KVCache:
        """Full-length caches seeded with the prefill's k/v: float caches in
        the compute dtype (``kv_cache_dtype: "compute"``), else the
        quantized prefix in lane caches or, with ``kv_cache_layout:
        "packed"``, in one packed cache per layer.  They are allocated once
        and written in place by ``decode_step``."""
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
        caches = []
        for k, v in prefill_kv:
            pair = []
            for t in (k, v):
                c = QuantCache.empty(batch, cfg.num_attn_heads,
                                     cfg.total_length, cfg.head_dim, bits,
                                     device)
                seeded = quant.quantize_kv(t, bits)
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
        return self._logits(self.transformer.final_ln(x))[:, 0]
