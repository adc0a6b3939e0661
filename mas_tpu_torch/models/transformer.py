"""MakeAScene autoregressive transformer, serving path (prefill + decode).

Counterpart of ``mas_tpu/models/transformer.py``: token sequence
[text | seg | image]; three token embeddings, text positions and
factorized row/col positions for the seg and image grids; the text pad
remap ``0 -> text_vocab_size - text_length + position``; pre-LN layers
with CogView sandwich LayerNorms and a tanh-GELU MLP; ``to_logits`` =
LayerNorm + Linear.

Attention is the plain masked softmax with fp32 statistics.  CogView's
PB-relax (``cogview_pb_relax``) subtracts an alpha-scaled max, a per-row
constant that softmax cancels exactly, so it is not computed.

Kernels: the full-sequence attention (``__call__`` and ``prefill``) is B1
(``ops/attention.py``); each decode step writes the new token's k/v with B3
(``ops/decode_cache.py``) and reads the int8/int4 caches with B2
(``ops/quant.py``).  CPU tensors take the kernels' plain twins.

Parameters use the reference ``state_dict`` keys
(``transformer.layers.{i}.attn.qkv`` ...), the layout the JAX package's
``utils/torch_export.py`` writes.  Linear and embedding weights are held
in the compute dtype, as flax casts them at use; LayerNorm parameters stay
fp32 and LayerNorm statistics are fp32.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..ops import attention, decode_cache, quant
from ..ops.norms import layer_norm
from ..ops.quant import QuantCache
from ..utils.config import TransformerConfig
from .vqvae import compute_dtype

KVCache = List[Tuple[QuantCache, QuantCache]]


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class SelfAttention(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.qkv = nn.Linear(cfg.hidden_dim, 3 * cfg.hidden_dim)
        self.out_proj = nn.Linear(cfg.hidden_dim, cfg.hidden_dim)

    def _heads(self, x: torch.Tensor):
        """[B, T, D] -> q, k, v views [B, H, T, hd] into the qkv output."""
        cfg = self.cfg
        b, t, _ = x.shape
        qkv = self.qkv(x).view(b, t, 3, cfg.num_attn_heads, cfg.head_dim)
        return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))

    def forward(self, x: torch.Tensor, prefix_length: int):
        """Full-sequence attention; returns (out, (k, v) [B, H, T, hd])."""
        b, t, d = x.shape
        q, k, v = self._heads(x)
        ctx, _ = attention.flash_attention(q, k, v, prefix_length)
        ctx = ctx.transpose(1, 2).reshape(b, t, d)
        return self.out_proj(ctx), (k, v)

    def decode(self, x: torch.Tensor, k_cache: QuantCache,
               v_cache: QuantCache, index: torch.Tensor) -> torch.Tensor:
        """x [B, 1, D]; writes this token's k/v at ``index`` in place, then
        attends over positions <= index."""
        b = x.shape[0]
        q, k, v = self._heads(x)
        decode_cache.write_quant_kv(k_cache, v_cache, k[:, :, 0], v[:, :, 0],
                                    index)
        ctx = quant.decode_attention_quant(q, k_cache, v_cache, index)
        return self.out_proj(ctx.reshape(b, 1, self.cfg.hidden_dim))


class MLP(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.lin1 = nn.Linear(cfg.hidden_dim, 4 * cfg.hidden_dim)
        self.lin2 = nn.Linear(4 * cfg.hidden_dim, cfg.hidden_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin2(F.gelu(self.lin1(x), approximate="tanh"))


class TransformerLayer(nn.Module):
    """Pre-LN block with optional CogView sandwich LayerNorms."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.sandwich = cfg.cogview_sandwich_layernorm
        self.ln_in = LayerNorm(cfg.hidden_dim)
        self.ln_out = LayerNorm(cfg.hidden_dim)
        if self.sandwich:
            self.first_ln_sandwich = LayerNorm(cfg.hidden_dim)
            self.second_ln_sandwich = LayerNorm(cfg.hidden_dim)
        self.attn = SelfAttention(cfg)
        self.mlp = MLP(cfg)

    def _post_attn(self, x, a):
        if self.sandwich:
            a = self.first_ln_sandwich(a)
        x = x + a
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
        self.final_ln = LayerNorm(cfg.hidden_dim)


class MakeAScene(nn.Module):
    """Embeddings + layers + final LN + to_logits (serving path)."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.dtype = compute_dtype(cfg.compute_dtype)
        d = cfg.hidden_dim
        self.image_token_embedding = nn.Embedding(cfg.image_vocab_size, d)
        self.seg_token_embedding = nn.Embedding(cfg.seg_vocab_size, d)
        self.text_token_embedding = nn.Embedding(cfg.text_vocab_size, d)
        self.text_pos_embeddings = nn.Embedding(cfg.text_length, d)
        self.seg_row_embeddings = nn.Embedding(cfg.seg_tokens_per_dim, d)
        self.seg_col_embeddings = nn.Embedding(cfg.seg_tokens_per_dim, d)
        self.image_row_embeddings = nn.Embedding(cfg.image_tokens_per_dim, d)
        self.image_col_embeddings = nn.Embedding(cfg.image_tokens_per_dim, d)
        self.transformer = _Stack(cfg)
        self.to_logits = nn.Sequential(LayerNorm(d),
                                       nn.Linear(d, cfg.image_vocab_size))
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

    def _backbone(self, x: torch.Tensor):
        kvs = []
        for layer in self.transformer.layers:
            x, kv = layer(x, self.cfg.effective_prefix)
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
        h, kvs = self._backbone(self.embed_prefix(text_tokens, seg_tokens))
        return self._logits(h[:, -1:, :])[:, 0], kvs

    def allocate_caches(self, prefill_kv: Sequence, batch: int) -> KVCache:
        """Full-length int8/int4 caches seeded with the quantized prefix.
        They are allocated once and written in place by ``decode_step``."""
        cfg = self.cfg
        cfg.check_decode_cache()
        bits = 4 if cfg.kv_cache_dtype == "int4" else 8
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
