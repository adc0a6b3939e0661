"""LFM2-MoE's hybrid block as the stage-2 transformer's layers.

A port-only block (the JAX package has none), built by ``MakeAScene``
when it is given a ``HybridBlockConfig`` (``utils/config.py``): the same
token interface, entry points and decode loop, with layers of two kinds
(LiquidAI's ``lfm2_moe``, ``LFM2-8B-A1B``).  Each layer, on the residual
x [B, T, D] (kept in fp32):

  * h = RMSNorm(x) (fp32 statistics, eps ``norm_eps``), in the compute
    dtype for the products;
  * conv layer: [B | C | u] = h W_in (3D wide, no bias); v = B * u; c_t =
    sum_j k_j v_{t-K+1+j}, depthwise and causal (v before the sequence is
    0), in fp32; y = (C * c) W_out;
  * attention layer: q, k, v = h W_q, h W_k, h W_v (no biases); q and k
    RMSNormed over each head's dims; RoPE (rotate-half, ``rope_theta``)
    at the sequence index; query head h reads kv head h // (H / KV),
    scale 1 / sqrt(d), under Make-A-Scene's mask (bidirectional over the
    prefix, causal after it); y = ctx W_o;
  * x += y; g = RMSNorm(x); the first ``num_dense_layers`` layers add
    W2 (silu(g W1) * g W3), the others the routed experts
    (``ops/moe.py``): router logits g W_r from the fp32 g and an fp32
    W_r, top-k of sigmoid + ``expert_bias``, weights from the sigmoid
    alone, normalized, then B12.

After the last layer a final RMSNorm (``transformer.final_ln``) and the
Linear head onto the image codes (``to_logits``).

Decode state, one a layer (``HybridStack.decode_states``): an attention
layer's k (after its norm and RoPE) and v in the state that
``models/decode_state.py`` chooses (lane caches: B3 writes, B2 reads,
grouped by kv head); a conv layer's ``ConvState``: v of every row at its
last positions in a ring of K slots, fp32, seeded from the prefill and
written in place by each step.  The step reads its position from the
device (the RoPE tables and the ring's slots are gathered at the cache
index), so ``DecodeGraph`` can replay it.

Counters: each MoE layer accumulates, on the device, the pairs routed to
each expert, the experts with at least one pair, its calls and the most
pairs one expert had in a call, for full-sequence calls (row 0) and
decode steps (row 1) apart, in a persistent int32 buffer that a replayed
step adds to as well (``MoE.routed``; B12's up launch adds each call's
counts, so they cost no launch of their own; ``MakeAScene.routed_pairs``
stacks them, one read a batch).  No span goes inside a block.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.nn import functional as F

from ..ops import attention, moe
from ..utils.config import HybridBlockConfig, TransformerConfig
from ..utils.spans import span
from .decode_state import kv_state
from .vqvae import compute_dtype

# a full-sequence call (prefill, training forward) routes in row 0 of a
# MoE layer's counters, a decode step in row 1
SEQUENCE, DECODE = 0, 1
# the prefill routes at most this many tokens through B12 a call
MOE_CHUNK = 65536


@dataclass
class ConvState:
    """A conv layer's decode state: a ring of K slots [B, K, D] fp32, v of
    position p in slot p % K.  A step at position t writes slot t % K and
    reads slots t - K + 1 .. t, so running it twice at one position (the
    warm-up before a capture) leaves the same state."""
    data: torch.Tensor

    def tensors(self):
        return (self.data,)


class Linear(nn.Linear):
    """A bias-free ``nn.Linear`` computing in ``compute_dtype``."""

    def __init__(self, d_in: int, d_out: int, compute_dtype: torch.dtype):
        super().__init__(d_in, d_out, bias=False)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt))


class RMSNorm(nn.Module):
    """z / sqrt(mean(z^2) + eps) * w over the last dim, fp32 in and out;
    the weight stays fp32."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        z = z.float()
        return z * torch.rsqrt(z.square().mean(-1, keepdim=True) + self.eps) \
            * self.weight.float()


def rope_tables(length: int, head_dim: int, theta: float, device=None):
    """cos and sin [length, head_dim] fp32 of rotate-half RoPE at positions
    0 .. length - 1."""
    inv = 1.0 / theta ** (torch.arange(0, head_dim, 2, device=device,
                                       dtype=torch.float64) / head_dim)
    ang = torch.arange(length, device=device, dtype=torch.float64)[:, None] \
        * inv[None, :]
    ang = torch.cat([ang, ang], dim=-1)
    return ang.cos().float(), ang.sin().float()


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [..., T, H, d] fp32 rotated at the positions of cos, sin [T, d]."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[:, None] + rot * sin[:, None]


class ShortConv(nn.Module):
    """The gated short convolution (HF ``Lfm2MoeShortConv``: ``in_proj``,
    ``conv`` [D, 1, K], ``out_proj``)."""

    def __init__(self, d: int, kernel: int, dt: torch.dtype):
        super().__init__()
        self.in_proj = Linear(d, 3 * d, dt)
        self.conv = nn.Conv1d(d, d, kernel, groups=d, bias=False)
        self.out_proj = Linear(d, d, dt)

    def _gates(self, h):
        b, c, u = self.in_proj(h).float().chunk(3, dim=-1)
        return b * u, c

    def forward(self, h: torch.Tensor):
        """h [B, T, D] -> (y [B, T, D], the ring of v [B, K, D] fp32 holding
        positions T - K + 1 .. T - 1)."""
        v, c_gate = self._gates(h)
        k = self.conv.weight.float()[:, 0]                 # [D, K]
        taps, t = k.shape[1], v.shape[1]
        c = v * k[:, -1]
        for j in range(1, min(taps, t)):                   # v_{t - j}
            c[:, j:] += v[:, :-j] * k[:, -1 - j]
        ring = v.new_zeros(v.shape[0], taps, v.shape[2])
        for p in range(max(t - taps + 1, 0), t):
            ring[:, p % taps] = v[:, p]
        return self.out_proj(c_gate * c), ring

    def decode(self, h: torch.Tensor, state: ConvState,
               index: torch.Tensor) -> torch.Tensor:
        """h [B, 1, D] at sequence position ``index`` (a device tensor):
        this token's v written into its slot, then the conv over the
        slots of positions index - K + 1 .. index."""
        v, c_gate = self._gates(h)
        k = self.conv.weight.float()[:, 0]
        taps = k.shape[1]
        at = index.long()
        state.data.index_copy_(1, at % taps, v)
        back = torch.arange(1 - taps, 1, device=at.device)
        window = state.data.index_select(1, (at + back) % taps)
        c = (window * k.t()[None]).sum(dim=1, keepdim=True)
        return self.out_proj(c_gate * c)


class Attention(nn.Module):
    """GQA with q/k RMSNorm and RoPE (HF ``Lfm2MoeAttention``)."""

    def __init__(self, cfg: TransformerConfig, block: HybridBlockConfig,
                 dt: torch.dtype):
        super().__init__()
        d, hd = cfg.hidden_dim, cfg.head_dim
        self.heads, self.kv_heads, self.head_dim = (cfg.num_attn_heads,
                                                    cfg.kv_heads, hd)
        self.q_proj = Linear(d, self.heads * hd, dt)
        self.k_proj = Linear(d, self.kv_heads * hd, dt)
        self.v_proj = Linear(d, self.kv_heads * hd, dt)
        self.out_proj = Linear(self.heads * hd, d, dt)
        self.q_layernorm = RMSNorm(hd, block.norm_eps)
        self.k_layernorm = RMSNorm(hd, block.norm_eps)
        self.dt = dt
        cos, sin = rope_tables(cfg.total_length, hd, block.rope_theta)
        self.register_buffer("cos", cos, persistent=False)
        self.register_buffer("sin", sin, persistent=False)

    def _qkv(self, h, cos, sin):
        """h [B, T, D] -> q [B, T, H, d], k, v [B, T, KV, d] in the
        compute dtype, q and k normed and rotated at the positions of cos,
        sin [T, d]."""
        b, t, _ = h.shape
        hd = self.head_dim
        q = self.q_layernorm(self.q_proj(h).view(b, t, self.heads, hd))
        k = self.k_layernorm(self.k_proj(h).view(b, t, self.kv_heads, hd))
        v = self.v_proj(h).view(b, t, self.kv_heads, hd)
        return (rope(q, cos, sin).to(self.dt), rope(k, cos, sin).to(self.dt),
                v)

    def forward(self, h, prefix_length: int):
        """Over the sequence through B1; returns (y, (k, v) [B, KV, T,
        d])."""
        b, t, _ = h.shape
        q, k, v = (z.transpose(1, 2)
                   for z in self._qkv(h, self.cos[:t], self.sin[:t]))
        g = self.heads // self.kv_heads
        ctx = attention.FlashAttentionQKVFunction.apply(
            q, k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1),
            prefix_length)
        y = self.out_proj(ctx.transpose(1, 2).reshape(b, t, -1))
        return y, (k, v)

    def decode(self, h, state, index):
        """h [B, 1, D]: this token's k, v written at ``index`` of the
        layer's state (the RoPE tables gathered there on the device), then
        the read over positions <= index."""
        b = h.shape[0]
        at = index.long()
        q, k, v = self._qkv(h, self.cos.index_select(0, at),
                            self.sin.index_select(0, at))
        state.write(k[:, 0], v[:, 0], index)               # [B, KV, d]
        ctx = state.read(q.transpose(1, 2), index)         # [B, H, 1, d]
        return self.out_proj(ctx.reshape(b, 1, -1))


class SwiGLU(nn.Module):
    """The dense feed-forward W2 (silu(g W1) * g W3) (HF
    ``Lfm2MoeMLP``)."""

    def __init__(self, d: int, width: int, dt: torch.dtype):
        super().__init__()
        self.w1 = Linear(d, width, dt)
        self.w3 = Linear(d, width, dt)
        self.w2 = Linear(width, d, dt)

    def forward(self, g: torch.Tensor, phase: int) -> torch.Tensor:
        return self.w2(F.silu(self.w1(g)) * self.w3(g))


class Experts(nn.Module):
    """The experts' stacked weights, in the compute dtype: w1, w3 [E, F,
    D], w2 [E, D, F]."""

    def __init__(self, n: int, d: int, width: int):
        super().__init__()
        self.w1 = nn.Parameter(torch.empty(n, width, d))
        self.w3 = nn.Parameter(torch.empty(n, width, d))
        self.w2 = nn.Parameter(torch.empty(n, d, width))
        for w in (self.w1, self.w3, self.w2):
            nn.init.normal_(w, std=0.02)


class MoE(nn.Module):
    """Routed SwiGLU experts (HF ``Lfm2MoeSparseMoeBlock``); the router
    ``gate`` [E, D] and ``expert_bias`` [E] stay fp32."""

    def __init__(self, d: int, block: HybridBlockConfig, dt: torch.dtype):
        super().__init__()
        n = block.num_experts
        self.gate = nn.Parameter(torch.empty(n, d).normal_(std=0.02))
        self.expert_bias = nn.Parameter(torch.zeros(n))
        self.experts = Experts(n, d, block.moe_intermediate_size)
        self.block = block
        self.dt = dt
        # [phase, pairs per expert | experts with a pair | calls | the
        # most pairs an expert had], each summed over calls
        self.register_buffer("routed", torch.zeros(2, n + 3,
                                                   dtype=torch.int32),
                             persistent=False)

    def _routed(self, g: torch.Tensor, phase: int) -> torch.Tensor:
        blk = self.block
        logits = F.linear(g, self.gate.float())
        bias = self.expert_bias if blk.use_expert_bias else None
        idx, w = moe.route(logits, bias, blk.num_experts_per_tok,
                           blk.norm_topk_prob, blk.routed_scaling_factor)
        e = self.experts
        return moe.expert_swiglu(
            g.to(self.dt), e.w1, e.w3, e.w2, moe.group(idx, blk.num_experts),
            w.contiguous(), blk.num_experts_per_tok, self.routed[phase])

    def forward(self, g: torch.Tensor, phase: int) -> torch.Tensor:
        """g [B, T, D] fp32 -> [B, T, D] fp32; full sequences go through
        B12 ``MOE_CHUNK`` tokens a call."""
        flat = g.reshape(-1, g.shape[-1])
        parts = [self._routed(flat[i:i + MOE_CHUNK], phase)
                 for i in range(0, flat.shape[0], MOE_CHUNK)]
        return (parts[0] if len(parts) == 1 else torch.cat(parts)).view(
            g.shape)


class HybridLayer(nn.Module):
    """One layer: operator (conv or attention) and feed-forward (dense or
    MoE), each behind an RMSNorm and a residual add in fp32."""

    def __init__(self, cfg: TransformerConfig, block: HybridBlockConfig,
                 i: int):
        super().__init__()
        dt = compute_dtype(cfg.compute_dtype)
        d, eps = cfg.hidden_dim, block.norm_eps
        self.is_conv = block.layer_types[i] == "conv"
        self.operator_norm = RMSNorm(d, eps)
        if self.is_conv:
            self.conv = ShortConv(d, block.conv_L_cache, dt)
        else:
            self.self_attn = Attention(cfg, block, dt)
        self.ffn_norm = RMSNorm(d, eps)
        self.feed_forward = (SwiGLU(d, block.intermediate_size, dt)
                             if i < block.num_dense_layers
                             else MoE(d, block, dt))

    def _ffn(self, x, phase):
        return x + self.feed_forward(self.ffn_norm(x), phase).float()

    def forward(self, x, prefix_length: int):
        """x [B, T, D] -> (x fp32, this layer's decode seed: the conv state
        or (k, v))."""
        x = x.float()
        h = self.operator_norm(x)
        if self.is_conv:
            y, seed = self.conv(h)
        else:
            y, seed = self.self_attn(h, prefix_length)
        return self._ffn(x + y.float(), SEQUENCE), seed

    def decode(self, x, state, index):
        """x [B, 1, D]; ``state``: the conv state or the attention layer's
        decode state."""
        x = x.float()
        h = self.operator_norm(x)
        y = (self.conv.decode(h, state, index) if self.is_conv
             else self.self_attn.decode(h, state, index))
        return self._ffn(x + y.float(), DECODE)


class HybridStack(nn.Module):
    """``layers`` and ``final_ln`` (an RMSNorm) under ``transformer.``."""

    def __init__(self, cfg: TransformerConfig, block: HybridBlockConfig):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(
            [HybridLayer(cfg, block, i) for i in range(cfg.num_layers)])
        self.final_ln = RMSNorm(cfg.hidden_dim, block.norm_eps)

    def decode_states(self, seeds, batch: int) -> list:
        """Each layer's decode state from its prefill seed: a copy of a
        conv layer's ring of v, or an attention layer's (k, v)."""
        with span("state_seed"):
            rings = {i: ConvState(seed.clone()) for i, seed in
                     enumerate(seeds) if self.layers[i].is_conv}
        return [rings[i] if i in rings else kv_state(self.cfg, *seed, batch)
                for i, seed in enumerate(seeds)]

    def moe_layers(self):
        return [layer.feed_forward for layer in self.layers
                if isinstance(layer.feed_forward, MoE)]


# modules whose parameters a serving model casts to the compute dtype,
# beside ``nn.Linear`` and ``nn.Embedding``
COMPUTE_MODULES = (nn.Conv1d, Experts)
