"""Hybrid blocks as the stage-2 transformer's layers: LFM2-MoE's and
Granite 4.0-H's.

Port-only blocks (the JAX package has none), built by ``MakeAScene``
when it is given a ``HybridBlockConfig`` or a ``GraniteBlockConfig``
(``utils/config.py``): the same token interface, entry points and decode
loop, with layers of two kinds each.  LFM2 (LiquidAI's ``lfm2_moe``,
``LFM2-8B-A1B``), each layer on the residual x [B, T, D] (kept in fp32):

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

Granite 4.0-H (IBM's ``granitemoehybrid``), each layer on x:

  * h = RMSNorm(x); a Mamba2 layer (``Mamba2``, the scan in
    ``ops/ssm.py``, causal over the prefix too) or GQA without positions
    or q/k norm, scaled by ``attention_multiplier``, under Make-A-Scene's
    mask (``Attention`` given a ``scale``); x += ``residual_multiplier`` y;
  * g = RMSNorm(x); x += ``residual_multiplier`` (routed + shared): the
    experts of the k largest router logits weighted by a softmax over
    them (B12), and a shared SwiGLU expert (``MoE`` with ``score``
    "softmax" and a ``shared`` width);
  * ``MakeAScene`` multiplies the summed embeddings by
    ``embedding_multiplier`` and divides the head's logits by
    ``logits_scaling``.

After the last layer a final RMSNorm (``transformer.final_ln``) and the
Linear head onto the image codes (``to_logits``).  Both blocks' layers
are ``HybridLayer``s, composed by ``lfm2_layer`` and ``granite_layer``
from the pieces above.

Decode state, one a layer (``HybridStack.decode_states``): an attention
layer's k (after its norm and RoPE) and v in the state that
``models/decode_state.py`` chooses (lane caches: B3 writes, B2 reads,
grouped by kv head); a conv layer's ``ConvState``: v of every row at its
last positions in a ring of K slots, fp32, seeded from the prefill and
written in place by each step.  The step reads its position from the
device (the RoPE tables and the ring's slots are gathered at the cache
index), so ``DecodeGraph`` can replay it.  A Mamba2 layer's
``MambaState`` (``models/decode_state.py``): its SSM state [B, H, P, N]
fp32 and a ring of its conv's last K inputs, the prefill's buffers taken
over; each step writes its ring slot and B14 advances the state in place.

Counters: each MoE layer accumulates, on the device, the pairs routed to
each expert, the experts with at least one pair, its calls and the most
pairs one expert had in a call, for full-sequence calls (row 0) and
decode steps (row 1) apart, in a persistent int32 buffer that a replayed
step adds to as well (``MoE.routed``; B12's up launch adds each call's
counts, so they cost no launch of their own; ``MakeAScene.routed_pairs``
stacks them, one read a batch).  No span goes inside a block.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Union

import torch
from torch import nn
from torch.nn import functional as F

from ..ops import attention, moe, ssm
from ..utils.config import (GraniteBlockConfig, HybridBlockConfig,
                            TransformerConfig)
from ..utils.spans import span
from .decode_state import MambaState, kv_state
from .vqvae import compute_dtype

# a full-sequence call (prefill, training forward) routes in row 0 of a
# MoE layer's counters, a decode step in row 1
SEQUENCE, DECODE = 0, 1
# the prefill routes at most this many (token, expert) pairs through B12
# a call (65,536 tokens at LFM2's top-4)
MOE_PAIRS = 262144


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

    def forward(self, h: torch.Tensor, prefix_length: int = 0):
        """h [B, T, D] -> (y [B, T, D], the ring of v [B, K, D] fp32 holding
        positions T - K + 1 .. T - 1); causal over the prefix too."""
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

    def seeded_state(self, ring: torch.Tensor) -> ConvState:
        """The decode state: a copy of the prefill's ring."""
        return ConvState(ring.clone())


class Attention(nn.Module):
    """GQA, query head h reading kv head h // (H / KV), without biases.
    LFM2's (HF ``Lfm2MoeAttention``) RMSNorms q and k over each head's
    dims (``norm_eps``) and rotates them by RoPE (``rope_theta``) at the
    sequence index; Granite's (HF ``GraniteMoeHybridAttention`` at
    ``position_embedding_type`` "nope") does neither and scales the scores
    by ``scale`` (``attention_multiplier``), not 1 / sqrt(d): B1 and B2
    scale by 1 / sqrt(d), so q is multiplied by ``scale`` sqrt(d) in fp32
    before its rounding to the compute dtype."""

    def __init__(self, cfg: TransformerConfig, dt: torch.dtype,
                 norm_eps: Optional[float] = None,
                 rope_theta: Optional[float] = None,
                 scale: Optional[float] = None):
        super().__init__()
        d, hd = cfg.hidden_dim, cfg.head_dim
        self.heads, self.kv_heads, self.head_dim = (cfg.num_attn_heads,
                                                    cfg.kv_heads, hd)
        self.q_proj = Linear(d, self.heads * hd, dt)
        self.k_proj = Linear(d, self.kv_heads * hd, dt)
        self.v_proj = Linear(d, self.kv_heads * hd, dt)
        self.out_proj = Linear(self.heads * hd, d, dt)
        self.qk_norm = norm_eps is not None
        if self.qk_norm:
            self.q_layernorm = RMSNorm(hd, norm_eps)
            self.k_layernorm = RMSNorm(hd, norm_eps)
        self.dt = dt
        self.rotary = rope_theta is not None
        if self.rotary:
            cos, sin = rope_tables(cfg.total_length, hd, rope_theta)
            self.register_buffer("cos", cos, persistent=False)
            self.register_buffer("sin", sin, persistent=False)
        self.q_gain = None if scale is None else scale * math.sqrt(hd)

    def _qkv(self, h, at=None):
        """h [B, T, D] -> q [B, T, H, d], k, v [B, T, KV, d] in the
        compute dtype; where the layer has them, q and k normed and rotated
        at positions 0 .. T - 1, or at the device index ``at`` (a decode
        step), and q times ``q_gain``."""
        b, t, _ = h.shape
        hd = self.head_dim
        q = self.q_proj(h).view(b, t, self.heads, hd)
        k = self.k_proj(h).view(b, t, self.kv_heads, hd)
        v = self.v_proj(h).view(b, t, self.kv_heads, hd)
        if self.qk_norm:
            q, k = self.q_layernorm(q), self.k_layernorm(k)
        if self.rotary:
            if at is None:
                cos, sin = self.cos[:t], self.sin[:t]
            else:
                cos, sin = (self.cos.index_select(0, at),
                            self.sin.index_select(0, at))
            q, k = rope(q, cos, sin), rope(k, cos, sin)
        if self.q_gain is not None:
            q = q.float() * self.q_gain
        return q.to(self.dt), k.to(self.dt), v

    def forward(self, h, prefix_length: int):
        """Over the sequence through B1; returns (y, (k, v) [B, KV, T,
        d])."""
        b, t, _ = h.shape
        q, k, v = (z.transpose(1, 2) for z in self._qkv(h))
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
        q, k, v = self._qkv(h, index.long())
        state.write(k[:, 0], v[:, 0], index)               # [B, KV, d]
        ctx = state.read(q.transpose(1, 2), index)         # [B, H, 1, d]
        return self.out_proj(ctx.reshape(b, 1, -1))

    def seeded_state(self, seed) -> None:
        """None: the stack puts (k, v) in the state ``kv_state`` chooses."""
        return None


class Mamba2(nn.Module):
    """Granite's Mamba2 mixer (HF ``GraniteMoeHybridMambaLayer``, one
    group: ``in_proj``, ``conv1d`` [C, 1, K] with its bias, ``dt_bias``,
    ``A_log``, ``D``, the gated ``norm``, ``out_proj``).  On h [B, T, D]:
    [z | xBC | dt] = h W_in; xBC = silu(causal depthwise conv + bias),
    split into x [H, P], B [N], C [N]; Δ = softplus(dt + dt_bias), A =
    -exp(A_log); the scan of ``ops/ssm.py``; y = RMSNorm(y * silu(z)) over
    the H P channels; y W_out.  The conv, the scan and the gate run in
    fp32 on the compute dtype's projections."""

    def __init__(self, d: int, block: GraniteBlockConfig, dt: torch.dtype):
        super().__init__()
        self.heads, self.head_dim = block.mamba_n_heads, block.mamba_d_head
        self.state_dim = block.mamba_d_state
        self.chunk = block.mamba_chunk_size
        inner, ch = block.mamba_inner, block.conv_channels
        self.in_proj = Linear(d, inner + ch + self.heads, dt)
        self.conv1d = nn.Conv1d(ch, ch, block.mamba_d_conv, groups=ch)
        self.dt_bias = nn.Parameter(torch.zeros(self.heads))
        self.A_log = nn.Parameter(torch.zeros(self.heads))
        self.D = nn.Parameter(torch.ones(self.heads))
        self.norm = RMSNorm(inner, block.rms_norm_eps)
        self.out_proj = Linear(inner, d, dt)

    def _split(self, h):
        """h [..., D] -> (z [..., H P] in the compute dtype, xBC [..., C]
        fp32, Δ [..., H] fp32)."""
        inner = self.heads * self.head_dim
        z, xbc, dt = self.in_proj(h).split(
            [inner, self.conv1d.in_channels, self.heads], dim=-1)
        return z, xbc.float(), F.softplus(dt.float() + self.dt_bias.float())

    def _a(self) -> torch.Tensor:
        return -torch.exp(self.A_log.float())

    def gate_out(self, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """y [..., H P] fp32 gated by silu(z), normed over its H P
        channels and projected back to D."""
        return self.out_proj(self.norm(y * F.silu(z.float())))

    def _rows(self, h):
        """The mixer over a block of rows h [R, T, D] -> (out [R, T, D],
        the state after position T - 1 [R, H, P, N], the conv's ring
        [R, K, C] holding xBC of positions T - K + 1 .. T - 1)."""
        z, xbc, delta = self._split(h)
        w = self.conv1d.weight.float()[:, 0]               # [C, K]
        taps, t = w.shape[1], xbc.shape[1]
        c = xbc * w[:, -1] + self.conv1d.bias.float()
        for j in range(1, min(taps, t)):                   # xBC_{t - j}
            c[:, j:] += xbc[:, :-j] * w[:, -1 - j]
        ring = xbc.new_zeros(xbc.shape[0], taps, xbc.shape[2])
        for p in range(max(t - taps + 1, 0), t):
            ring[:, p % taps] = xbc[:, p]
        c = F.silu(c)
        inner, n = self.heads * self.head_dim, self.state_dim
        x = c[..., :inner].unflatten(-1, (self.heads, self.head_dim))
        y, state = ssm.ssd_chunked(x, delta, self._a(),
                                   c[..., inner:inner + n],
                                   c[..., inner + n:], self.chunk)
        y = y + x * self.D.float()[:, None]
        return self.gate_out(y.flatten(-2), z), state, ring

    def forward(self, h: torch.Tensor, prefix_length: int = 0):
        """h [B, T, D] -> (y [B, T, D], (the SSM state [B, H, P, N], the
        conv ring [B, K, C])), causal over the prefix too, in blocks of
        ``ssm.scan_rows`` rows written into buffers made once, so that no
        block's scan outgrows its bound and no state is held twice."""
        b, t, d = h.shape
        rows = ssm.scan_rows(self.heads, min(self.chunk, t))
        y = h.new_empty(b, t, d, dtype=self.out_proj.compute_dtype)
        state = h.new_empty(b, self.heads, self.head_dim, self.state_dim,
                            dtype=torch.float32)
        ring = h.new_empty(b, self.conv1d.kernel_size[0],
                           self.conv1d.in_channels, dtype=torch.float32)
        for lo in range(0, b, rows):
            y[lo:lo + rows], state[lo:lo + rows], ring[lo:lo + rows] = \
                self._rows(h[lo:lo + rows])
        return y, (state, ring)

    def decode(self, h: torch.Tensor, state: MambaState,
               index: torch.Tensor) -> torch.Tensor:
        """h [B, 1, D] at sequence position ``index`` (a device tensor):
        this token's xBC written into its ring slot, the conv over the
        slots of positions index - K + 1 .. index, then B14 advances the
        state in place."""
        z, xbc, delta = self._split(h[:, 0])
        w = self.conv1d.weight.float()[:, 0]
        taps = w.shape[1]
        at = index.long()
        state.conv.index_copy_(1, at % taps, xbc[:, None])
        back = torch.arange(1 - taps, 1, device=at.device)
        window = state.conv.index_select(1, (at + back) % taps)
        c = F.silu((window * w.t()[None]).sum(dim=1)
                   + self.conv1d.bias.float())
        y = ssm.ssm_update(state.ssm, c, delta, self._a(), self.D.float())
        return self.gate_out(y, z)[:, None]

    def seeded_state(self, seed) -> MambaState:
        """The decode state: the prefill's SSM state and ring, taken
        over."""
        return MambaState(*seed)


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
    """Routed SwiGLU experts through B12; the router ``gate`` [E, D] stays
    fp32.  ``score`` "sigmoid" (HF ``Lfm2MoeSparseMoeBlock``): the top-k
    of sigmoid + ``expert_bias`` [E] (fp32; ``use_expert_bias``), weighted
    by the sigmoid alone, normalized (``norm_topk_prob``) and scaled;
    "softmax" (HF ``GraniteMoeHybridMoE``): the k largest logits weighted
    by a softmax over them, no bias.  A ``shared`` width adds a shared
    SwiGLU expert that every token takes (Granite's ``shared_mlp``)."""

    def __init__(self, d: int, n: int, width: int, block, dt: torch.dtype,
                 score: str = "sigmoid", shared: int = 0):
        super().__init__()
        self.gate = nn.Parameter(torch.empty(n, d).normal_(std=0.02))
        self.score = score
        if score == "sigmoid":
            self.expert_bias = nn.Parameter(torch.zeros(n))
        self.experts = Experts(n, d, width)
        self.shared = SwiGLU(d, shared, dt) if shared else None
        self.block = block
        self.dt = dt
        # [phase, pairs per expert | experts with a pair | calls | the
        # most pairs an expert had], each summed over calls
        self.register_buffer("routed", torch.zeros(2, n + 3,
                                                   dtype=torch.int32),
                             persistent=False)

    def _choose(self, logits: torch.Tensor):
        """Router logits [T, E] -> (experts [T, k], weights [T, k])."""
        blk = self.block
        if self.score == "softmax":
            return moe.route(logits, None, blk.num_experts_per_tok, False,
                             1.0, "softmax")
        bias = self.expert_bias if blk.use_expert_bias else None
        return moe.route(logits, bias, blk.num_experts_per_tok,
                         blk.norm_topk_prob, blk.routed_scaling_factor)

    def _routed(self, g: torch.Tensor, phase: int) -> torch.Tensor:
        idx, w = self._choose(F.linear(g, self.gate.float()))
        e = self.experts
        return moe.expert_swiglu(
            g.to(self.dt), e.w1, e.w3, e.w2,
            moe.group(idx, self.gate.shape[0]), w.contiguous(),
            idx.shape[1], self.routed[phase])

    def forward(self, g: torch.Tensor, phase: int) -> torch.Tensor:
        """g [B, T, D] fp32 -> [B, T, D] fp32; full sequences go through
        B12 ``MOE_PAIRS`` (token, expert) pairs a call."""
        flat = g.reshape(-1, g.shape[-1])
        step = max(1, MOE_PAIRS // self.block.num_experts_per_tok)
        parts = [self._routed(flat[i:i + step], phase)
                 for i in range(0, flat.shape[0], step)]
        out = (parts[0] if len(parts) == 1 else torch.cat(parts)).view(
            g.shape)
        if self.shared is not None:
            out = out + self.shared(g, phase).float()
        return out


class HybridLayer(nn.Module):
    """One layer of either block: a mixer (``mixer_name`` is the module's
    name in the state dict: LFM2's ``conv`` or ``self_attn``, Granite's
    ``mamba`` or ``self_attn``) and a feed-forward (dense or MoE), each
    behind an RMSNorm and a residual add in fp32 that scales the branch's
    output by ``residual`` (1 for LFM2, Granite's ``residual_multiplier``).
    A mixer maps h [B, T, D] to (y, its decode seed), steps with
    ``decode`` and makes its decode state with ``seeded_state``."""

    def __init__(self, d: int, eps: float, mixer_name: str,
                 mixer: nn.Module, feed_forward: nn.Module,
                 residual: float = 1.0):
        super().__init__()
        self.operator_norm = RMSNorm(d, eps)
        self.mixer_name = mixer_name
        self.add_module(mixer_name, mixer)
        self.ffn_norm = RMSNorm(d, eps)
        self.feed_forward = feed_forward
        self.residual = residual

    @property
    def mixer(self) -> nn.Module:
        return getattr(self, self.mixer_name)

    def _add(self, x, y):
        return x.add(y.float(), alpha=self.residual)

    def _ffn(self, x, phase):
        return self._add(x, self.feed_forward(self.ffn_norm(x), phase))

    def forward(self, x, prefix_length: int):
        """x [B, T, D] -> (x fp32, this layer's decode seed)."""
        x = x.float()
        y, seed = self.mixer(self.operator_norm(x), prefix_length)
        return self._ffn(self._add(x, y), SEQUENCE), seed

    def decode(self, x, state, index):
        """x [B, 1, D]; ``state``: the layer's decode state."""
        x = x.float()
        y = self.mixer.decode(self.operator_norm(x), state, index)
        return self._ffn(self._add(x, y), DECODE)

    def seeded_state(self, seed):
        """The mixer's decode state from its prefill seed; None for an
        attention layer, whose (k, v) go to ``kv_state``."""
        return self.mixer.seeded_state(seed)


def lfm2_layer(cfg: TransformerConfig, block: HybridBlockConfig,
               i: int) -> HybridLayer:
    """LFM2's layer ``i``: a gated short conv or GQA with q/k norm and
    RoPE; the first ``num_dense_layers`` with a dense SwiGLU, the others
    with sigmoid-routed experts."""
    dt = compute_dtype(cfg.compute_dtype)
    d = cfg.hidden_dim
    if block.layer_types[i] == "conv":
        name, mixer = "conv", ShortConv(d, block.conv_L_cache, dt)
    else:
        name, mixer = "self_attn", Attention(cfg, dt, block.norm_eps,
                                             block.rope_theta)
    ffn = (SwiGLU(d, block.intermediate_size, dt)
           if i < block.num_dense_layers
           else MoE(d, block.num_experts, block.moe_intermediate_size, block,
                    dt))
    return HybridLayer(d, block.norm_eps, name, mixer, ffn)


def granite_layer(cfg: TransformerConfig, block: GraniteBlockConfig,
                  i: int) -> HybridLayer:
    """Granite's layer ``i`` (HF ``GraniteMoeHybridDecoderLayer``): a
    Mamba2 mixer or NoPE GQA, and softmax-routed experts with a shared
    one, each branch scaled by ``residual_multiplier``."""
    dt = compute_dtype(cfg.compute_dtype)
    d = cfg.hidden_dim
    if block.layer_types[i] == "mamba":
        name, mixer = "mamba", Mamba2(d, block, dt)
    else:
        name, mixer = "self_attn", Attention(
            cfg, dt, scale=block.attention_multiplier)
    ffn = MoE(d, block.num_local_experts, block.intermediate_size, block, dt,
              "softmax", block.shared_intermediate_size)
    return HybridLayer(d, block.rms_norm_eps, name, mixer, ffn,
                       block.residual_multiplier)


class HybridStack(nn.Module):
    """``layers`` and ``final_ln`` (an RMSNorm) under ``transformer.``."""

    def __init__(self, cfg: TransformerConfig,
                 block: Union[HybridBlockConfig, GraniteBlockConfig]):
        super().__init__()
        self.cfg = cfg
        layer, eps = ((granite_layer, block.rms_norm_eps)
                      if isinstance(block, GraniteBlockConfig)
                      else (lfm2_layer, block.norm_eps))
        self.layers = nn.ModuleList(
            [layer(cfg, block, i) for i in range(cfg.num_layers)])
        self.final_ln = RMSNorm(cfg.hidden_dim, eps)

    def decode_states(self, seeds, batch: int) -> list:
        """Each layer's decode state from its prefill seed: a conv or
        Mamba2 layer's own (``seeded_state``), an attention layer's (k, v)
        in the state that ``kv_state`` chooses."""
        with span("state_seed"):
            own = [layer.seeded_state(seed)
                   for layer, seed in zip(self.layers, seeds)]
        return [kv_state(self.cfg, *seed, batch) if state is None else state
                for state, seed in zip(own, seeds)]

    def moe_layers(self):
        return [layer.feed_forward for layer in self.layers
                if isinstance(layer.feed_forward, MoE)]


# modules whose parameters a serving model casts to the compute dtype,
# beside ``nn.Linear`` and ``nn.Embedding``
COMPUTE_MODULES = (nn.Conv1d, Experts)
