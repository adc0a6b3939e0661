"""The Mamba2 state-space scan: the prefill's chunked form and the decode
step's state update (kernel B14).

With one group of B and C (``mamba_n_groups`` 1), each head h of P
channels keeps a state S [P, N] that a position t updates and reads:

  S_t = exp(Δ_t,h A_h) S_{t-1} + Δ_t,h x_t,h ⊗ B_t,
  y_t,h = S_t C_t + D_h x_t,h

with Δ > 0 (after the softplus) and A = -exp(A_log) < 0.

The prefill (``ssd_chunked``) takes the dual form of Mamba2's SSD over
chunks of ``chunk`` positions: within a chunk the outputs are one masked
product (C B^T weighted by exp of the segment sums of Δ A, times Δ x),
plus the state entering the chunk read through C; the chunk's end state
is that state decayed over the chunk plus the chunk's own outer products.
Its segment sums are cumulative sums of a masked matrix (Mamba2's
``segsum``), not differences of one cumulative sum, which lose digits
where the sum grows.  Every product is fp32 torch: a [rows, H, chunk,
chunk] tensor a call, so the caller bounds ``rows`` (``scan_rows``).

The decode step (``ssm_update``) advances every row's state in place by
one position: kernel B14 (``csrc/ssm_update.cu``, where its design and
what bounds it are set out), one launch a Mamba2 layer and step that reads
and writes each state once; its plain twin ``ssm_update_plain`` rounds the
state's update as the kernel does (a product, a product, a sum), so the
two states agree bit for bit and y within the order of its sum over N.
B14 replaces no kernel of the JAX package, which has no state-space layer.
A state advanced twice at one position is not the state once advanced:
the decode graph runs each step's body once (``models/decode_graph.py``).
"""

from __future__ import annotations

import torch

from .. import _build

# the bytes of fp32 one [rows, H, chunk, chunk] tensor of a prefill call
# may take (``scan_rows``)
SCAN_BYTES = 1 << 29


def scan_rows(heads: int, chunk: int) -> int:
    """Rows a call of ``ssd_chunked`` takes so that a [rows, heads,
    chunk, chunk] fp32 tensor stays within ``SCAN_BYTES``."""
    return max(1, SCAN_BYTES // (heads * chunk * chunk * 4))


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a [..., L] -> [..., L, L]: at [t, s] the sum of a over s < u <= t
    where s <= t, -inf above the diagonal."""
    n = a.shape[-1]
    on_or_below = torch.ones(n, n, dtype=torch.bool, device=a.device).tril()
    below = on_or_below.tril(-1)
    seg = a[..., :, None].expand(*a.shape, n).masked_fill(~below, 0.0)
    return seg.cumsum(dim=-2).masked_fill_(~on_or_below, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, chunk: int):
    """The scan from a zero state over a whole sequence, without the D
    skip: x [R, T, H, P], Δ ``dt`` [R, T, H], A ``a`` [H], B and C [R, T,
    N], all fp32 -> (y [R, T, H, P], the state after position T - 1 [R,
    H, P, N])."""
    r, t, h, p = x.shape
    state = x.new_zeros(r, h, p, b.shape[-1])
    ys = []
    for lo in range(0, t, chunk):
        hi = min(lo + chunk, t)
        dtc = dt[:, lo:hi].transpose(1, 2)                  # [R, H, L]
        xdt = x[:, lo:hi].transpose(1, 2) * dtc[..., None]  # Δ x [R, H, L, P]
        bc, cc = b[:, lo:hi], c[:, lo:hi]                   # [R, L, N]
        da = dtc * a[:, None]
        cum = da.cumsum(dim=-1)
        m = _segsum(da).exp_()                              # [R, H, L, L]
        m.mul_(torch.matmul(cc, bc.transpose(1, 2))[:, None])
        y = torch.matmul(m, xdt)
        del m
        y += cum.exp()[..., None] * torch.matmul(
            cc[:, None], state.transpose(-1, -2))
        to_end = (cum[..., -1:] - cum).exp()                # [R, H, L]
        state = (cum[..., -1, None, None].exp() * state
                 + torch.matmul((xdt * to_end[..., None]).transpose(-1, -2),
                                bc[:, None]))
        ys.append(y.transpose(1, 2))
    return torch.cat(ys, dim=1), state


def _split(xbc: torch.Tensor, heads: int, head_dim: int, n: int):
    inner = heads * head_dim
    return (xbc[:, :inner].view(-1, heads, head_dim), xbc[:, inner:inner + n],
            xbc[:, inner + n:])


def ssm_update_plain(state: torch.Tensor, xbc: torch.Tensor,
                     dt: torch.Tensor, a: torch.Tensor,
                     d: torch.Tensor) -> torch.Tensor:
    """Plain twin of B14: the state [R, H, P, N] fp32 advanced in place by
    one position of x, B, C (``xbc`` [R, H P + 2 N] fp32, in that order),
    Δ ``dt`` [R, H], A ``a`` [H] and D ``d`` [H], all fp32 -> y [R, H P]
    fp32."""
    r, h, p, n = state.shape
    x, b, c = _split(xbc, h, p, n)
    decay = torch.exp(dt * a)
    state.mul_(decay[..., None, None]).add_(
        (dt[..., None] * x)[..., None] * b[:, None, None, :])
    y = (state * c[:, None, None, :]).sum(dim=-1) + d[:, None] * x
    return y.reshape(r, h * p)


def _check(state, xbc, dt, a, d):
    if state.dim() != 4:
        raise ValueError(f"state must be [R, H, P, N], got "
                         f"{tuple(state.shape)}")
    r, h, p, n = state.shape
    want = {"xbc": (r, h * p + 2 * n), "dt": (r, h), "a": (h,), "d": (h,)}
    for name, t in (("xbc", xbc), ("dt", dt), ("a", a), ("d", d)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {list(want[name])}, got "
                             f"{list(t.shape)}")
    tensors = (state, xbc, dt, a, d)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("B14 takes fp32 state, x/B/C, Δ, A and D")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("B14's inputs must be contiguous")
    if any(t.device != state.device for t in tensors):
        raise ValueError("B14's inputs must share a device")
    if n % 4 or state.data_ptr() % 16 or xbc.data_ptr() % 16 or (
            h * p) % 4:
        raise ValueError(f"B14 reads the state and B, C as float4: N "
                         f"({n}) and H P must be multiples of 4, the data "
                         f"16-byte aligned")
    if n > 128 or r > 65535:
        raise ValueError(f"B14 takes N <= 128 (a float4 a lane) and at most "
                         f"65,535 rows, got N {n}, {r} rows")


def ssm_update(state: torch.Tensor, xbc: torch.Tensor, dt: torch.Tensor,
               a: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """One decode position of the scan, the state advanced in place
    (arguments as ``ssm_update_plain``) -> y [R, H P] fp32.  Kernel B14
    for CUDA tensors, the plain twin for CPU tensors."""
    if state.device.type == "cpu":
        return ssm_update_plain(state, xbc, dt, a, d)
    if state.device.type != "cuda":
        raise ValueError(f"ssm_update runs on cpu or cuda, got "
                         f"{state.device}")
    _check(state, xbc, dt, a, d)
    r, h, p, n = state.shape
    y = torch.empty(r, h * p, dtype=torch.float32, device=state.device)
    status = _build.library().mas_ssm_update(
        state.data_ptr(), xbc.data_ptr(), dt.data_ptr(), a.data_ptr(),
        d.data_ptr(), y.data_ptr(), r, h, p, n,
        _build.stream(state.device.index))
    _build.check(status, "ssm_update")
    ssm_update.launches += 1
    return y


ssm_update.launches = 0
