"""Vector quantization: nearest codebook entry (kernel B5) and the
quantize step built on it, as ``mas_tpu/ops/vq.py``.

``vq_argmin`` launches ``csrc/vq_argmin.cu`` for CUDA tensors and its plain
twin ``vq_argmin_plain`` (the counterpart of ``vq_argmin_jnp``) for CPU
tensors.  On the card, bf16 inputs run on the tensor cores (bf16 products,
exact in fp32, summed in fp32) and fp32 inputs keep fp32 products on the
CUDA cores; any code width D (bf16 rows are zero-padded to a multiple of 8
values where D is not one, which changes no distance).  Inputs are detached, as the JAX package stop-gradients them:
indices carry no gradient.  The gather of the chosen rows is
``F.embedding``, outside the kernel, so the codebook gets its gradient
through it.

Agreement rule between the kernel and the twin (``argmin_agrees``).  The
kernel drops ||z||^2 (constant per row) and sums each dot product in
another order than the twin's matmul, so the two can pick different codes
only where two distances are within fp32 rounding of each other:
  * at every row where they differ, the twin's distance of the kernel's
    choice lies within 1e-5 * (||z||^2 + max_k ||e_k||^2) of the twin's
    minimum;
  * every chosen code is the first of the codebook rows bitwise equal to
    it: exactly equal distances resolve to the lower index.
The number of differing rows is not bounded beyond that.  A trained
codebook holds exact duplicates (k-means seeds drawn from a reservoir
sampled with replacement) and a few rows of latents whose two nearest
codes differ by less than that rounding; at seg training size (512 rows)
even one such row flipping is 0.2% of them, so a share floor would turn
a legitimate near-tie into a failure.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from .. import _build

_SMS = {}       # SM count by device, after the kernel's set-up there
_SCRATCH = {}   # scratch floats by (device, N, K, D, bf16)


def vq_distances(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """fp32 [N, K] squared distances ||z||^2 + ||e||^2 - 2 z.e."""
    zf, cf = z.float(), codebook.float()
    return (zf.square().sum(dim=1, keepdim=True) + cf.square().sum(dim=1)
            - 2.0 * (zf @ cf.T))


def vq_argmin_plain(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Plain twin: z [N, D], codebook [K, D] -> int32 [N]; the first index
    wins on equal distances, as ``torch.argmin`` and ``jnp.argmin``."""
    return vq_distances(z.detach(), codebook.detach()).argmin(dim=1).to(
        torch.int32)


def argmin_agrees(z: torch.Tensor, codebook: torch.Tensor,
                  got: torch.Tensor, want: torch.Tensor) -> bool:
    """The agreement rule of the module docstring: ``got`` picks the
    first of equal codebook rows, and indexes the same rows as ``want`` or
    rows whose distances tie with them within fp32 rounding."""
    got, want = got.reshape(-1).long(), want.reshape(-1).long()
    _, copy_of = torch.unique(codebook, dim=0, return_inverse=True)
    first = torch.full((int(copy_of.max()) + 1,), len(copy_of),
                       dtype=torch.long, device=copy_of.device)
    first.scatter_reduce_(0, copy_of, torch.arange(
        len(copy_of), device=copy_of.device), reduce="amin")
    if not bool((first[copy_of[got]] == got).all()):
        return False
    diff = (got != want).nonzero().reshape(-1)
    if not len(diff):
        return True
    dist = vq_distances(z[diff], codebook)
    scale = (z[diff].float().square().sum(dim=1)
             + codebook.float().square().sum(dim=1).max())
    gap = dist.gather(1, got[diff, None])[:, 0] - dist.min(dim=1).values
    return bool((gap <= 1e-5 * scale).all())


def _check(z, codebook):
    if z.dim() != 2 or codebook.dim() != 2 or z.shape[1] != codebook.shape[1]:
        raise ValueError(f"z must be [N, D] and codebook [K, D], got "
                         f"{tuple(z.shape)} and {tuple(codebook.shape)}")
    n, d = z.shape
    if n == 0 or codebook.shape[0] == 0 or d == 0:
        raise ValueError(f"vq_argmin needs N, K and D >= 1, got N={n}, "
                         f"K={codebook.shape[0]}, D={d}")
    if z.dtype not in (torch.float32, torch.bfloat16) or \
            codebook.dtype != z.dtype:
        raise TypeError(f"z and codebook must share one dtype, fp32 or bf16; "
                        f"got {z.dtype} and {codebook.dtype}")
    if not (z.is_contiguous() and codebook.is_contiguous()):
        raise ValueError("z and codebook must be contiguous")
    if codebook.device != z.device:
        raise ValueError(f"codebook is on {codebook.device}, z on {z.device}")


def _padded(t: torch.Tensor) -> torch.Tensor:
    """A fresh (16-byte aligned) copy of t with zero columns up to a
    multiple of 8: the bf16 kernel loads rows in 16-byte pieces."""
    width = -(-t.shape[1] // 8) * 8
    out = t.new_zeros(t.shape[0], width)
    out[:, :t.shape[1]] = t
    return out


def vq_argmin(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest-codebook-entry indices: z [N, D], codebook [K, D] (same
    dtype) -> int32 [N].  Kernel B5 for CUDA tensors, plain twin for CPU
    tensors."""
    z, codebook = z.detach(), codebook.detach()
    if z.device.type == "cpu":
        return vq_argmin_plain(z, codebook)
    if z.device.type != "cuda":
        raise ValueError(f"vq_argmin runs on cpu or cuda, got {z.device}")
    _check(z, codebook)
    bf16 = int(z.dtype == torch.bfloat16)
    if bf16 and (z.shape[1] % 8 or z.data_ptr() % 16
                 or codebook.data_ptr() % 16):
        z, codebook = _padded(z), _padded(codebook)
    (n, d), k = z.shape, codebook.shape[0]
    dev = z.get_device()
    lib = _build.library()
    sms = _SMS.get(dev)
    if sms is None:
        sms = _SMS[dev] = lib.mas_vq_argmin_prepare(dev)
        if sms < 1:
            raise RuntimeError(f"vq_argmin: set-up failed on cuda:{dev}")
    key = (dev, n, k, d, bf16)
    floats = _SCRATCH.get(key)
    if floats is None:
        floats = _SCRATCH[key] = lib.mas_vq_argmin_scratch(n, k, d, bf16, sms)
    scratch = torch.empty(floats, dtype=torch.float32, device=z.device)
    out = torch.empty(n, dtype=torch.int32, device=z.device)
    status = lib.mas_vq_argmin(
        z.data_ptr(), codebook.data_ptr(), scratch.data_ptr(), out.data_ptr(),
        n, k, d, bf16, sms, _build.stream(dev))
    _build.check(status, "vq_argmin")
    vq_argmin.launches += 1
    return out


vq_argmin.launches = 0


def vq_quantize(z: torch.Tensor, codebook: torch.Tensor):
    """z [..., D] -> (z_q [..., D] rows of ``codebook``, int32 indices
    [...]).  The gather is differentiable w.r.t. ``codebook``."""
    lead = z.shape[:-1]
    idx = vq_argmin(z.reshape(-1, z.shape[-1]).contiguous(), codebook)
    z_q = F.embedding(idx.long(), codebook)
    return z_q.reshape(*lead, codebook.shape[-1]), idx.reshape(lead)
