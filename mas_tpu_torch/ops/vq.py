"""Vector quantization: nearest codebook entry (kernel B5) and the
quantize step built on it, as ``mas_tpu/ops/vq.py``.

``vq_argmin`` launches ``csrc/vq_argmin.cu`` for CUDA tensors and its plain
twin ``vq_argmin_plain`` (the counterpart of ``vq_argmin_jnp``) for CPU
tensors.  Inputs are detached, as the JAX package stop-gradients them:
indices carry no gradient.  The gather of the chosen rows is
``F.embedding``, outside the kernel, so the codebook gets its gradient
through it.

Agreement rule between the kernel and the twin.  The kernel drops ||z||^2
(constant per row) and sums each dot product in another order than the
twin's matmul, so the two can pick different codes only where two
distances are within fp32 rounding of each other: indices must agree on
at least 99.9% of rows, and at every row where they differ, the twin's
distance of the kernel's choice must lie within 1e-5 * (||z||^2 + max_k
||e_k||^2) of the twin's minimum (``argmin_agrees``).  Exactly equal
distances resolve to the lower index on both sides.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from .. import _build

MAX_DIM = 256   # the kernel stages two [64, D + 1] fp32 tiles (<= 130 KB)


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
                  got: torch.Tensor, want: torch.Tensor,
                  min_share: float = 0.999) -> bool:
    """The agreement rule of the module docstring: ``got`` and ``want``
    index the same rows, or rows whose distances tie within fp32
    rounding."""
    got, want = got.reshape(-1).long(), want.reshape(-1).long()
    if float((got == want).float().mean()) < min_share:
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
    if n == 0 or codebook.shape[0] == 0 or d > MAX_DIM:
        raise ValueError(f"vq_argmin needs N, K >= 1 and D <= {MAX_DIM}, got "
                         f"N={n}, K={codebook.shape[0]}, D={d}")
    if z.dtype not in (torch.float32, torch.bfloat16) or \
            codebook.dtype != z.dtype:
        raise TypeError(f"z and codebook must share one dtype, fp32 or bf16; "
                        f"got {z.dtype} and {codebook.dtype}")
    if not (z.is_contiguous() and codebook.is_contiguous()):
        raise ValueError("z and codebook must be contiguous")
    if codebook.device != z.device:
        raise ValueError(f"codebook is on {codebook.device}, z on {z.device}")


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
    n, d = z.shape
    cb_sq = codebook.float().square().sum(dim=1)
    out = torch.empty(n, dtype=torch.int32, device=z.device)
    lib = _build.library()
    status = lib.mas_vq_argmin(
        z.data_ptr(), codebook.data_ptr(), cb_sq.data_ptr(), out.data_ptr(),
        n, codebook.shape[0], d, int(z.dtype == torch.bfloat16),
        torch.cuda.current_stream(z.device).cuda_stream)
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
