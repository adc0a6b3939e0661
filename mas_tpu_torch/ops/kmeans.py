"""Chunked Lloyd k-means for the codebook re-init, as
``mas_tpu/ops/kmeans.py``.

The JAX function is plain jnp (no Pallas kernel), so the distance here is a
``torch.matmul`` per chunk of points; the [N, K] distance matrix is never
built for the whole reservoir.  Per-cluster sums accumulate with
``index_add_`` (``segment_sum`` in JAX); rows past ``n_valid`` go to an
overflow segment K that is dropped, and chunks that hold no valid row are
skipped.  A cluster that receives no point keeps its centroid.

On CUDA ``index_add_`` sums in an order that varies from run to run, so
centroids computed on the card agree with another run only to fp32
rounding.
"""

from __future__ import annotations

from typing import Optional

import torch


def kmeans_init(points: torch.Tensor, generator: torch.Generator,
                n_clusters: int, n_valid: Optional[int] = None
                ) -> torch.Tensor:
    """``n_clusters`` rows drawn without replacement from the first
    ``n_valid`` rows (all rows if None), as fp32 [K, D]: the K smallest of
    uniform scores, with invalid rows scored past every valid one.  With
    fewer valid rows than clusters the picks wrap onto the valid rows."""
    n = points.shape[0]
    nv = max(n if n_valid is None else n_valid, 1)
    score = torch.rand(n, generator=generator, device=points.device)
    score = score + 2.0 * (torch.arange(n, device=points.device) >= nv)
    idx = torch.topk(-score, n_clusters).indices
    idx = torch.where(idx < nv, idx, idx % nv)
    return points[idx].float()


def lloyd(points: torch.Tensor, init: torch.Tensor, iters: int,
          n_valid: Optional[int] = None, chunk: int = 2048) -> torch.Tensor:
    """``iters`` Lloyd iterations from ``init`` [K, D] over the first
    ``n_valid`` rows of ``points`` [N, D] -> fp32 centroids [K, D]."""
    n, d = points.shape
    k = init.shape[0]
    nv = n if n_valid is None else min(n_valid, n)
    pts = points.float()
    pts_sq = pts.square().sum(dim=1, keepdim=True)
    rows = torch.arange(n, device=points.device)
    ones = torch.ones(chunk, device=points.device)
    centroids = init.float()
    for _ in range(iters):
        c_sq = centroids.square().sum(dim=1)
        sums = torch.zeros(k + 1, d, device=points.device)
        counts = torch.zeros(k + 1, device=points.device)
        for start in range(0, nv, chunk):
            p = pts[start:start + chunk]
            dist = pts_sq[start:start + chunk] + c_sq - 2.0 * (p @ centroids.T)
            a = dist.argmin(dim=1)
            a = torch.where(rows[start:start + chunk] < nv, a, k)
            sums.index_add_(0, a, p)
            counts.index_add_(0, a, ones[:len(a)])
        sums, counts = sums[:k], counts[:k, None]
        centroids = torch.where(counts > 0, sums / counts.clamp(min=1.0),
                                centroids)
    return centroids


def kmeans(points: torch.Tensor, generator: torch.Generator, n_clusters: int,
           iters: int = 10, chunk: int = 2048,
           n_valid: Optional[int] = None) -> torch.Tensor:
    """points [N, D] -> fp32 centroids [n_clusters, D]."""
    init = kmeans_init(points, generator, n_clusters, n_valid)
    return lloyd(points, init, iters, n_valid, chunk)
