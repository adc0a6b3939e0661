"""Reconstruction-quality evaluation of a VQ model, as ``mas_tpu/eval.py``:

  * ``recon_metrics``: L1, MSE and PSNR of a batch, and LPIPS when an
    LPIPS callable is given;
  * ``codebook_stats``: usage entropy, perplexity, used fraction and the
    largest code share of the tokens;
  * ``fid_from_features`` / ``FIDAccumulator``: the Frechet distance over
    any feature function, streaming float64 sums on the host, the matrix
    square root by scipy on the host (with pytorch-fid's diagonal offset
    where the product is singular and scipy's root is not finite);
  * ``lpips_feature_fn``: the spatially pooled VGG16 taps of an LPIPS
    tower as those features (no Inception weights are bundled);
  * ``evaluate_vq_model``: reconstruct ``n_batches`` and average the
    metrics and codebook stats per batch.

The model runs in eval mode: BN running statistics and ``quantize_eval``,
through B4 (every GroupNorm+swish) and B5 (the nearest code) on the card.
For a seg model the metrics compare the mask with the decoder's logits,
as the JAX package does.  LPIPS runs in fp32 on the fp32 reconstruction.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from .models.codebook import quantize_eval

# diagonal offset of both covariances where the root of their singular
# product is not finite (pytorch-fid's value)
FID_EPS = 1e-6


def recon_metrics(images: torch.Tensor, recon: torch.Tensor,
                  lpips_apply: Optional[Callable] = None
                  ) -> Dict[str, torch.Tensor]:
    """images / recon [B, H, W, C] -> scalar metric dict."""
    x, y = images.float(), recon.float()
    l1 = (x - y).abs().mean()
    mse = (x - y).square().mean()
    psnr = -10.0 * torch.log10(mse.clamp(min=1e-12))
    out = dict(l1=l1, mse=mse, psnr=psnr)
    if lpips_apply is not None:
        out["lpips"] = lpips_apply(x, y).mean()
    return out


def codebook_stats(indices: torch.Tensor,
                   codebook_size: int) -> Dict[str, torch.Tensor]:
    """Token indices [...] -> usage histogram health metrics."""
    counts = torch.bincount(indices.reshape(-1).long(),
                            minlength=codebook_size)
    p = counts.float() / counts.sum().clamp(min=1)
    entropy = -torch.where(p > 0, p * p.log(), torch.zeros_like(p)).sum()
    return dict(perplexity=entropy.exp(), entropy=entropy,
                used_fraction=(counts > 0).float().mean(),
                max_usage=p.max())


def fid_from_features(mu1, sigma1, mu2, sigma2) -> float:
    """Frechet distance between two feature Gaussians (host numpy; the
    matrix square root of the covariance product by scipy, its real part
    taken against numerical imaginary leakage).  A singular product (fewer
    samples than features, or features that never fire) comes back
    non-finite from some scipy versions; then both covariances get
    ``FID_EPS`` on their diagonal for the square root, as pytorch-fid
    does.  Where the
    first root is finite the value is the JAX package's."""
    import scipy.linalg

    mu1, mu2 = np.asarray(mu1), np.asarray(mu2)
    sigma1, sigma2 = np.asarray(sigma1), np.asarray(sigma2)
    diff = mu1 - mu2
    covmean = scipy.linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(len(sigma1)) * FID_EPS
        covmean = scipy.linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * np.trace(covmean))


class FIDAccumulator:
    """Streaming mean and covariance of feature vectors for FID.

    ``feature_fn(images [B, H, W, C]) -> [B, D]``; call ``update`` per
    batch on both the real and the generated stream, then ``fid(other)``.
    """

    def __init__(self, feature_fn: Callable):
        self.feature_fn = feature_fn
        self.n = 0
        self.sum: Optional[np.ndarray] = None
        self.outer: Optional[np.ndarray] = None

    def update(self, images) -> None:
        f = self.feature_fn(images)
        if torch.is_tensor(f):
            f = f.detach().cpu().numpy()
        f = np.asarray(f, np.float64)
        if self.sum is None:
            d = f.shape[1]
            self.sum = np.zeros((d,))
            self.outer = np.zeros((d, d))
        self.n += f.shape[0]
        self.sum += f.sum(axis=0)
        self.outer += f.T @ f

    def stats(self):
        if self.n <= 1:
            raise ValueError(f"FID needs more than one sample, got {self.n}")
        mu = self.sum / self.n
        cov = (self.outer - self.n * np.outer(mu, mu)) / (self.n - 1)
        return mu, cov

    def fid(self, other: "FIDAccumulator") -> float:
        mu1, s1 = self.stats()
        mu2, s2 = other.stats()
        return fid_from_features(mu1, s1, mu2, s2)


def lpips_feature_fn(lpips_model: torch.nn.Module) -> Callable:
    """NHWC images -> [B, 1472] fp32: the spatially pooled VGG16 taps of
    ``lpips_model`` (``losses/lpips.py::LPIPS``) on the raw images, as
    the FID stand-in features."""
    param = next(lpips_model.parameters())

    def features(images) -> torch.Tensor:
        x = torch.as_tensor(images).to(param.device, torch.float32)
        with torch.no_grad():
            taps = lpips_model.vgg(x.permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last))
        return torch.cat([t.float().mean(dim=(2, 3)) for t in taps], dim=-1)

    return features


def eval_step(model, images: torch.Tensor):
    """One eval-mode pass of the VQ model: (fp32 reconstruction, int32
    tokens [B, h, w]).  One encode gives both: the recon of the eval
    forward and the tokens of ``encode_tokens``."""
    model.eval()
    with torch.no_grad():
        z_q, tokens = quantize_eval(model.encode_latent(images),
                                    model.quantize.embedding.weight)
        return model.decode_latent(z_q), tokens


def evaluate_vq_model(model, batches: Iterable[Dict], n_batches: int = 8,
                      lpips_apply: Optional[Callable] = None
                      ) -> Dict[str, float]:
    """Reconstruct ``n_batches`` batches (their ``image``, else their
    ``mask``) and average each metric and codebook stat over them."""
    device = model.quantize.embedding.weight.device
    agg: Dict[str, list] = {}
    for i, batch in enumerate(batches):
        if i >= n_batches:
            break
        images = torch.as_tensor(batch["image"] if "image" in batch
                                 else batch["mask"]).to(device)
        recon, tokens = eval_step(model, images)
        with torch.no_grad():
            m = recon_metrics(images, recon, lpips_apply)
        m.update(codebook_stats(tokens, model.cfg.codebook.codebook_size))
        for k, v in m.items():
            agg.setdefault(k, []).append(float(v))
    return {k: float(np.mean(v)) for k, v in agg.items()}
