"""VQ-IMG decode side, as ``mas_tpu/models/vqvae.py``.

``VQModel`` holds what ``decode_code`` needs: the codebook, the 1x1
``post_quant_conv`` and the ``Decoder``.  Its ``state_dict`` uses the
reference ``VQBASE`` keys (``decoder.model.{i}.*``, ``post_quant_conv.*``,
``quantize.embedding.weight``), so a JAX tree converted by
``utils/weights.py`` and a ``.pt`` written by the JAX package's
``--mode export`` load with ``strict=True`` once the encode-side keys are
set aside (ROADMAP A7).

Decoder: conv3x3 -> ResnetBlock-Attn-ResnetBlock -> per stage
{(num_res_blocks+1) x ResnetBlock (+Attn)} + Upsample -> GN-swish-conv.
The ``nn.Sequential`` index order replays the reference construction
(``decoder_layout``).  The reference's separate Swish module after
``norm_out`` is fused into ``norm_out`` here, and its index holds an
``nn.Identity`` so the later indices keep their numbers.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from ..utils.config import VQModelConfig
from .codebook import Codebook, lookup
from .layers import AttnBlock, GroupNormSwish, ResnetBlock, Upsample, conv


def compute_dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def decoder_layout(cfg: VQModelConfig) -> List[Tuple[str, str]]:
    """[(kind, JAX module name)] per reference Sequential index."""
    ch_mult = cfg.channels[1:]
    n = len(ch_mult)
    res = cfg.resolution // 2 ** (n - 1)
    plan = [("conv", "conv_in"), ("resnet", "mid_block_1"),
            ("attn", "mid_attn"), ("resnet", "mid_block_2")]
    for i in reversed(range(n)):
        for j in range(cfg.num_res_blocks + 1):
            plan.append(("resnet", f"up_{i}_block_{j}"))
            if res in cfg.attn_resolutions:
                plan.append(("attn", f"up_{i}_attn_{j}"))
        if i > 0:
            plan.append(("up", f"up_{i}_upsample"))
        res *= 2
    plan += [("norm", "norm_out"), ("skip", ""), ("conv", "conv_out")]
    return plan


class Decoder(nn.Module):
    def __init__(self, cfg: VQModelConfig):
        super().__init__()
        ch_mult = cfg.channels[1:]
        block_in = ch_mult[-1]
        stage_out = {f"up_{i}": c for i, c in enumerate(ch_mult)}
        layers = []
        for kind, name in decoder_layout(cfg):
            if kind == "conv" and name == "conv_in":
                layers.append(conv(cfg.z_channels, block_in))
            elif kind == "resnet":
                cout = (block_in if name.startswith("mid")
                        else stage_out[name.rsplit("_block", 1)[0]])
                layers.append(ResnetBlock(block_in, cout))
                block_in = cout
            elif kind == "attn":
                layers.append(AttnBlock(block_in))
            elif kind == "up":
                layers.append(Upsample(block_in))
            elif kind == "norm":
                layers.append(GroupNormSwish(block_in))
            elif kind == "skip":
                layers.append(nn.Identity())
            else:
                layers.append(conv(block_in, cfg.out_channels))
        self.model = nn.Sequential(*layers)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.model(z)


class VQModel(nn.Module):
    """Decode side of VQ-IMG: tokens -> NHWC image."""

    def __init__(self, cfg: VQModelConfig):
        super().__init__()
        if cfg.embed_dim != cfg.codebook.codebook_dim:
            raise ValueError("embed_dim must equal codebook.codebook_dim")
        self.cfg = cfg
        self.dtype = compute_dtype(cfg.compute_dtype)
        self.decoder = Decoder(cfg)
        self.post_quant_conv = conv(cfg.embed_dim, cfg.z_channels, 1)
        self.quantize = Codebook(cfg.codebook.codebook_size,
                                 cfg.codebook.codebook_dim)
        # convs run in the compute dtype; norms and the codebook stay fp32
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m.to(self.dtype)

    def decode_latent(self, z_q: torch.Tensor) -> torch.Tensor:
        """NHWC quantized latent -> NHWC fp32 reconstruction."""
        x = z_q.to(self.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        out = self.decoder(self.post_quant_conv(x))
        return out.float().permute(0, 2, 3, 1).contiguous()

    def decode_code(self, indices: torch.Tensor) -> torch.Tensor:
        """Token indices [B, h, w] -> NHWC fp32 image."""
        return self.decode_latent(
            lookup(indices, self.quantize.embedding.weight))
