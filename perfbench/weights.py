"""Seeded weights, made on the device in one large draw.

A spec lists (name, shape, mean, std, role).  One normal draw from a
generator on the device covers every tensor of the spec; each tensor is
its slice, scaled and shifted, in the dtype its role is given.  The same
seed and spec give the same tensors, so the program's weights and the
reference's are made twice from the seed rather than kept.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for one use of the run's seed."""
    state = np.random.SeedSequence([seed % 2 ** 64, *path]).generate_state(
        2, np.uint32)
    return int(state[0]) << 31 | int(state[1]) >> 1


def make(spec, seed: int, device, dtypes: Dict[str, torch.dtype]
         ) -> Dict[str, torch.Tensor]:
    total = sum(int(np.prod(shape)) for _, shape, *_ in spec)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, mean, std, role in spec:
        n = int(np.prod(shape))
        t = flat[at:at + n].view(shape)
        out[name] = (t * std + mean).to(dtypes[role])
        at += n
    return out
