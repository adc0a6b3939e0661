"""The port's kernel ids by device kernel name, frozen here so that the
yardstick does not move with the program.

Copied from ``mas_tpu_torch/breakdown.py::_KERNEL_IDS`` (PR 16's tree);
the ids are those of ``PERF.md``'s kernel table.  The first substring
that a kernel's name contains decides its id.
"""

from __future__ import annotations

from typing import Optional

KERNEL_IDS = (("flash_fwd_kernel", "B1"), ("decode_quant_kernel", "B2"),
              ("kv_write_packed_kernel", "B10"),
              ("kv_write_lane_kernel", "B3"),
              ("gn_swish_bwd_kernel", "B8"), ("gn_swish_fwd_kernel", "B4"),
              ("vq_", "B5"), ("flash_bwd_", "B6"),
              ("layer_norm_fwd_kernel", "B7"),
              ("layer_norm_bwd_kernel", "B7"),
              ("decode_float_kernel", "B9"), ("_add_stats_kernel", "B11"))


def kernel_id(name: str) -> Optional[str]:
    return next((kid for sub, kid in KERNEL_IDS if sub in name), None)
