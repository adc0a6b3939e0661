"""The benchmark of ``mas_tpu_torch`` on one NVIDIA H100: see README.md."""
