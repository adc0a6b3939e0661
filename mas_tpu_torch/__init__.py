"""mas_tpu_torch: the Make-A-Scene serving path in PyTorch for NVIDIA
Hopper, held against the JAX package ``mas_tpu``.

Slice ported so far: text+seg -> 256^2 image sampling (``models.sampler.
sample_images``, CLI ``python -m mas_tpu_torch.cli``).  Four hand-written
kernels carry it on CUDA: B1 prefix-causal attention forward
(``csrc/flash_fwd.cu``), B2 quantized decode attention
(``csrc/decode_quant.cu``), B3 quantize-and-write of the decode caches
(Triton, ``ops/decode_cache.py``) and B4 GroupNorm+swish (Triton,
``ops/gn_swish.py``).  CPU tensors take each kernel's plain twin.

This package imports torch and numpy, never jax.
"""
