"""mas_tpu_torch: Make-A-Scene in PyTorch for NVIDIA Hopper, held against
the JAX package ``mas_tpu``.

Slices ported so far:
  * text+seg -> 256^2 image sampling (``models.sampler.sample_images``,
    ``python -m mas_tpu_torch.cli --mode sample``);
  * VQ tokenization (``models.vqvae.VQModel.encode_tokens``) and VQ-SEG
    training (``train.loop.run_pretrain_segmentation``,
    ``--mode pretrain_segmentation``).
Six hand-written kernels carry them on CUDA: B1 prefix-causal attention
forward (``csrc/flash_fwd.cu``), B2 quantized decode attention
(``csrc/decode_quant.cu``), B3 quantize-and-write of the decode caches
(Triton, ``ops/decode_cache.py``), B4 GroupNorm+swish forward and B8 its
backward (Triton, ``ops/gn_swish.py``), and B5 the VQ nearest-code argmin
(``csrc/vq_argmin.cu``).  CPU tensors take each kernel's plain twin.

This package imports torch and numpy, never jax.
"""
