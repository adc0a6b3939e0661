"""mas_tpu_torch: Make-A-Scene in PyTorch for NVIDIA Hopper, held against
the JAX package ``mas_tpu``.

Slices ported so far:
  * text+seg -> image sampling at 256^2 and 512^2 over float, int8/int4
    lane and int8/int4 packed KV caches (``models.sampler.sample_images``,
    ``python -m mas_tpu_torch.cli --mode sample``);
  * VQ tokenization (``models.vqvae.VQModel.encode_tokens``) and VQ-SEG
    training (``train.loop.run_pretrain_segmentation``,
    ``--mode pretrain_segmentation``);
  * transformer training (``train.loop.run_train_transformer``,
    ``--mode train_transformer``), on synthetic tokens or on processed
    tar shards tokenized by both VQ encoders (``train.loop.
    tokenize_batches``);
  * VQ-IMG (VQGAN) training (``--mode pretrain_image``), VQ eval, show
    and export (``--mode eval``, ``show``, ``export``);
  * the data layer (``data``: tar shards, datasets, batching,
    prefetching, the ``webdataset`` and ``local_npz`` kinds) and the data
    factory (``data.preprocess``, ``--mode preprocess_dataset``);
  * data-parallel training over processes, one device a rank
    (``parallel``: ``torchrun -m mas_tpu_torch``; NCCL, or gloo where
    ranks share a card).
Eleven hand-written kernels carry them on CUDA: B1 prefix-causal attention
forward and B6 its backward (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``),
B2 quantized and B9 float decode attention (``csrc/decode_quant.cu``), B3
and B10 quantize-and-write of the lane and packed decode caches
(``csrc/kv_write.cu``), B4 GroupNorm+swish forward
(``csrc/gn_swish_fwd.cu``) and B8 its backward (``csrc/gn_swish_bwd.cu``),
B5 the VQ nearest-code argmin (``csrc/vq_argmin.cu``), B7 LayerNorm forward
and backward (``csrc/layer_norm.cu``) and B11 the residual add with
LayerNorm statistics (Triton, ``ops/ln_producer.py``).  CPU tensors take
each kernel's plain twin.

This package imports torch and numpy, never jax.
"""
