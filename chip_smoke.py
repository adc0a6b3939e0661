"""Smoke run of the PyTorch port (``mas_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. print the card (nvidia-smi name and power limit) and the versions;
     no CUDA device is an error — there is no CPU path;
  2. build the CUDA kernels from ``mas_tpu_torch/csrc`` (nvcc, sm_90a);
     print each kernel's registers and fail if a tensor-core, decode,
     cache-write, LayerNorm, GroupNorm or VQ kernel spills, or a bf16
     flash kernel or B5's bf16 kernel has no tensor-core instruction;
  3. hold each hand-written kernel (B1-B11) against its plain PyTorch
     twin on the card at the main paths' shapes (the attention kernels
     also at head dims 32 to 512, padded and odd ones included, the decode
     reads over the edges of their split, the cache writes bit for bit at
     ten head dims, B4 and B8 at channel counts no power of two, B5 at
     code widths 72 to 512 and on exact copies of a code across the
     codebook's split, B4, B5, B7 and B8 bitwise equal from call to call),
     and time both, and one PyTorch library call that computes the same
     function where there is one (CUDA events, median; B2 and B9 also back
     to back and replayed from a CUDA graph, over enough cache sets to
     keep the L2 cold; B3, B10 and B7 from a CUDA graph and by the host's
     time per call; B4, B5 and B8 from a CUDA graph); each kernel's bound
     is the larger of its bytes over 3.35 TB/s and its operations over the
     peak for their type;
  4. run the serving path at full width — ``configs/sample_256.json``
     (24 layers, hidden 1024, int4 cache, guidance 3.0, top-k 64), seeded
     random weights, its 4 captions — through ``sample_images``, check the
     images and that every kernel of that path was launched; then check
     teacher-forced logits through the kernels against the plain twins on
     the card, and print end-to-end img/s at batch 4 and 64;
  5. train VQ-SEG at full width — ``configs/seg_256.json`` with
     codebook.init_steps 4 and samples_per_image 256 — for 16 micro-steps
     through ``run_pretrain_segmentation``: pass-through, reservoir
     collection, k-means at counters 12, 14 and 16, quantization through
     B5, five Adam updates; check losses, the phase schedule, the launch
     floors of B4/B5/B8, a bitwise resume from the final checkpoint, and
     one micro-step through the kernels against the plain twins;
  6. tokenize 8 random 512^2 images with the ``configs/img_512.json``
     model (bf16, K = 8192) through ``encode_tokens``;
  7. train the transformer at full width — ``configs/transformer_512.json``
     as shipped (24 layers, hidden 1024, T = 1408, batch 8, bf16, remat
     'mlp') — for 8 steps through ``run_train_transformer`` (B1, B6), then
     2 resumed steps with ``layernorm_impl: "pallas"`` (B7) and CFG dropout
     forced; check losses, fp32 parameters, a nonzero gradient for every
     parameter, the exact launch counts, a bitwise resume, and one step
     through the kernels against the plain twins;
  8. serve 512^2 images over the float KV cache from the checkpoint that
     phase 7 wrote, loaded as the CLI loads ``transformer_checkpoint``: the
     ``transformer`` section of ``configs/transformer_512.json`` as it is
     (``kv_cache_dtype`` "compute"), the ``model`` section of
     ``configs/img_512.json`` (seeded random weights) and the sampling
     keys of ``configs/sample_256.json``, built in memory
     (``sample_512_raw``); exact launch counts (B1 24, B9 24 x 1023, B2 =
     B3 = B10 = 0), teacher-forced logits through the kernels against the
     twins, end-to-end s and img/s at batch 4 and 64;
  9. serve 256^2 images over the packed int4 cache (``configs/
     sample_256.json`` with ``kv_cache_layout: "packed"``) at batch 4:
     exact counts (B10 = B2 = 24 x 255, B3 = 0), and greedy tokens equal to
     the lane cache's on the same weights;
 10. the producer-fused LayerNorm harness of ``benchmarks/ln_producer.py``
     at its shape (rows 16 x 1408, d 1024, bf16, 20 chained steps of
     ``x + LN(a + b) @ W``): parity, then the plain and the B11 path,
     forward and forward + backward;
 11. train VQ-IMG (the VQGAN) at full width — ``configs/img_512.json`` as
     shipped, cut in time only (``img_training_configs``) — for 16
     micro-steps through ``run_pretrain_image``: pass-through, reservoir,
     k-means at counters 12, 14 and 16, B5 from 12, the GAN terms gated
     to micro-step 8 and active after, two Adam updates a side; check the
     losses, the gate, the parameter updates, fp32 parameters and bf16
     convolutions, the launch floors of B4/B5/B8, a bitwise resume and
     one micro-step through the kernels against the plain twins; print
     the micro-step's host time, device busy time and idle share, B4/B5/B8
     time and launches, and peak device memory;
 12. after training, through the CLI as a user runs it: ``--mode eval``
     of ``configs/eval_256.json`` (VQ-SEG, fp32, 256^2) with
     ``train.resume`` on phase 5's checkpoint dir and ``--mode show`` of
     ``configs/show_256.json`` from it (10 colorized panels); an eval of
     the ``model`` section of ``configs/img_512.json`` (bf16, 512^2, 4
     batches of 2, seeded random LPIPS) with a real-vs-recon FID on the
     pooled VGG16 taps; ``--mode export`` of phase 5's and phase 7's
     checkpoint dirs.  Checks: exact B4/B5 launch counts (the model's
     GroupNorms x batches, one B5 call a batch) and no other kernel; the
     metrics through the kernels against the plain twins on the same
     batches (l1, mse, lpips rel 1e-3 fp32 / 1e-2 bf16, psnr 0.05 dB, FID
     1e-2 x max(1, FID)); the tokens by B5's rule on their own latents,
     at least 99% equal to the twin's on those latents in bf16, and each
     difference from the twins' whole pass explained by the latents';
     the panels written and finite; each export bitwise equal to its
     checkpoint's model and loadable.  Prints images/s, device busy time
     and idle share, B4/B5 ms per batch (cuDNN TF32 off and on), and peak
     device memory at 512^2;
 13. real input and the data factory, through the CLI, with cuDNN TF32 at
     PyTorch's default (on), as ``python -m mas_tpu_torch`` runs: 2 raw
     tar shards of 16 JPEGs (640 x 480 and 480 x 720) and captions, made
     from a seed; ``--mode preprocess_dataset`` of
     ``configs/preprocess_web.json`` (synthetic annotators) into 2
     processed shards, every sample read written with jpg, txt and the
     npz of 7 keys, and ``info.state``; again with three traced
     TorchScript annotators on the card in spawned workers (the same
     counts; one sample's arrays equal the modules' on the CPU); local
     mode over the same JPEGs (96 npz); ``--mode pretrain_segmentation`` of seg_256 as phase 5
     cuts it on the shards at 256^2 (16 micro-steps; B4, B5, B8 floors)
     and 2 micro-steps on ``local_npz``; ``--mode train_transformer`` of
     ``configs/transformer_512.json`` as shipped on the shards at 512^2,
     tokenized by ``vq_img`` (img_512's model from phase 11's checkpoint
     dir) and ``vq_seg`` (seg_256's model at 512^2 with channels (128,
     128, 128, 256, 512, 512, 512): 16 x 16 tokens), 4 steps; exact
     counts (B1 = B6 = 24 x 4, B4 = both encoders' GroupNorms x 4, B5 =
     2 x 4), steps 2-4 profiled inside the CLI's loop; one batch's seg
     and image tokens held to B5's rule on their own latents and to the
     twins' pass.  Prints the loader's images/s, tokenization ms a batch,
     the host-to-device copy of one fp32 mask batch (pageable and
     pinned), the step's host time, device busy time and idle share with
     the real loader (phase 7 gives the step on synthetic tokens), and
     peak device memory;
 14. the transformer's variants at full width, with seeded random
     weights: ``configs/sample_256.json`` with ``num_kv_heads: 4`` (int4
     lane cache at batch 4 and 64; with ``kv_scale_dtype: "bfloat16"`` at
     batch 64; over the float cache at batch 4), with ``rudalle_relax`` and
     ``cogview_layernorm_prescale`` over the float cache, and with
     ``ln_matmul_fold``, each through ``sample_images`` (images, exact
     B1/B2/B3 or B9/B4 counts, teacher-forced logits against the twins,
     the decode step's host and busy ms from step 8 beside phase 4's MHA
     figures); ``configs/transformer_512.json`` with ``num_kv_heads: 4``
     and with rudalle_relax + prescale + ``ln_matmul_fold``, 2 steps each
     through ``run_train_transformer`` (every parameter moved with a
     nonzero gradient, exact B1/B6 counts, one step against the twins;
     the cost of expanding k/v to the query heads).  Phase 3 also holds
     B2 and B9 with grouped query rows (16 query heads over 8, 4 or 1 kv
     heads) and B3/B2 with bf16 scales against their twins, and times B2
     GQA-4.
 15. data-parallel training through the CLI, in processes started with a
     launcher's environment (``parallel.distributed.initialize`` under
     test; ``python3 chip_smoke.py --rank-worker SPEC`` is one rank):
     seg_256 as phase 5 cuts it (15 micro-steps: k-means at 12 and 14, a
     quantized Adam update at 15), img_512 as phase 11 cuts it with the
     GAN gate open (8 micro-steps, one Adam update a side) and
     transformer_512 cut to 8 of its 24 layers (2 steps; phase 16 runs it
     at full depth), each on 2 gloo ranks sharing
     the card (rows seeded per rank, faces in rank 0's rows only) against
     one process on the same global batch: the ranks bitwise equal, rank 0
     alone writing checkpoints, a bitwise resume on both ranks (seg),
     losses (1e-3 fp32, 1e-2 bf16), d_weight (10%), parameters within
     what the Adam updates can move them, BN statistics, the reservoir,
     the B4/B5/B8 floors and exact B1/B6 counts; then transformer_512 on a
     world of one over NCCL, bitwise equal to the one process.  Prints
     each run's step ms, the collectives' share of it, and whether MPS
     serves the card.
 16. tensor parallelism at model 2, on 2 gloo ranks sharing the card
     (``python3 chip_smoke.py --tp-worker SPEC`` is one rank):
     ``configs/transformer_512.json`` as shipped (8 of its 16 heads a
     rank), 2 steps through the CLI on a 1 x 2 mesh against one process
     on the same rows (losses 1e-2, parameters within what the Adam
     updates can move them, the replicated parameters bitwise equal on
     both ranks, exact B1/B6 counts, rank 0's full checkpoint loading into
     one process's model); then ``configs/sample_256.json`` (int4 lane
     cache, guidance 3.0, top-k 64) at batch 4 from seeded random weights
     sharded over the ranks: teacher-forced logits against one process
     under phase 4's gate, ``sample_images`` with the same tokens on both
     ranks, exact B1/B3/B2 counts a rank and B4 in model rank 0's VQ
     decode; prints s per batch and the collectives' share.  Phase 3
     holds B2 and B3 at a rank's shape too (q [8, 8, 1, 64], int4).
Each path's launch counts are zeroed just before it and read just after.
The line before the last is a JSON object with one entry per kernel
(``launches`` summed over the paths); the last line is ``{"ok": true,
"device": {...}}``.

    python3 chip_smoke.py --decode-times DIR

times only the decode reads B2 and B9 and the cache writes B3 and B10 of
the ``mas_tpu_torch`` under DIR (for example a ``git archive`` of another
commit) and prints one JSON line, so two trees compare on one card in one
call.

    python3 chip_smoke.py --norm-times DIR

does the same for B4 (GroupNorm+swish forward), B7 (LayerNorm forward +
backward, with ``F.layer_norm`` beside it) and B8 (GroupNorm+swish
backward), and

    python3 chip_smoke.py --vq-times DIR

for B5 (VQ argmin) at the tokenization and seg training shapes, and

    python3 chip_smoke.py --vq-paths DIR

profiles the two paths that B4 and B5 carry outside training:
tokenization of 8 x 512^2 images and the VQ decode of 4 256^2 images, and

    python3 chip_smoke.py --mha-outputs DIR

prints digests of the multi-head decode kernels' outputs and of a
full-width multi-head prefill + decode on inputs made from a seed, so two
trees show in one call whether they compute the same bits.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tarfile
import tempfile
import time
from contextlib import ExitStack
from unittest import mock

import numpy as np
import torch
from torch.nn import functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "sample_256.json")
SEG_CONFIG = os.path.join(ROOT, "configs", "seg_256.json")
IMG_CONFIG = os.path.join(ROOT, "configs", "img_512.json")
TRANSFORMER_CONFIG = os.path.join(ROOT, "configs", "transformer_512.json")
TRAIN_STEPS = 16
TRANSFORMER_STEPS = 8
DEVICE = "cuda"
# H100 SXM data sheet (dense): device memory rate and peak rates by type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def timed_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms (CUDA events around each call)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def run_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device time per call of ``fn`` in ms when ``calls`` calls run back
    to back between two CUDA events (median of ``reps`` runs): the host
    enqueues ahead of a kernel longer than its launch, so the gaps of a
    single timed call drop out."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def graph_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device time per call of ``fn`` when ``calls`` calls replay from one
    CUDA graph (median of ``reps`` replays, CUDA events around each): no
    host time between the launches, so a kernel shorter than its launch's
    host time (``run_ms`` then measures the host) is timed too.  Capturing
    also shows that the launches can be captured, the thread-block-cluster
    launches of B2 and B9 included."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                       # allocations and JIT outside the graph
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def rotating(fn, sets):
    """A no-argument call of ``fn(*sets[i])`` for i = 0, 1, ... in turn:
    with more bytes in the sets than the 50 MB L2 holds, each call reads
    its inputs from device memory, as a decode step reads a layer's
    cache."""
    sets = list(sets)
    state = {"i": -1}

    def call():
        state["i"] = (state["i"] + 1) % len(sets)
        return fn(*sets[state["i"]])

    return call


def n_sets(set_bytes: int, total: float = 100e6) -> int:
    """Input sets to rotate over: at least 4, and more than ``total``
    bytes in all."""
    return max(4, int(total // set_bytes) + 1)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def close(a, b, atol: float, rtol: float) -> bool:
    return bool(((a.float() - b.float()).abs()
                 <= atol + rtol * b.float().abs()).all())


def bound(nbytes: float, ops: float, dtype) -> dict:
    """The least time the card could take: the larger of the bytes the
    function must move (each input read once, each output written once)
    over the memory rate, and its operations over the peak for the inputs'
    type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def prefix_causal_pairs(t: int, prefix: int) -> int:
    """Visible (query, key) pairs of one (b, h) under the prefix mask."""
    return prefix * prefix + sum(r + 1 for r in range(prefix, t))


def prefix_causal_mask(t: int, prefix: int):
    pos = torch.arange(t, device="cuda")
    q, k = pos[:, None], pos[None, :]
    return (k <= q) | ((q < prefix) & (k < prefix))


# --- phase 1 / 2 ------------------------------------------------------------

def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA GPU; "
                           "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} devices "
          f"{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build() -> None:
    from mas_tpu_torch import _build

    t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        lib = _build.build(verbose=True)
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    spill_check(log.getvalue())
    sass_check(lib, _build._nvcc())


# kernels that must not spill registers to local memory
NO_SPILL_KERNELS = ("_bf16", "decode_quant_kernel", "decode_float_kernel",
                    "kv_write_", "layer_norm_", "gn_swish_bwd_kernel",
                    "gn_swish_fwd_kernel", "vq_argmin_")


def spill_check(log: str) -> None:
    """Print registers and spill stores per kernel from ptxas's -v log (an
    empty log: the library was built before, nothing to read); fail if a
    kernel of NO_SPILL_KERNELS spills."""
    name, rows = None, []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            rows.append([name, int(m.group(1)), None])
        m = re.search(r"Used (\d+) registers", line)
        if m and rows and rows[-1][0] == name:
            rows[-1][2] = int(m.group(1))
    for name, spill, regs in rows:
        print(f"ptxas {name}: {regs} registers, {spill} bytes spill stores")
    bad = [name for name, spill, _ in rows
           if spill and any(k in name for k in NO_SPILL_KERNELS)]
    require(not bad, f"register spills in {bad}")


# the bf16 flash kernels and B5's bf16 kernel must run their products on
# the tensor cores
TENSOR_CORE_KERNELS = ("flash_fwd_kernel_bf16", "flash_bwd_dkv_kernel_bf16",
                       "flash_bwd_dq_kernel_bf16", "vq_argmin_mma_kernel")


def sass_check(lib, nvcc: str) -> None:
    """Count HMMA (tensor-core) instructions in the SASS of each kernel of
    TENSOR_CORE_KERNELS in the built library (cuobjdump, beside nvcc);
    fail on a kernel with none."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    hmma, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            hmma[name] = []
        elif name is not None and "HMMA" in line:
            hmma[name].append(line.split(";")[0].strip())
    for kernel in TENSOR_CORE_KERNELS:
        found = [n for n in hmma if kernel in n]
        require(bool(found) and all(hmma[n] for n in found),
                f"{kernel}: no HMMA in its SASS")
        for n in found:
            print(f"SASS {kernel}: {len(hmma[n])} HMMA, e.g. {hmma[n][0]}")


# --- phase 3: kernels vs plain twins ----------------------------------------

def check_b1(gen) -> dict:
    """Prefill attention at [8, 16, 384, 64] bf16, q/k/v as views into one
    fused qkv tensor as the model passes them.  Tolerance: both versions
    accumulate in fp32 and round the output to bf16 once; the kernel also
    rounds the softmax weights P to bf16 before P V, as the Pallas kernel
    does (``p.astype(v.dtype)``), at most 2^-9 relative per weight of an
    average: atol 1e-2, rtol 1e-2 (one bf16 ulp of the output is 2^-8
    relative); lse is fp32: atol 1e-4.  The same bf16 tolerances hold at
    T = 200 (ragged) and at the training shape [8, 16, 1408, 64], which is
    also timed beside the library call and its bound, and at head dims 32
    (zero-padded to 64), 128, 160 (zero-padded to 256), 256 and 320
    (zero-padded to 512: column passes) at T = 200; [8, 16, 1408, d] at d
    128, 256 and 320 are timed back to back.  A tensor-parallel rank's
    shapes at model 2 (phase 16: 8 of the 16 heads, so the fused view's
    row stride is 3 * 8 * 64) hold the same bf16 tolerances at T 384 and
    1408, prefixes 384 and 0."""
    from mas_tpu_torch.ops import attention

    def qkv_views(b, h, t, dtype, dim=64):
        return attention.split_qkv(torch.randn(
            b, t, 3, h, dim, device="cuda", generator=gen, dtype=dtype))

    def held(q, k, v, prefix, what):
        o, lse = attention.flash_attention(q, k, v, prefix)
        po, plse = attention.prefix_causal_attention_plain(q, k, v, prefix)
        torch.cuda.synchronize()
        tol = 1e-5 if q.dtype == torch.float32 else 1e-2
        lse_tol = 1e-5 if q.dtype == torch.float32 else 1e-4
        require(close(o, po, tol, tol), f"B1 out, {what}: max err "
                f"{max_err(o, po)}")
        require(close(lse, plse, lse_tol, 0.0), f"B1 lse, {what}: max err "
                f"{max_err(lse, plse)}")
        return max_err(o, po), max_err(lse, plse)

    b, h, t, d = 8, 16, 384, 64
    q, k, v = qkv_views(b, h, t, torch.bfloat16)
    err, out = 0.0, {}
    for prefix in (384, 0):
        e, le = held(q, k, v, prefix, f"prefix {prefix}")
        err = max(err, e)
        print(f"B1 prefix {prefix}: out max err {e:.3e}, lse max err "
              f"{le:.3e}")
    # T = 200 (no multiple of a tile), prefixes at and between the ends,
    # bf16 (tensor cores) and fp32 (CUDA cores; fp32 sums in another order:
    # atol 1e-5)
    for dtype in (torch.bfloat16, torch.float32):
        q2, k2, v2 = qkv_views(2, 4, 200, dtype)
        for prefix in (0, 37, 100, 200):
            e, _ = held(q2, k2, v2, prefix, f"{dtype} T=200 prefix {prefix}")
            if dtype == torch.bfloat16:
                err = max(err, e)
        print(f"B1 {dtype} T=200 prefix 0/37/100/200: ok")
    for dim in (32, 128, 160, 256, 320):
        for dtype in (torch.bfloat16, torch.float32):
            q2, k2, v2 = qkv_views(2, 4, 200, dtype, dim)
            for prefix in (0, 37, 200):
                e, _ = held(q2, k2, v2, prefix,
                            f"{dtype} d={dim} T=200 prefix {prefix}")
                if dtype == torch.bfloat16:
                    err = max(err, e)
        print(f"B1 d={dim} bf16 and fp32 T=200 prefix 0/37/200: ok")
    out["ms"] = timed_ms(lambda: attention.flash_attention(q, k, v, 384))
    out["plain_ms"] = timed_ms(
        lambda: attention.prefix_causal_attention_plain(q, k, v, 384))
    mask = prefix_causal_mask(t, 384)
    kernel = lambda: attention.flash_attention(q, k, v, 384)
    library = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    out["library_ms"] = timed_ms(library)
    out.update(bound(4 * b * h * t * d * 2 + b * h * t * 4,
                     4 * d * prefix_causal_pairs(t, 384) * b * h,
                     torch.bfloat16))
    print(f"B1 [{b},{h},{t},{d}] bf16 prefix 384, back to back: kernel "
          f"{run_ms(kernel):.4f} ms, library {run_ms(library):.4f} ms")
    # the training shape
    t2 = 1408
    q2, k2, v2 = qkv_views(b, h, t2, torch.bfloat16)
    e, le = held(q2, k2, v2, 384, f"[{b},{h},{t2},{d}] prefix 384")
    err = max(err, e)
    mask = prefix_causal_mask(t2, 384)
    kernel = lambda: attention.flash_attention(q2, k2, v2, 384)
    library = lambda: F.scaled_dot_product_attention(q2, k2, v2,
                                                     attn_mask=mask)
    bd = bound(4 * b * h * t2 * d * 2 + b * h * t2 * 4,
               4 * d * prefix_causal_pairs(t2, 384) * b * h, torch.bfloat16)
    print(f"B1 [{b},{h},{t2},{d}] bf16 prefix 384: out max err {e:.3e}, lse "
          f"max err {le:.3e}; kernel {timed_ms(kernel):.4f} ms, library "
          f"{timed_ms(library):.4f} ms, back to back {run_ms(kernel):.4f} / "
          f"{run_ms(library):.4f} ms, bound {bd['bound_ms']:.4f} ms "
          f"({bd['bound_by']})")
    q3, k3, v3 = qkv_views(b, h, t2, torch.bfloat16, 128)
    e, le = held(q3, k3, v3, 384, f"[{b},{h},{t2},128] prefix 384")
    err = max(err, e)
    kernel = lambda: attention.flash_attention(q3, k3, v3, 384)
    library = lambda: F.scaled_dot_product_attention(q3, k3, v3,
                                                     attn_mask=mask)
    bd = bound(4 * b * h * t2 * 128 * 2 + b * h * t2 * 4,
               4 * 128 * prefix_causal_pairs(t2, 384) * b * h, torch.bfloat16)
    print(f"B1 [{b},{h},{t2},128] bf16 prefix 384: out max err {e:.3e}; back "
          f"to back kernel {run_ms(kernel):.4f} ms, library "
          f"{run_ms(library):.4f} ms, bound {bd['bound_ms']:.4f} ms "
          f"({bd['bound_by']})")
    del q3, k3, v3
    q3, k3, v3 = qkv_views(b, h, t2, torch.bfloat16, 256)
    e, le = held(q3, k3, v3, 384, f"[{b},{h},{t2},256] prefix 384")
    err = max(err, e)
    kernel = lambda: attention.flash_attention(q3, k3, v3, 384)
    library = lambda: F.scaled_dot_product_attention(q3, k3, v3,
                                                     attn_mask=mask)
    bd = bound(4 * b * h * t2 * 256 * 2 + b * h * t2 * 4,
               4 * 256 * prefix_causal_pairs(t2, 384) * b * h, torch.bfloat16)
    print(f"B1 [{b},{h},{t2},256] bf16 prefix 384: out max err {e:.3e}; back "
          f"to back kernel {run_ms(kernel):.4f} ms, library "
          f"{run_ms(library):.4f} ms, bound {bd['bound_ms']:.4f} ms "
          f"({bd['bound_by']})")
    del q3, k3, v3
    # d 320: column passes over a head dim padded to 512 (not a speed goal)
    q3, k3, v3 = qkv_views(b, h, t2, torch.bfloat16, 320)
    e, le = held(q3, k3, v3, 384, f"[{b},{h},{t2},320] prefix 384")
    err = max(err, e)
    bd = bound(4 * b * h * t2 * 320 * 2 + b * h * t2 * 4,
               4 * 320 * prefix_causal_pairs(t2, 384) * b * h, torch.bfloat16)
    out["d320_b2b_ms"] = run_ms(
        lambda: attention.flash_attention(q3, k3, v3, 384), calls=5)
    print(f"B1 [{b},{h},{t2},320] bf16 prefix 384: out max err {e:.3e}; back "
          f"to back kernel {out['d320_b2b_ms']:.4f} ms, bound "
          f"{bd['bound_ms']:.4f} ms ({bd['bound_by']})")
    del q3, k3, v3
    for t_rank in (t, t2):
        q3, k3, v3 = qkv_views(b, h // 2, t_rank, torch.bfloat16)
        for prefix in (384, 0):
            e, le = held(q3, k3, v3, prefix, f"tp rank [{b},{h // 2},"
                         f"{t_rank},{d}] prefix {prefix}")
            err = max(err, e)
            print(f"B1 tp rank [{b},{h // 2},{t_rank},{d}] bf16 (qkv row "
                  f"stride {q3.stride(2)}) prefix {prefix}: out max err "
                  f"{e:.3e}, lse max err {le:.3e}")
    out["max_abs_err"] = err
    return out


def _caches(gen, bits, b=128, h=16, t=640, d=64):
    from mas_tpu_torch.ops import quant

    mk = lambda: quant.quantize_kv(torch.randn(
        b, h, t, d, device="cuda", generator=gen), bits)
    return mk(), mk()


def _decode_q(gen, rows, h, d, dtype=torch.bfloat16):
    """A decode query [rows, h, 1, d], a view into a fused qkv tensor as
    the model passes it."""
    qkv = torch.randn(rows, 1, 3, h, d, device="cuda", generator=gen,
                      dtype=dtype)
    return qkv[:, :, 0].transpose(1, 2)


# decode positions around the edges of the split's chunks (valid = index +
# 1 below, at and above multiples of S = 8 and of the 32- to 128-position
# tiles, chunks left empty at index < 7) and of the cache
CHUNK_EDGES = (0, 1, 6, 7, 8, 9, 127, 128, 383, 511, 638, 639)


def b2_times(gen, rows: int) -> dict:
    """B2 over int4 caches [rows, 16, 640, 64] at index 511 (mid-way
    through the 256^2 decode), q bf16: the kernel one call at a time
    (``timed_ms``) and back to back (``run_ms``), the packed read of the
    same shape back to back, and the plain twin; each rotates over
    ``n_sets`` cache sets so the cache is read from device memory."""
    from mas_tpu_torch.ops import decode_cache, quant

    h, t, d, bits = 16, 640, 64, 4
    pair = 2 * rows * h * t * (d // 2 + 4)
    idx = torch.tensor([511], dtype=torch.int32, device="cuda")
    lane = [(_decode_q(gen, rows, h, d), *_caches(gen, bits, rows, h, t, d))
            for _ in range(n_sets(pair))]
    packed = [(q, decode_cache.seed_packed_cache(
        torch.randn(rows, h, t, d, device="cuda", generator=gen),
        torch.randn(rows, h, t, d, device="cuda", generator=gen), t, bits))
        for q, _, _ in lane]
    kernel = rotating(lambda q, kc, vc: quant.decode_attention_quant(
        q, kc, vc, idx), lane)
    packed_read = rotating(lambda q, c: decode_cache.decode_attention_packed(
        q, c, idx), packed)
    plain = rotating(lambda q, kc, vc: quant.decode_attention_quant_plain(
        q, kc, vc, idx), lane)
    valid = 512
    out = {"ms": timed_ms(kernel), "b2b_ms": run_ms(kernel),
           "graph_ms": graph_ms(kernel),
           "packed_b2b_ms": run_ms(packed_read),
           "packed_graph_ms": graph_ms(packed_read),
           "plain_ms": timed_ms(plain, reps=5), "sets": len(lane),
           **bound(2 * rows * h * valid * (d // 2 + 4) + 2 * rows * h * d * 2,
                   4 * d * valid * rows * h, torch.bfloat16)}
    out["bound_share"] = out["bound_ms"] / out["graph_ms"]
    return out


def _gqa_q(gen, rows, h, kv, d, dtype=torch.bfloat16):
    """A grouped-query decode query [rows, h, 1, d]: the q view into a
    projection [rows, 1, (h + 2 kv) d], as the model slices it."""
    proj = torch.randn(rows, 1, (h + 2 * kv) * d, device="cuda",
                       generator=gen, dtype=dtype)
    return proj[..., :h * d].view(rows, 1, h, d).transpose(1, 2)


def _quant_caches(gen, bits, b, kv, t, d, scale_dtype):
    from mas_tpu_torch.ops import quant

    mk = lambda: quant.quantize_kv(torch.randn(
        b, kv, t, d, device="cuda", generator=gen), bits, scale_dtype)
    return mk(), mk()


# (rows, query heads per kv head g, d) of the grouped reads: g 2, 4 and
# 16 (one kv head), and d 256 at g 16 (the merge states of four rows at
# the widest instance)
B2_GROUPS = ((128, 4, 64), (8, 4, 64), (128, 2, 64), (8, 16, 64),
             (128, 16, 64), (8, 16, 256))


def b2_gqa_times(gen, rows: int, g: int, scale_dtype) -> dict:
    """B2 over int4 caches [rows, 16 / g, 640, 64] with ``scale_dtype``
    scales at index 511, q [rows, 16, 1, 64] bf16: back to back
    (``run_ms``), from a CUDA graph (``graph_ms``), the plain twin, and the
    bound (each kv head's positions and scales read once), rotating over
    ``n_sets`` cache sets."""
    from mas_tpu_torch.ops import quant

    h, t, d, bits = 16, 640, 64, 4
    kv, sb = h // g, torch.finfo(scale_dtype).bits // 8
    pair = 2 * rows * kv * t * (d // 2 + sb)
    idx = torch.tensor([511], dtype=torch.int32, device="cuda")
    sets = [(_gqa_q(gen, rows, h, kv, d),
             *_quant_caches(gen, bits, rows, kv, t, d, scale_dtype))
            for _ in range(n_sets(pair))]
    kernel = rotating(lambda q, kc, vc: quant.decode_attention_quant(
        q, kc, vc, idx), sets)
    plain = rotating(lambda q, kc, vc: quant.decode_attention_quant_plain(
        q, kc, vc, idx), sets)
    valid = 512
    out = {"ms": timed_ms(kernel), "b2b_ms": run_ms(kernel),
           "graph_ms": graph_ms(kernel), "plain_ms": timed_ms(plain, reps=5),
           **bound(2 * rows * kv * valid * (d // 2 + sb)
                   + 2 * rows * h * d * 2, 4 * d * valid * rows * h,
                   torch.bfloat16)}
    out["bound_share"] = out["bound_ms"] / out["graph_ms"]
    return out


def check_b2_grouped(gen) -> dict:
    """Grouped-query and bf16-scale reads of B2: q [rows, 16, 1, d] bf16
    (and fp32) against int4 and int8 caches of 16 / g kv heads, fp32 and
    bf16 scales, T = 640, at indices over the split's and the tiles'
    edges, for B2_GROUPS; and bf16 scales at g = 1.  Same tolerances as
    ``check_b2``: the twin reads the same scales (bf16 widened to fp32).
    Times GQA-4 int4 at 128 and 8 rows, index 511, with fp32 and bf16
    scales (``b2_gqa_times``)."""
    from mas_tpu_torch.ops import quant

    h, t = 16, 640
    err, out = 0.0, {}
    cases = [(rows, g, d, bits, sd) for rows, g, d in B2_GROUPS
             for bits in (4, 8) for sd in (torch.float32, torch.bfloat16)]
    cases += [(rows, 1, 64, bits, torch.bfloat16) for rows in (128, 8)
              for bits in (4, 8)]
    for rows, g, d, bits, sd in cases:
        kv = h // g
        q = _gqa_q(gen, rows, h, kv, d)
        kc, vc = _quant_caches(gen, bits, rows, kv, t, d, sd)
        for index in (0, 6, 7, 8, 127, 383, 511, 639):
            idx = torch.tensor([index], dtype=torch.int32, device="cuda")
            o = quant.decode_attention_quant(q, kc, vc, idx)
            p = quant.decode_attention_quant_plain(q, kc, vc, idx)
            q32 = q.float()
            o32 = quant.decode_attention_quant(q32, kc, vc, idx)
            p32 = quant.decode_attention_quant_plain(q32, kc, vc, idx)
            torch.cuda.synchronize()
            what = (f"B2 q [{rows},{h},1,{d}] g {g} int{bits} {sd} scales "
                    f"index {index}")
            require(close(o, p, 1e-2, 1e-2), f"{what}: max err "
                    f"{max_err(o, p)}")
            require(close(o32, p32, 1e-5, 1e-5), f"{what} fp32: max err "
                    f"{max_err(o32, p32)}")
            err = max(err, max_err(o, p))
        print(f"B2 grouped [{rows},{kv},{t},{d}] g {g} int{bits} {sd} "
              "scales, bf16 and fp32 q, 8 indices: ok")
    for rows in (128, 8):
        for sd in (torch.float32, torch.bfloat16):
            res = b2_gqa_times(gen, rows, 4, sd)
            key = f"gqa4_{'bf16' if sd == torch.bfloat16 else 'fp32'}"
            print(f"B2 GQA-4 int4 {sd} scales [{rows},4,{t},64] index 511: "
                  f"one call {res['ms']:.4f} ms, back to back "
                  f"{res['b2b_ms']:.4f} ms, graph {res['graph_ms']:.4f} ms, "
                  f"plain {res['plain_ms']:.4f} ms, bound "
                  f"{res['bound_ms']:.4f} ms ({res['bound_by']}), "
                  f"{100 * res['bound_share']:.1f}% of it")
            out[f"{key}_rows{rows}"] = res
    out["max_abs_err"] = err
    return out


def check_b2(gen) -> dict:
    """Decode read: q [rows, 16, 1, d] bf16 (a view into qkv) at 128 rows
    (batch 64 with guidance: one block per (b, h)) and 8 rows (batch 4:
    eight blocks of one cluster per (b, h)), int4 and int8 caches with
    T = 640, at every index of CHUNK_EDGES; head dims 32, 128 and 256 too,
    48 and 96 over caches padded to 64 and 128 values a position, the odd
    33 and 47 (an int4 cache's last byte pairs column d - 1 with a zero
    nibble), and 320 and 512 (positions of 512 values taken in chunks of
    256).
    Tolerance: both versions accumulate in fp32 and round to bf16 once:
    atol 1e-2, rtol 1e-2; fp32 q: only the fp32 summation order differs,
    atol 1e-5.  The packed cache is read through strided views of its k
    and v halves: it must give the lane read of the same values bit for
    bit (same kernel, same split, another position stride), and match its
    plain twin (at d 64 and, padded, 96).  Timed by ``b2_times`` at both
    row counts."""
    from mas_tpu_torch.ops import decode_cache, quant

    h, t = 16, 640
    err, out = 0.0, {}
    for rows, d in ((128, 64), (8, 64), (8, 32), (8, 128), (128, 32),
                    (128, 128), (8, 256), (128, 256), (8, 96), (128, 48),
                    (8, 47), (128, 33), (8, 320), (128, 512)):
        indices = CHUNK_EDGES if d == 64 else (0, 6, 383, 639)
        q = _decode_q(gen, rows, h, d)
        for bits in (4, 8):
            kc, vc = _caches(gen, bits, rows, h, t, d)
            for index in indices:
                idx = torch.tensor([index], dtype=torch.int32, device="cuda")
                o = quant.decode_attention_quant(q, kc, vc, idx)
                p = quant.decode_attention_quant_plain(q, kc, vc, idx)
                q32 = q.float()
                o32 = quant.decode_attention_quant(q32, kc, vc, idx)
                p32 = quant.decode_attention_quant_plain(q32, kc, vc, idx)
                torch.cuda.synchronize()
                what = f"B2 [{rows},{h},{t},{d}] int{bits} index {index}"
                require(close(o, p, 1e-2, 1e-2),
                        f"{what}: max err {max_err(o, p)}")
                require(close(o32, p32, 1e-5, 1e-5),
                        f"{what} fp32: max err {max_err(o32, p32)}")
                err = max(err, max_err(o, p))
            print(f"B2 [{rows},{h},{t},{d}] int{bits}, bf16 and fp32 q, "
                  f"index {indices[0]}..{indices[-1]} ({len(indices)}): ok")
            if d not in (64, 96):
                continue
            packed = decode_cache.seed_packed_cache(
                torch.randn(rows, h, t, d, device="cuda", generator=gen),
                torch.randn(rows, h, t, d, device="cuda", generator=gen), t,
                bits)
            lane = [quant.QuantCache(c.q.contiguous(), c.scale.contiguous(),
                                     bits) for c in packed.views()]
            for index in indices:
                idx = torch.tensor([index], dtype=torch.int32, device="cuda")
                o = decode_cache.decode_attention_packed(q, packed, idx)
                p = decode_cache.decode_attention_packed_plain(q, packed, idx)
                o_lane = quant.decode_attention_quant(q, *lane, idx)
                torch.cuda.synchronize()
                require(torch.equal(o, o_lane), f"B2 packed [{rows}] "
                        f"int{bits} index {index}: differs from the lane read "
                        "of the same values")
                require(close(o, p, 1e-2, 1e-2), f"B2 packed [{rows}] "
                        f"int{bits} index {index}: max err {max_err(o, p)}")
                err = max(err, max_err(o, p))
            print(f"B2 packed [{rows}] int{bits}: bitwise equal to the lane "
                  "read at every index")
    # head dim 256, not a speed goal: device time over one cache pair of
    # 2 x 84 MB (more than the L2 holds)
    q = _decode_q(gen, 128, h, 256)
    kc, vc = _caches(gen, 4, 128, h, t, 256)
    idx = torch.tensor([511], dtype=torch.int32, device="cuda")
    out["d256_graph_ms"] = graph_ms(
        lambda: quant.decode_attention_quant(q, kc, vc, idx))
    print(f"B2 int4 [128,{h},{t},256] index 511: graph "
          f"{out['d256_graph_ms']:.4f} ms")
    del q, kc, vc
    q = _decode_q(gen, 128, h, 512)
    kc, vc = _caches(gen, 4, 128, h, t, 512)
    out["d512_graph_ms"] = graph_ms(
        lambda: quant.decode_attention_quant(q, kc, vc, idx))
    bd = bound(2 * 128 * h * 512 * (256 + 4), 0, torch.bfloat16)
    print(f"B2 int4 [128,{h},{t},512] index 511: graph "
          f"{out['d512_graph_ms']:.4f} ms (bound {bd['bound_ms']:.4f} ms)")
    del q, kc, vc
    for rows in (128, 8):
        res = b2_times(gen, rows)
        print(f"B2 int4 [{rows},{h},{t},64] index 511 ({res['sets']} cache "
              f"sets): one call {res['ms']:.4f} ms, back to back "
              f"{res['b2b_ms']:.4f} ms (packed {res['packed_b2b_ms']:.4f}), "
              f"graph {res['graph_ms']:.4f} ms (packed "
              f"{res['packed_graph_ms']:.4f}), plain {res['plain_ms']:.4f} "
              f"ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']}), "
              f"{100 * res['bound_share']:.1f}% of it")
        if rows == 128:
            out.update(res)
        else:
            out["batch4_graph_ms"] = res["graph_ms"]
            out["batch4_bound_ms"] = res["bound_ms"]
    out["tp_rank"] = check_b2_tp_rank(
        torch.Generator(device="cuda").manual_seed(4))
    # the grouped reads draw from a generator of their own, so the shared
    # one reaches the later phases in the state it had before they existed
    grouped = check_b2_grouped(torch.Generator(device="cuda").manual_seed(2))
    out["grouped"] = {k: v for k, v in grouped.items() if k != "max_abs_err"}
    out["library_ms"] = None
    out["max_abs_err"] = max(err, grouped["max_abs_err"],
                             out["tp_rank"]["max_abs_err"])
    return out


def check_b2_tp_rank(gen) -> dict:
    """B2 at a tensor-parallel rank's shape on phase 16's serving path: q
    [8, 8, 1, 64] bf16 (8 of sample_256's 16 heads, batch 4 with
    guidance), int4 and int8 caches of T 640, at every index of
    CHUNK_EDGES, against its twin (check_b2's tolerance); the int4 read's
    device time at index 511 (``graph_ms``; its split is
    ``decode_split(64)``)."""
    from mas_tpu_torch.ops import quant

    rows, h, t, d = 8, 8, 640, 64
    q = _decode_q(gen, rows, h, d)
    err = 0.0
    for bits in (4, 8):
        kc, vc = _caches(gen, bits, rows, h, t, d)
        for index in CHUNK_EDGES:
            idx = torch.tensor([index], dtype=torch.int32, device="cuda")
            o = quant.decode_attention_quant(q, kc, vc, idx)
            p = quant.decode_attention_quant_plain(q, kc, vc, idx)
            torch.cuda.synchronize()
            require(close(o, p, 1e-2, 1e-2), f"B2 [{rows},{h},{t},{d}] "
                    f"int{bits} index {index}: max err {max_err(o, p)}")
            err = max(err, max_err(o, p))
    kc, vc = _caches(gen, 4, rows, h, t, d)
    idx = torch.tensor([511], dtype=torch.int32, device="cuda")
    ms = graph_ms(lambda: quant.decode_attention_quant(q, kc, vc, idx))
    bd = bound(2 * rows * h * 512 * (d // 2 + 4) + 2 * rows * h * d * 2, 0,
               torch.bfloat16)
    print(f"B2 at a rank's shape [{rows},{h},{t},{d}] int4/int8, index "
          f"{CHUNK_EDGES[0]}..{CHUNK_EDGES[-1]}: ok; int4 index 511 graph "
          f"{ms:.4f} ms (bound {bd['bound_ms']:.5f} ms)")
    return dict(graph_ms=ms, bound_ms=bd["bound_ms"], max_abs_err=err)


def host_ms(fn, calls: int = 1000) -> float:
    """Host time per call of ``fn`` in ms: wall clock over ``calls`` calls
    issued with no synchronisation between them, after a warmup (the
    device's queue absorbs a kernel shorter than its launch)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / calls


# head dims of the write checks: the four instances, two padded ones, two
# odd ones and two above 256 (chunks of 256)
WRITE_HEAD_DIMS = (32, 48, 64, 96, 128, 256, 33, 47, 320, 512)


def _new_kv(gen, rows, h, d, dtype=torch.bfloat16):
    """New k and v [rows, h, d] as views into a fused qkv tensor, as the
    model passes them (scaled by 3: the int4 grid's edges are reached)."""
    qkv = torch.randn(rows, 1, 3, h, d, device="cuda", generator=gen,
                      dtype=dtype) * 3
    return qkv[:, 0, 1], qkv[:, 0, 2]


def _held_writes(gen, rows, d, bits, t=640, dtype=torch.bfloat16, h=16):
    """B3 and B10 into fresh lane and packed caches [rows, h, t, *] at
    indices 0, 384, t - 1 against their plain twins: bitwise equal values
    and scales, B10's halves bitwise equal to B3's caches, and the columns
    past d still zero."""
    from mas_tpu_torch.ops import decode_cache, quant

    kn, vn = _new_kv(gen, rows, h, d, dtype)
    kc, vc = _caches(gen, bits, rows, h, t, d)
    pk, pv = (quant.QuantCache(c.q.clone(), c.scale.clone(), bits)
              for c in (kc, vc))
    seed = [torch.randn(rows, h, 384, d, device="cuda", generator=gen)
            for _ in range(2)]
    packed = decode_cache.seed_packed_cache(*seed, t, bits)
    plain = decode_cache.PackedQuantCache(packed.kv.clone(),
                                          packed.scale.clone(), bits)
    for index in (0, 384, t - 1):
        idx = torch.tensor([index], dtype=torch.int32, device="cuda")
        decode_cache.write_quant_kv(kc, vc, kn, vn, idx)
        decode_cache.write_quant_kv_plain(pk, pv, kn, vn, idx)
        decode_cache.write_packed_kv(packed, kn, vn, idx)
        decode_cache.write_packed_kv_plain(plain, kn, vn, idx)
    torch.cuda.synchronize()
    what = f"[{rows},{h},{t},{d}] {dtype} int{bits}"
    for got, want in ((kc, pk), (vc, pv)):
        require(torch.equal(got.q, want.q)
                and torch.equal(got.scale, want.scale),
                f"B3 {what}: kernel and plain twin stored different bits")
        require(not got.values()[..., d:].any(), f"B3 {what}: the padding "
                "was written")
    require(torch.equal(packed.kv, plain.kv)
            and torch.equal(packed.scale, plain.scale),
            f"B10 {what}: kernel and plain twin stored different bits")
    written = [0, 384, t - 1]
    for view, lane in zip(packed.views(), (kc, vc)):
        require(torch.equal(view.q[:, :, written], lane.q[:, :, written])
                and torch.equal(view.scale[:, :, written],
                                lane.scale[:, :, written]),
                f"B10 {what}: packed halves differ from B3's lane caches")
        require(not view.values()[..., d:].any(), f"B10 {what}: the "
                "padding was written")


def _held_bf16_writes(gen, rows, kv, d, bits, t=640):
    """B3 into lane caches [rows, kv, t, *] with bf16 scales at indices 0,
    384 and t - 1 against its plain twin: bitwise equal values and scales
    (the scale rounded to bf16, the values quantized against it), the
    padding untouched, and each written position equal to ``quantize_kv``
    of the new k/v with bf16 scales."""
    from mas_tpu_torch.ops import decode_cache, quant

    kn, vn = _new_kv(gen, rows, kv, d)
    kc, vc = _quant_caches(gen, bits, rows, kv, t, d, torch.bfloat16)
    pk, pv = (quant.QuantCache(c.q.clone(), c.scale.clone(), bits)
              for c in (kc, vc))
    for index in (0, 384, t - 1):
        idx = torch.tensor([index], dtype=torch.int32, device="cuda")
        decode_cache.write_quant_kv(kc, vc, kn, vn, idx)
        decode_cache.write_quant_kv_plain(pk, pv, kn, vn, idx)
    torch.cuda.synchronize()
    what = f"B3 bf16 scales [{rows},{kv},{t},{d}] int{bits}"
    for got, want, new in ((kc, pk, kn), (vc, pv, vn)):
        require(torch.equal(got.q, want.q)
                and torch.equal(got.scale, want.scale),
                f"{what}: kernel and plain twin stored different bits")
        require(not got.values()[..., d:].any(), f"{what}: the padding "
                "was written")
        ref = quant.quantize_kv(new[:, :, None].float(), bits,
                                torch.bfloat16)
        require(torch.equal(got.q[:, :, t - 1:], ref.q)
                and torch.equal(got.scale[:, :, t - 1:], ref.scale),
                f"{what}: differs from quantize_kv with bf16 scales")


def bf16_write_times(gen, rows: int, kv: int) -> dict:
    """B3 writing new k/v [rows, kv, 64] bf16 into int4 lane caches with
    bf16 scales at index 511: device time from a CUDA graph, host time
    per call, and the bound (2-byte scales)."""
    from mas_tpu_torch.ops import decode_cache, quant

    t, d, bits = 640, 64, 4
    kn, vn = _new_kv(gen, rows, kv, d)
    idx = torch.tensor([511], dtype=torch.int32, device="cuda")
    kc, vc = (quant.QuantCache.empty(rows, kv, t, d, bits, "cuda",
                                     torch.bfloat16) for _ in range(2))
    fn = lambda: decode_cache.write_quant_kv(kc, vc, kn, vn, idx)
    return {"graph_ms": graph_ms(fn), "host_ms": host_ms(fn),
            **bound(2 * rows * kv * d * 2 + 2 * rows * kv * (d // 2 + 2),
                    2 * rows * kv * d * 4, torch.bfloat16)}


def write_times(gen, rows: int) -> dict:
    """B3 and B10 writing new k/v [rows, 16, 64] bf16 (views into qkv) into
    int4 caches [rows, 16, 640, *] at index 511: one call at a time
    (``timed_ms``), replayed from a CUDA graph (``graph_ms``, the device
    time), and the host time per call (``host_ms``); the plain twins one
    call at a time.  For whichever ``mas_tpu_torch`` is imported."""
    from mas_tpu_torch.ops import decode_cache, quant

    h, t, d, bits = 16, 640, 64, 4
    kn, vn = _new_kv(gen, rows, h, d)
    idx = torch.tensor([511], dtype=torch.int32, device="cuda")
    kc, vc = (quant.QuantCache.empty(rows, h, t, d, bits, "cuda")
              for _ in range(2))
    packed = decode_cache.PackedQuantCache.empty(rows, h, t, d, bits, "cuda")
    lane = lambda: decode_cache.write_quant_kv(kc, vc, kn, vn, idx)
    pack = lambda: decode_cache.write_packed_kv(packed, kn, vn, idx)
    out = {}
    for kid, fn, plain in (
            ("B3", lane, lambda: decode_cache.write_quant_kv_plain(
                kc, vc, kn, vn, idx)),
            ("B10", pack, lambda: decode_cache.write_packed_kv_plain(
                packed, kn, vn, idx))):
        out[kid] = {"ms": timed_ms(fn), "graph_ms": graph_ms(fn),
                    "host_ms": host_ms(fn), "plain_ms": timed_ms(plain),
                    **bound(2 * rows * h * d * 2 + 2 * rows * h * (d // 2 + 4),
                            2 * rows * h * d * 4, torch.bfloat16)}
    return out


def check_b3(gen) -> dict:
    """Cache writes, B3 (lane) and B10 (packed): at 128 rows (batch 64 with
    guidance) and 8 rows (batch 4), int4 and int8, bf16 new k/v, at every
    head dim of WRITE_HEAD_DIMS (padded caches at 48 and 96), and fp32 new
    k/v at d 64 and 96: each kernel and its plain twin must store identical
    bits (IEEE division and round-half-even in both), B10's halves must
    equal B3's caches, and the columns past d must stay zero
    (``_held_writes``).  Timed by ``write_times`` at both row counts."""
    cases = [(rows, d, bits, torch.bfloat16) for d in WRITE_HEAD_DIMS
             for rows in (128, 8) for bits in (4, 8)]
    cases += [(128, d, bits, torch.float32) for d in (64, 96)
              for bits in (4, 8)]
    for rows, d, bits, dtype in cases:
        _held_writes(gen, rows, d, bits, dtype=dtype)
    print(f"B3, B10: bitwise equal to their twins and to each other, padding "
          f"untouched, at {len(cases)} cases: rows 128/8, d "
          f"{'/'.join(map(str, WRITE_HEAD_DIMS))}, int4/int8, bf16 and fp32")
    tp = torch.Generator(device="cuda").manual_seed(5)     # see check_b2
    for bits in (4, 8):
        _held_writes(tp, 8, 64, bits, h=8)
    print("B3, B10 at a tensor-parallel rank's shape [8,8,64] (8 of 16 "
          "heads), int4/int8: bitwise equal to their twins")
    bf16_cases = [(rows, kv, d, bits) for rows in (128, 8) for kv in (16, 4)
                  for d in (64, 33, 256, 320) for bits in (4, 8)]
    own = torch.Generator(device="cuda").manual_seed(3)   # see check_b2
    for rows, kv, d, bits in bf16_cases:
        _held_bf16_writes(own, rows, kv, d, bits)
    print(f"B3 with bf16 scales: bitwise equal to its twin and to "
          f"quantize_kv, padding untouched, at {len(bf16_cases)} cases: "
          "rows 128/8, 16 and 4 kv heads, d 64/33/256/320, int4/int8")
    bf16_times = {}
    for kv in (16, 4):
        bf16_times[kv] = bf16_write_times(own, 128, kv)
        r = bf16_times[kv]
        print(f"B3 int4 bf16 scales [128,{kv},64] -> T 640, index 511: graph "
              f"{r['graph_ms']:.4f} ms, host per call {r['host_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
    out = {}
    for rows in (128, 8):
        res = write_times(gen, rows)
        for kid in ("B3", "B10"):
            r = res[kid]
            print(f"{kid} int4 [{rows},16,64] -> T 640, index 511: one call "
                  f"{r['ms']:.4f} ms, graph {r['graph_ms']:.4f} ms, host per "
                  f"call {r['host_ms']:.4f} ms, plain {r['plain_ms']:.4f} "
                  f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        if rows == 128:
            out = {kid: dict(res[kid], library_ms=None, max_abs_err=0.0)
                   for kid in ("B3", "B10")}
            out["B3"]["bf16_scales"] = bf16_times
        else:
            for kid in ("B3", "B10"):
                out[kid]["rows8_graph_ms"] = res[kid]["graph_ms"]
                out[kid]["rows8_host_ms"] = res[kid]["host_ms"]
    _WRITE_ROWS.update(out)
    return out["B3"]


# B10's row of the kernel table, measured by check_b3 beside B3's
_WRITE_ROWS = {}


def check_b10(gen) -> dict:
    """Packed cache write: held and timed beside B3 by ``check_b3``."""
    require("B10" in _WRITE_ROWS, "check_b3 runs before check_b10")
    return _WRITE_ROWS["B10"]


# the GroupNorm shapes of check_b4 beyond the decoder's two: C not a power
# of two (96, 192, 384 in 32 groups), C not a multiple of a thread's
# channels (element loads: 36 in 4 groups, 6 in 3), several slabs of
# channels (4096 fp32, 8192 bf16), and few rows (one slice an image).  B4
# takes images of few rows without a grid barrier (slabs of whole groups,
# "local") and larger ones with two: each kind of C is held in both.
GN_SHAPES = (((4, 256, 256, 128), torch.bfloat16, 32),
             ((2, 512, 512, 128), torch.bfloat16, 32),
             ((4, 16, 16, 512), torch.bfloat16, 32),
             ((4, 16, 16, 512), torch.float32, 32),
             ((2, 32, 32, 96), torch.bfloat16, 32),
             ((2, 32, 32, 96), torch.float32, 32),
             ((2, 64, 64, 96), torch.float32, 32),
             ((2, 64, 64, 192), torch.bfloat16, 32),
             ((2, 16, 16, 384), torch.bfloat16, 32),
             ((2, 16, 16, 384), torch.float32, 32),
             ((2, 64, 64, 384), torch.bfloat16, 32),
             ((2, 16, 16, 36), torch.bfloat16, 4),
             ((2, 64, 64, 36), torch.bfloat16, 4),
             ((1, 8, 8, 6), torch.float32, 3),
             ((2, 16, 16, 4096), torch.float32, 32),
             ((1, 8, 8, 8192), torch.bfloat16, 4),
             ((8, 2, 2, 512), torch.bfloat16, 32))


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of t whose data starts one element past a 16-byte
    boundary: the kernels must take their element-load instance."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def check_b4(gen) -> dict:
    """GroupNorm+swish forward at ``GN_SHAPES`` (the decoder's [4, 256, 256,
    128], the img_512 training encoder's and decoder's [2, 512, 512, 128]
    and [4, 16, 16, 512] bf16 first) and on bf16 x whose data is not
    16-byte aligned (element loads, with and without a grid barrier),
    against the plain twin.  Tolerances: bf16 outputs are
    rounded to bf16 once from fp32 values that differ only in summation
    order and the sigmoid's few ulps: atol 3e-2, rtol 1e-2 (two bf16 ulps
    at |y| < 4); fp32 outputs atol 1e-5, rtol 1e-5; stats are fp32 sums of
    up to 2^21 terms in another order: rtol 1e-4 (bf16 inputs), 1e-5
    (fp32).  Two calls must give equal bits (no atomics), also after
    replays from a CUDA graph.  Timed by ``b4_times``."""
    from mas_tpu_torch.ops import gn_swish

    err, out = 0.0, {}
    cases = [(shape, dtype, groups, False) for shape, dtype, groups
             in GN_SHAPES] + [((2, 32, 32, 128), torch.bfloat16, 32, True),
                              ((2, 64, 64, 128), torch.bfloat16, 32, True)]
    for shape, dtype, groups, shifted in cases:
        c = shape[-1]
        x = (torch.randn(*shape, device="cuda", generator=gen) * 2 + 0.5
             ).to(dtype)
        if shifted:
            x = _misaligned(x)
        s = torch.randn(c, device="cuda", generator=gen)
        bias = torch.randn(c, device="cuda", generator=gen)
        y, st = gn_swish.gn_swish(x, s, bias, groups)
        py, pst = gn_swish.gn_swish_plain(x, s, bias, groups)
        graph_ms(lambda: gn_swish.gn_swish(x, s, bias, groups), calls=2,
                 reps=2)
        y2, st2 = gn_swish.gn_swish(x, s, bias, groups)
        torch.cuda.synchronize()
        what = f"B4 {shape} {dtype} G {groups}{' misaligned' if shifted else ''}"
        tol = (3e-2, 1e-2) if dtype == torch.bfloat16 else (1e-5, 1e-5)
        s_tol = (1e-6, 1e-4) if dtype == torch.bfloat16 else (1e-6, 1e-5)
        require(y.dtype == dtype and close(y, py, *tol),
                f"{what} out: max err {max_err(y, py)}")
        require(close(st, pst, *s_tol), f"{what} stats: max err "
                f"{max_err(st, pst)}")
        require(torch.equal(y, y2) and torch.equal(st, st2),
                f"{what}: two calls differ (one after graph replays)")
        err = max(err, max_err(y, py))
        print(f"{what}: out max err {max_err(y, py):.3e}, stats max err "
              f"{max_err(st, pst):.3e}; two calls bitwise equal")
        del x, y, py, y2
    res = b4_times(gen)
    for key, r in res.items():
        print(f"B4 {key}: one call {r['ms']:.4f} ms, back to back "
              f"{r['b2b_ms']:.4f} ms, graph {r['graph_ms']:.4f} ms "
              f"({100 * r['bound_share']:.1f}% of the bound "
              f"{r['bound_ms']:.4f} ms, {r['bound_by']}); plain "
              f"{r['plain_ms']:.4f} ms")
    out.update(res["bf16"])
    for key in ("small", "mid", "fp32"):
        out[f"{key}_graph_ms"] = res[key]["graph_ms"]
        out[f"{key}_bound_ms"] = res[key]["bound_ms"]
    out["library_ms"] = None
    out["max_abs_err"] = err
    return out


def b4_times(gen) -> dict:
    """B4 at [4, 256, 256, 128] bf16 (the VQ decoder's largest), [4, 16,
    16, 512] bf16 (its smallest, "small"), [4, 32, 32, 512] bf16 ("mid")
    and [2, 256, 256, 128] fp32 (the seg encoder's largest), for whichever ``mas_tpu_torch`` is imported:
    one call (``timed_ms``), back to back (``run_ms``) and replayed from a
    CUDA graph (``graph_ms``), and the plain twin one call at a time.
    Bound: x read once, y written once, the stats."""
    from mas_tpu_torch.ops import gn_swish

    out = {}
    for key, shape, dtype in (("bf16", (4, 256, 256, 128), torch.bfloat16),
                              ("small", (4, 16, 16, 512), torch.bfloat16),
                              ("mid", (4, 32, 32, 512), torch.bfloat16),
                              ("fp32", (2, 256, 256, 128), torch.float32)):
        c = shape[-1]
        x = (torch.randn(*shape, device="cuda", generator=gen) * 2 + 0.5
             ).to(dtype)
        s = torch.randn(c, device="cuda", generator=gen)
        b = torch.randn(c, device="cuda", generator=gen)
        fn = lambda: gn_swish.gn_swish(x, s, b)
        n = x.numel()
        out[key] = {"ms": timed_ms(fn), "b2b_ms": run_ms(fn),
                    "graph_ms": graph_ms(fn),
                    "plain_ms": timed_ms(
                        lambda: gn_swish.gn_swish_plain(x, s, b)),
                    **bound(2 * n * x.element_size() + shape[0] * 32 * 2 * 4,
                            12 * n, dtype)}
        out[key]["bound_share"] = out[key]["bound_ms"] / out[key]["graph_ms"]
        del x
    return out


def vq_paths() -> dict:
    """The paths that B4 and B5 carry outside training, for whichever
    ``mas_tpu_torch`` is imported (``python3 chip_smoke.py --vq-paths
    DIR``): ``encode_tokens`` of 8 random 512^2 images (``configs/
    img_512.json``, bf16) and ``decode_code`` of 4 random 16 x 16 code
    grids (the VQ model of ``configs/sample_256.json``), seeded random
    weights, each profiled over 4 calls after 2 warm-up calls by
    ``mas_tpu_torch.breakdown._profile``: host ms per call, device-busy ms
    per call, idle share and each kernel id's device ms per call."""
    from mas_tpu_torch.breakdown import _profile
    from mas_tpu_torch.cli import load_vq
    from mas_tpu_torch.utils.config import VQModelConfig

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for key, path in (("tokenize", IMG_CONFIG), ("vq_decode", CONFIG)):
        with open(path) as f:
            cfg = VQModelConfig.from_dict(json.load(f)["model"])
        model = load_vq(cfg, None, "cuda", gen)
        side = cfg.latent_resolution
        if key == "tokenize":
            x = torch.rand(8, cfg.resolution, cfg.resolution,
                           cfg.in_channels, device="cuda", generator=gen)
            fn = lambda: model.encode_tokens(x)
        else:
            codes = torch.randint(0, cfg.codebook.codebook_size,
                                  (4, side, side), device="cuda",
                                  generator=gen)
            fn = lambda: model.decode_code(codes)
        with torch.inference_mode():
            for _ in range(2):
                fn()
            out[key] = _profile(fn, 4)
        del model
    return out


def _vq_inputs(gen, n, k, d, dtype):
    z = torch.randn(n, d, device="cuda", generator=gen).to(dtype)
    cb = torch.randn(k, d, device="cuda", generator=gen).to(dtype)
    return z, cb


def check_b5(gen) -> dict:
    """VQ argmin at (N=512, K=1024, D=256) fp32, the seg training shape,
    (N=8192, K=8192, D=256) bf16, the img_512 tokenization shape, and
    (N=2048, K=8192, D=256) bf16, the img_512 training shape; at
    D 320 and 512, bf16 and fp32 (2048 rows and codes); and at (1000, 3000)
    with D 72 (a dim chunk of 8) and 100 (bf16: zero-padded to 104), against
    the plain twin.  Tolerance: the agreement rule of
    ``mas_tpu_torch/ops/vq.py`` (where the indices differ, the twin's
    distance of the kernel's choice within 1e-5 * (||z||^2 + max ||e||^2)
    of the minimum; every chosen code the first of its exact copies),
    since the kernel sums each dot product in another order.  At the three
    main shapes, codebook rows 700 and K - 3 are copies of row 5, in other
    tiles and another run of the split than row 5; latent rows equal to
    row 5 must pick 5.  Two calls must give equal bits.  max_abs_err is
    the largest such distance gap.  Timed by ``b5_times``."""
    from mas_tpu_torch.ops import vq

    gap = 0.0
    for n, k, d, dtype in ((512, 1024, 256, torch.float32),
                           (8192, 8192, 256, torch.bfloat16),
                           (2048, 8192, 256, torch.bfloat16),
                           (2048, 2048, 320, torch.bfloat16),
                           (2048, 2048, 320, torch.float32),
                           (2048, 2048, 512, torch.bfloat16),
                           (2048, 2048, 512, torch.float32),
                           (1000, 3000, 72, torch.bfloat16),
                           (1000, 3000, 100, torch.bfloat16),
                           (1000, 3000, 100, torch.float32)):
        z, cb = _vq_inputs(gen, n, k, d, dtype)
        ties = d == 256
        if ties:
            cb[700] = cb[5]
            cb[k - 3] = cb[5]
            z[0] = cb[5]
            z[n - 1] = cb[5]
            z[1] = cb[17]
        got = vq.vq_argmin(z, cb)
        want = vq.vq_argmin_plain(z, cb)
        again = vq.vq_argmin(z, cb)
        torch.cuda.synchronize()
        what = f"B5 ({n}, {k}, {d}) {dtype}"
        require(got.dtype == torch.int32 and got.shape == (n,),
                f"{what}: output {got.dtype} {tuple(got.shape)}")
        require(torch.equal(got, again), f"{what}: two calls differ")
        require(vq.argmin_agrees(z, cb, got, want),
                f"{what}: indices disagree beyond near-ties "
                f"({int((got != want).sum())} rows differ)")
        if ties:
            picked = [int(got[0]), int(got[n - 1]), int(got[1])]
            require(picked == [5, 5, 17], f"{what} ties: {picked}")
        dist = vq.vq_distances(z, cb)
        gap = max(gap, float((dist.gather(1, got.long()[:, None])[:, 0]
                              - dist.min(dim=1).values).max()))
        print(f"{what}: agreement {float((got == want).float().mean()):.6f}"
              f"{', ties to row 5 across runs' if ties else ''}; two calls "
              "bitwise equal")
        del z, cb, dist
    res = b5_times(gen)
    for key, r in res.items():
        print(f"B5 {key}: one call {r['ms']:.4f} ms, back to back "
              f"{r['b2b_ms']:.4f} ms, graph {r['graph_ms']:.4f} ms "
              f"({100 * r['bound_share']:.1f}% of the bound "
              f"{r['bound_ms']:.4f} ms, {r['bound_by']}); plain "
              f"{r['plain_ms']:.4f} ms")
    out = dict(res["bf16"])
    out["fp32_graph_ms"] = res["fp32"]["graph_ms"]
    out["fp32_bound_ms"] = res["fp32"]["bound_ms"]
    out["library_ms"] = None
    out["max_abs_err"] = gap
    return out


def b5_times(gen) -> dict:
    """B5 at (8192, 8192, 256) bf16 (tokenization, "bf16") and (512, 1024,
    256) fp32 (seg training, "fp32"), for whichever ``mas_tpu_torch`` is
    imported: one call, back to back and replayed from a CUDA graph, and
    the plain twin one call at a time.  Bound: z and the codebook read
    once, the indices written, 2 N K D products at the peak of the inputs'
    type."""
    from mas_tpu_torch.ops import vq

    out = {}
    for key, (n, k, d), dtype in (("bf16", (8192, 8192, 256), torch.bfloat16),
                                  ("fp32", (512, 1024, 256), torch.float32)):
        z, cb = _vq_inputs(gen, n, k, d, dtype)
        fn = lambda: vq.vq_argmin(z, cb)
        out[key] = {"ms": timed_ms(fn), "b2b_ms": run_ms(fn),
                    "graph_ms": graph_ms(fn),
                    "plain_ms": timed_ms(lambda: vq.vq_argmin_plain(z, cb)),
                    **bound((n + k) * d * z.element_size() + n * 4,
                            2 * n * k * d + 2 * k * d, dtype)}
        out[key]["bound_share"] = out[key]["bound_ms"] / out[key]["graph_ms"]
    return out


def vq_times() -> dict:
    """``b5_times`` for whichever ``mas_tpu_torch`` is imported: ``python3
    chip_smoke.py --vq-times DIR`` imports it from DIR (e.g. a ``git
    archive`` of the parent commit), so two trees are timed on one card in
    one call."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    return {"B5": b5_times(gen)}


def _gn_inputs(gen, shape, dtype, groups=32, shifted=False):
    """x, g, scale, bias and B4's stats of x for a B8 call; x and g not
    16-byte aligned if ``shifted``."""
    from mas_tpu_torch.ops import gn_swish

    c = shape[-1]
    x = (torch.randn(*shape, device="cuda", generator=gen) * 2 + 0.5
         ).to(dtype)
    g = torch.randn(*shape, device="cuda", generator=gen).to(dtype)
    if shifted:
        x, g = _misaligned(x), _misaligned(g)
    s = torch.randn(c, device="cuda", generator=gen) * 0.5 + 1.0
    b = torch.randn(c, device="cuda", generator=gen) * 0.1
    return x, g, s, b, gn_swish.gn_swish(x, s, b, groups)[1]


def check_b8(gen) -> dict:
    """GroupNorm+swish backward at [2,256,256,128] fp32 (the seg encoder's
    largest), [2,16,16,512] fp32 (more blocks than rows to share: slices of
    one or two rows), [4,16,16,512] bf16, [4,256,256,128] bf16 and
    [2,512,512,128] bf16 (the img_512 training's largest), and at
    channel and group counts no model here uses: C 96 and 384 in 32 groups
    (no power of two), C 4096 (four slabs of
    channels) with 32 and 256 groups, C 8192 in 4 groups (a group wider
    than a slab), C 256 in 256 groups (a channel a group), C 8 in 2
    groups (a warp's lanes past C idle), C 6 and 18 in 3 groups (not a
    multiple of a thread's four channels: element loads) and bf16 x and g
    not 16-byte aligned (element loads), against
    the closed-form twin and against torch.autograd through gn_swish_plain.
    Tolerances: fp32 dx atol 1e-5 (elementwise work in another order; the
    per-group sums enter divided by N); dscale/dbias are sums over B*H*W
    rows, whose fp32 rounding grows like sqrt(rows): atol 1e-4 * sqrt(rows),
    rtol 1e-5; bf16 dx is rounded to bf16 once on each side: atol 3e-2,
    rtol 1e-2, as the B4 check.  Two calls must give equal bits (no atomics
    on the sums), also after replays from a CUDA graph.  Also:
    GroupNormSwish's output carries a grad_fn on the card and its gradients
    through GNSwishFunction (B4 + B8) match autograd of the plain twin.
    Timed by ``b8_times``."""
    from mas_tpu_torch.models.layers import GroupNormSwish
    from mas_tpu_torch.ops import gn_swish

    err, out = 0.0, {}
    for shape, dtype, groups, shifted in (
            ((2, 256, 256, 128), torch.float32, 32, False),
            ((2, 16, 16, 512), torch.float32, 32, False),
            ((4, 16, 16, 512), torch.bfloat16, 32, False),
            ((4, 256, 256, 128), torch.bfloat16, 32, False),
            ((2, 512, 512, 128), torch.bfloat16, 32, False),
            ((2, 32, 32, 96), torch.float32, 32, False),
            ((2, 32, 32, 96), torch.bfloat16, 32, False),
            ((2, 16, 16, 384), torch.float32, 32, False),
            ((2, 16, 16, 384), torch.bfloat16, 32, False),
            ((2, 16, 16, 4096), torch.float32, 32, False),
            ((2, 16, 16, 4096), torch.bfloat16, 256, False),
            ((1, 8, 8, 8192), torch.float32, 4, False),
            ((2, 16, 16, 256), torch.float32, 256, False),
            ((2, 32, 32, 8), torch.bfloat16, 2, False),
            ((1, 8, 8, 6), torch.float32, 3, False),
            ((2, 16, 16, 18), torch.bfloat16, 3, False),
            ((2, 32, 32, 128), torch.bfloat16, 32, True)):
        c = shape[-1]
        rows = shape[0] * shape[1] * shape[2]
        x, g, s, b, stats = _gn_inputs(gen, shape, dtype, groups, shifted)
        got = gn_swish.gn_swish_bwd(x, g, s, b, stats, groups)
        plain = gn_swish.gn_swish_bwd_plain(x, g, s, b, stats, groups)
        leaves = [t.detach().clone().requires_grad_() for t in (x, s, b)]
        auto = torch.autograd.grad(
            gn_swish.gn_swish_plain(*leaves, groups)[0], leaves, g)
        graph_ms(lambda: gn_swish.gn_swish_bwd(x, g, s, b, stats, groups),
                 calls=2, reps=2)
        again = gn_swish.gn_swish_bwd(x, g, s, b, stats, groups)
        torch.cuda.synchronize()
        require(all(torch.equal(a_, b_) for a_, b_ in zip(got, again)),
                f"B8 {shape} {dtype}: two calls differ (one after graph "
                "replays)")
        dx_tol = (1e-5, 0.0) if dtype == torch.float32 else (3e-2, 1e-2)
        p_tol = (1e-4 * rows ** 0.5, 1e-5)
        for name, want in (("plain twin", plain), ("autograd", auto)):
            require(close(got[0], want[0], *dx_tol),
                    f"B8 {shape} {dtype} G {groups} dx vs {name}: max err "
                    f"{max_err(got[0], want[0])}")
            for i, what in ((1, "dscale"), (2, "dbias")):
                require(close(got[i], want[i], *p_tol),
                        f"B8 {shape} {dtype} G {groups} {what} vs {name}: "
                        f"max err "
                        f"{max_err(got[i], want[i])}")
        err = max(err, max_err(got[0], plain[0]))
        print(f"B8 {shape} {dtype} G {groups}"
              f"{' misaligned' if shifted else ''}: dx max err "
              f"{max_err(got[0], plain[0]):.3e}"
              f", dscale {max_err(got[1], plain[1]):.3e}, dbias "
              f"{max_err(got[2], plain[2]):.3e}; two calls bitwise equal")
        if shape == (2, 256, 256, 128):
            norm = GroupNormSwish(c).cuda()
            with torch.no_grad():
                norm.weight.copy_(s)
                norm.bias.copy_(b)
            xin = x.permute(0, 3, 1, 2).detach().requires_grad_()
            y = norm(xin)
            require(y.requires_grad and y.grad_fn is not None,
                    "GroupNormSwish output carries no grad_fn on the card")
            fn = torch.autograd.grad(y, (xin, norm.weight, norm.bias),
                                     g.permute(0, 3, 1, 2))
            require(close(fn[0].permute(0, 2, 3, 1), auto[0], *dx_tol)
                    and close(fn[1], auto[1], *p_tol)
                    and close(fn[2], auto[2], *p_tol),
                    "GNSwishFunction gradients vs autograd of the twin")
        del x, g, got, plain, leaves, auto, again
    res = b8_times(gen)
    for key, r in res.items():
        print(f"B8 {key}: one call {r['ms']:.4f} ms, back to back "
              f"{r['b2b_ms']:.4f} ms, graph {r['graph_ms']:.4f} ms "
              f"({100 * r['bound_share']:.1f}% of the bound "
              f"{r['bound_ms']:.4f} ms, {r['bound_by']}); plain "
              f"{r['plain_ms']:.4f} ms")
    out.update(res["fp32"])
    for key in ("bf16", "fp32_b4", "bf16_b2"):
        out[f"{key}_graph_ms"] = res[key]["graph_ms"]
        out[f"{key}_bound_ms"] = res[key]["bound_ms"]
    out["library_ms"] = None
    out["max_abs_err"] = err
    return out


def bf16_ulps(a: torch.Tensor, b: torch.Tensor, n: int) -> bool:
    """|a - b| <= n bf16 ulps of max |b| everywhere."""
    top = float(b.float().abs().max())
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0
    return max_err(a, b) <= n * ulp


def check_b6(gen) -> dict:
    """Attention backward at [8, 16, 1408, 64] bf16 at prefix 384 and 0
    (the training geometry) and [2, 16, 640, 64] fp32 at prefix 384; at
    T = 200 (a ragged last tile) with head dims 64, 32 (zero-padded to 64),
    128, 160 (zero-padded to 256), 256 and 320 (zero-padded to 512: column
    passes), bf16 and fp32; [8, 16, 1408, d] bf16 at d 128, 256 and
    320, timed back to back; and a tensor-parallel rank's [8, 8, 1408, 64]
    bf16 at prefix 384 and 0 (phase 16, model 2), q/k/v
    as views into one fused qkv tensor, out and lse from B1 and dO laid out
    [B, T, H, d] as the model passes them.  Tolerances, per tensor against
    the plain twin: fp32 atol 1e-4 * max |grad| (both sum over up to T
    products in fp32, in other orders); bf16 two bf16 ulps of max |grad|
    (both round an fp32 value to bf16 once)."""
    from mas_tpu_torch.ops import attention

    out, err = {}, 0.0
    for (b, h, t, d), dtype, prefix in (
            ((8, 16, 1408, 64), torch.bfloat16, 384),
            ((8, 16, 1408, 64), torch.bfloat16, 0),
            ((2, 16, 640, 64), torch.float32, 384),
            ((2, 8, 200, 64), torch.bfloat16, 37),
            ((2, 8, 200, 32), torch.bfloat16, 37),
            ((2, 8, 200, 128), torch.bfloat16, 37),
            ((2, 8, 200, 128), torch.float32, 0),
            ((2, 8, 200, 32), torch.float32, 200),
            ((2, 8, 200, 160), torch.bfloat16, 37),
            ((2, 8, 200, 256), torch.bfloat16, 0),
            ((2, 8, 200, 256), torch.float32, 37),
            ((2, 8, 200, 160), torch.float32, 200),
            ((2, 8, 200, 320), torch.bfloat16, 37),
            ((2, 8, 200, 320), torch.float32, 0),
            ((8, 16, 1408, 128), torch.bfloat16, 384),
            ((8, 16, 1408, 256), torch.bfloat16, 384),
            ((8, 16, 1408, 320), torch.bfloat16, 384),
            ((8, 8, 1408, 64), torch.bfloat16, 384),
            ((8, 8, 1408, 64), torch.bfloat16, 0)):
        qkv = torch.randn(b, t, 3, h, d, device="cuda", generator=gen,
                          dtype=dtype)
        q, k, v = attention.split_qkv(qkv)
        o, lse = attention.flash_attention(q, k, v, prefix)
        do = torch.randn(b, t, h, d, device="cuda", generator=gen,
                         dtype=dtype).transpose(1, 2)
        got = attention.flash_attention_bwd(q, k, v, o, lse, do, prefix)
        want = attention.prefix_causal_attention_bwd_plain(q, k, v, o, lse,
                                                           do, prefix)
        torch.cuda.synchronize()
        for i, name in enumerate(("dq", "dk", "dv")):
            g, w = got[:, :, i].transpose(1, 2), want[i]
            ok = (bf16_ulps(g, w, 2) if dtype == torch.bfloat16 else
                  max_err(g, w) <= 1e-4 * float(w.abs().max()))
            require(ok, f"B6 {name} [{b},{h},{t},{d}] {dtype} prefix "
                    f"{prefix}: max err {max_err(g, w):.3e}, max |grad| "
                    f"{float(w.float().abs().max()):.3e}")
            err = max(err, max_err(g, w))
            print(f"B6 {name} [{b},{h},{t},{d}] {dtype} prefix {prefix}: "
                  f"max err {max_err(g, w):.3e}, max |grad| "
                  f"{float(w.float().abs().max()):.3e}")
        if (b, h, d) == (8, 16, 64) and dtype == torch.bfloat16 \
                and prefix == 384:
            args = (q, k, v, o, lse, do, prefix)
            kernel = lambda: attention.flash_attention_bwd(*args)
            out["ms"] = timed_ms(kernel)
            out["plain_ms"] = timed_ms(
                lambda: attention.prefix_causal_attention_bwd_plain(*args),
                reps=5)
            # the library call's backward, from its own forward's graph
            leaves = [x.detach().contiguous().requires_grad_()
                      for x in (q, k, v)]
            lib_out = F.scaled_dot_product_attention(
                *leaves, attn_mask=prefix_causal_mask(t, prefix))
            library = lambda: torch.autograd.grad(lib_out, leaves, do,
                                                  retain_graph=True)
            out["library_ms"] = timed_ms(library, reps=10)
            print(f"B6 [{b},{h},{t},{d}] bf16 prefix {prefix}, back to back: "
                  f"kernel {run_ms(kernel):.4f} ms, library "
                  f"{run_ms(library, calls=10):.4f} ms")
            del leaves, lib_out, library, kernel
            n = b * h * t * d
            out.update(bound(8 * n * 2 + b * h * t * 4,
                             10 * d * prefix_causal_pairs(t, prefix) * b * h,
                             torch.bfloat16))
        elif d in (128, 256, 320) and t == 1408:
            args = (q, k, v, o, lse, do, prefix)
            n = b * h * t * d
            bd = bound(8 * n * 2 + b * h * t * 4,
                       10 * d * prefix_causal_pairs(t, prefix) * b * h,
                       torch.bfloat16)
            ms = run_ms(lambda: attention.flash_attention_bwd(*args),
                        calls=20 if d < 320 else 3)
            out[f"d{d}_b2b_ms"] = ms
            print(f"B6 [{b},{h},{t},{d}] bf16 prefix {prefix}, back to back: "
                  f"kernel {ms:.4f} ms, bound {bd['bound_ms']:.4f} ms "
                  f"({bd['bound_by']})")
        del got, want
    out["max_abs_err"] = err
    return out


LN_TRAIN = (11264, 1024)   # the train step's B * T rows, hidden 1024


def _ln_inputs(gen, n, d, dtype):
    x = (torch.randn(n, d, device="cuda", generator=gen) * 2 + 0.5).to(dtype)
    g = torch.randn(n, d, device="cuda", generator=gen).to(dtype)
    s = torch.randn(d, device="cuda", generator=gen) * 0.5 + 1.0
    b = torch.randn(d, device="cuda", generator=gen) * 0.1
    return x, g, s, b


def b7_times(gen) -> dict:
    """B7 forward + backward at [11264, 1024] bf16, for whichever
    ``mas_tpu_torch`` is imported: the pair one call at a time
    (``timed_ms``), back to back (``run_ms``) and replayed from a CUDA graph
    (``graph_ms``, the device time; also each wrapper alone); each
    wrapper's host time per call (``host_ms``); the plain twins; and
    ``F.layer_norm`` forward +
    backward (bf16 parameters: it refuses fp32 ones on a bf16 input) in
    the same three ways."""
    from mas_tpu_torch.ops import layer_norm as ln

    n, d = LN_TRAIN
    x, g, s, b = _ln_inputs(gen, n, d, torch.bfloat16)
    pair = lambda: (ln.layer_norm_fwd(x, s, b), ln.layer_norm_bwd(x, g, s))
    lib_in = [t.detach().to(torch.bfloat16).requires_grad_()
              for t in (x, s, b)]
    library = lambda: torch.autograd.grad(
        F.layer_norm(lib_in[0], (d,), lib_in[1], lib_in[2], 1e-5), lib_in, g)
    out = {"ms": timed_ms(pair), "b2b_ms": run_ms(pair),
           "graph_ms": graph_ms(pair),
           "fwd_graph_ms": graph_ms(lambda: ln.layer_norm_fwd(x, s, b)),
           "bwd_graph_ms": graph_ms(lambda: ln.layer_norm_bwd(x, g, s)),
           "fwd_host_ms": host_ms(lambda: ln.layer_norm_fwd(x, s, b)),
           "bwd_host_ms": host_ms(lambda: ln.layer_norm_bwd(x, g, s)),
           "plain_ms": timed_ms(lambda: (ln.layer_norm_fwd_plain(x, s, b),
                                         ln.layer_norm_bwd_plain(x, g, s))),
           "library_ms": timed_ms(library), "library_b2b_ms": run_ms(library),
           "library_graph_ms": graph_ms(library),
           **bound(5 * n * d * 2, 20 * n * d, torch.bfloat16)}
    out["bound_share"] = out["bound_ms"] / out["graph_ms"]
    return out


def check_b7(gen) -> dict:
    """LayerNorm forward and backward at [11264, 1024] (the train step's
    B * T rows) in bf16 and fp32 against the plain twins and against
    autograd through the forward twin (on an fp32 copy of x); also, bf16
    and fp32, at [3000, 1000] (a multiple of 8, not of a block's 256 or
    1024 columns: vector loads of a partly covered row), [3000, 1001] (odd:
    element loads, and element sums of the partials at both levels),
    [4096, 1002] (even, not a multiple of 4: element loads, vector sums at
    level 1 and element sums at level 2), [4096, 64] (one warp a row,
    vector loads), [4096, 100] (one warp a row; element loads in bf16),
    [2000, 37] (one warp a row, element loads), [2048, 4096] (eight warps
    a row) and [300, 8192].  Tolerances: y and dx are
    rounded to x's dtype once from fp32 values that differ only in
    summation order: fp32 atol 1e-5, rtol 1e-5; bf16 atol 1e-2, rtol 1e-2
    (one bf16 ulp is 2^-8 to 2^-7 relative).  dscale and dbias are fp32
    sums over the rows, whose rounding grows like sqrt(rows): atol 1e-4 *
    sqrt(rows), rtol 1e-5, as for B8.  Two calls must give equal bits (no
    atomics on the sums), also after the pair was replayed from a CUDA
    graph (the backward's ticket counters).  Timed by ``b7_times``."""
    from mas_tpu_torch.ops import layer_norm as ln

    out, err = {}, 0.0
    for (n, d) in (LN_TRAIN, (3000, 1000), (3000, 1001), (4096, 1002),
                   (4096, 64), (4096, 100), (2000, 37), (2048, 4096),
                   (300, 8192)):
        for dtype in (torch.bfloat16, torch.float32):
            x, g, s, b = _ln_inputs(gen, n, d, dtype)
            y = ln.layer_norm_fwd(x, s, b)
            py = ln.layer_norm_fwd_plain(x, s, b)
            got = ln.layer_norm_bwd(x, g, s)
            want = ln.layer_norm_bwd_plain(x, g, s)
            leaves = [t.detach().float().requires_grad_() for t in (x, s, b)]
            auto = torch.autograd.grad(
                ln.layer_norm_fwd_plain(*leaves), leaves, g.float())
            again = ln.layer_norm_bwd(x, g, s)
            torch.cuda.synchronize()
            tol = (1e-5, 1e-5) if dtype == torch.float32 else (1e-2, 1e-2)
            p_tol = (1e-4 * n ** 0.5, 1e-5)
            what = f"B7 [{n},{d}] {dtype}"
            require(y.dtype == dtype and close(y, py, *tol),
                    f"{what} fwd: max err {max_err(y, py):.3e}")
            for name, ref in (("plain twin", want), ("autograd", auto)):
                require(got[0].dtype == dtype and close(got[0], ref[0], *tol),
                        f"{what} dx vs {name}: max err "
                        f"{max_err(got[0], ref[0]):.3e}")
                for i, part in ((1, "dscale"), (2, "dbias")):
                    require(close(got[i], ref[i], *p_tol), f"{what} {part} vs "
                            f"{name}: max err {max_err(got[i], ref[i]):.3e}")
            require(all(torch.equal(a_, b_) for a_, b_ in zip(got, again)),
                    f"{what}: two backward calls differ")
            err = max(err, max_err(y, py), max_err(got[0], want[0]))
            print(f"{what}: y max err {max_err(y, py):.3e}, dx "
                  f"{max_err(got[0], want[0]):.3e}, dscale "
                  f"{max_err(got[1], want[1]):.3e}, dbias "
                  f"{max_err(got[2], want[2]):.3e}; two calls bitwise equal")
    x, g, s, b = _ln_inputs(gen, *LN_TRAIN, torch.bfloat16)
    first = (ln.layer_norm_fwd(x, s, b), *ln.layer_norm_bwd(x, g, s))
    graph_ms(lambda: (ln.layer_norm_fwd(x, s, b), ln.layer_norm_bwd(x, g, s)),
             calls=3, reps=2)
    after = (ln.layer_norm_fwd(x, s, b), *ln.layer_norm_bwd(x, g, s))
    torch.cuda.synchronize()
    require(all(torch.equal(a_, b_) for a_, b_ in zip(first, after)),
            "B7: a call after graph replays differs from one before")
    res = b7_times(gen)
    print(f"B7 bf16 {list(LN_TRAIN)} fwd + bwd: one call {res['ms']:.4f} ms, "
          f"back to back {res['b2b_ms']:.4f} ms, graph {res['graph_ms']:.4f} "
          f"ms ({100 * res['bound_share']:.1f}% of the bound "
          f"{res['bound_ms']:.4f} ms, {res['bound_by']}; graph fwd "
          f"{res['fwd_graph_ms']:.4f}, bwd {res['bwd_graph_ms']:.4f}); host "
          f"per call fwd "
          f"{res['fwd_host_ms']:.4f} ms, bwd {res['bwd_host_ms']:.4f} ms; "
          f"F.layer_norm one call {res['library_ms']:.4f} ms, back to back "
          f"{res['library_b2b_ms']:.4f} ms, graph "
          f"{res['library_graph_ms']:.4f} ms; plain {res['plain_ms']:.4f} ms")
    out.update(res)
    out["max_abs_err"] = err
    return out


def b8_times(gen) -> dict:
    """B8 at [2, 256, 256, 128] fp32 (the seg encoder's largest) and [4,
    256, 256, 128] bf16, for whichever ``mas_tpu_torch`` is imported: one
    call (``timed_ms``), back to back (``run_ms``) and replayed from a CUDA
    graph (``graph_ms``), and the plain twin one call at a time.  Also
    [4, 256, 256, 128] fp32 and [2, 256, 256, 128] bf16 ("fp32_b4",
    "bf16_b2"): with the two timed shapes, the same bytes at twice the
    elements and the same elements at twice the bytes, which tell whether
    a dtype's time follows its bytes or its elements."""
    from mas_tpu_torch.ops import gn_swish

    out = {}
    for key, shape, dtype in (("fp32", (2, 256, 256, 128), torch.float32),
                              ("bf16", (4, 256, 256, 128), torch.bfloat16),
                              ("fp32_b4", (4, 256, 256, 128), torch.float32),
                              ("bf16_b2", (2, 256, 256, 128),
                               torch.bfloat16)):
        x, g, s, b, stats = _gn_inputs(gen, shape, dtype)
        fn = lambda: gn_swish.gn_swish_bwd(x, g, s, b, stats)
        n = x.numel()
        out[key] = {"ms": timed_ms(fn), "b2b_ms": run_ms(fn),
                    "graph_ms": graph_ms(fn),
                    "plain_ms": timed_ms(lambda: gn_swish.gn_swish_bwd_plain(
                        x, g, s, b, stats)),
                    **bound(3 * n * x.element_size(), 20 * n, dtype)}
        out[key]["bound_share"] = out[key]["bound_ms"] / out[key]["graph_ms"]
        del x, g
    return out


def norm_times() -> dict:
    """``b4_times``, ``b7_times`` and ``b8_times`` for whichever
    ``mas_tpu_torch`` is imported: ``python3 chip_smoke.py --norm-times
    DIR`` imports it from DIR (e.g. a ``git archive`` of the parent
    commit), so two trees are timed on one card in one call."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    return {"B4": b4_times(gen), "B7": b7_times(gen), "B8": b8_times(gen)}


def b9_times(gen, rows: int) -> dict:
    """B9 over bf16 caches [rows, 16, 1408, 64] at index 1407 (every
    position read; the 512^2 geometry), q bf16: the kernel, and the library
    call ``F.scaled_dot_product_attention`` over the valid prefix, one call
    at a time (``timed_ms``) and back to back (``run_ms``), and the plain
    twin; each rotates over ``n_sets`` cache sets so the cache is read from
    device memory."""
    from mas_tpu_torch.ops import decode_attention as da

    h, t, d = 16, 1408, 64
    pair = 2 * rows * h * t * d * 2
    idx = torch.tensor([1407], dtype=torch.int32, device="cuda")
    sets = [(_decode_q(gen, rows, h, d),
             *(da.FloatCache(torch.randn(rows, h, t, d, device="cuda",
                                         generator=gen, dtype=torch.bfloat16))
               for _ in range(2)))
            for _ in range(n_sets(pair))]
    kernel = rotating(lambda q, kc, vc: da.decode_attention_float(
        q, kc, vc, idx), sets)
    plain = rotating(lambda q, kc, vc: da.decode_attention_float_plain(
        q, kc, vc, idx), sets)
    library = rotating(lambda q, kc, vc: F.scaled_dot_product_attention(
        q, kc.data, vc.data), [(q.contiguous(), kc, vc)
                               for q, kc, vc in sets])
    out = {"ms": timed_ms(kernel), "b2b_ms": run_ms(kernel),
           "graph_ms": graph_ms(kernel),
           "library_ms": timed_ms(library), "library_b2b_ms": run_ms(library),
           "library_graph_ms": graph_ms(library),
           "plain_ms": timed_ms(plain, reps=5), "sets": len(sets),
           **bound(2 * rows * h * t * d * 2 + 2 * rows * h * d * 2,
                   4 * d * t * rows * h, torch.bfloat16)}
    out["bound_share"] = out["bound_ms"] / out["graph_ms"]
    return out


def check_b9(gen) -> dict:
    """Float-cache decode read at the 512^2 serving shape: q [rows, 16, 1,
    64] bf16 (a view into qkv) against bf16 caches [rows, 16, 1408, 64] at
    128 rows (batch 64 with guidance) and 8 rows (batch 4), at the indices
    of CHUNK_EDGES and 895 and 1407; head dims 32, 128 and 256 too, and 96
    and 160 over caches padded to 128 and 256 values a position, 47 (padded
    to 64), 320 and 512 (positions of 512 values in chunks of 256); fp32 q
    and caches [8, 16, 640, 64], [128, 16, 640, 64], d 128, 256 and 320.
    Tolerance: both versions accumulate in fp32 and round the output to
    bf16 once:
    atol 1e-2, rtol 1e-2; fp32 q and caches: only the fp32 summation order
    differs, atol 1e-5, rtol 1e-5.  Timed by ``b9_times`` at both row
    counts."""
    from mas_tpu_torch.ops import decode_attention as da

    h = 16
    out, err = {}, 0.0
    for rows, t, d, dtype in ((128, 1408, 64, torch.bfloat16),
                              (8, 1408, 64, torch.bfloat16),
                              (8, 1408, 32, torch.bfloat16),
                              (8, 1408, 128, torch.bfloat16),
                              (128, 1408, 128, torch.bfloat16),
                              (128, 640, 32, torch.bfloat16),
                              (8, 1408, 256, torch.bfloat16),
                              (128, 640, 256, torch.bfloat16),
                              (8, 640, 96, torch.bfloat16),
                              (128, 640, 160, torch.bfloat16),
                              (8, 640, 47, torch.bfloat16),
                              (8, 640, 320, torch.bfloat16),
                              (128, 640, 512, torch.bfloat16),
                              (8, 640, 320, torch.float32),
                              (8, 640, 64, torch.float32),
                              (128, 640, 64, torch.float32),
                              (8, 640, 128, torch.float32),
                              (8, 640, 256, torch.float32)):
        q = _decode_q(gen, rows, h, d, dtype)
        kc, vc = (da.FloatCache.seeded(torch.randn(
            rows, h, t, d, device="cuda", generator=gen, dtype=dtype), t)
                  for _ in range(2))
        indices = sorted({i for i in CHUNK_EDGES + (895, 1407) if i < t}
                         | {t - 1})
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        for index in indices:
            idx = torch.tensor([index], dtype=torch.int32, device="cuda")
            o = da.decode_attention_float(q, kc, vc, idx)
            p = da.decode_attention_float_plain(q, kc, vc, idx)
            torch.cuda.synchronize()
            require(close(o, p, tol, tol), f"B9 [{rows},{h},{t},{d}] {dtype} "
                    f"index {index}: max err {max_err(o, p)}")
            if dtype == torch.bfloat16:
                err = max(err, max_err(o, p))
        print(f"B9 [{rows},{h},{t},{d}] {dtype}, index {indices[0]}.."
              f"{indices[-1]} ({len(indices)}): ok")
        del kc, vc
    # grouped-query reads: 16 query heads over 16 / g kv heads (from a
    # generator of their own, see check_b2)
    own = torch.Generator(device="cuda").manual_seed(9)
    for rows, t, d, g, dtype in ((128, 1408, 64, 4, torch.bfloat16),
                                 (8, 1408, 64, 4, torch.bfloat16),
                                 (8, 640, 64, 2, torch.bfloat16),
                                 (8, 640, 256, 16, torch.bfloat16),
                                 (128, 640, 64, 4, torch.float32),
                                 (8, 640, 64, 4, torch.float32)):
        kv = h // g
        q = _gqa_q(own, rows, h, kv, d, dtype)
        kc, vc = (da.FloatCache.seeded(torch.randn(
            rows, kv, t, d, device="cuda", generator=own, dtype=dtype), t)
                  for _ in range(2))
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        for index in (0, 6, 7, 8, 127, 383, 639, t - 1):
            idx = torch.tensor([index], dtype=torch.int32, device="cuda")
            o = da.decode_attention_float(q, kc, vc, idx)
            p = da.decode_attention_float_plain(q, kc, vc, idx)
            torch.cuda.synchronize()
            require(close(o, p, tol, tol), f"B9 grouped [{rows},{kv},{t},"
                    f"{d}] g {g} {dtype} index {index}: max err "
                    f"{max_err(o, p)}")
            if dtype == torch.bfloat16:
                err = max(err, max_err(o, p))
        print(f"B9 grouped [{rows},{kv},{t},{d}] g {g} {dtype}, 8 indices: "
              "ok")
        if (rows, t, g, dtype) == (128, 1408, 4, torch.bfloat16):
            idx = torch.tensor([1407], dtype=torch.int32, device="cuda")
            fn = lambda: da.decode_attention_float(q, kc, vc, idx)
            out["gqa4_graph_ms"] = graph_ms(fn)
            out["gqa4_b2b_ms"] = run_ms(fn)
            out["gqa4_bound_ms"] = bound(
                2 * rows * kv * t * d * 2 + 2 * rows * h * d * 2,
                4 * d * t * rows * h, torch.bfloat16)["bound_ms"]
            print(f"B9 GQA-4 bf16 [{rows},{kv},{t},{d}] index 1407 (one "
                  f"cache pair of {2 * rows * kv * t * d * 2 / 1e6:.0f} MB): "
                  f"graph {out['gqa4_graph_ms']:.4f} ms, back to back "
                  f"{out['gqa4_b2b_ms']:.4f} ms, bound "
                  f"{out['gqa4_bound_ms']:.4f} ms")
        del kc, vc
    # head dim 256, not a speed goal: device time over one cache pair of
    # 2 x 1.5 GB
    q = _decode_q(gen, 128, h, 256)
    kc, vc = (da.FloatCache(torch.randn(128, h, 1408, 256, device="cuda",
                                        generator=gen, dtype=torch.bfloat16))
              for _ in range(2))
    idx = torch.tensor([1407], dtype=torch.int32, device="cuda")
    out["d256_graph_ms"] = graph_ms(
        lambda: da.decode_attention_float(q, kc, vc, idx))
    print(f"B9 bf16 [128,{h},1408,256] index 1407: graph "
          f"{out['d256_graph_ms']:.4f} ms")
    del q, kc, vc
    q = _decode_q(gen, 128, h, 512)
    kc, vc = (da.FloatCache(torch.randn(128, h, 1408, 512, device="cuda",
                                        generator=gen, dtype=torch.bfloat16))
              for _ in range(2))
    out["d512_graph_ms"] = graph_ms(
        lambda: da.decode_attention_float(q, kc, vc, idx))
    bd = bound(2 * 128 * h * 1408 * 512 * 2, 0, torch.bfloat16)
    print(f"B9 bf16 [128,{h},1408,512] index 1407: graph "
          f"{out['d512_graph_ms']:.4f} ms (bound {bd['bound_ms']:.4f} ms)")
    del q, kc, vc
    for rows in (128, 8):
        res = b9_times(gen, rows)
        print(f"B9 bf16 [{rows},{h},1408,64] index 1407 ({res['sets']} cache "
              f"sets): kernel one call / back to back / graph "
              f"{res['ms']:.4f} / {res['b2b_ms']:.4f} / {res['graph_ms']:.4f}"
              f" ms; SDPA {res['library_ms']:.4f} / "
              f"{res['library_b2b_ms']:.4f} / {res['library_graph_ms']:.4f} "
              f"ms; plain {res['plain_ms']:.4f} ms; bound "
              f"{res['bound_ms']:.4f} ms ({res['bound_by']}), "
              f"{100 * res['bound_share']:.1f}% of it")
        if rows == 128:
            out.update(res)
        else:
            out["batch4_graph_ms"] = res["graph_ms"]
            out["batch4_library_graph_ms"] = res["library_graph_ms"]
            out["batch4_bound_ms"] = res["bound_ms"]
    out["max_abs_err"] = err
    return out


def decode_times() -> dict:
    """``b2_times``, ``b9_times`` and ``write_times`` (B3, B10) at 128 and
    8 rows, for whichever ``mas_tpu_torch`` is imported: ``python3
    chip_smoke.py --decode-times DIR`` imports it from DIR (e.g. a ``git
    archive`` of the parent commit), so two trees are timed on one card in
    one call."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {f"B{k}_{rows}": fn(gen, rows) for k, fn in (("2", b2_times),
                                                       ("9", b9_times))
           for rows in (128, 8)}
    for rows in (128, 8):
        for kid, res in write_times(gen, rows).items():
            out[f"{kid}_{rows}"] = res
    return out


def mha_outputs() -> dict:
    """SHA-256 digests (16 hex digits) of the multi-head decode reads (B2
    int4/int8, B9), cache writes (B3), B1, and the logits of a full-width
    ``configs/sample_256.json`` prefill + 8 decode steps, all on inputs
    and weights made on the CPU from seed 0, for whichever
    ``mas_tpu_torch`` is imported: ``python3 chip_smoke.py --mha-outputs
    DIR`` for two trees in one call shows whether their multi-head paths
    give the same bits."""
    import hashlib

    from mas_tpu_torch.cli import load_transformer
    from mas_tpu_torch.ops import attention
    from mas_tpu_torch.ops import decode_attention as da
    from mas_tpu_torch.ops import decode_cache, quant
    from mas_tpu_torch.utils.config import TransformerConfig

    cpu = torch.Generator().manual_seed(0)

    def rn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=cpu).to(dtype).cuda()

    res = {}
    for rows in (128, 8):
        qkv = rn(rows, 1, 3, 16, 64, dtype=torch.bfloat16)
        q = qkv[:, :, 0].transpose(1, 2)
        for bits in (4, 8):
            kc, vc = (quant.quantize_kv(rn(rows, 16, 640, 64), bits)
                      for _ in range(2))
            for i in (0, 7, 383, 511, 639):
                idx = torch.tensor([i], dtype=torch.int32, device="cuda")
                res[f"B2 {rows} int{bits} {i}"] = \
                    quant.decode_attention_quant(q, kc, vc, idx)
            idx = torch.tensor([600], dtype=torch.int32, device="cuda")
            decode_cache.write_quant_kv(kc, vc, qkv[:, 0, 1], qkv[:, 0, 2],
                                        idx)
            res[f"B3 {rows} int{bits}"] = torch.cat(
                [t[:, :, 600].flatten().float()
                 for t in (kc.q, kc.scale, vc.q, vc.scale)])
        kc, vc = (da.FloatCache(rn(rows, 16, 1408, 64, dtype=torch.bfloat16))
                  for _ in range(2))
        for i in (0, 7, 895, 1407):
            idx = torch.tensor([i], dtype=torch.int32, device="cuda")
            res[f"B9 {rows} {i}"] = da.decode_attention_float(q, kc, vc, idx)
    qkv = rn(8, 384, 3, 16, 64, dtype=torch.bfloat16)
    res["B1"] = attention.flash_attention(*attention.split_qkv(qkv), 384)[0]
    with open(CONFIG) as f:
        tcfg = TransformerConfig.from_dict(json.load(f)["transformer"])
    model = load_transformer(tcfg, None, "cpu", cpu).cuda()
    text = torch.randint(1, 16000, (4, 128), generator=cpu).cuda()
    seg = torch.randint(0, 1024, (4, 256), generator=cpu).cuda()
    img = torch.randint(0, 8192, (4, 8), generator=cpu).cuda()
    with torch.inference_mode():
        logits, kvs = model.prefill(text, seg)
        caches = model.allocate_caches(kvs, 4)
        outs = [logits]
        for step in range(8):
            outs.append(model.decode_step(img[:, step:step + 1], step,
                                          caches))
    res["MHA int4 prefill + 8 decode steps, logits"] = torch.stack(outs)
    torch.cuda.synchronize()
    return {k: hashlib.sha256(v.float().cpu().numpy().tobytes()).hexdigest()[
        :16] for k, v in res.items()}


LN_ROWS, LN_D = 16 * 1408, 1024


def check_b11(gen) -> dict:
    """Residual add + LayerNorm stats at the harness shape [16 * 1408, 1024]
    bf16, and at [1000, 1000] fp32 (no power of two, no multiple of the
    TPU kernel's 512-row tile).  x must be bitwise equal (one fp32 add,
    rounded once); the stats are fp32 row sums in another order, and
    rstd a reciprocal square root: atol 1e-6, rtol 1e-6.  At the harness
    shape, kernel and twin are timed one call at a time (``ms``), back to
    back (``run_ms``) and replayed from a CUDA graph (``graph_ms``, the
    device time without the Triton launch's host time)."""
    from mas_tpu_torch.ops import ln_producer

    out, err = {}, 0.0
    for (rows, d), dtype in (((LN_ROWS, LN_D), torch.bfloat16),
                             ((1000, 1000), torch.float32)):
        a, b = (torch.randn(rows, d, device="cuda", generator=gen).to(dtype)
                for _ in range(2))
        x, st = ln_producer.add_stats(a, b)
        px, pst = ln_producer.add_stats_plain(a, b)
        torch.cuda.synchronize()
        require(torch.equal(x, px), f"B11 [{rows},{d}] {dtype}: x differs "
                "from the plain twin")
        require(close(st, pst, 1e-6, 1e-6), f"B11 [{rows},{d}] {dtype}: "
                f"stats max err {max_err(st, pst)}")
        err = max(err, max_err(st, pst))
        print(f"B11 [{rows},{d}] {dtype}: x bitwise equal, stats max err "
              f"{max_err(st, pst):.3e}")
        if dtype == torch.bfloat16:
            kernel = lambda: ln_producer.add_stats(a, b)
            plain = lambda: ln_producer.add_stats_plain(a, b)
            out["ms"] = timed_ms(kernel)
            out["plain_ms"] = timed_ms(plain)
            for key, fn in (("", kernel), ("plain_", plain)):
                out[f"{key}graph_ms"] = graph_ms(fn)
                out[f"{key}run_ms"] = run_ms(fn)
            n = rows * d
            out.update(bound(3 * n * 2 + rows * 8, 6 * n, torch.bfloat16))
            print(f"B11 [{rows},{d}] bf16 device time: graph "
                  f"{out['graph_ms']:.4f} ms, back to back "
                  f"{out['run_ms']:.4f} ms; plain graph "
                  f"{out['plain_graph_ms']:.4f} ms, back to back "
                  f"{out['plain_run_ms']:.4f} ms; bound "
                  f"{out['bound_ms']:.4f} ms ({out['bound_by']})")
    out["library_ms"] = None
    out["max_abs_err"] = err
    return out


KERNELS = (
    # id, name, route, source, replaces, check
    ("B1", "B1 flash_attention", "cuda", "mas_tpu_torch/csrc/flash_fwd.cu",
     "mas_tpu/ops/attention.py:117", check_b1),
    ("B2", "B2 decode_attention_quant", "cuda",
     "mas_tpu_torch/csrc/decode_quant.cu", "mas_tpu/ops/quant.py:187",
     check_b2),
    ("B3", "B3 write_quant_kv", "cuda", "mas_tpu_torch/csrc/kv_write.cu",
     "mas_tpu/ops/decode_cache.py:270", check_b3),
    ("B4", "B4 gn_swish", "cuda", "mas_tpu_torch/csrc/gn_swish_fwd.cu",
     "mas_tpu/ops/pallas/gn_swish.py:50", check_b4),
    ("B5", "B5 vq_argmin", "cuda", "mas_tpu_torch/csrc/vq_argmin.cu",
     "mas_tpu/ops/vq.py:33", check_b5),
    ("B6", "B6 flash_attention_bwd", "cuda", "mas_tpu_torch/csrc/flash_bwd.cu",
     "mas_tpu/ops/attention.py:354", check_b6),
    ("B7", "B7 layer_norm_fwd + layer_norm_bwd", "cuda",
     "mas_tpu_torch/csrc/layer_norm.cu", "mas_tpu/ops/pallas/layer_norm.py:47",
     check_b7),
    ("B8", "B8 gn_swish_bwd", "cuda", "mas_tpu_torch/csrc/gn_swish_bwd.cu",
     "mas_tpu/ops/pallas/gn_swish.py:117", check_b8),
    ("B9", "B9 decode_attention_float", "cuda",
     "mas_tpu_torch/csrc/decode_quant.cu", "mas_tpu/ops/decode_attention.py:69",
     check_b9),
    ("B10", "B10 write_packed_kv", "cuda", "mas_tpu_torch/csrc/kv_write.cu",
     "mas_tpu/ops/decode_cache.py:111", check_b10),
    ("B11", "B11 add_stats", "triton", "mas_tpu_torch/ops/ln_producer.py",
     "benchmarks/ln_producer.py:49", check_b11),
)


def wrappers() -> dict:
    """The launch-counting wrappers of each kernel, keyed by its id in
    KERNELS order (B7's forward and backward are two wrappers)."""
    from mas_tpu_torch.ops import (attention, decode_attention, decode_cache,
                                   gn_swish, layer_norm, ln_producer, quant,
                                   vq)

    return {"B1": (attention.flash_attention,),
            "B2": (quant.decode_attention_quant,),
            "B3": (decode_cache.write_quant_kv,),
            "B4": (gn_swish.gn_swish,), "B5": (vq.vq_argmin,),
            "B6": (attention.flash_attention_bwd,),
            "B7": (layer_norm.layer_norm_fwd, layer_norm.layer_norm_bwd),
            "B8": (gn_swish.gn_swish_bwd,),
            "B9": (decode_attention.decode_attention_float,),
            "B10": (decode_cache.write_packed_kv,),
            "B11": (ln_producer.add_stats,)}


def reset_counts() -> None:
    for fns in wrappers().values():
        for fn in fns:
            fn.launches = 0


def read_counts() -> dict:
    """Launches since ``reset_counts``, per kernel id."""
    return {k: sum(fn.launches for fn in fns)
            for k, fns in wrappers().items()}


def phase_kernels(gen) -> list:
    rows = []
    for kid, name, route, source, replaces, check in KERNELS:
        res = check(gen)
        lib = res["library_ms"]
        print(f"{name}: kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f}"
              f" ms, library {'none' if lib is None else f'{lib:.4f} ms'}, "
              f"bound {res['bound_ms']:.4f} ms ({res['bound_by']})")
        rows.append(dict(id=kid, name=name, route=route, source=source,
                         replaces=replaces, **res))
    return rows


# --- phase 4: the main path at full width -----------------------------------

def load_pipeline(raw, gen):
    """Transformer and VQ-IMG as ``mas_tpu_torch.cli.run_sample`` loads
    them, and the prompts' tokens on the card."""
    from mas_tpu_torch.cli import load_transformer, load_vq, prompt_tokens
    from mas_tpu_torch.utils.config import TransformerConfig, VQModelConfig

    tcfg = TransformerConfig.from_dict(raw["transformer"])
    vcfg = VQModelConfig.from_dict(raw["model"])
    transformer = load_transformer(tcfg, raw.get("transformer_checkpoint"),
                                   "cuda", gen)
    vq = load_vq(vcfg, raw.get("vq_checkpoint"), "cuda", gen)
    text, seg = prompt_tokens(raw, tcfg, raw["train"]["batch_size"])
    return transformer, vq, torch.from_numpy(text).cuda(), \
        torch.from_numpy(seg).cuda()


def run_slice(raw, transformer, vq, text, seg, seed: int):
    from mas_tpu_torch.models.sampler import sample_images

    gen = torch.Generator(device="cuda").manual_seed(seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    imgs = sample_images(transformer, vq, text, seg, gen,
                         guidance_scale=raw["guidance_scale"],
                         temperature=raw["temperature"], top_k=raw["top_k"])
    torch.cuda.synchronize()
    return imgs, time.perf_counter() - t0


def count_gns(module) -> int:
    from mas_tpu_torch.models.layers import GroupNormSwish

    return sum(isinstance(m, GroupNormSwish) for m in module.modules())


def phase_slice(gen) -> dict:
    """The serving path; returns its launch count per kernel."""
    with open(CONFIG) as f:
        raw = json.load(f)
    transformer, vq, text, seg = load_pipeline(raw, gen)
    cfg = transformer.cfg
    n_gns = count_gns(vq.decoder)
    reset_counts()
    imgs, secs = run_slice(raw, transformer, vq, text, seg, seed=1)
    counts = read_counts()
    print(f"slice: images {tuple(imgs.shape)} in {secs:.2f} s (first run, "
          f"includes kernel JIT); launches {counts}")
    require(tuple(imgs.shape) == (4, 256, 256, 3), f"image shape "
            f"{tuple(imgs.shape)}")
    require(bool(torch.isfinite(imgs).all()), "images are finite")
    steps = cfg.image_length - 1
    floors = {"B1": cfg.num_layers, "B2": cfg.num_layers * steps,
              "B3": cfg.num_layers * steps, "B4": n_gns}
    for kid, floor in floors.items():
        require(counts[kid] >= floor, f"{kid} launched {counts[kid]} times "
                f"on the serving path, expected >= {floor}")

    teacher_forced_check(transformer, text, seg, gen)

    _, secs4 = run_slice(raw, transformer, vq, text, seg, seed=2)
    print(f"e2e batch 4: {secs4:.3f} s, {4 / secs4:.3f} img/s")
    rep = 16
    _, secs64 = run_slice(raw, transformer, vq, text.repeat(rep, 1),
                          seg.repeat(rep, 1), seed=3)
    print(f"e2e batch 64: {secs64:.3f} s, {64 / secs64:.3f} img/s")
    for batch in (4, 64):
        _MHA_DECODE[batch] = decode_profile(transformer, text, seg, batch)
        print_decode_profile("sample_256 (MHA, int4)", batch,
                             _MHA_DECODE[batch])
    return counts


# phase 4's decode-step profiles by batch, beside which phase 14 prints
# its variants'
_MHA_DECODE = {}


def decode_profile(transformer, text, seg, batch: int, steps: int = 16):
    """Host ms, device busy ms and idle share of ``steps`` decode steps
    from step 8, with the ported kernels' ms a step
    (``breakdown._profile``), at ``batch`` prompts with guidance."""
    from mas_tpu_torch.breakdown import _decode_steps, _profile

    reps = -(-batch // text.shape[0])
    t, s = text.repeat(reps, 1)[:batch], seg.repeat(reps, 1)[:batch]
    with torch.inference_mode():
        logits, kvs = transformer.prefill(torch.cat([t, torch.zeros_like(t)]),
                                          torch.cat([s, s]))
        caches = transformer.allocate_caches(kvs, 2 * batch)
        del kvs
        tok = logits.argmax(-1, keepdim=True)
        for step in range(8):
            transformer.decode_step(tok, step, caches)
        return _profile(_decode_steps(transformer, caches, tok, 8), steps)


def print_decode_profile(what: str, batch: int, res: dict) -> None:
    print(f"{what} batch {batch}, decode steps 8-23 (profiled): host "
          f"{res['host_ms']:.3f} ms a step, device busy "
          f"{res['device_busy_ms']:.3f} ms, idle "
          f"{100 * res['device_idle_share']:.1f}%; ported kernels ms and "
          "launches a step " + json.dumps(res["ported_kernels_ms_per_call"]))


def teacher_forced_check(transformer, text, seg, gen, steps: int = 16,
                         margin_ulps: int = 0):
    """Prefill + ``steps`` decode steps over the same forced tokens, once
    through the kernels and once through the plain twins on the card (bf16
    model; every decode kernel is patched, whichever cache the model
    allocates).  Tolerance: the two differ only inside attention and the
    cache write, by bf16 rounding of the attention output (2^-8 relative),
    which 24 bf16 layers carry on: max |d logit| <= 0.1 * max |logit| and
    top-1 agreement >= 90%.  With ``margin_ulps`` the top-1 agreement
    counts only the positions whose twin logits put the top choice more
    than that many bf16 ulps of max |logit| above the second: a model
    trained for a few steps has near-uniform logits (loss ~ ln 8192), and
    bf16 rounding then flips near-ties, not decisions."""
    from mas_tpu_torch.ops import (attention, decode_attention, decode_cache,
                                   quant)

    cfg = transformer.cfg
    text2 = torch.cat([text, torch.zeros_like(text)])
    seg2 = torch.cat([seg, seg])
    forced = torch.randint(0, cfg.image_vocab_size, (text2.shape[0], steps),
                           device="cuda", generator=gen)

    def run():
        with torch.inference_mode():
            logits, kvs = transformer.prefill(text2, seg2)
            caches = transformer.allocate_caches(kvs, text2.shape[0])
            out = [logits]
            for step in range(steps):
                out.append(transformer.decode_step(
                    forced[:, step:step + 1], step, caches))
            return torch.stack(out, dim=1)

    kern = run()
    with ExitStack() as stack:
        for mod, name, plain in (
                (attention, "flash_attention",
                 attention.prefix_causal_attention_plain),
                (quant, "decode_attention_quant",
                 quant.decode_attention_quant_plain),
                (decode_cache, "write_quant_kv",
                 decode_cache.write_quant_kv_plain),
                (decode_cache, "write_packed_kv",
                 decode_cache.write_packed_kv_plain),
                (decode_attention, "decode_attention_float",
                 decode_attention.decode_attention_float_plain)):
            stack.enter_context(mock.patch.object(mod, name, plain))
        ref = run()
    diff = (kern - ref).abs()
    scale = float(ref.abs().max())
    margin = margin_ulps * 2.0 ** (math.floor(math.log2(scale)) - 7)
    best = ref.topk(2, dim=-1).values
    decided = ((best[..., 0] - best[..., 1]) > margin) | (margin_ulps == 0)
    same = (kern.argmax(-1) == ref.argmax(-1))[decided]
    top1 = float(same.float().mean())
    print(f"teacher-forced ({steps} steps, {text2.shape[0]} rows): max |d| "
          f"{float(diff.max()):.4e}, mean |d| {float(diff.mean()):.4e}, "
          f"max |logit| {scale:.4e}, top-1 agreement {top1:.4f} over the "
          f"{same.numel()} of {decided.numel()} positions with a twin "
          f"margin above {margin:.4g}")
    flips = (kern.argmax(-1) != ref.argmax(-1)) & decided
    if bool(flips.any()):
        gaps = (best[..., 0] - best[..., 1])[flips]
        print(f"teacher-forced: {int(flips.sum())} flipped positions, twin "
              f"top-1 margins {float(gaps.min()):.4e}..{float(gaps.max()):.4e}"
              f" (max |d| there {float(diff.amax(-1)[flips].max()):.4e})")
    require(same.numel() > 0, "teacher-forced: some position is decided")
    require(float(diff.max()) <= 0.1 * scale, "teacher-forced logits close")
    require(top1 >= 0.9, "teacher-forced top-1 agreement >= 90%")


# --- phase 5: VQ-SEG training at full width ---------------------------------

def seg_training_raw(tmp: str) -> dict:
    """configs/seg_256.json as it is, with two overrides in memory:
    codebook.init_steps 4 and samples_per_image 256, so 16 micro-steps run
    pass-through (counter < 12), reservoir collection (counter > 4: 4,096
    rows by counter 12), k-means re-inits at 12, 14 and 16, quantization
    through B5 from 12 and five optimizer updates (accumulate_grad 3);
    checkpoints under ``tmp``."""
    with open(SEG_CONFIG) as f:
        raw = json.load(f)
    raw["model"]["codebook"] = dict(raw["model"]["codebook"], init_steps=4,
                                    samples_per_image=256)
    raw["train"] = dict(raw["train"], total_steps=TRAIN_STEPS,
                        checkpoint_dir=os.path.join(tmp, "checkpoints"))
    return raw


def seg_training_configs(tmp: str):
    """``seg_training_raw`` as (train, model, loss configs, data)."""
    from mas_tpu_torch.utils.config import (SegLossConfig, TrainConfig,
                                            VQModelConfig)

    raw = seg_training_raw(tmp)
    return (TrainConfig.from_dict(raw["train"]),
            VQModelConfig.from_dict(raw["model"]),
            SegLossConfig.from_dict(raw["loss"]), raw["data"])


def phase_train(smi: str, tmp: str) -> dict:
    """16 micro-steps of seg_256 training through ``run_pretrain_
    segmentation`` with B4, B5 and B8, checkpoints under ``tmp`` (phase 12
    evaluates, shows and exports them); returns the launch counts."""
    from mas_tpu_torch.data.dataset import SyntheticSegBatches
    from mas_tpu_torch.train.loop import (build_seg_state,
                                          run_pretrain_segmentation)
    from mas_tpu_torch.utils.logging import Logger

    train_cfg, model_cfg, loss_cfg, data = seg_training_configs(tmp)
    cb = model_cfg.codebook
    source = iter(SyntheticSegBatches(train_cfg.batch_size,
                                      data["resolution"],
                                      data.get("seed", 0)))
    batches = [{"mask": torch.from_numpy(next(source)["mask"]).to(DEVICE)}
               for _ in range(TRAIN_STEPS)]
    record, snap = [], {}

    def on_step(step_no, state, metrics):
        torch.cuda.synchronize()
        counter = state.vq_state.counter
        trig = metrics["kmeans_triggered"]
        record.append(dict(t=time.perf_counter(), counter=counter,
                           loss=float(metrics["loss"]), trig=trig,
                           filled=state.vq_state.filled))
        if trig:
            require(torch.equal(state.model.quantize.embedding.weight,
                                metrics["centroids"]),
                    f"codebook != k-means centroids after counter "
                    f"{counter}")
        if counter == cb.q_init:
            snap["state"] = copy.deepcopy(state)

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = run_pretrain_segmentation(
        train_cfg, model_cfg, batches, loss_cfg, DEVICE,
        logger=Logger(os.path.join(tmp, "logs")), on_step=on_step)
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"train: {TRAIN_STEPS} micro-steps in "
          f"{time.perf_counter() - t0:.2f} s (first run, includes "
          f"kernel JIT); launches {counts}")

    losses = [r["loss"] for r in record]
    print("train losses: " + " ".join(f"{v:.5f}" for v in losses))
    require(len(record) == TRAIN_STEPS and state.step == TRAIN_STEPS,
            f"ran {len(record)} micro-steps")
    require(all(math.isfinite(v) for v in losses), "losses are finite")
    fired = [r["counter"] for r in record if r["trig"]]
    require(fired == [12, 14, 16], f"k-means fired at {fired}")
    require(record[11]["filled"] == 4096,
            f"reservoir rows at counter 12: {record[11]['filled']}")
    require(state.opt.count == TRAIN_STEPS // 3, "optimizer updates")
    n_gns = count_gns(state.model)
    quantizing = sum(r["counter"] >= cb.q_init for r in record)
    floors = {"B4": n_gns * TRAIN_STEPS, "B5": quantizing,
              "B8": n_gns * TRAIN_STEPS}
    for name, floor in floors.items():
        require(counts[name] >= floor, f"{name} launched "
                f"{counts[name]} times in training, expected >= {floor}")

    step_ms = {r["counter"]: 1e3 * (r["t"] - prev["t"])
               for prev, r in zip(record, record[1:])}
    quant = sorted(step_ms[c] for c in (13, 15))
    print(f"train micro-step, quantize phase (counters 13, 15): median "
          f"{statistics.median(quant):.1f} ms; k-means micro-step "
          f"(counters 14, 16): {step_ms[14]:.1f} / {step_ms[16]:.1f} ms;"
          f" pass-through (counters 6-11) median "
          f"{statistics.median(step_ms[c] for c in range(6, 12)):.1f} "
          f"ms [{smi}]")

    resume_check(train_cfg, model_cfg, state)
    kmeans_repeat_check(state, cb)
    kernels_vs_twins_step(snap["state"], batches[TRAIN_STEPS // 2],
                          loss_cfg)
    return counts


def resume_check(train_cfg, model_cfg, state) -> None:
    """The checkpoint written at the end resumes bitwise."""
    from mas_tpu_torch.train.loop import build_seg_state

    resumed = build_seg_state(dataclasses.replace(train_cfg, resume=True),
                              model_cfg, DEVICE)
    require(resumed.step == state.step
            and resumed.vq_state.counter == state.vq_state.counter
            and resumed.vq_state.filled == state.vq_state.filled
            and torch.equal(resumed.vq_state.reservoir,
                            state.vq_state.reservoir), "resume: codebook")
    for k, v in state.model.state_dict().items():
        require(torch.equal(resumed.model.state_dict()[k], v),
                f"resume: model {k}")
    a, b = resumed.opt.state_dict(), state.opt.state_dict()
    require((a["count"], a["mini_step"]) == (b["count"], b["mini_step"]),
            "resume: optimizer counters")
    for part in ("mu", "nu", "acc"):
        for k, v in b[part].items():
            require(torch.equal(a[part][k], v), f"resume: {part} {k}")
    print(f"resume: step {resumed.step}, counter "
          f"{resumed.vq_state.counter}, filled {resumed.vq_state.filled}: "
          "bitwise equal")


def kmeans_repeat_check(state, cb) -> None:
    """One Lloyd iteration over the final reservoir, twice from one init.
    The assignments are equal (one deterministic matmul and argmin), but
    ``index_add_`` sums each cluster with atomics in a varying order, so
    the centroids are held to fp32 rounding (atol 1e-5, rtol 1e-5), not
    to bitwise equality."""
    from mas_tpu_torch.ops import kmeans

    res, n = state.vq_state.reservoir, state.vq_state.filled
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    init = kmeans.kmeans_init(res, gen, cb.codebook_size, n)
    a, b = (kmeans.lloyd(res, init, 1, n) for _ in range(2))
    torch.cuda.synchronize()
    require(close(a, b, 1e-5, 1e-5), f"k-means repeat: max |d| "
            f"{max_err(a, b)}")
    print(f"k-means repeat over {n} rows: max |d| {max_err(a, b):.3e}, "
          f"bitwise equal: {torch.equal(a, b)}")


def kernels_vs_twins_step(state, batch, loss_cfg) -> None:
    """One micro-step at counter 13 (quantize phase, no k-means) from two
    copies of the state after micro-step 12, once through B4/B5/B8 and
    once with their plain twins patched in.  Tolerances: fp32 summation
    order differs inside every GroupNorm forward and backward and is
    carried through the dozens of conv layers of encoder and decoder, so
    the loss agrees to rel 1e-4 and every parameter gradient to max |d| <=
    1e-3 * max |g| of its tensor, or 1e-6 * the largest gradient of the
    model for a tensor whose gradient is zero up to rounding (the conv
    bias ahead of the BN).  The kernel's indices obey the B5 rule on its
    own latents, and >= 99% equal the twins' (the latents themselves differ
    by that rounding).  A row whose index differs moves its share of the
    codebook gradient from one code to another, so the codebook rows of
    such codes are left out of its gradient comparison."""
    from mas_tpu_torch.ops import gn_swish, vq
    from mas_tpu_torch.train.steps import seg_loss_and_grads

    def run(st):
        gen = torch.Generator(device=DEVICE).manual_seed(13)
        st.model.train()
        return seg_loss_and_grads(st.model, st.vq_state, batch["mask"], gen,
                                  loss_cfg)

    loss, aux, grads = run(copy.deepcopy(state))
    with ExitStack() as stack:
        for mod, name, plain in (
                (gn_swish, "gn_swish", gn_swish.gn_swish_plain),
                (gn_swish, "gn_swish_bwd", gn_swish.gn_swish_bwd_plain),
                (vq, "vq_argmin", vq.vq_argmin_plain)):
            stack.enter_context(mock.patch.object(mod, name, plain))
        ploss, paux, pgrads = run(copy.deepcopy(state))
    torch.cuda.synchronize()
    require(aux["vq_state"].counter == 13 and not aux["kmeans_triggered"],
            "kernels-vs-twins step runs at counter 13")
    rel = abs(float(loss) - float(ploss)) / abs(float(ploss))
    emb = state.model.quantize.embedding.weight
    z = aux["latent"].reshape(-1, emb.shape[1])
    idx, pidx = aux["indices"].reshape(-1), paux["indices"].reshape(-1)
    own = vq.vq_argmin_plain(z, emb)
    require(vq.argmin_agrees(z, emb, idx, own),
            f"kernel indices vs the twin on the kernel's latents "
            f"({int((idx != own).sum())} of {len(own)} rows differ)")
    agree = float((idx == pidx).float().mean())
    flipped = idx != pidx
    moved = torch.cat([idx[flipped], pidx[flipped]]).long()
    top = max(float(g.abs().max()) for g in pgrads)
    worst, bad = 0.0, []
    names = [n for n, _ in state.model.named_parameters()]
    for name, g, pg in zip(names, grads, pgrads):
        if name == "quantize.embedding.weight" and len(moved):
            keep = torch.ones(len(g), dtype=torch.bool, device=g.device)
            keep[moved] = False
            g, pg = g[keep], pg[keep]
        d = float((g - pg).abs().max())
        bound = max(1e-3 * float(pg.abs().max()), 1e-6 * top)
        worst = max(worst, d / bound)
        if d > bound:
            bad.append(f"{name}: max |d| {d:.3e} > {bound:.3e}")
    print(f"kernels vs twins, one micro-step at counter 13: loss "
          f"{float(loss)!r} vs {float(ploss)!r} (rel {rel:.2e}), index "
          f"agreement {agree:.4f} ({int(flipped.sum())} rows), worst "
          f"gradient |d| / bound {worst:.3f}")
    require(not bad, "kernels-vs-twins gradients: " + "; ".join(bad))
    require(rel <= 1e-4, "kernels-vs-twins loss")
    require(agree >= 0.99, "kernels-vs-twins indices")


# --- phase 6: tokenization at img_512 width ---------------------------------

def phase_tokenize(gen, smi: str) -> dict:
    """``encode_tokens`` of the img_512 model (bf16, K = 8192, seeded
    random weights) on 8 random 512^2 images; returns the launch counts.
    The random codebook (U(-1/K, 1/K)) would make every distance a near-tie,
    so the codebook is first set to the 8192 latents of another batch, as
    the k-means re-init places a trained codebook among the latents; the
    tokens are then held to the B5 agreement rule against the plain twin
    on the same latents."""
    from mas_tpu_torch.cli import load_vq
    from mas_tpu_torch.ops import vq as vq_ops
    from mas_tpu_torch.utils.config import VQModelConfig

    with open(IMG_CONFIG) as f:
        cfg = VQModelConfig.from_dict(json.load(f)["model"])
    model = load_vq(cfg, None, DEVICE, gen)
    shape = (8, cfg.resolution, cfg.resolution, 3)
    with torch.no_grad():
        book = model.encode_latent(torch.rand(*shape, device=DEVICE,
                                              generator=gen))
        model.quantize.embedding.weight.copy_(
            book.reshape(-1, cfg.embed_dim)[:cfg.codebook.codebook_size])
    x = torch.rand(*shape, device=DEVICE, generator=gen)
    reset_counts()
    with torch.inference_mode():
        tokens = model.encode_tokens(x)
        torch.cuda.synchronize()
        counts = read_counts()
        z = model.encode_latent(x).reshape(-1, cfg.embed_dim)
        emb = model.quantize.embedding.weight.to(z.dtype)
        plain = vq_ops.vq_argmin_plain(z, emb)
        ms = timed_ms(lambda: model.encode_tokens(x), reps=10)
    side = cfg.latent_resolution
    agree = float((tokens.reshape(-1) == plain).float().mean())
    require(tuple(tokens.shape) == (8, side, side), f"token shape "
            f"{tuple(tokens.shape)}")
    require(not tokens.is_floating_point()
            and int(tokens.min()) >= 0
            and int(tokens.max()) < cfg.codebook.codebook_size,
            "tokens are integer codebook indices")
    require(vq_ops.argmin_agrees(z, emb, tokens.reshape(-1), plain),
            f"tokens vs the plain twin on the same latents (agreement "
            f"{agree:.5f})")
    require(counts["B5"] >= 1, f"B5 launched {counts['B5']} times in "
            "tokenization")
    require(counts["B4"] >= count_gns(model.encoder),
            f"B4 launched {counts['B4']} times in tokenization")
    print(f"tokenize: 8 x {cfg.resolution}^2 -> {tuple(tokens.shape)}, "
          f"{len(torch.unique(tokens))} distinct codes, agreement with the "
          f"twin {agree:.5f}; {ms:.2f} ms per batch (device, CUDA events); "
          f"launches {counts} [{smi}]")
    return counts


# --- phase 7: transformer training at full width ----------------------------

def transformer_configs(tmp: str, **train_overrides):
    """configs/transformer_512.json as shipped (24 layers, hidden 1024, 16
    heads, T = 1408, batch 8, bf16, remat 'mlp', Adam lr 4.5e-6, betas
    0.9/0.95), with its checkpoints under ``tmp``."""
    from mas_tpu_torch.utils.config import TrainConfig, TransformerConfig

    with open(TRANSFORMER_CONFIG) as f:
        raw = json.load(f)
    train = dict(raw["train"], checkpoint_dir=os.path.join(tmp, "ckpt"),
                 **train_overrides)
    return (TrainConfig.from_dict(train),
            TransformerConfig.from_dict(raw["transformer"]), raw["data"])


def phase_train_transformer(smi: str, tmp: str):
    """``run_train_transformer`` at full width: 8 steps as configured, then
    2 resumed steps with ``layernorm_impl: "pallas"`` (B7) and uncond_p 1.0
    from step 9.  Checks finite losses, fp32 parameters, a finite nonzero
    gradient for every parameter at step 1 (Adam's first moment after one
    update is 0.1 g), moved parameters, the CFG dropout schedule, the exact
    B1/B6/B7 launch counts, one step through the kernels against the plain
    twins, and a bitwise resume; returns the launch counts and the final
    checkpoint's path (checkpoints go under ``tmp``)."""
    from mas_tpu_torch.data.dataset import SyntheticTokenBatches
    from mas_tpu_torch.train.loop import (build_transformer_state,
                                          run_train_transformer)
    from mas_tpu_torch.utils.checkpoint import checkpoint_path
    from mas_tpu_torch.utils.logging import Logger

    steps_a, steps_b = TRANSFORMER_STEPS, 2
    train_cfg, tcfg, data = transformer_configs(
        tmp, total_steps=steps_a)
    source = iter(SyntheticTokenBatches(train_cfg.batch_size, tcfg,
                                        data.get("seed", 0)))
    batches = [{k: torch.from_numpy(v).to(DEVICE)
                for k, v in next(source).items()}
               for _ in range(steps_a + steps_b)]
    init = build_transformer_state(train_cfg, tcfg, DEVICE)
    before = {k: v.clone() for k, v in init.model.state_dict().items()}
    del init
    record = []

    def on_step(step_no, state, metrics):
        torch.cuda.synchronize()
        record.append(dict(t=time.perf_counter(), step=step_no,
                           loss=float(metrics["loss"]),
                           uncond=bool(metrics["uncond"])))
        if step_no == 1:
            first_step_checks(state, before)

    logger = Logger(os.path.join(tmp, "logs"))
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = run_train_transformer(train_cfg, tcfg, batches[:steps_a],
                                  DEVICE, logger, on_step)
    torch.cuda.synchronize()
    counts_a = read_counts()
    secs_a = time.perf_counter() - t0

    ln_cfg = dataclasses.replace(tcfg, layernorm_impl="pallas")
    train_b = dataclasses.replace(train_cfg, total_steps=steps_a + steps_b,
                                  resume=True, uncond_p=1.0,
                                  start_uncond=steps_a + 1)
    reset_counts()
    state = run_train_transformer(train_b, ln_cfg, batches[steps_a:],
                                  DEVICE, logger, on_step)
    torch.cuda.synchronize()
    counts_b = read_counts()
    print(f"train_transformer: {steps_a} steps in {secs_a:.2f} s (first "
          f"run); launches {counts_a}, then {steps_b} steps with B7: "
          f"{counts_b}")

    losses = [r["loss"] for r in record]
    print("train_transformer losses: "
          + " ".join(f"{v:.5f}" for v in losses))
    require(len(record) == steps_a + steps_b
            and state.step == steps_a + steps_b,
            f"ran {len(record)} steps, state at {state.step}")
    require(all(math.isfinite(v) for v in losses), "losses are finite")
    require(all(p.dtype == torch.float32
                for p in state.model.parameters()), "fp32 parameters")
    uncond = [r["uncond"] for r in record[steps_a:]]
    require(uncond == [False, True],
            f"uncond with uncond_p 1.0 from step {steps_a + 1}: {uncond}")
    n_layers, n_ln = tcfg.num_layers, 4 * tcfg.num_layers + 2
    want_a = dict(B1=n_layers * steps_a, B6=n_layers * steps_a, B7=0)
    want_b = dict(B1=n_layers * steps_b, B6=n_layers * steps_b,
                  B7=2 * n_ln * steps_b)
    for want, got, what in ((want_a, counts_a, "as configured"),
                            (want_b, counts_b, "with B7")):
        for kid, n in want.items():
            require(got[kid] == n, f"{kid} launched {got[kid]} times in "
                    f"transformer training {what}, expected {n}")
        require(all(got[k] == 0 for k in ("B2", "B3", "B4", "B5", "B8")),
                f"serving or VQ kernels launched in transformer training:"
                f" {got}")

    step_ms = [1e3 * (r["t"] - prev["t"])
               for prev, r in zip(record, record[1:])]
    tokens = train_cfg.batch_size * tcfg.total_length
    steady = statistics.median(step_ms[1:steps_a - 1])
    print(f"train_transformer step (steps 3-{steps_a}, host clock, "
          f"synchronized): median {steady:.1f} ms, {tokens / steady * 1e3:.0f}"
          f" tokens/s; with B7 (step {steps_a + 2}): {step_ms[-1]:.1f} ms"
          f" [{smi}]")

    transformer_resume_check(train_b, ln_cfg, state)
    transformer_kernels_vs_twins(state, batches[-1])
    return ({k: counts_a[k] + counts_b[k] for k in counts_a},
            checkpoint_path(train_cfg.checkpoint_dir, steps_a + steps_b))


def first_step_checks(state, before) -> None:
    """After step 1: every parameter moved and got a finite, nonzero
    gradient (Adam's first moment is 0.1 g), every layer's qkv weight
    included (the attention Function passes the gradient through B6)."""
    bad = []
    for name, p in state.model.named_parameters():
        mu = state.opt.mu[name]
        if not bool(torch.isfinite(mu).all()) or float(mu.abs().max()) == 0:
            bad.append(f"{name}: gradient zero or not finite")
        if torch.equal(p, before[name]):
            bad.append(f"{name}: unchanged after step 1")
    require(not bad, "after step 1: " + "; ".join(bad))
    qkv = [f"transformer.layers.{i}.attn.qkv.weight"
           for i in range(state.model.cfg.num_layers)]
    require(all(name in state.opt.mu for name in qkv), "qkv weights in Adam")
    print(f"step 1: all {len(before)} parameters moved with finite nonzero "
          f"gradients, qkv weight gradient max |g| per layer from "
          f"{min(float(state.opt.mu[n].abs().max()) * 10 for n in qkv):.3e}"
          f" to {max(float(state.opt.mu[n].abs().max()) * 10 for n in qkv):.3e}")


def transformer_resume_check(train_cfg, tcfg, state) -> None:
    """The checkpoint written at the end resumes bitwise."""
    from mas_tpu_torch.train.loop import build_transformer_state

    resumed = build_transformer_state(train_cfg, tcfg, DEVICE)
    require(resumed.step == state.step, f"resume: step {resumed.step}")
    for k, v in state.model.state_dict().items():
        require(torch.equal(resumed.model.state_dict()[k], v),
                f"resume: model {k}")
    a, b = resumed.opt.state_dict(), state.opt.state_dict()
    require((a["count"], a["mini_step"]) == (b["count"], b["mini_step"]),
            "resume: optimizer counters")
    for part in ("mu", "nu", "acc"):
        for k, v in b[part].items():
            require(torch.equal(a[part][k], v), f"resume: {part} {k}")
    print(f"resume: step {resumed.step}, model and Adam state bitwise equal")


def transformer_kernels_vs_twins(state, batch) -> None:
    """One loss and gradient of the bf16 model with B7 LayerNorms, once
    through B1/B6/B7 and once with their plain twins patched in, from the
    same weights and tokens.  The two differ only where a kernel and its
    twin round an fp32 value to bf16 in another place or sum in another
    order, which 24 bf16 layers carry on.  Bounds (PERF.md): loss within
    rel 1e-2; each gradient tensor within 0.1 of its norm
    (||g - g_twin|| <= 0.1 ||g_twin||)."""
    from mas_tpu_torch.ops import attention
    from mas_tpu_torch.ops import layer_norm as ln
    from mas_tpu_torch.train.steps import transformer_loss_and_grads

    args = (batch["text"], batch["seg"], batch["image"])
    loss, grads = transformer_loss_and_grads(state.model, *args)
    with ExitStack() as stack:
        for mod, name, plain in (
                (attention, "flash_attention",
                 attention.prefix_causal_attention_plain),
                (attention, "flash_attention_bwd",
                 lambda *a: torch.stack(
                     [g.transpose(1, 2) for g in
                      attention.prefix_causal_attention_bwd_plain(*a)],
                     dim=2)),
                (ln, "layer_norm_fwd", ln.layer_norm_fwd_plain),
                (ln, "layer_norm_bwd", ln.layer_norm_bwd_plain)):
            stack.enter_context(mock.patch.object(mod, name, plain))
        ploss, pgrads = transformer_loss_and_grads(state.model, *args)
    torch.cuda.synchronize()
    rel = abs(float(loss) - float(ploss)) / abs(float(ploss))
    worst, bad = 0.0, []
    names = [n for n, _ in state.model.named_parameters()]
    for name, g, pg in zip(names, grads, pgrads):
        r = float((g - pg).norm()) / max(float(pg.norm()), 1e-30)
        worst = max(worst, r)
        if r > 0.1:
            bad.append(f"{name}: {r:.3e}")
    print(f"kernels vs twins, one step (bf16, B7 LayerNorms): loss "
          f"{float(loss)!r} vs {float(ploss)!r} (rel {rel:.2e}), worst "
          f"gradient ||d|| / ||g|| {worst:.3e}")
    require(rel <= 1e-2, "kernels-vs-twins loss")
    require(not bad, "kernels-vs-twins gradients: " + "; ".join(bad))


# --- phase 8: 512^2 serving over the float cache ----------------------------

def sample_512_raw(transformer_checkpoint=None) -> dict:
    """The 512^2 serving config, as README shows it: the sampling keys of
    configs/sample_256.json (guidance 3.0, top-k 64, its four captions),
    the ``transformer`` section of configs/transformer_512.json as it is
    (its ``kv_cache_dtype`` is the default "compute": a float cache) and
    the ``model`` section of configs/img_512.json."""
    with open(CONFIG) as f:
        raw = json.load(f)
    with open(TRANSFORMER_CONFIG) as f:
        raw["transformer"] = json.load(f)["transformer"]
    with open(IMG_CONFIG) as f:
        raw["model"] = json.load(f)["model"]
    raw["transformer_checkpoint"] = transformer_checkpoint
    raw["output"] = "samples_512.jpg"
    return raw


def phase_serve_512(gen, smi: str, checkpoint: str) -> dict:
    """512^2 sampling over the float cache with the transformer that phase
    7 trained; returns the launch counts of one batch-4 run."""
    from mas_tpu_torch.ops.decode_attention import FloatCache

    raw = sample_512_raw(checkpoint)
    transformer, vq, text, seg = load_pipeline(raw, gen)
    cfg = transformer.cfg
    require(cfg.kv_cache_dtype == "compute" and cfg.total_length == 1408,
            f"512^2 config: cache {cfg.kv_cache_dtype}, T {cfg.total_length}")
    with torch.inference_mode():          # the VQ decoder's Triton JIT
        vq.decode_code(torch.zeros(1, cfg.image_tokens_per_dim,
                                   cfg.image_tokens_per_dim, dtype=torch.long,
                                   device="cuda"))
    reset_counts()
    imgs, secs4 = run_slice(raw, transformer, vq, text, seg, seed=21)
    counts = read_counts()
    print(f"serve 512^2 (float cache, trained checkpoint): images "
          f"{tuple(imgs.shape)}; launches {counts}")
    require(tuple(imgs.shape) == (4, 512, 512, 3), f"image shape "
            f"{tuple(imgs.shape)}")
    require(bool(torch.isfinite(imgs).all()), "images are finite")
    steps = cfg.image_length - 1
    want = {"B1": cfg.num_layers, "B9": cfg.num_layers * steps, "B2": 0,
            "B3": 0, "B10": 0}
    for kid, n in want.items():
        require(counts[kid] == n, f"{kid} launched {counts[kid]} times on "
                f"the 512^2 float-cache path, expected {n}")
    require(counts["B4"] >= count_gns(vq.decoder),
            f"B4 launched {counts['B4']} times in the VQ decoder")

    with torch.inference_mode():
        _, kvs = transformer.prefill(text[:1], seg[:1])
        cache = transformer.allocate_caches(kvs, 1)[0][0]
    require(isinstance(cache, FloatCache)
            and cache.data.dtype == torch.bfloat16
            and tuple(cache.data.shape) == (1, 16, 1408, 64),
            "the float cache is bf16 [B, 16, 1408, 64]")
    teacher_forced_check(transformer, text, seg, gen, margin_ulps=4)

    print(f"e2e 512^2 batch 4: {secs4:.3f} s, {4 / secs4:.4f} img/s "
          f"(first run at this shape) [{smi}]")
    rep = 16
    _, secs64 = run_slice(raw, transformer, vq, text.repeat(rep, 1),
                          seg.repeat(rep, 1), seed=22)
    print(f"e2e 512^2 batch 64: {secs64:.3f} s, {64 / secs64:.4f} img/s "
          f"[{smi}]")
    return counts


# --- phase 9: 256^2 serving over the packed cache ---------------------------

def phase_packed(gen, smi: str) -> dict:
    """configs/sample_256.json with ``kv_cache_layout: "packed"`` (int4) at
    batch 4: exact launch counts, then greedy (top_k 1) tokens of the packed
    and the lane cache on the same weights must be equal — the same
    quantization (B10 and B3 store the same bits) read by the same B2
    arithmetic.  Returns the launch counts of the sampling run."""
    from mas_tpu_torch.models.sampler import sample_tokens
    from mas_tpu_torch.models.transformer import MakeAScene
    from mas_tpu_torch.utils.config import TransformerConfig

    with open(CONFIG) as f:
        raw = json.load(f)
    raw["transformer"] = dict(raw["transformer"], kv_cache_layout="packed")
    packed, vq, text, seg = load_pipeline(raw, gen)
    cfg = packed.cfg
    reset_counts()
    imgs, secs = run_slice(raw, packed, vq, text, seg, seed=31)
    counts = read_counts()
    print(f"serve 256^2 packed int4: images {tuple(imgs.shape)} in "
          f"{secs:.2f} s; launches {counts}")
    require(tuple(imgs.shape) == (4, 256, 256, 3)
            and bool(torch.isfinite(imgs).all()), "packed: images")
    steps = cfg.image_length - 1
    want = {"B1": cfg.num_layers, "B10": cfg.num_layers * steps,
            "B2": cfg.num_layers * steps, "B3": 0, "B9": 0}
    for kid, n in want.items():
        require(counts[kid] == n, f"{kid} launched {counts[kid]} times on "
                f"the packed path, expected {n}")

    lane_cfg = TransformerConfig.from_dict(
        dict(raw["transformer"], kv_cache_layout="lane"))
    with torch.device("cuda"):
        lane = MakeAScene(lane_cfg).eval()
    lane.load_state_dict(packed.state_dict())
    toks, secs = [], []
    for model in (packed, lane, packed, lane):
        g = torch.Generator(device="cuda").manual_seed(32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks.append(sample_tokens(model, text, seg, g, guidance_scale=3.0,
                                  top_k=1))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    agree = float((toks[0] == toks[1]).float().mean())
    print(f"packed vs lane, greedy, batch 4: token agreement {agree:.6f}; "
          f"sample_tokens {secs[2]:.3f} s packed, {secs[3]:.3f} s lane "
          f"({1e3 * secs[2] / steps:.2f} / {1e3 * secs[3] / steps:.2f} ms per "
          f"decode step, host clock, prefill included) [{smi}]")
    require(torch.equal(toks[0], toks[1]) and torch.equal(toks[0], toks[2]),
            "packed and lane caches give equal greedy tokens")
    return counts


# --- phase 10: the producer-fused LayerNorm harness -------------------------

LN_CHAIN = 20


def phase_ln_producer(gen, smi: str) -> dict:
    """``benchmarks/ln_producer.py`` at its shape: y = x + LN(a + b) @ W,
    the plain path (``add_ln_plain``) against the producer path (B11 for
    x and the stats, then ``normalize_with``), forward alone and forward +
    backward (gradient w.r.t. a, the producer's backward recomputing the
    plain add_ln), each chained ``LN_CHAIN`` times with the output fed
    back as a.  Parity first, as the harness: x bitwise, LN within 3e-2.
    Returns the launch counts of the timed chains."""
    from mas_tpu_torch.ops import ln_producer as lp

    a, b = (torch.randn(LN_ROWS, LN_D, device="cuda", generator=gen)
            .to(torch.bfloat16) for _ in range(2))
    g = 1.0 + 0.1 * torch.randn(LN_D, device="cuda", generator=gen)
    beta = 0.1 * torch.randn(LN_D, device="cuda", generator=gen)
    w = (torch.randn(LN_D, LN_D, device="cuda", generator=gen) * 0.02
         ).to(torch.bfloat16)
    with torch.no_grad():
        xp, yp = lp.AddLNProducerFunction.apply(a, b, g, beta)
        xj, yj = lp.add_ln_plain(a, b, g, beta)
    ex, ey = max_err(xp, xj), max_err(yp, yj)
    print(f"ln_producer parity: x {ex:.2e}  ln {ey:.2e}")
    require(ex == 0.0 and ey < 3e-2, "ln_producer parity")

    def plain(a_, b_, g_, beta_, w_):
        x_, t = lp.add_ln_plain(a_, b_, g_, beta_)
        return x_ + (t @ w_).to(x_.dtype)

    def producer(a_, b_, g_, beta_, w_):
        x_, t = lp.AddLNProducerFunction.apply(a_, b_, g_, beta_)
        return x_ + (t @ w_).to(x_.dtype)

    def chain(fn, grad):
        carry = a
        for _ in range(LN_CHAIN):
            if grad:
                leaf = carry.detach().requires_grad_()
                out = fn(leaf, b, g, beta, w)
                carry = torch.autograd.grad(out.float().sum(), leaf)[0]
            else:
                with torch.no_grad():
                    carry = fn(carry, b, g, beta, w)
        return carry

    reset_counts()
    ms = {}
    for grad in (False, True):
        for name, fn in (("plain", plain), ("producer", producer)):
            ms[(grad, name)] = timed_ms(lambda: chain(fn, grad), reps=5,
                                        warmup=1) / LN_CHAIN
    torch.cuda.synchronize()
    counts = read_counts()
    fj, fp, gj, gp = (ms[(False, "plain")], ms[(False, "producer")],
                      ms[(True, "plain")], ms[(True, "producer")])
    print(f"ln_producer [{LN_ROWS}x{LN_D}] bf16, x{LN_CHAIN} chained, ms per "
          f"step (CUDA events, median of 5): fwd plain {fj:.4f}, fwd "
          f"producer {fp:.4f}, fwd+bwd plain {gj:.4f}, fwd+bwd producer "
          f"{gp:.4f}; fwd delta {100 * (fj - fp) / fj:+.1f}%, fwd+bwd delta "
          f"{100 * (gj - gp) / gj:+.1f}% (positive = producer wins) [{smi}]")
    n = 2 * (1 + 5) * LN_CHAIN
    require(counts["B11"] == n, f"B11 launched {counts['B11']} times in the "
            f"harness, expected {n}")
    return counts


# --- phase 11: VQ-IMG (VQGAN) training at full width -----------------------

IMG_STEPS = 16
IMG_DISC_START = 8


def img_training_configs(tmp: str):
    """configs/img_512.json as shipped (512^2 RGB, batch 2, channels (128,
    128, 128, 256, 512, 512), attention at 32^2, K 8192, D 256, bf16 with
    fp32 master weights, both Adams at accumulation 8, LPIPS, face loss and
    PatchGAN), cut in time only, in memory: total_steps 16 (2 Adam updates
    a side); codebook.init_steps 4 and samples_per_image 640, so 16
    micro-steps run pass-through (counters 1-11), reservoir collection
    (counter > 4: 10,240 rows of the 12,500 by counter 12, more than
    K = 8192), k-means re-inits at 12, 14 and 16 and quantization through
    B5 from 12 (micro-steps 13 and 15 without k-means); loss.disc_start 8,
    so the GAN terms are gated for micro-steps 1-8 and active for 9-16;
    lpips_weights and face_weights null as shipped (seeded random towers);
    checkpoints under ``tmp``."""
    from mas_tpu_torch.utils.config import (TrainConfig, VQGANLossConfig,
                                            VQModelConfig)

    with open(IMG_CONFIG) as f:
        raw = json.load(f)
    model = dict(raw["model"])
    model["codebook"] = dict(model["codebook"], init_steps=4,
                             samples_per_image=640)
    train = dict(raw["train"], total_steps=IMG_STEPS,
                 checkpoint_dir=os.path.join(tmp, "ckpt_img"))
    loss = dict(raw["loss"], disc_start=IMG_DISC_START)
    return (TrainConfig.from_dict(train), VQModelConfig.from_dict(model),
            VQGANLossConfig.from_dict(loss), raw)


def _changed(module, prev) -> list:
    """Names of ``module``'s parameters that differ from ``prev``."""
    names = [n for n, _ in module.named_parameters()]
    flags = torch.stack([(p != prev[n]).any()
                         for n, p in module.named_parameters()]).tolist()
    return [n for n, f in zip(names, flags) if f]


def phase_train_image(smi: str, tmp: str) -> dict:
    """16 micro-steps of img_512 VQGAN training through
    ``run_pretrain_image`` (``img_training_configs``), with B4, B5 and B8.
    Checks: every loss finite; disc_factor 0 for micro-steps 1-8 and 1
    after, d_loss 0 while gated and > 0 after; d_weight finite, and > 0
    once active; the parameters move only at the Adam updates (micro-steps
    8 and 16) and the k-means write-backs (the codebook at 12 and 14): at
    update 1 every VQ parameter but the codebook (no gradient in the
    pass-through window) and no discriminator parameter (its loss is gated
    to 0), at update 2 every parameter of both; fp32 parameters; the
    launch floors of B4, B5 and B8 and no launch of another kernel; a
    bitwise resume; one micro-step through the kernels against the plain
    twins (``img_kernels_vs_twins``).  Prints the micro-step's host time,
    its device busy time and idle share and B4/B5/B8 time and launches
    from a profile (``breakdown._profile``), and the peak device memory.
    Returns the launch counts of the 16 micro-steps."""
    from mas_tpu_torch.breakdown import _profile
    from mas_tpu_torch.data.dataset import SyntheticImgBatches
    from mas_tpu_torch.train.loop import (build_img_state, frozen_towers,
                                          run_pretrain_image)
    from mas_tpu_torch.train.steps import make_img_train_step
    from mas_tpu_torch.utils.logging import Logger

    train_cfg, model_cfg, loss_cfg, raw = img_training_configs(tmp)
    cb = model_cfg.codebook
    data = raw["data"]
    source = iter(SyntheticImgBatches(train_cfg.batch_size,
                                      data["resolution"],
                                      seed=data.get("seed", 0)))
    batches = [{k: torch.from_numpy(v).to(DEVICE)
                for k, v in next(source).items()} for _ in range(IMG_STEPS)]
    init = build_img_state(train_cfg, model_cfg, DEVICE)
    prev = {m: {n: p.detach().clone() for n, p in mod.named_parameters()}
            for m, mod in (("model", init.model), ("disc", init.disc))}
    del init
    record, snap, bad = [], {}, []
    every = {m: len(p) for m, p in prev.items()}

    def on_step(step_no, state, metrics):
        torch.cuda.synchronize()
        t = time.perf_counter()
        counter = state.vq_state.counter
        rec = dict(t=t, step=step_no, counter=counter,
                   trig=bool(metrics["kmeans_triggered"]),
                   g_update=state.opt.mini_step == 0,
                   d_update=state.disc_opt.mini_step == 0,
                   **{k: float(metrics[k]) for k in (
                       "loss", "nll_loss", "g_loss", "face_loss",
                       "d_weight", "disc_factor", "q_loss", "d_loss",
                       "logits_real", "logits_fake")})
        for m, mod in (("model", state.model), ("disc", state.disc)):
            moved = _changed(mod, prev[m])
            update = rec["g_update" if m == "model" else "d_update"]
            if not update:
                want = (["quantize.embedding.weight"]
                        if m == "model" and rec["trig"] else [])
            elif step_no == IMG_STEPS:
                want = [n for n, _ in mod.named_parameters()]
            elif m == "model":
                want = [n for n, _ in mod.named_parameters()
                        if n != "quantize.embedding.weight"]
            else:
                want = []
            if sorted(moved) != sorted(want):
                bad.append(f"micro-step {step_no} {m}: moved "
                           f"{sorted(set(moved) ^ set(want))[:4]} "
                           f"({len(moved)} moved, {len(want)} expected)")
            rec[f"{m}_moved"] = len(moved)
            prev[m] = {n: p.detach().clone()
                       for n, p in mod.named_parameters()}
        if counter == cb.q_init:
            snap["state"] = copy.deepcopy(state)
        record.append(rec)
        rec["t_out"] = time.perf_counter()

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = run_pretrain_image(
        train_cfg, model_cfg, batches, loss_cfg, raw.get("lpips_weights"),
        raw.get("face_weights"), DEVICE,
        logger=Logger(os.path.join(tmp, "logs_img")), on_step=on_step)
    torch.cuda.synchronize()
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"train_image: {IMG_STEPS} micro-steps in "
          f"{time.perf_counter() - t0:.2f} s (first run, includes cuDNN "
          f"autotuning); launches {counts}; peak device memory "
          f"{peak_gb:.2f} GiB [{smi}]")
    for r in record:
        print("train_image step {step} counter {counter}: loss {loss:.5f} "
              "nll {nll_loss:.5f} g {g_loss:.5f} face {face_loss:.5f} "
              "d_weight {d_weight:.4g} disc_factor {disc_factor:g} q "
              "{q_loss:.5f} d_loss {d_loss:.5f} kmeans {trig} moved "
              "{model_moved}/{disc_moved}".format(**r))

    require(len(record) == IMG_STEPS and state.step == IMG_STEPS,
            f"ran {len(record)} micro-steps")
    keys = ("loss", "nll_loss", "g_loss", "face_loss", "d_weight", "q_loss",
            "d_loss", "logits_real", "logits_fake")
    require(all(math.isfinite(r[k]) for r in record for k in keys),
            "losses are finite")
    gated = [r for r in record if r["step"] <= IMG_DISC_START]
    active = [r for r in record if r["step"] > IMG_DISC_START]
    require(all(r["disc_factor"] == 0.0 and r["d_loss"] == 0.0
                for r in gated), "disc_factor and d_loss 0 while gated")
    require(all(r["disc_factor"] == 1.0 and r["d_loss"] > 0.0
                and r["d_weight"] > 0.0 for r in active),
            "disc_factor 1, d_loss > 0 and d_weight > 0 once active")
    fired = [r["counter"] for r in record if r["trig"]]
    require(fired == [12, 14, 16], f"k-means fired at {fired}")
    require(state.opt.count == state.disc_opt.count == 2,
            f"Adam updates {state.opt.count} / {state.disc_opt.count}")
    require(not bad, "parameter updates: " + "; ".join(bad))
    print(f"parameters: all {every['model']} VQ and {every['disc']} "
          "discriminator parameters moved exactly at their updates")
    require(all(p.dtype == torch.float32 for p in
                list(state.model.parameters())
                + list(state.disc.parameters())), "fp32 parameters")
    n_gns = count_gns(state.model)
    quantizing = sum(r["counter"] >= cb.q_init for r in record)
    floors = {"B4": n_gns * IMG_STEPS, "B5": quantizing,
              "B8": n_gns * IMG_STEPS}
    for kid, floor in floors.items():
        require(counts[kid] >= floor, f"{kid} launched {counts[kid]} times "
                f"in image training, expected >= {floor}")
    others = {k: v for k, v in counts.items() if k not in floors and v}
    require(not others, f"other kernels launched in image training: "
            f"{others}")

    step_ms = {r["step"]: 1e3 * (r["t"] - prev_r["t_out"])
               for prev_r, r in zip(record, record[1:])}
    quant = [step_ms[s] for s in (13, 15)]
    passing = [step_ms[s] for s in range(3, 8)]
    print(f"train_image micro-step, host clock between synchronized steps: "
          f"quantize phase (13, 15) {quant[0]:.1f} / {quant[1]:.1f} ms; "
          f"pass-through (3-7, GAN gated) median "
          f"{statistics.median(passing):.1f} ms; Adam update micro-step 8 "
          f"{step_ms[8]:.1f} ms; k-means micro-steps 12 / 14 "
          f"{step_ms[12]:.1f} / {step_ms[14]:.1f} ms [{smi}]")

    img_resume_check(train_cfg, model_cfg, state)
    lpips, face = frozen_towers(loss_cfg, DEVICE)
    batch = batches[-1]
    for tf32 in (False, True):
        # TF32 off as this script runs everything; on is PyTorch's
        # default for cuDNN convolutions, as the CLI runs the step
        torch.backends.cudnn.allow_tf32 = tf32
        prof = copy.deepcopy(state)
        prof.vq_state = dataclasses.replace(prof.vq_state,
                                            counter=cb.q_re_end)
        step = make_img_train_step(prof.model, prof.disc, prof.opt,
                                   prof.disc_opt, loss_cfg, lpips, face)
        gen = torch.Generator(device=DEVICE).manual_seed(17)
        res = _profile(lambda: step(prof, batch["image"], batch["bbox_obj"],
                                    batch["bbox_face"], gen), 3)
        torch.backends.cudnn.allow_tf32 = False
        ported = res["ported_kernels_ms_per_call"]
        mode = "on" if tf32 else "off"
        print(f"train_image GAN micro-step, cudnn tf32 {mode}, quantize "
              "phase past the k-means window, profiled "
              f"over 3 (no Adam update): host {res['host_ms']:.1f} ms, "
              f"device busy {res['device_busy_ms']:.1f} ms, idle share "
              f"{100 * res['device_idle_share']:.1f}%; per micro-step "
              + ", ".join(f"{k} {ported[k][0]:.3f} ms / {ported[k][1]} "
                          "launches" for k in ("B4", "B5", "B8")
                          if k in ported) + f"; peak device memory "
              f"{peak_gb:.2f} GiB [{smi}]")
        print("train_image top kernels (name, ms, launches per "
              "micro-step): " + json.dumps(res["top_kernels_ms_per_call"]))
        for kid in ("B4", "B5", "B8"):
            require(kid in ported, f"{kid} not in the profile of the "
                    "micro-step")
        del prof, step
    img_kernels_vs_twins(snap.pop("state"), batches[IMG_STEPS // 2 + 4],
                         loss_cfg, lpips, face)
    return counts


def img_resume_check(train_cfg, model_cfg, state) -> None:
    """The checkpoint written at the end resumes bitwise: both models (BN
    statistics included), the codebook state and both Adams."""
    from mas_tpu_torch.train.loop import build_img_state

    resumed = build_img_state(dataclasses.replace(train_cfg, resume=True),
                              model_cfg, DEVICE)
    require(resumed.step == state.step
            and resumed.vq_state.counter == state.vq_state.counter
            and resumed.vq_state.filled == state.vq_state.filled
            and torch.equal(resumed.vq_state.reservoir,
                            state.vq_state.reservoir), "resume: codebook")
    for what in ("model", "disc"):
        mine, theirs = (getattr(s, what).state_dict()
                        for s in (resumed, state))
        for k, v in theirs.items():
            require(torch.equal(mine[k], v), f"resume: {what} {k}")
    for what in ("opt", "disc_opt"):
        a, b = (getattr(s, what).state_dict() for s in (resumed, state))
        require((a["count"], a["mini_step"]) == (b["count"], b["mini_step"]),
                f"resume: {what} counters")
        for part in ("mu", "nu", "acc"):
            for k, v in b[part].items():
                require(torch.equal(a[part][k], v),
                        f"resume: {what} {part} {k}")
    print(f"resume: step {resumed.step}, counter {resumed.vq_state.counter}:"
          " VQ model, discriminator, codebook state and both Adams bitwise "
          "equal")


def img_kernels_vs_twins(state, batch, loss_cfg, lpips, face) -> None:
    """One generator micro-step at counter 13 (quantized, no k-means, GAN
    active) from copies of the state after micro-step 12, four times:
    through B4/B5/B8 in bf16 ("kernel"); with the plain twins of B4 and B8
    patched in ("twin"); and both again with the VQ model computing in
    fp32 ("kernel fp32", "fp32", the reference).  All but the first take
    its indices: latents that differ by the GroupNorms' rounding pick other
    codes among near-ties, which would move the decoder's input and every
    gradient after it; B5 itself is held to its rule
    (``vq.argmin_agrees``) against the plain twin on the first run's own
    latents.

    The adaptive weight d_weight is a ratio of gradient norms through
    VGG16's ReLUs, and the total loss carries it some 15-fold (d_weight
    ~17 x g ~0.44 against a total of ~3.5), so the total is compared at
    one d_weight, the fp32 run's.  bf16 leaves the step ill-conditioned:
    in either bf16 run the gradients lie ~16% (median over tensors, up to
    40%) from the fp32 ones and d_weight 0.1-4.2% from its fp32 value
    (PERF.md, section 6).  Tolerances:
      * bf16, kernel vs twin: the nll, g, face and q losses and the total
        at the fp32 d_weight rel <= 1e-2 (phase 7's bound); d_weight
        within 10% of the fp32 value; the median over tensors of ||g -
        g32|| / ||g32|| at most 1.25 x the twin's plus 0.01, and no tensor
        off by more than 3 x the twin's error plus 5% of ||g32|| plus
        1e-4 x the largest ||g32|| (gradients that are zero up to
        rounding);
      * fp32, kernel vs twin (phase 5's setting, the kernels' fp32
        instances): the loss terms and the total at the fp32 d_weight rel
        <= 1e-3, d_weight rel <= 1e-2, each gradient within 2% of its
        norm plus 1e-4 x the largest gradient norm.
    Also: the conv outputs of the VQ model are bf16 and the towers'
    fp32."""
    from mas_tpu_torch.ops import gn_swish, vq
    from mas_tpu_torch.train.steps import img_generator_loss_and_grads

    dtypes = {"model": set(), "towers": set()}
    hooks = []
    for what, mods in (("model", [state.model]), ("towers", [lpips, face])):
        for mod in mods:
            for m in mod.modules():
                if isinstance(m, torch.nn.Conv2d):
                    hooks.append(m.register_forward_hook(
                        lambda m_, i, o, w=what: dtypes[w].add(o.dtype)))

    def run(fp32=False, **patches):
        st = copy.deepcopy(state)
        if fp32:
            st.model.dtype = torch.float32
        gen = torch.Generator(device=DEVICE).manual_seed(13)
        st.model.train()
        with ExitStack() as stack:
            for name, fn in patches.items():
                mod = vq if name == "vq_argmin" else gn_swish
                stack.enter_context(mock.patch.object(mod, name, fn))
            m, aux, grads = img_generator_loss_and_grads(
                st.model, st.disc, lpips, face, st.vq_state, batch["image"],
                batch["bbox_obj"], batch["bbox_face"], st.step, gen,
                loss_cfg)
        m = {k: float(v) for k, v in m.items()}
        m["q_loss"] = float(aux["q_loss"])
        return m, aux, grads

    km, aux, kg = run()
    for h in hooks:
        h.remove()
    idx = aux["indices"].reshape(-1)
    same = dict(vq_argmin=lambda z, cb: idx)
    twins = dict(same, gn_swish=gn_swish.gn_swish_plain,
                 gn_swish_bwd=gn_swish.gn_swish_bwd_plain)
    tm, _, tg = run(**twins)
    k32m, _, k32g = run(fp32=True, **same)
    rm, _, rg = run(fp32=True, **twins)
    torch.cuda.synchronize()
    require(aux["vq_state"].counter == 13 and not aux["kmeans_triggered"]
            and km["disc_factor"] == 1.0, "kernels-vs-twins micro-step runs "
            "at counter 13 with the GAN active")
    emb = state.model.quantize.embedding.weight
    z = aux["latent"].reshape(-1, emb.shape[1])
    own = vq.vq_argmin_plain(z, emb.to(z.dtype))
    require(vq.argmin_agrees(z, emb.to(z.dtype), idx, own),
            f"B5 indices vs the twin on the kernel's latents "
            f"({int((idx != own).sum())} of {len(own)} rows differ)")
    terms = ("loss", "nll_loss", "g_loss", "face_loss", "q_loss",
             "d_weight")
    for name, m in (("kernel", km), ("twin", tm), ("kernel fp32", k32m),
                    ("fp32", rm)):
        print(f"kernels vs twins, {name}: "
              + ", ".join(f"{k} {m[k]!r}" for k in terms))

    def rel(a, b):
        return abs(a - b) / abs(b)

    def total(m):
        """The loss at the fp32 run's d_weight."""
        return (m["nll_loss"] + rm["d_weight"] * m["disc_factor"]
                * m["g_loss"] + loss_cfg.codebook_weight * m["q_loss"]
                + m["face_loss"])

    for m in (km, tm, k32m, rm):
        m["total"] = total(m)
    checked = ("total", "nll_loss", "g_loss", "face_loss", "q_loss")
    bad = [f"bf16 {k} rel {rel(km[k], tm[k]):.2e}" for k in checked
           if rel(km[k], tm[k]) > 1e-2]
    bad += [f"fp32 {k} rel {rel(k32m[k], rm[k]):.2e}" for k in checked
            if rel(k32m[k], rm[k]) > 1e-3]
    dw16 = rel(km["d_weight"], rm["d_weight"])
    if dw16 > 0.1:
        bad.append(f"bf16 d_weight rel {dw16:.2e} to fp32")
    dw32 = rel(k32m["d_weight"], rm["d_weight"])
    if dw32 > 1e-2:
        bad.append(f"fp32 d_weight rel {dw32:.2e}")
    top = max(float(g.norm()) for g in rg)
    worst16 = worst32 = 0.0
    k_rel, t_rel = [], []
    names = [n for n, _ in state.model.named_parameters()]
    for name, g, pg, g32k, g32 in zip(names, kg, tg, k32g, rg):
        ref = float(g32.norm())
        dk, dt = float((g - g32).norm()), float((pg - g32).norm())
        k_rel.append(dk / max(ref, 1e-30))
        t_rel.append(dt / max(ref, 1e-30))
        allowed = 3 * dt + 0.05 * ref + 1e-4 * top
        worst16 = max(worst16, dk / allowed)
        if dk > allowed:
            bad.append(f"bf16 {name}: ||g - g32|| {dk:.3e}, twin {dt:.3e},"
                       f" ||g32|| {ref:.3e}")
        d32, allowed = float((g32k - g32).norm()), 0.02 * ref + 1e-4 * top
        worst32 = max(worst32, d32 / allowed)
        if d32 > allowed:
            bad.append(f"fp32 {name}: ||g - g32|| {d32:.3e}, ||g32|| "
                       f"{ref:.3e}")
    med_k, med_t = statistics.median(k_rel), statistics.median(t_rel)
    if med_k > 1.25 * med_t + 0.01:
        bad.append(f"bf16 gradients off fp32, median {med_k:.3f} (twin "
                   f"{med_t:.3f})")
    print(f"kernels vs twins, one GAN micro-step at counter 13: bf16 loss "
          f"rel {rel(km['loss'], tm['loss']):.2e}, at the fp32 d_weight "
          f"{rel(km['total'], tm['total']):.2e}; bf16 d_weight rel to fp32 "
          f"{dw16:.2e} (twin {rel(tm['d_weight'], rm['d_weight']):.2e}); "
          f"bf16 gradients off fp32, median over tensors {med_k:.3f} (twin "
          f"{med_t:.3f}), worst / allowed {worst16:.3f}; fp32 loss rel "
          f"{rel(k32m['loss'], rm['loss']):.2e}, at one d_weight "
          f"{rel(k32m['total'], rm['total']):.2e}, d_weight rel {dw32:.2e},"
          f" gradients worst / allowed {worst32:.3f}; B5 rows equal to the "
          f"twin's on the same latents "
          f"{float((idx == own).float().mean()):.4f}; conv outputs "
          f"{sorted(map(str, dtypes['model']))} (VQ model), "
          f"{sorted(map(str, dtypes['towers']))} (LPIPS, FaceNet)")
    require(dtypes["model"] == {torch.bfloat16}
            and dtypes["towers"] == {torch.float32}, "conv compute dtypes")
    require(not bad, "kernels-vs-twins: " + "; ".join(bad))


# --- phase 12: VQ eval, show and export at full width -----------------------

EVAL_CONFIG = os.path.join(ROOT, "configs", "eval_256.json")
SHOW_CONFIG = os.path.join(ROOT, "configs", "show_256.json")
EXPORT_CONFIG = os.path.join(ROOT, "configs", "export_vq.json")
RGB_EVAL_BATCHES = 4
EVAL_KEYS = {"l1", "mse", "psnr", "perplexity", "entropy", "used_fraction",
             "max_usage"}


@contextlib.contextmanager
def eval_twins():
    """B4 and B5 replaced by their plain twins."""
    from mas_tpu_torch.ops import gn_swish, vq

    with mock.patch.object(gn_swish, "gn_swish", gn_swish.gn_swish_plain), \
            mock.patch.object(vq, "vq_argmin", vq.vq_argmin_plain):
        yield


def write_config(tmp: str, name: str, raw: dict) -> str:
    path = os.path.join(tmp, name)
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def run_cli(config: str, cwd=None, on_step=None):
    """``mas_tpu_torch.cli.main`` on DEVICE, as ``python -m mas_tpu_torch
    --config ... --device cuda`` runs it, with a training mode's
    ``on_step`` hook: (its stdout lines, seconds)."""
    from mas_tpu_torch.cli import main as cli_main

    out = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), \
            (contextlib.chdir(cwd) if cwd else contextlib.nullcontext()):
        rc = cli_main(["--config", config, "--device", DEVICE], on_step)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    require(rc == 0, f"cli --config {config}: exit {rc}")
    return out.getvalue().strip().splitlines(), secs


def exact_counts(counts: dict, want: dict, what: str) -> None:
    for kid, n in counts.items():
        require(n == want.get(kid, 0), f"{kid} launched {n} times in {what},"
                f" expected {want.get(kid, 0)}")


def eval_batch(model, x, lpips=None) -> dict:
    """What ``evaluate_vq_model`` computes for one batch, left on the
    device."""
    from mas_tpu_torch.eval import codebook_stats, eval_step, recon_metrics

    recon, tokens = eval_step(model, x)
    with torch.no_grad():
        m = recon_metrics(x, recon, lpips)
    m.update(codebook_stats(tokens, model.cfg.codebook.codebook_size))
    return m


def metrics_vs_twins(what: str, got: dict, twin: dict, rel: float) -> None:
    """l1, mse (and lpips) within ``rel`` of the twins', psnr within 0.05
    dB; the codebook stats are printed (they move only with the tokens)."""
    bad = [f"{k} {got[k]!r} vs {twin[k]!r}" for k in ("l1", "mse", "lpips")
           if k in twin and abs(got[k] - twin[k]) > rel * abs(twin[k])]
    if abs(got["psnr"] - twin["psnr"]) > 0.05:
        bad.append(f"psnr {got['psnr']!r} vs {twin['psnr']!r}")
    print(f"{what} kernels vs twins: " + ", ".join(
        f"{k} {got[k]:.6g} / {twin[k]:.6g}" for k in sorted(twin)))
    require(not bad, f"{what} metrics vs twins: " + "; ".join(bad))


def tokens_check(model, x, what: str):
    """``hold_tokens`` on the tokens of ``eval_step``."""
    from mas_tpu_torch.eval import eval_step

    return hold_tokens(model, x, eval_step(model, x)[1], what)


def hold_tokens(model, x, tokens, what: str):
    """``tokens`` (of ``model`` on ``x``, through the kernels) obey B5's
    rule against the plain twin on their own latents
    (``vq.argmin_agrees``).  Where they differ from the tokens of the
    whole pass through the twins, the two passes' latents differ (B4's
    rounding, carried through the encoder), and each such position must be
    explained by that: with a, b the two passes' codes, the twin's latent
    z' prefers b over a by at most 2 |z - z'| |a - b| (Cauchy-Schwarz)
    plus each side's fp32 rounding.  Returns (the share of positions where
    B5 equals the twin on the same latents, the share equal to the twins'
    pass)."""
    from mas_tpu_torch.ops import vq as vq_ops

    d = model.cfg.embed_dim
    with torch.no_grad():
        z = model.encode_latent(x).reshape(-1, d)
        with eval_twins():
            twin = model.encode_tokens(x)
            zt = model.encode_latent(x).reshape(-1, d)
    emb = model.quantize.embedding.weight.to(z.dtype)
    plain = vq_ops.vq_argmin_plain(z, emb)
    got, want = tokens.reshape(-1).long(), twin.reshape(-1).long()
    require(vq_ops.argmin_agrees(z, emb, got, plain),
            f"{what}: tokens vs the plain twin on the same latents "
            f"({int((got != plain).sum())} of {len(plain)} differ)")
    rows = (got != want).nonzero().reshape(-1)
    if len(rows):
        zk, zp = z[rows].float(), zt[rows].float()
        a, b = emb[got[rows]].float(), emb[want[rows]].float()
        gap = (zp - a).square().sum(1) - (zp - b).square().sum(1)
        top = emb.float().square().sum(1).max()
        slack = 1e-5 * (zk.square().sum(1) + zp.square().sum(1) + 2 * top)
        allowed = 2 * (zk - zp).norm(dim=1) * (a - b).norm(dim=1) + slack
        require(bool((gap <= allowed).all()), f"{what}: "
                f"{int((gap > allowed).sum())} of {len(rows)} positions that "
                "differ from the twins' pass are not explained by the "
                "latents' difference")
    return (float((got == plain.long()).float().mean()),
            float((got == want).float().mean()))


def profile_eval(what: str, fn, batch: int, smi: str) -> None:
    """Host and device time of one eval batch (``breakdown._profile``
    over 3), B4 and B5 per batch and their share of the device time, with
    cuDNN TF32 off (as this script runs) and on (PyTorch's default, as the
    CLI runs)."""
    from mas_tpu_torch.breakdown import _profile

    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        res = _profile(fn, 3)
        torch.backends.cudnn.allow_tf32 = False
        ported = res["ported_kernels_ms_per_call"]
        busy = res["device_busy_ms"]
        for kid in ("B4", "B5"):
            require(kid in ported, f"{kid} not in the profile of {what}")
        print(f"{what}, cudnn tf32 {'on' if tf32 else 'off'}, one batch of "
              f"{batch}, profiled over 3: host {res['host_ms']:.2f} ms "
              f"({batch / res['host_ms'] * 1e3:.1f} images/s), device busy "
              f"{busy:.2f} ms, idle share "
              f"{100 * res['device_idle_share']:.1f}%; "
              + ", ".join(f"{k} {ported[k][0]:.3f} ms / {ported[k][1]} "
                          f"launches ({100 * ported[k][0] / busy:.1f}% of "
                          "busy)" for k in ("B4", "B5")) + f" [{smi}]")
        print(f"{what}, cudnn tf32 {'on' if tf32 else 'off'}, top kernels "
              "(name, ms, launches per batch): "
              + json.dumps(res["top_kernels_ms_per_call"]))


def seg_eval(gen, smi: str, seg_dir: str, tmp: str) -> dict:
    """``configs/eval_256.json`` with ``train.resume`` and
    ``checkpoint_dir`` = phase 5's dir, through the CLI; returns the
    launch counts."""
    from mas_tpu_torch.cli import data_iter, load_vq
    from mas_tpu_torch.eval import evaluate_vq_model
    from mas_tpu_torch.utils.config import VQModelConfig

    with open(EVAL_CONFIG) as f:
        raw = json.load(f)
    raw["train"] = dict(raw["train"], resume=True, checkpoint_dir=seg_dir)
    n, b = raw["n_eval_batches"], raw["train"]["batch_size"]
    reset_counts()
    lines, secs = run_cli(write_config(tmp, "eval_256.json", raw))
    counts = read_counts()
    print(f"eval_256 (CLI, checkpoint dir of phase 5): {lines[-1]}; "
          f"{secs:.2f} s with loading and data; launches {counts}")
    metrics = json.loads(lines[-1])
    require(set(metrics) == EVAL_KEYS
            and all(math.isfinite(v) for v in metrics.values()),
            f"eval_256 metrics: {metrics}")
    cfg = VQModelConfig.from_dict(raw["model"])
    model = load_vq(cfg, seg_dir, DEVICE, gen)
    exact_counts(counts, dict(B4=count_gns(model) * n, B5=n), "eval_256")
    batches = [torch.as_tensor(bb["mask"]).to(DEVICE) for bb, _ in
               zip(data_iter(raw["data"], b, cfg), range(n))]
    with eval_twins():
        twin = evaluate_vq_model(model, ({"mask": x} for x in batches), n)
    metrics_vs_twins("eval_256", metrics, twin, 1e-3)
    agree = [tokens_check(model, x, "eval_256") for x in batches]
    print(f"eval_256 tokens: B5 rule held on every batch; B5 equal to the "
          f"twin on the same latents at {min(a for a, _ in agree):.4f} of "
          f"the positions or more, to the twins' whole pass at "
          f"{min(p for _, p in agree):.4f} or more")
    profile_eval("eval_256 (VQ-SEG, fp32)",
                 lambda: eval_batch(model, batches[0]), b, smi)
    return counts


def seg_show(seg_dir: str, tmp: str) -> dict:
    """``configs/show_256.json`` with ``checkpoint_dir`` = phase 5's dir,
    through the CLI, in a fresh working directory; returns the launch
    counts."""
    import numpy as np
    from PIL import Image

    from mas_tpu_torch.models.vqvae import VQModel
    from mas_tpu_torch.utils.config import VQModelConfig

    with open(SHOW_CONFIG) as f:
        raw = json.load(f)
    raw["train"] = dict(raw["train"], checkpoint_dir=seg_dir)
    cwd = os.path.join(tmp, "show")
    os.makedirs(cwd)
    reset_counts()
    lines, secs = run_cli(write_config(tmp, "show_256.json", raw), cwd)
    counts = read_counts()
    b = raw["train"]["batch_size"]
    n = -(-raw["n_samples"] // b)
    res = raw["model"]["resolution"]
    print(f"show_256 (CLI): {lines[0]}; {len(lines) - 1} panels in "
          f"{secs:.2f} s; launches {counts}")
    require(lines[0].startswith("resumed from step"), "show resumed")
    require(len(lines) - 1 == n, f"show wrote {len(lines) - 1} panels, "
            f"expected {n}")
    size = (9 * (res + 2) + 2, b * (res + 2) + 2)
    for path in lines[1:]:
        img = Image.open(os.path.join(cwd, path))
        pixels = torch.from_numpy(np.array(img)).float()
        require(img.size == size and bool(torch.isfinite(pixels).all())
                and float(pixels.std()) > 0, f"show panel {path}: "
                f"{img.size}, expected {size}")
    with torch.device("meta"):
        n_gns = count_gns(VQModel(VQModelConfig.from_dict(raw["model"])))
    exact_counts(counts, dict(B4=n_gns * n, B5=n), "show_256")
    return counts


def rgb_eval(gen, smi: str) -> dict:
    """The ``model`` section of ``configs/img_512.json`` (512^2, bf16, K
    8192, seeded random weights, the codebook placed among the latents of
    8 other images as in phase 6) over 4 batches of 2 with the seeded
    random LPIPS tower, as ``--mode eval`` runs it, then a real-vs-recon
    FID on ``lpips_feature_fn``; returns the launch counts."""
    from mas_tpu_torch.cli import data_iter, load_vq
    from mas_tpu_torch.eval import (FIDAccumulator, eval_step,
                                    evaluate_vq_model, lpips_feature_fn)
    from mas_tpu_torch.train.loop import frozen_lpips
    from mas_tpu_torch.utils.config import VQModelConfig

    with open(IMG_CONFIG) as f:
        raw = json.load(f)
    cfg = VQModelConfig.from_dict(raw["model"])
    n, b, res = RGB_EVAL_BATCHES, 2, cfg.resolution
    model = load_vq(cfg, None, DEVICE, gen)
    with torch.no_grad():
        book = model.encode_latent(torch.rand(8, res, res, 3, device=DEVICE,
                                              generator=gen))
        model.quantize.embedding.weight.copy_(
            book.reshape(-1, cfg.embed_dim)[:cfg.codebook.codebook_size])
    batches = [{"image": torch.as_tensor(bb["image"]).to(DEVICE)} for bb, _
               in zip(data_iter(raw["data"], b, cfg), range(n))]
    lpips = frozen_lpips(DEVICE)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = evaluate_vq_model(model, iter(batches), n, lpips)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"eval img_512 (VQ-IMG bf16, {n} x {b} x {res}^2, LPIPS): "
          f"{json.dumps(metrics)}; {secs:.3f} s ({n * b / secs:.1f} images/s"
          f", first run); peak device memory {peak_gb:.2f} GiB; launches "
          f"{counts} [{smi}]")
    require(set(metrics) == EVAL_KEYS | {"lpips"}
            and all(math.isfinite(v) for v in metrics.values()),
            f"img_512 eval metrics: {metrics}")
    exact_counts(counts, dict(B4=count_gns(model) * n, B5=n), "img_512 eval")
    with eval_twins():
        twin = evaluate_vq_model(model, iter(batches), n, lpips)
    metrics_vs_twins("eval img_512", metrics, twin, 1e-2)
    agree = [tokens_check(model, bb["image"], "eval img_512")
             for bb in batches]
    same = min(a for a, _ in agree)
    print(f"eval img_512 tokens: B5 rule held on every batch; B5 equal to "
          f"the twin on the same latents at {same:.4f} of the positions or "
          f"more, to the twins' whole pass at {min(p for _, p in agree):.4f}"
          " or more (every difference explained by the latents')")
    require(same >= 0.99, "eval img_512 tokens: B5 vs the twin on the same "
            "latents")
    features = lpips_feature_fn(lpips)
    fids = []
    for twins in (False, True):
        real, fake = FIDAccumulator(features), FIDAccumulator(features)
        for bb in batches:
            with eval_twins() if twins else contextlib.nullcontext():
                recon, _ = eval_step(model, bb["image"])
            real.update(bb["image"])
            fake.update(recon)
        fids.append(real.fid(fake))
    print(f"eval img_512 FID real vs recon ({n * b} images, pooled VGG16 "
          f"taps, {real.sum.shape[0]} features): kernels {fids[0]!r}, twins "
          f"{fids[1]!r}")
    require(math.isfinite(fids[0])
            and abs(fids[0] - fids[1]) <= 1e-2 * max(1.0, abs(fids[1])),
            "FID kernels vs twins")
    profile_eval("eval img_512 (VQ-IMG, bf16, LPIPS)",
                 lambda: eval_batch(model, batches[0]["image"], lpips), b,
                 smi)
    return counts


def state_equal(got: dict, want: dict, what: str) -> None:
    require(sorted(got) == sorted(want), f"{what}: keys differ "
            f"{sorted(set(got) ^ set(want))[:4]}")
    bad = [k for k, v in want.items() if got[k].dtype != v.dtype
           or not torch.equal(got[k].cpu(), v.cpu())]
    require(not bad, f"{what}: not bitwise equal at {bad[:4]}")


def export_dirs(gen, seg_dir: str, transformer_dir: str, tmp: str) -> dict:
    """``--mode export`` of phase 5's and phase 7's checkpoint dirs
    (``configs/export_vq.json``; the ``transformer`` section of
    ``configs/transformer_512.json``): each ``.pt`` equals its
    checkpoint's ``model`` bitwise and loads into ``load_vq`` /
    ``load_transformer``.  Returns the launch counts (none)."""
    from mas_tpu_torch.cli import load_transformer, load_vq
    from mas_tpu_torch.utils.checkpoint import checkpoint_path, latest_step
    from mas_tpu_torch.utils.config import TransformerConfig, VQModelConfig
    from mas_tpu_torch.utils.weights import load_reference_pt

    with open(EXPORT_CONFIG) as f:
        vq_raw = json.load(f)
    with open(TRANSFORMER_CONFIG) as f:
        t_section = json.load(f)["transformer"]
    jobs = (("vq_seg", dict(vq_raw, checkpoint=seg_dir), seg_dir),
            ("transformer_512", {"train": {"mode": "export"},
                                 "transformer": t_section,
                                 "transformer_checkpoint": transformer_dir},
             transformer_dir))
    reset_counts()
    for name, raw, ck in jobs:
        out = os.path.join(tmp, f"{name}_reference_layout.pt")
        raw["output"] = out
        lines, secs = run_cli(write_config(tmp, f"export_{name}.json", raw))
        require(lines == [out], f"export printed {lines}")
        want = torch.load(checkpoint_path(ck, latest_step(ck)),
                          map_location="cpu", weights_only=True)["model"]
        got = load_reference_pt(out)
        state_equal(got, want, f"export {name}")
        if "transformer" in raw:
            model = load_transformer(TransformerConfig.from_dict(t_section),
                                     out, DEVICE, gen)
        else:
            model = load_vq(VQModelConfig.from_dict(raw["model"]), out,
                            DEVICE, gen)
        state_equal(model.state_dict(),
                    {k: v.to(model.state_dict()[k].dtype)
                     for k, v in want.items()}, f"{name} reloaded")
        print(f"export {name} (CLI, checkpoint dir): {len(got)} tensors, "
              f"{os.path.getsize(out) / 2 ** 20:.1f} MiB in {secs:.2f} s; "
              "bitwise equal to the checkpoint's model, and loaded by "
              f"{'load_transformer' if 'transformer' in raw else 'load_vq'}")
        del model, want, got
    counts = read_counts()
    exact_counts(counts, {}, "export")
    return counts


def phase_eval_show_export(gen, smi: str, seg_dir: str, transformer_dir: str,
                           tmp: str) -> dict:
    """Phase 12: ``--mode eval`` and ``show`` of phase 5's VQ-SEG
    checkpoint dir through the CLI, an img_512 eval, and ``--mode export``
    of phases 5 and 7's dirs; returns the launch counts summed over the
    eval, show and export runs."""
    import scipy

    print(f"phase 12 runs with cudnn.allow_tf32 "
          f"{torch.backends.cudnn.allow_tf32}, cuda.matmul.allow_tf32 "
          f"{torch.backends.cuda.matmul.allow_tf32}; the twins under the "
          f"same setting; scipy {scipy.__version__}")
    parts = [seg_eval(gen, smi, seg_dir, tmp), seg_show(seg_dir, tmp),
             rgb_eval(gen, smi), export_dirs(gen, seg_dir, transformer_dir,
                                             tmp)]
    return {k: sum(p[k] for p in parts) for k in parts[0]}


# --- phase 13: real input and the data factory ------------------------------

PREPROCESS_CONFIG = os.path.join(ROOT, "configs", "preprocess_web.json")
RAW_SHARDS, RAW_PER_SHARD = 2, 16
# (h, w) of the raw JPEGs in turn: landscape 640 x 480, portrait 480 x 720
RAW_SIZES = ((480, 640), (720, 480))
NPZ_KEYS = {"seg_panoptic", "edge_panoptic", "seg_human", "edge_human",
            "seg_face", "box_things", "box_face"}
# transformer_512's data at 512^2; seg_256's model there with a 32-fold
# reduction gives its 16 x 16 seg tokens (seg_tokens_per_dim)
DATA_RES = 512
SEG_512_CHANNELS = [128, 128, 128, 256, 512, 512, 512]


def write_raw_shards(d: str) -> dict:
    """RAW_SHARDS tar shards of RAW_PER_SHARD samples: a JPEG (a seeded
    12 x 16 numpy image, bicubic-upsampled to RAW_SIZES in turn, plus
    noise) and a caption each; returns {shard path: [keys]}."""
    from PIL import Image

    os.makedirs(d)
    rng = np.random.default_rng(13)
    keys = {}
    for k in range(RAW_SHARDS):
        path = os.path.join(d, f"raw{k:03d}.tar")
        keys[path] = []
        with tarfile.open(path, "w") as tf:
            for i in range(RAW_PER_SHARD):
                h, w = RAW_SIZES[i % len(RAW_SIZES)]
                small = Image.fromarray(
                    (rng.random((12, 16, 3)) * 255).astype(np.uint8))
                img = np.asarray(small.resize((w, h), Image.BICUBIC),
                                 np.float32)
                img += rng.normal(0, 6, img.shape)
                buf = io.BytesIO()
                Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                    buf, "JPEG")
                key = f"{k:03d}_{i:04d}"
                for name, data in ((f"{key}.jpg", buf.getvalue()),
                                   (f"{key}.txt",
                                    f"scene {k} {i}: a dog on a red sofa"
                                    .encode())):
                    info = tarfile.TarInfo(name)
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
                keys[path].append(key)
    return keys


def _members(path: str) -> dict:
    """{key: {extension: bytes}} of a tar."""
    out = {}
    with tarfile.open(path) as tf:
        for m in tf:
            key, ext = m.name.split(".", 1)
            out.setdefault(key, {})[ext] = tf.extractfile(m).read()
    return out


def _npz(data: bytes) -> dict:
    with np.load(io.BytesIO(data)) as z:
        return {k: z[k] for k in z.files}


def check_processed(raw: dict, out: str, what: str) -> dict:
    """Every sample read from the raw shards was written to ``out`` with
    its jpg and txt and the npz of NPZ_KEYS; ``info.state`` counts three
    annotators done on every shard; returns {key: its members}."""
    shards = sorted(f for f in os.listdir(out) if f.endswith(".tar"))
    require(shards == [os.path.basename(p) for p in raw],
            f"{what}: processed shards {shards}")
    read = written = 0
    members = {}
    for path, keys in raw.items():
        got = _members(os.path.join(out, os.path.basename(path)))
        src = _members(path)
        read += len(src)
        written += len(got)
        require(sorted(got) == sorted(keys) == sorted(src),
                f"{what}, {path}: {len(src)} samples read, {len(got)} "
                "written")
        for key in keys:
            require(got[key]["jpg"] == src[key]["jpg"]
                    and got[key]["txt"] == src[key]["txt"]
                    and set(_npz(got[key]["npz"])) == NPZ_KEYS,
                    f"{what}, {path} {key}: members {sorted(got[key])}")
        members.update(got)
    with open(os.path.join(out, "info.state")) as f:
        state = json.load(f)
    require(sorted(state["done"].values()) == [3] * RAW_SHARDS,
            f"{what}: info.state {state}")
    print(f"preprocess_dataset ({what}): {RAW_SHARDS} shards, {read} samples"
          f" read, {written} written, each with jpg, txt and the npz of "
          f"{len(NPZ_KEYS)} keys")
    return members


class ScriptedAnnotator(torch.nn.Module):
    """A stand-in for a user's annotator network, traced to TorchScript:
    [1, 3, H, W] image -> the npz arrays of ``kind``, integer functions of
    the image's 8-bit values, so that any device gives the same arrays."""

    def __init__(self, kind: str):
        super().__init__()
        self.kind = kind

    def forward(self, x):
        v = (x[0] * 255).round().to(torch.int16)
        box = x[0, :, :2, :2].reshape(-1, 4)
        if self.kind == "panoptic":
            return {"seg_panoptic": v[0] % 133,
                    "edges": (v[1] > 128).to(torch.uint8), "box_things": box}
        if self.kind == "human":
            return {"seg_human": v[1] % 24,
                    "edges": (v[2] > 128).to(torch.uint8)}
        return {"seg_face": (v[2] > 200).to(torch.uint8), "box_face": box}


def data_factory(raw: dict, tmp: str) -> tuple:
    """``--mode preprocess_dataset`` of configs/preprocess_web.json with
    its paths in ``tmp``; again with three traced TorchScript annotators,
    which run on the card in worker processes started by spawn; then in
    local mode over the same JPEGs.  Checks that every sample read was
    written (``check_processed``) and holds the TorchScript run's arrays
    of one sample to its modules run on the CPU; returns (the processed
    shard dir, the image dir, the npz dir)."""
    from mas_tpu_torch.data.dataset import decode_jpg

    with open(PREPROCESS_CONFIG) as f:
        cfg = json.load(f)
    raw_dir = os.path.dirname(next(iter(raw)))
    out = os.path.join(tmp, "processed")
    cfg["preprocess"] = dict(cfg["preprocess"], shards=raw_dir, out_dir=out)
    reset_counts()
    _, secs = run_cli(write_config(tmp, "preprocess_web.json", cfg), tmp)
    require(not any(read_counts().values()), "a kernel launched in "
            "preprocessing")
    members = check_processed(raw, out, f"web, synthetic annotators, CLI, "
                              f"{secs:.2f} s")

    scripted, anns = {}, {}
    for kind in ("panoptic", "human", "face"):
        scripted[kind] = torch.jit.trace(ScriptedAnnotator(kind),
                                         torch.zeros(1, 3, 8, 8),
                                         strict=False)
        anns[kind] = {"type": "torchscript",
                      "path": os.path.join(tmp, f"{kind}.pt")}
        scripted[kind].save(anns[kind]["path"])
    ts_out = os.path.join(tmp, "processed_ts")
    ts_cfg = dict(cfg, preprocess=dict(cfg["preprocess"], out_dir=ts_out,
                                       annotators=anns))
    _, secs = run_cli(write_config(tmp, "preprocess_ts.json", ts_cfg), tmp)
    got = check_processed(raw, ts_out, f"web, TorchScript annotators on "
                          f"{DEVICE} in spawned workers, CLI, {secs:.2f} s")
    key = next(iter(got))
    arrays = _npz(got[key]["npz"])
    x = torch.from_numpy(decode_jpg(got[key]["jpg"])).permute(2, 0, 1)[
        None].float()
    with torch.no_grad():
        want = {("edge_" + kind if k == "edges" else k): v.numpy()
                for kind, m in scripted.items() for k, v in m(x).items()}
    require(set(arrays) == set(want) and all(
        np.array_equal(arrays[k], want[k]) for k in want),
        f"TorchScript annotators' arrays of {key} differ from the CPU's")
    print(f"TorchScript annotators: the arrays of {key} equal the modules' "
          "on the CPU")

    images = []
    img_dir = os.path.join(tmp, "images")
    os.makedirs(img_dir)
    for key in sorted(members):
        images.append(os.path.join(img_dir, key + ".jpg"))
        with open(images[-1], "wb") as f:
            f.write(members[key]["jpg"])
    pre = os.path.join(tmp, "npz")
    cfg["preprocess"] = dict(cfg["preprocess"], mode="local", images=images,
                             out_dir=pre, workers_per_annotator=2)
    _, secs = run_cli(write_config(tmp, "preprocess_local.json", cfg), tmp)
    want = sorted(f"{os.path.basename(p)[:-4]}_{k}.npz" for p in images
                  for k in ("panoptic", "human", "face"))
    require(sorted(os.listdir(pre)) == want,
            f"local mode wrote {len(os.listdir(pre))} of {len(want)} npz")
    print(f"preprocess_dataset (local, CLI): {len(images)} images -> "
          f"{len(want)} npz; {secs:.2f} s")
    return out, img_dir, pre


def logged(lines: list) -> list:
    """The JSON scalar lines a CLI training run printed."""
    return [json.loads(x) for x in lines if x.startswith('{"step"')]


def seg_on_shards(shards: str, img_dir: str, pre: str, tmp: str) -> dict:
    """``--mode pretrain_segmentation`` of seg_256 as phase 5 cuts it
    (``seg_training_raw``: 16 micro-steps through pass-through,
    reservoir, k-means and B5) on the processed shards at 256^2 (one pass
    of 32 samples at batch 2), then 2 micro-steps on local_npz; returns
    the launch counts of both runs."""
    from mas_tpu_torch.models.vqvae import VQModel
    from mas_tpu_torch.utils.config import VQModelConfig

    raw = seg_training_raw(tmp)
    raw["train"] = dict(raw["train"], log_period=1,
                        checkpoint_dir=os.path.join(tmp, "seg_web"))
    raw["data"] = {"kind": "webdataset", "shards": shards,
                   "resolution": raw["model"]["resolution"]}
    reset_counts()
    lines, secs = run_cli(write_config(tmp, "seg_web.json", raw), tmp)
    counts = read_counts()
    losses = [e["loss"] for e in logged(lines)]
    print(f"pretrain_segmentation on shards (CLI): {len(losses)} micro-steps"
          f" in {secs:.2f} s; losses " + " ".join(f"{v:.5f}" for v in losses)
          + f"; launches {counts}")
    require(len(losses) == TRAIN_STEPS and lines[-1] == f"trained to step "
            f"{TRAIN_STEPS}" and all(math.isfinite(v) for v in losses),
            f"seg on shards: {lines[-1]!r}, losses {losses}")
    with torch.device("meta"):
        n_gns = count_gns(VQModel(VQModelConfig.from_dict(raw["model"])))
    for kid, floor in (("B4", n_gns * TRAIN_STEPS), ("B5", 1),
                       ("B8", n_gns * TRAIN_STEPS)):
        require(counts[kid] >= floor, f"{kid} launched {counts[kid]} times "
                f"in seg training on shards, expected >= {floor}")

    raw["train"] = dict(raw["train"], total_steps=2,
                        checkpoint_dir=os.path.join(tmp, "seg_local"))
    raw["data"] = {"kind": "local_npz", "image_dir": img_dir,
                   "preprocessed_dir": pre,
                   "resolution": raw["model"]["resolution"]}
    reset_counts()
    lines, secs = run_cli(write_config(tmp, "seg_local.json", raw), tmp)
    local = read_counts()
    losses = [e["loss"] for e in logged(lines)]
    print(f"pretrain_segmentation on local_npz (CLI): losses {losses}, "
          f"{secs:.2f} s; launches {local}")
    require(len(losses) == 2 and all(math.isfinite(v) for v in losses),
            f"seg on local_npz: {lines[-1]!r}, losses {losses}")
    require(local["B4"] > 0 and local["B8"] > 0,
            f"B4 / B8 launched {local['B4']} / {local['B8']} times on "
            "local_npz")
    return {k: counts[k] + local[k] for k in counts}


def transformer_on_shards_raw(shards: str, img_dir, tmp: str) -> dict:
    """configs/transformer_512.json as shipped, on the processed shards at
    512^2 (``kind: webdataset``), with ``vq_img`` img_512's model (from
    ``img_dir``, phase 11's checkpoint dir, where given) and ``vq_seg``
    seg_256's model at 512^2 with SEG_512_CHANNELS (16 x 16 tokens)."""
    with open(TRANSFORMER_CONFIG) as f:
        raw = json.load(f)
    with open(SEG_CONFIG) as f:
        seg_model = dict(json.load(f)["model"], resolution=DATA_RES,
                         channels=SEG_512_CHANNELS)
    with open(IMG_CONFIG) as f:
        img_model = json.load(f)["model"]
    raw["train"] = dict(raw["train"], log_period=1,
                        checkpoint_dir=os.path.join(tmp, "transformer_web"))
    raw["data"] = {"kind": "webdataset", "shards": shards,
                   "resolution": DATA_RES}
    raw["vq_seg"] = {"model": seg_model}
    raw["vq_img"] = {"model": img_model, "checkpoint": img_dir}
    return raw


def profile_steps(first: int, last: int, out: dict):
    """An ``on_step`` hook that profiles a training loop's micro-steps
    ``first`` + 1 ... ``last`` as the loop runs them, batch loading
    included, and puts the profile and the host ms a step (taken with the
    profiler on) into ``out``; ``breakdown.summary`` reads them after the
    run, off the loop's clock."""
    from mas_tpu_torch.breakdown import ACTIVITIES

    prof = torch.profiler.profile(activities=ACTIVITIES)
    t0 = []

    def on_step(step_no, state, metrics):
        if step_no == first:
            torch.cuda.synchronize()
            prof.start()
            t0.append(time.perf_counter())
        elif step_no == last:
            torch.cuda.synchronize()
            out["host_ms"] = (time.perf_counter() - t0[0]) * 1e3 / (
                last - first)
            prof.stop()
            out["prof"] = prof

    return on_step


def tokenize_and_train(smi: str, shards: str, img_dir, tmp: str):
    """Transformer training on tokenized shards through the CLI (4 steps:
    one pass of 32 samples at batch 8) with exact launch counts, its
    steps 2-4 profiled as the CLI's loop runs them; one batch's tokens
    held to the twins; the loader, tokenization and the mask batch's
    host-to-device copy measured; returns the launch counts."""
    from mas_tpu_torch.breakdown import summary
    from mas_tpu_torch.cli import data_iter, load_vq
    from mas_tpu_torch.data.tokenizer import HashWordTokenizer
    from mas_tpu_torch.models.vqvae import VQModel
    from mas_tpu_torch.train.loop import tokenize_batches
    from mas_tpu_torch.utils.config import (TrainConfig, TransformerConfig,
                                            VQModelConfig)

    raw = transformer_on_shards_raw(shards, img_dir, tmp)
    tcfg = TransformerConfig.from_dict(raw["transformer"])
    train_cfg = TrainConfig.from_dict(raw["train"])
    b = train_cfg.batch_size
    steps = RAW_SHARDS * RAW_PER_SHARD // b
    cfgs = {k: VQModelConfig.from_dict(raw[k]["model"])
            for k in ("vq_seg", "vq_img")}
    with torch.device("meta"):
        gns = sum(count_gns(VQModel(c).encoder) for c in cfgs.values())

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    prof = {}
    reset_counts()
    lines, secs = run_cli(write_config(tmp, "transformer_web.json", raw),
                          tmp, profile_steps(1, steps, prof))
    counts = read_counts()
    res = summary(prof["prof"], prof["host_ms"], steps - 1)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    log = logged(lines)
    losses = [e["loss"] for e in log]
    step_ms = [1e3 / e["steps_per_sec"] for e in log]
    print(f"train_transformer on tokenized shards (CLI): {len(log)} steps "
          f"in {secs:.2f} s with loading, tokenizing and the final "
          f"checkpoint; losses " + " ".join(f"{v:.5f}" for v in losses)
          + "; ms a step (host clock between logged steps, loader + "
          "tokenize + step; steps 2-4 profiled) "
          + " ".join(f"{v:.1f}" for v in step_ms)
          + f"; peak device memory {peak_gb:.2f} GiB; launches {counts}")
    require(len(log) == steps and lines[-1] == f"trained to step {steps}"
            and all(math.isfinite(v) for v in losses),
            f"transformer on shards: {lines[-1]!r}, losses {losses}")
    exact_counts(counts, dict(B1=tcfg.num_layers * steps,
                              B6=tcfg.num_layers * steps, B4=gns * steps,
                              B5=2 * steps), "tokenize and train")
    print(f"transformer step with the real loader (CLI loop, steps 2-"
          f"{steps}, profiler on): host {res['host_ms']:.1f} ms, device "
          f"busy {res['device_busy_ms']:.1f} ms, idle share "
          f"{100 * res['device_idle_share']:.1f}%; ported kernels "
          + json.dumps(res["ported_kernels_ms_per_call"]) + f" [{smi}]")

    # the loader alone: one pass over the 32 samples at 512^2
    t0 = time.perf_counter()
    batches = list(data_iter(raw["data"], b, tcfg))
    loader_s = time.perf_counter() - t0
    n = sum(len(x["caption"]) for x in batches)
    require(n == RAW_SHARDS * RAW_PER_SHARD and batches[0]["mask"].shape
            == (b, DATA_RES, DATA_RES, 159), f"loader: {n} samples")
    print(f"loader (webdataset, {DATA_RES}^2, seg maps, host clock, one "
          f"pass): {n} samples in {loader_s:.2f} s, {n / loader_s:.2f} "
          f"images/s")

    generator = torch.Generator(device=DEVICE).manual_seed(train_cfg.seed)
    vq_seg, vq_img = (load_vq(cfgs[k], raw[k].get("checkpoint"), DEVICE,
                              generator) for k in ("vq_seg", "vq_img"))
    tok = HashWordTokenizer(tcfg.text_vocab_size - tcfg.text_length,
                            tcfg.text_length)
    first = batches[0]
    reset_counts()
    tokens = next(tokenize_batches([first], vq_seg, vq_img, tok, DEVICE))
    torch.cuda.synchronize()
    one = read_counts()
    exact_counts(one, dict(B4=gns, B5=2), "tokenizing one batch")
    mask = torch.as_tensor(first["mask"]).to(DEVICE)
    image = torch.as_tensor(first["image"]).to(DEVICE)
    for what, model, x, t in (("seg", vq_seg, mask, tokens["seg"]),
                              ("image", vq_img, image, tokens["image"])):
        same, whole = hold_tokens(model, x, t, f"{what} tokens")
        print(f"{what} tokens of batch 1: B5 rule held; equal to the twin on "
              f"the same latents at {same:.5f}, to the twins' whole pass at "
              f"{whole:.5f}")

    with torch.inference_mode():
        tok_ms = timed_ms(lambda: (vq_seg.encode_tokens(mask),
                                   vq_img.encode_tokens(image)),
                          reps=5, warmup=1)
        seg_ms = timed_ms(lambda: vq_seg.encode_tokens(mask), reps=5,
                          warmup=1)
    print(f"tokenize one batch of {b} x {DATA_RES}^2 (device-resident, CUDA "
          f"events): {tok_ms:.2f} ms, of it the seg encoder {seg_ms:.2f} "
          f"ms [{smi}]")

    host = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.as_tensor(first["mask"]).to(DEVICE, non_blocking=True)
        torch.cuda.synchronize()
        host.append(1e3 * (time.perf_counter() - t0))
    pinned = torch.from_numpy(first["mask"]).pin_memory()
    pin_ms = timed_ms(lambda: pinned.to(DEVICE, non_blocking=True), reps=3,
                      warmup=1)
    gb = first["mask"].nbytes / 1e9
    print(f"host-to-device copy of one mask batch ({gb:.3f} GB fp32): "
          f"pageable " + ", ".join(f"{v:.1f}" for v in host)
          + f" ms ({gb / statistics.median(host) * 1e3:.2f} GB/s); pinned "
          f"{pin_ms:.1f} ms ({gb / pin_ms * 1e3:.2f} GB/s) [{smi}]")
    del pinned, batches, first, mask, image, vq_seg, vq_img
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_data(smi: str, tmp: str, img_dir=None) -> dict:
    """Phase 13: raw shards -> the data factory -> VQ-SEG training on the
    processed shards and on local_npz -> transformer training on shards
    tokenized by both encoders, all through the CLI, with cuDNN TF32 at
    PyTorch's default (on), as ``python -m mas_tpu_torch`` runs; returns
    the launch counts of the training runs."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    os.makedirs(tmp)
    try:
        t0 = time.perf_counter()
        raw = write_raw_shards(os.path.join(tmp, "raw"))
        shards, images, pre = data_factory(raw, tmp)
        seg = seg_on_shards(shards, images, pre, tmp)
        tr = tokenize_and_train(smi, shards, img_dir, tmp)
        print(f"phase 13 (data) took {time.perf_counter() - t0:.1f} s; "
              "vq_img from " + (img_dir or "seeded random weights"))
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    return {k: seg[k] + tr[k] for k in seg}


# --- phase 14: the transformer's variants at full width ---------------------

VARIANT_LAYERS = 8     # phase 14's depth: full width, a third of the layers


def variant_raws() -> list:
    """The serving variants of phase 14: configs/sample_256.json with
    transformer fields changed in memory (``VARIANT_LAYERS`` of its 24
    layers), and the batches each runs."""
    with open(CONFIG) as f:
        raw = json.load(f)

    def variant(**fields):
        return dict(raw, transformer=dict(raw["transformer"],
                                          num_layers=VARIANT_LAYERS,
                                          **fields))

    return [
        ("GQA-4 int4", variant(num_kv_heads=4), (4, 64)),
        ("GQA-4 int4 bf16 scales",
         variant(num_kv_heads=4, kv_scale_dtype="bfloat16"), (64,)),
        ("GQA-4 float", variant(num_kv_heads=4, kv_cache_dtype="compute"),
         (4,)),
        ("rudalle_relax + prescale float",
         variant(rudalle_relax=True, cogview_layernorm_prescale=True,
                 kv_cache_dtype="compute"), (4,)),
        ("ln_matmul_fold int4", variant(ln_matmul_fold=True), (4,)),
    ]


def serve_variant(gen, smi: str, what: str, raw: dict, batches) -> dict:
    """One serving variant through ``sample_images`` as the CLI loads it:
    images, exact launch counts at each batch, teacher-forced logits
    against the twins, and the decode step's profile from step 8; returns
    the launch counts summed over its runs."""
    transformer, vq, text, seg = load_pipeline(raw, gen)
    cfg = transformer.cfg
    n_gns = count_gns(vq.decoder)
    steps = cfg.image_length - 1
    layers = cfg.num_layers
    quantized = cfg.kv_cache_dtype != "compute"
    total = {}
    for i, batch in enumerate(batches):
        rep = batch // text.shape[0]
        t, s = text.repeat(rep, 1), seg.repeat(rep, 1)
        reset_counts()
        imgs, secs = run_slice(raw, transformer, vq, t, s, seed=41 + i)
        counts = read_counts()
        res = vq.cfg.resolution
        require(tuple(imgs.shape) == (batch, res, res, 3)
                and bool(torch.isfinite(imgs).all()), f"{what}: images")
        want = {k: 0 for k in counts}
        want.update(B1=layers, B4=n_gns * -(-batch // 32))
        want.update({"B2": layers * steps, "B3": layers * steps}
                    if quantized else {"B9": layers * steps})
        exact_counts(counts, want, f"{what} batch {batch}")
        print(f"{what} batch {batch}: images {tuple(imgs.shape)} in "
              f"{secs:.3f} s ({batch / secs:.3f} img/s"
              f"{', first run' if i == 0 else ''}); launches exact: "
              f"{ {k: v for k, v in counts.items() if v} } [{smi}]")
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        res = decode_profile(transformer, text, seg, batch)
        print_decode_profile(what, batch, res)
        mha = _MHA_DECODE.get(batch)
        read = "B2" if quantized else "B9"
        if mha and read in res["ported_kernels_ms_per_call"]:
            # per launch: phase 4 runs all 24 layers, this phase fewer
            per = lambda ms_n: ms_n[0] / max(ms_n[1], 1)
            print(f"{what} batch {batch}: {read} "
                  f"{per(res['ported_kernels_ms_per_call'][read]):.5f} ms a "
                  f"launch, beside phase 4's MHA int4 B2 "
                  f"{per(mha['ported_kernels_ms_per_call']['B2']):.5f} ms")
    # seeded random weights give near-uniform logits (max |logit| ~2.6 over
    # 8192 codes), whose near-ties bf16 rounding flips: over phase 4's
    # unchanged multi-head path the agreement at every position ranged
    # 85-100% from one weight draw to another on the card, so the top-1
    # share counts the positions the twins decide by more than 4 bf16 ulps
    # of max |logit|, as phase 8 does
    teacher_forced_check(transformer, text, seg, gen, margin_ulps=4)
    del transformer, vq
    gc.collect()
    torch.cuda.empty_cache()
    return total


TRAIN_VARIANTS = (
    ("GQA-4", dict(num_kv_heads=4)),
    ("rudalle_relax + prescale + ln_matmul_fold",
     dict(rudalle_relax=True, cogview_layernorm_prescale=True,
          ln_matmul_fold=True)),
)


def train_variant(smi: str, tmp: str, what: str, fields: dict) -> dict:
    """configs/transformer_512.json with ``fields`` and
    ``VARIANT_LAYERS`` layers, 2 steps
    through ``run_train_transformer``: finite losses, every parameter
    moved with a finite nonzero gradient at step 1, exact B1/B6 counts,
    one step through the kernels against the twins (B1/B6 patched, which
    both attention Functions call); returns the launch counts."""
    from mas_tpu_torch.data.dataset import SyntheticTokenBatches
    from mas_tpu_torch.train.loop import (build_transformer_state,
                                          run_train_transformer)
    from mas_tpu_torch.utils.logging import Logger

    steps = 2
    train_cfg, tcfg, data = transformer_configs(tmp, total_steps=steps)
    tcfg = dataclasses.replace(tcfg, num_layers=VARIANT_LAYERS, **fields)
    source = iter(SyntheticTokenBatches(train_cfg.batch_size, tcfg,
                                        data.get("seed", 0)))
    batches = [{k: torch.from_numpy(v).to(DEVICE)
                for k, v in next(source).items()} for _ in range(steps)]
    init = build_transformer_state(train_cfg, tcfg, DEVICE)
    before = {k: v.clone() for k, v in init.model.state_dict().items()}
    del init
    record = []

    def on_step(step_no, state, metrics):
        torch.cuda.synchronize()
        if step_no == 1:
            first_step_checks(state, before)
        record.append((time.perf_counter(), float(metrics["loss"])))

    reset_counts()
    t0 = time.perf_counter()
    state = run_train_transformer(train_cfg, tcfg, batches, DEVICE,
                                  Logger(os.path.join(tmp, "logs")), on_step)
    torch.cuda.synchronize()
    counts = read_counts()
    losses = [loss for _, loss in record]
    require(len(losses) == steps and all(map(math.isfinite, losses)),
            f"{what}: losses {losses}")
    want = {k: 0 for k in counts}
    want.update(B1=tcfg.num_layers * steps, B6=tcfg.num_layers * steps)
    exact_counts(counts, want, f"train {what}")
    print(f"train_transformer {what}: {steps} steps in "
          f"{time.perf_counter() - t0:.2f} s (first run, checkpoint "
          f"included), losses {losses}, step 2 "
          f"{1e3 * (record[1][0] - record[0][0]):.1f} ms (host clock); "
          f"launches exact: { {k: v for k, v in counts.items() if v} } "
          f"[{smi}]")
    transformer_kernels_vs_twins(state, batches[-1])
    if tcfg.kv_heads != tcfg.num_attn_heads:
        expand_cost(smi, train_cfg.batch_size, tcfg)
    del state, batches
    shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def expand_cost(smi: str, batch: int, tcfg) -> None:
    """What the grouped-query training step pays to expand k and v to the
    query heads for B1/B6 (``repeat_interleave``) and to sum their
    gradients back over each group (autograd's backward of it), per layer
    at the step's shape (CUDA events, median)."""
    g = tcfg.num_attn_heads // tcfg.kv_heads
    shape = (batch, tcfg.kv_heads, tcfg.total_length, tcfg.head_dim)
    k, v = (torch.randn(shape, device="cuda", dtype=torch.bfloat16)
            for _ in range(2))
    dk = torch.randn((batch, tcfg.num_attn_heads) + shape[2:], device="cuda",
                     dtype=torch.bfloat16)
    fwd = timed_ms(lambda: (k.repeat_interleave(g, dim=1),
                            v.repeat_interleave(g, dim=1)))
    bwd = timed_ms(lambda: [dk.unflatten(1, (tcfg.kv_heads, g)).sum(2)
                            for _ in range(2)])
    layers = tcfg.num_layers
    print(f"GQA-{tcfg.kv_heads} k/v expansion at {list(shape)} bf16, g {g}: "
          f"forward {fwd:.4f} ms, gradient sum {bwd:.4f} ms a layer; "
          f"{layers * (fwd + bwd):.2f} ms a step over {layers} layers "
          f"[{smi}]")


def phase_variants(gen, smi: str, tmp: str) -> dict:
    """Phase 14: the transformer's variants at full width and
    ``VARIANT_LAYERS`` layers (grouped-query
    attention over int4 lane, bf16-scale and float caches; rudalle_relax
    with the LayerNorm prescale; ln_matmul_fold), served through
    ``sample_images`` and trained through ``run_train_transformer``;
    returns the launch counts summed over its runs."""
    t0 = time.perf_counter()
    total = {}
    for what, raw, batches in variant_raws():
        counts = serve_variant(gen, smi, what, raw, batches)
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
    for i, (what, fields) in enumerate(TRAIN_VARIANTS):
        counts = train_variant(smi, os.path.join(tmp, f"variant{i}"), what,
                               fields)
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
    print(f"phase 14 (variants) took {time.perf_counter() - t0:.1f} s")
    return total


# --- phase 15: data-parallel training across processes -----------------------

PAR_WORLD = 2
PAR_STEPS = {"seg": 15, "img": 8, "transformer": 2}
PAR_TRANSFORMER_LAYERS = 8


def parallel_raws(tmp: str, world: int) -> dict:
    """Phase 15's configs at full width for ``world`` ranks (``world`` 1:
    one process on the global batch), by name: ``seg`` — seg_256 as
    phase 5 cuts it (codebook.init_steps 4, samples_per_image 256), 15
    micro-steps: k-means at 12 and 14, quantization through B5 from 12,
    Adam updates at 3, 6, 9, 12 and 15 (the last one quantized);
    ``img`` — img_512 as phase 11 cuts it with the GAN gate open from
    micro-step 0 (loss.disc_start 0), 8 micro-steps: one Adam update a
    side; ``transformer`` — transformer_512 cut in depth to
    ``PAR_TRANSFORMER_LAYERS`` layers (phase 16 trains all 24), 2 steps.
    The
    global batch is the shipped one (seg 4: 2 a rank, as shipped; img 2;
    transformer 8), ``mesh.data`` the world size; checkpoints under
    ``tmp``."""
    seg = seg_training_raw(tmp)
    with open(IMG_CONFIG) as f:
        img = json.load(f)
    img["model"]["codebook"] = dict(img["model"]["codebook"], init_steps=4,
                                    samples_per_image=640)
    img["loss"] = dict(img["loss"], disc_start=0)
    with open(TRANSFORMER_CONFIG) as f:
        transformer = json.load(f)
    transformer["transformer"]["num_layers"] = PAR_TRANSFORMER_LAYERS
    raws = {"seg": (seg, 2 * PAR_WORLD), "img": (img, 2),
            "transformer": (transformer, 8)}
    out = {}
    for name, (raw, global_batch) in raws.items():
        raw = copy.deepcopy(raw)
        raw["train"] = dict(
            raw["train"], total_steps=PAR_STEPS[name],
            batch_size=global_batch // world, mesh={"data": world},
            checkpoint_dir=os.path.join(tmp, f"{name}_w{world}"))
        out[name] = raw
    return out


def rank_rows(real, process_index: int):
    """``cli.data_iter`` as rank ``process_index`` reads it here: the
    config's synthetic data with its seed offset by 1000 x the rank, so
    every rank's rows differ, and faces (``bbox_face``) in rank 0's rows
    only: one box a row there, [res/4, 5 res/8) on both axes, none
    elsewhere."""
    def data_iter(data_cfg, batch_size, model_cfg, *args):
        cfg = dict(data_cfg, seed=data_cfg.get("seed", 0)
                   + 1000 * process_index)
        for batch in real(cfg, batch_size, model_cfg):
            if "bbox_face" in batch:
                faces = np.zeros_like(batch["bbox_face"])
                if process_index == 0:
                    res = batch["image"].shape[1]
                    faces[:, 0] = (res // 4, res // 4, 5 * res // 8,
                                   5 * res // 8)
                batch = dict(batch, bbox_face=faces)
            yield batch

    return data_iter


def global_rows(real, world: int):
    """``cli.data_iter`` of one process holding the global batch of
    ``world`` ranks: each rank's rows (``rank_rows``), in rank order."""
    def data_iter(data_cfg, batch_size, model_cfg, *args):
        parts = [rank_rows(real, r)(data_cfg, batch_size // world, model_cfg)
                 for r in range(world)]
        for rows in zip(*parts):
            yield {k: np.concatenate([np.asarray(r[k]) for r in rows])
                   for k in rows[0]}

    return data_iter


def digests(state) -> dict:
    """sha1 of every tensor a train state holds: the model's (and the
    discriminator's) state_dict and the codebook's reservoir."""
    import hashlib

    tensors = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    if getattr(state, "disc", None) is not None:
        tensors.update({f"disc.{k}": v
                        for k, v in state.disc.state_dict().items()})
    if hasattr(state, "vq_state"):
        tensors["reservoir"] = state.vq_state.reservoir
    return {k: hashlib.sha1(v.detach().contiguous().cpu().numpy()
                            .tobytes()).hexdigest()
            for k, v in tensors.items()}


def step_record(metrics: dict, clock: dict) -> dict:
    """One micro-step's scalars, the host time after a synchronize and the
    host time spent in collectives so far."""
    torch.cuda.synchronize()
    rec = {k: float(v) for k, v in metrics.items()
           if isinstance(v, (bool, int, float))
           or (torch.is_tensor(v) and v.numel() == 1)}
    return dict(rec, t=time.perf_counter(), coll_ms=clock["ms"])


def timed_collectives(clock: dict) -> None:
    """Count the host time of every ``all_reduce`` and ``broadcast`` (both
    ends synchronized) into ``clock["ms"]``."""
    import torch.distributed as dist

    for name in ("all_reduce", "broadcast"):
        real = getattr(dist, name)

        def timed(*args, _real=real, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _real(*args, **kwargs)
            torch.cuda.synchronize()
            clock["ms"] += 1e3 * (time.perf_counter() - t0)
            return out

        setattr(dist, name, timed)


def rank_worker(spec_path: str) -> int:
    """One rank of phase 15, started with a launcher's environment: run
    each config of the spec through ``mas_tpu_torch.cli.main`` (its data
    as ``rank_rows``, or ``global_rows`` where the spec says so), then
    write the launch counts, the per-step records, the final state's
    digests, this rank's checkpoint writes, the backend and, for seg,
    whether a resume from the checkpoint restores the state bitwise."""
    import torch.distributed as dist

    from mas_tpu_torch import cli
    from mas_tpu_torch.train import loop
    from mas_tpu_torch.utils.config import TrainConfig, VQModelConfig

    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = int(os.environ["RANK"])
    real_iter = cli.data_iter
    cli.data_iter = (global_rows(real_iter, spec["rows_of"])
                     if spec.get("rows_of") else rank_rows(real_iter, rank))
    writes = []
    real_save = loop.save_checkpoint

    def save(directory, state):
        writes.append(state.step)
        return real_save(directory, state)

    loop.save_checkpoint = save
    clock = {"ms": 0.0}
    timed_collectives(clock)
    results = {}
    for name, config in spec["configs"].items():
        record, last = [], {}

        def on_step(step_no, state, metrics):
            record.append(step_record(metrics, clock))
            last["state"] = state

        del writes[:]
        reset_counts()
        rc = cli.main(["--config", config, "--device", spec["device"]],
                      on_step)
        counts = read_counts()
        state = last.pop("state")
        res = dict(rc=rc, counts=counts, record=record,
                   digests=digests(state), writes=list(writes),
                   backend=dist.get_backend(), world=dist.get_world_size(),
                   n_gns=count_gns(state.model))
        if name == "seg":
            with open(config) as f:
                raw = json.load(f)
            again = loop.build_seg_state(
                TrainConfig.from_dict(dict(raw["train"], resume=True)),
                VQModelConfig.from_dict(raw["model"]), spec["device"])
            res["resumed_bitwise"] = digests(again) == res["digests"]
            del again
        results[name] = res
        del state, last
        gc.collect()
        torch.cuda.empty_cache()
    with open(spec["out"].format(rank=rank), "w") as f:
        json.dump(results, f)
    return 0


def launch_ranks(world: int, configs: dict, tmp: str, what: str,
                 rows_of: int = 0, timeout: float = 600,
                 worker: str = "--rank-worker") -> list:
    """Start ``world`` processes of ``rank_worker`` (or of the ``worker``
    mode of this script) with a launcher's environment (localhost
    rendezvous, ``LOCAL_WORLD_SIZE`` = world, one card), wait for them,
    and return each rank's results."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    spec = os.path.join(tmp, f"{what}.json")
    with open(spec, "w") as f:
        json.dump({"configs": configs, "rows_of": rows_of,
                   "device": DEVICE,
                   "out": os.path.join(tmp, what + "_rank{rank}.json")}, f)
    procs, logs = [], []
    for r in range(world):
        env = dict(os.environ, WORLD_SIZE=str(world), RANK=str(r),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
        logs.append(open(os.path.join(tmp, f"{what}_rank{r}.log"), "w+"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
             worker, spec], env=env, cwd=tmp, stdout=logs[-1],
            stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = []
    for r, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        if p.returncode != 0:
            failed.append(f"rank {r} exit {p.returncode}:\n{text[-4000:]}")
    require(not failed, f"{what}: " + "\n".join(failed))
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"{what}_rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def reference_run(config: str, world: int, cwd: str) -> tuple:
    """One process on the global batch of ``world`` ranks (``global_rows``)
    through ``run_cli``: (per-step records, final state, launch counts)."""
    from mas_tpu_torch import cli

    record, last, clock = [], {}, {"ms": 0.0}

    def on_step(step_no, state, metrics):
        record.append(step_record(metrics, clock))
        last["state"] = state

    reset_counts()
    with mock.patch.object(cli, "data_iter",
                           global_rows(cli.data_iter, world)):
        run_cli(config, cwd, on_step)
    return record, last["state"], read_counts()


def step_ms(record: list) -> tuple:
    """(median host ms of a micro-step after the first, the collectives'
    share of those steps' host time)."""
    steps = list(zip(record, record[1:]))
    ms = [1e3 * (b["t"] - a["t"]) for a, b in steps]
    coll = sum(b["coll_ms"] - a["coll_ms"] for a, b in steps)
    return statistics.median(ms), coll / max(sum(ms), 1e-9)


def rel_close(a: float, b: float, rel: float) -> bool:
    return abs(a - b) <= rel * max(abs(a), abs(b), 1e-6)


def params_close(got: dict, want: dict, bound: float, rel: float,
                 what: str, median: bool = True) -> float:
    """State dicts of two runs: every parameter within ``bound`` (what the
    Adam updates between the runs could move one apart; a gradient that
    is zero up to rounding, as a conv bias's ahead of a normalization,
    takes either sign) and, with ``median`` (fp32 runs; in bf16 a small
    gradient's sign is the rounding's), the median difference over all of
    them below a hundredth of it; running statistics within ``rel`` of the
    largest
    magnitude of their tensor (a running mean near 0 of bf16 activations
    moves by the activations' rounding, not by its own).  Returns the
    largest parameter difference."""
    diffs = []
    for k, v in want.items():
        if not v.is_floating_point():
            continue
        a, b = got[k].float().cpu(), v.float().cpu()
        if "running" in k:
            scale = float(b.abs().max())
            require(max_err(a, b) <= rel * scale, f"{what}: {k} differs "
                    f"by {max_err(a, b):.3g} (scale {scale:.3g})")
            continue
        d = (a - b).abs().reshape(-1)
        require(float(d.max()) <= bound, f"{what}: {k} differs by "
                f"{float(d.max()):.3g}, bound {bound:.3g}")
        diffs.append(d)
    d = torch.cat(diffs)
    require(not median or float(d.median()) <= bound / 100,
            f"{what}: median difference {float(d.median()):.3g}, bound "
            f"{bound / 100:.3g}")
    return float(d.max())


def mps_state() -> str:
    """Whether an MPS control daemon serves this machine, and the card's
    compute mode."""
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    pipe = os.environ.get("CUDA_MPS_PIPE_DIRECTORY", "/tmp/nvidia-mps")
    mps = os.path.exists(os.path.join(pipe, "control"))
    return f"MPS {'found' if mps else 'not found'}, compute mode {mode}"


def phase_parallel(smi: str, tmp: str) -> dict:
    """Phase 15: data-parallel training through the CLI in ranks started
    with a launcher's environment (``parallel.distributed.initialize``
    under test).  seg_256, img_512 and transformer_512 at full width on 2
    gloo ranks sharing the card, each against one process on the same
    global batch; then a world of one over NCCL against that one process,
    bitwise.  Returns the launch counts summed over its runs."""
    from mas_tpu_torch.utils.checkpoint import checkpoint_path

    t_phase = time.perf_counter()
    print(f"phase 15: {mps_state()}")
    os.makedirs(tmp)
    gc.collect()
    torch.cuda.empty_cache()
    paths = {w: {name: write_config(tmp, f"{name}_w{w}.json", raw)
                 for name, raw in parallel_raws(tmp, w).items()}
             for w in (1, PAR_WORLD)}
    nccl = parallel_raws(os.path.join(tmp, "nccl"), 1)["transformer"]
    nccl_path = write_config(tmp, "transformer_nccl.json", nccl)
    ranks = launch_ranks(PAR_WORLD, paths[PAR_WORLD], tmp, "ranks")
    total = {}
    for r in ranks:
        for res in r.values():
            total = {k: total.get(k, 0) + v for k, v in res["counts"].items()}
    refs = {}
    for name in ("seg", "img", "transformer"):
        record, state, counts = reference_run(paths[1][name], PAR_WORLD, tmp)
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        refs[name] = dict(record=record, digests=digests(state),
                          state={k: v.detach().cpu() for k, v in
                                 state.model.state_dict().items()},
                          reservoir=(state.vq_state.reservoir.cpu()
                                     if hasattr(state, "vq_state") else None),
                          disc=({k: v.detach().cpu() for k, v in
                                 state.disc.state_dict().items()}
                                if getattr(state, "disc", None) is not None
                                else None),
                          lr=state.opt.lr,
                          disc_lr=getattr(getattr(state, "disc_opt", None),
                                          "lr", None))
        del state
        gc.collect()
        torch.cuda.empty_cache()
    for name in ("seg", "img", "transformer"):
        r0, r1 = (r[name] for r in ranks)
        ref = refs[name]
        steps = PAR_STEPS[name]
        for r, res in enumerate((r0, r1)):
            require(res["rc"] == 0 and res["backend"] == "gloo"
                    and res["world"] == PAR_WORLD,
                    f"{name} rank {r}: {res['backend']} x {res['world']}")
            require(len(res["record"]) == steps, f"{name}: steps")
        require(r0["writes"] == [steps] and r1["writes"] == [],
                f"{name}: checkpoint writes {r0['writes']} / "
                f"{r1['writes']}: rank 0 alone writes")
        require(r0["digests"] == r1["digests"],
                f"{name}: the ranks' states differ at " + str(
                    [k for k in r0["digests"]
                     if r0["digests"][k] != r1["digests"][k]][:4]))
        require(r0["record"] == [dict(x, t=y["t"], coll_ms=y["coll_ms"])
                                 for x, y in zip(r1["record"],
                                                 r0["record"])],
                f"{name}: the ranks logged other metrics")
        with open(paths[PAR_WORLD][name]) as f:
            ck_dir = json.load(f)["train"]["checkpoint_dir"]
        saved = torch.load(checkpoint_path(ck_dir, steps),
                           map_location="cpu", weights_only=True)
        # an Adam update moves a parameter by at most 2 lr with these
        # betas (|m^| / sqrt(v^) < 2), so two runs drift apart by at most
        # 4 lr an update
        updates = 5 if name == "seg" else 1 if name == "img" else steps
        bound = 4 * updates * ref["lr"] + 1e-7
        rel = 1e-3 if name == "seg" else 1e-2
        worst = params_close(saved["model"], ref["state"], bound, rel,
                             f"{name} state, 2 ranks vs one process",
                             median=name == "seg")
        # the GAN total carries d_weight ~15-fold (phase 11): compare it
        # at the one process's d_weight, d_weight itself within 10%
        keys = ("total", "nll_loss", "g_loss", "face_loss", "q_loss",
                "d_loss") if name == "img" else ("loss", "q_loss")
        for i, (a, b) in enumerate(zip(r0["record"], ref["record"])):
            if name == "img":
                for m in (a, b):
                    m["total"] = m["loss"] + (b["d_weight"] - m["d_weight"]) \
                        * m["disc_factor"] * m["g_loss"]
                require(rel_close(a["d_weight"], b["d_weight"], 0.1),
                        f"img step {i + 1} d_weight {a['d_weight']} vs "
                        f"{b['d_weight']}")
            for k in keys:
                if k in b:
                    require(rel_close(a[k], b[k], rel),
                            f"{name} step {i + 1} {k}: {a[k]} vs {b[k]}")
        if name == "seg":
            fired = [i + 1 for i, rec in enumerate(r0["record"])
                     if rec["kmeans_triggered"]]
            require(fired == [12, 14], f"seg k-means at {fired}")
            require(r0["resumed_bitwise"] and r1["resumed_bitwise"],
                    "seg: a resume from rank 0's checkpoint is not bitwise "
                    "on both ranks")
            res_d = (saved["codebook"]["reservoir"] - ref["reservoir"]).abs()
            scale = float(ref["reservoir"].abs().max())
            require(float(res_d.max()) <= 1e-3 * scale,
                    f"seg reservoir differs by {float(res_d.max()):.3g} "
                    f"(scale {scale:.3g})")
            n = r0["n_gns"]
            for kid, floor in (("B4", n * steps), ("B8", n * steps),
                               ("B5", 4)):
                require(r0["counts"][kid] >= floor,
                        f"seg rank 0: {kid} {r0['counts'][kid]} < {floor}")
        if name == "img":
            require(all(rec["face_loss"] > 0 for rec in ref["record"]),
                    "img: no face term")
            worst = max(worst, params_close(
                saved["disc"], ref["disc"], 4 * ref["disc_lr"] + 1e-7, rel,
                "img discriminator, 2 ranks vs one process", median=False))
            n = r0["n_gns"]
            for kid in ("B4", "B8"):
                require(r0["counts"][kid] >= n * steps,
                        f"img rank 0: {kid} {r0['counts'][kid]}")
        if name == "transformer":
            for r, res in enumerate((r0, r1)):
                n = PAR_TRANSFORMER_LAYERS * steps
                exact_counts(res["counts"], dict(B1=n, B6=n),
                             f"transformer rank {r}")
        rank_ms, share = step_ms(r0["record"])
        one_ms, _ = step_ms(ref["record"])
        print(f"phase 15 {name}: 2 ranks (gloo, one card) step median "
              f"{rank_ms:.1f} ms, collectives {100 * share:.1f}% of it; one "
              f"process on the global batch {one_ms:.1f} ms; params max "
              f"|d| {worst:.3g} [{smi}]")
    # a world of one over NCCL: the same global batch as the transformer's
    # one process above, so the two must agree bit for bit
    one = launch_ranks(1, {"transformer": nccl_path}, tmp, "world1",
                       rows_of=PAR_WORLD)[0]["transformer"]
    total = {k: total.get(k, 0) + v for k, v in one["counts"].items()}
    ref = refs["transformer"]
    require(one["backend"] == "nccl" and one["world"] == 1,
            f"world of one: {one['backend']} x {one['world']}")
    require([rec["loss"] for rec in one["record"]]
            == [rec["loss"] for rec in ref["record"]],
            "world of one: losses differ from one process")
    differ = [k for k in ref["digests"]
              if one["digests"][k] != ref["digests"][k]]
    require(not differ, f"world of one: not bitwise at {differ[:4]}")
    one_ms, share = step_ms(one["record"])
    print(f"phase 15 transformer, world of one ({one['backend']}): step "
          f"median {one_ms:.1f} ms, collectives {100 * share:.1f}%; bitwise "
          f"equal to one process [{smi}]")
    for path in list(paths[1].values()) + list(paths[PAR_WORLD].values()) \
            + [nccl_path]:
        with open(path) as f:
            shutil.rmtree(json.load(f)["train"]["checkpoint_dir"],
                          ignore_errors=True)
    print(f"phase 15 (data parallel) took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return total


# --- phase 16: tensor parallelism at full width ----------------------------

TP_MODEL = 2
TP_STEPS = 2
TP_SEED = 16           # the serving weights' generator, in ranks and parent
TP_FORCED = 16         # teacher-forced decode steps


def tp_train_raw(tmp: str, model: int) -> dict:
    """configs/transformer_512.json as shipped, ``TP_STEPS`` steps on a 1 x
    ``model`` mesh, checkpoints under ``tmp``."""
    with open(TRANSFORMER_CONFIG) as f:
        raw = json.load(f)
    raw["train"] = dict(raw["train"], total_steps=TP_STEPS,
                        mesh={"model": model},
                        checkpoint_dir=os.path.join(tmp, f"ck_m{model}"))
    return raw


def tp_pipeline(raw: dict, shard=(0, 1)):
    """Phase 4's serving pipeline from ``TP_SEED`` (``load_pipeline``),
    the transformer as model rank ``shard`` of the seeded whole."""
    from mas_tpu_torch.models.transformer import MakeAScene

    gen = torch.Generator(device="cuda").manual_seed(TP_SEED)
    transformer, vq, text, seg = load_pipeline(raw, gen)
    if shard[1] > 1:
        with torch.device(text.device):
            transformer = MakeAScene.sharded(
                transformer.cfg, transformer.state_dict(), shard).eval()
    return transformer, vq, text, seg


def tp_forced_logits(transformer, text, seg) -> torch.Tensor:
    """Prefill + ``TP_FORCED`` decode steps over forced tokens drawn on the
    CPU from a seed, with guidance's doubled batch: the full-vocabulary
    logits [2B, TP_FORCED + 1, V] (gathered over the model group on a
    rank)."""
    from mas_tpu_torch.parallel.collectives import gather_vocab

    full = ((lambda x: gather_vocab(x)) if transformer.shard[1] > 1
            else (lambda x: x))
    text2 = torch.cat([text, torch.zeros_like(text)])
    seg2 = torch.cat([seg, seg])
    forced = torch.randint(0, transformer.cfg.image_vocab_size,
                           (text2.shape[0], TP_FORCED),
                           generator=torch.Generator().manual_seed(7)
                           ).to(text.device)
    with torch.inference_mode():
        logits, kvs = transformer.prefill(text2, seg2)
        caches = transformer.allocate_caches(kvs, text2.shape[0])
        out = [full(logits)]
        for step in range(TP_FORCED):
            out.append(full(transformer.decode_step(
                forced[:, step:step + 1], step, caches)))
    return torch.stack(out, dim=1)


def tp_serve(raw: dict, clock: dict, logits_path: str) -> dict:
    """Phase 16's serving in one rank: teacher-forced logits (saved to
    ``logits_path``), then ``sample_images`` at batch 4 with its launch
    counts, tokens, seconds and the collectives' milliseconds in them."""
    from mas_tpu_torch.models import sampler
    from mas_tpu_torch.parallel.distributed import model_shard

    transformer, vq, text, seg = tp_pipeline(raw, model_shard())
    torch.save(tp_forced_logits(transformer, text, seg).cpu(), logits_path)
    tokens = {}
    real = sampler.sample_tokens

    def capture(*args, **kwargs):
        tokens["t"] = real(*args, **kwargs)
        return tokens["t"]

    reset_counts()
    c0 = clock["ms"]
    with mock.patch.object(sampler, "sample_tokens", capture):
        imgs, secs = run_slice(raw, transformer, vq, text, seg, seed=1)
    out = dict(counts=read_counts(), secs=secs, coll_ms=clock["ms"] - c0)
    out["n_gns"] = count_gns(vq.decoder)
    out["tokens"] = tokens["t"].cpu().tolist()
    out["images"] = (None if imgs is None else
                     [list(imgs.shape), bool(torch.isfinite(imgs).all())])
    return out


def first_adam_step(into: dict):
    """A patch of ``Adam.step`` that keeps, on the CPU, the gradients of
    its first call (before the update) in ``into["grads"]`` and the
    parameters they were taken at in ``into["params"]``."""
    from mas_tpu_torch.train.state import Adam

    real = Adam.step

    def step(self, grads):
        grads = list(grads)
        if not into:
            into["grads"] = {k: g.detach().to("cpu", copy=True)
                             for k, g in zip(self.params, grads)}
            into["params"] = {k: p.detach().to("cpu", copy=True)
                              for k, p in self.params.items()}
        return real(self, grads)

    return mock.patch.object(Adam, "step", step)


def tp_worker(spec_path: str) -> int:
    """One rank of phase 16, started with a launcher's environment:
    ``TP_STEPS`` training steps through ``mas_tpu_torch.cli.main`` (rows
    as the CLI reads them: the ranks of one data index alike), then
    ``tp_serve``; writes the launch counts, per-step records, digests of
    the replicated parameters, checkpoint writes, grid and backend, and
    (rank 0) the first step's gradients gathered into the full tree."""
    import torch.distributed as dist

    from mas_tpu_torch import cli
    from mas_tpu_torch.parallel.collectives import model_parts
    from mas_tpu_torch.parallel.distributed import grid
    from mas_tpu_torch.parallel.sharding import gather_state, split_dim
    from mas_tpu_torch.train import loop

    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = int(os.environ["RANK"])
    writes = []
    real_save = loop.save_checkpoint

    def save(directory, state):
        writes.append(state.step)
        return real_save(directory, state)

    loop.save_checkpoint = save
    clock = {"ms": 0.0}
    timed_collectives(clock)
    record, last = [], {}

    def on_step(step_no, state, metrics):
        record.append(step_record(metrics, clock))
        last["state"] = state

    first = {}
    reset_counts()
    with first_adam_step(first):
        rc = cli.main(["--config", spec["configs"]["train"], "--device",
                       spec["device"]], on_step)
    counts = read_counts()
    state = last.pop("state")
    grads = first["grads"]
    grads = gather_state(model_parts(
        grads, [k for k in grads if split_dim(k) is not None]),
        state.model.cfg)
    if rank == 0:
        torch.save(grads, spec["out"].format(rank=rank) + ".grads.pt")
    del first, grads
    g = grid()
    res = dict(rc=rc, counts=counts, record=record, writes=list(writes),
               replicated={k: v for k, v in digests(state).items()
                           if split_dim(k[len("model."):]) is None},
               backend=dist.get_backend(), world=dist.get_world_size(),
               grid=[g.data, g.model, g.data_index, g.model_index])
    del state, last
    gc.collect()
    torch.cuda.empty_cache()
    with open(spec["configs"]["serve"]) as f:
        raw = json.load(f)
    res["serve"] = tp_serve(raw, clock, spec["out"].format(rank=rank)
                            + ".logits.pt")
    with open(spec["out"].format(rank=rank), "w") as f:
        json.dump(res, f)
    return 0


TP_GRAD_REL = 0.1      # step 1's gradients, ||g_tp - g|| / ||g|| a tensor
TP_UPDATE_COS = 0.9    # cosine of the 2 steps' updates, a sharded matrix


def tp_update_checks(grads: dict, first: dict, saved: dict,
                     ref: dict) -> tuple:
    """Phase 16's training against one process, tensor by tensor: step 1's
    gradients gathered from the ranks (``grads``) against the one
    process's (``first``), ||g_tp - g|| <= TP_GRAD_REL ||g|| (the bound
    of the kernels-vs-twins gradients: both sides run bf16 products that
    round and sum in another order); and, for every sharded weight
    matrix, the update the 2 steps made (rank 0's checkpoint ``saved``
    less the seeded start) against the one process's (``ref`` less the
    start), cosine >= TP_UPDATE_COS.  Biases are held by their gradients
    alone: the key bias's is zero up to rounding (softmax ignores a shift
    shared by every key), so Adam moves it by lr in the rounding's sign.
    A rank that applied no update, or another gradient, fails.  Returns
    (worst gradient ratio, worst cosine)."""
    from mas_tpu_torch.parallel.sharding import split_dim

    g_one, start = first["grads"], first["params"]
    require(set(grads) == set(g_one), "tp: the gathered gradients' keys")
    g_worst, c_worst, bad = 0.0, 1.0, []
    for k, g in g_one.items():
        g = g.to(DEVICE)
        r = float((grads[k].to(DEVICE) - g).norm()) / max(float(g.norm()),
                                                          1e-30)
        g_worst = max(g_worst, r)
        if r > TP_GRAD_REL:
            bad.append(f"gradient {k}: {r:.3e}")
        if split_dim(k) is None or g.dim() < 2:
            continue
        p0 = start[k].to(DEVICE)
        a = (saved[k].to(DEVICE) - p0).reshape(-1)
        b = (ref[k].to(DEVICE) - p0).reshape(-1)
        c = float(a @ b) / max(float(a.norm() * b.norm()), 1e-30)
        c_worst = min(c_worst, c)
        if c < TP_UPDATE_COS:
            bad.append(f"update {k}: cosine {c:.4f}")
    require(not bad, "tp vs one process: " + "; ".join(bad[:8]))
    return g_worst, c_worst


def phase_tensor_parallel(smi: str, tmp: str) -> dict:
    """Phase 16: tensor parallelism at model 2 on 2 gloo ranks sharing the
    card, transformer_512 training and sample_256 serving, each against
    one process.  Returns the launch counts summed over its runs."""
    from mas_tpu_torch.models.transformer import MakeAScene
    from mas_tpu_torch.utils.checkpoint import checkpoint_path
    from mas_tpu_torch.utils.config import TransformerConfig

    t_phase = time.perf_counter()
    os.makedirs(tmp)
    gc.collect()
    torch.cuda.empty_cache()
    train = {m: write_config(tmp, f"tp_train_m{m}.json", tp_train_raw(tmp, m))
             for m in (1, TP_MODEL)}
    ranks = launch_ranks(TP_MODEL, {"train": train[TP_MODEL],
                                    "serve": CONFIG}, tmp, "tp",
                         worker="--tp-worker")
    total = {}
    for r in ranks:
        for counts in (r["counts"], r["serve"]["counts"]):
            total = {k: total.get(k, 0) + v for k, v in counts.items()}
    r0, r1 = ranks
    # training: the ranks against each other and one process on their rows
    for r, res in enumerate(ranks):
        require(res["rc"] == 0 and res["backend"] == "gloo"
                and res["world"] == TP_MODEL
                and res["grid"] == [1, TP_MODEL, 0, r],
                f"tp rank {r}: {res['backend']} x {res['world']}, grid "
                f"{res['grid']}")
        require(len(res["record"]) == TP_STEPS, f"tp rank {r}: steps")
        exact_counts(res["counts"], dict(B1=24 * TP_STEPS, B6=24 * TP_STEPS),
                     f"tp transformer rank {r}")
    require(r0["writes"] == [TP_STEPS] and r1["writes"] == [],
            f"tp: checkpoint writes {r0['writes']} / {r1['writes']}")
    require(r0["replicated"] == r1["replicated"],
            "tp: the replicated parameters differ between the ranks at " +
            str([k for k in r0["replicated"]
                 if r0["replicated"][k] != r1["replicated"][k]][:4]))
    require([x["loss"] for x in r0["record"]]
            == [x["loss"] for x in r1["record"]], "tp: the ranks' losses")
    record, last = [], {}

    def on_step(step_no, state, metrics):
        record.append(step_record(metrics, {"ms": 0.0}))
        last["state"] = state

    first = {}
    reset_counts()
    with first_adam_step(first):
        run_cli(train[1], tmp, on_step)
    total = {k: total.get(k, 0) + v for k, v in read_counts().items()}
    state = last.pop("state")
    ref = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    lr = state.opt.lr
    del state
    gc.collect()
    torch.cuda.empty_cache()
    for i, (a, b) in enumerate(zip(r0["record"], record)):
        require(rel_close(a["loss"], b["loss"], 1e-2),
                f"tp step {i + 1} loss {a['loss']} vs one process "
                f"{b['loss']}")
    with open(train[TP_MODEL]) as f:
        ck_dir = json.load(f)["train"]["checkpoint_dir"]
    saved = torch.load(checkpoint_path(ck_dir, TP_STEPS), map_location="cpu",
                       weights_only=True)["model"]
    worst = params_close(saved, ref, 4 * TP_STEPS * lr + 1e-7, 1e-2,
                         "tp: rank 0's checkpoint vs one process",
                         median=False)
    grads = torch.load(os.path.join(tmp, "tp_rank0.json.grads.pt"),
                       map_location="cpu", weights_only=True)
    g_worst, c_worst = tp_update_checks(grads, first, saved, ref)
    del grads, first
    with open(TRANSFORMER_CONFIG) as f:
        tcfg = TransformerConfig.from_dict(json.load(f)["transformer"])
    with torch.device(DEVICE):
        MakeAScene(tcfg, fp32_params=True).load_state_dict(saved,
                                                           strict=True)
    del saved, ref
    rank_ms, share = step_ms(r0["record"])
    one_ms, _ = step_ms(record)
    print(f"phase 16 transformer_512, 1 x {TP_MODEL} (gloo, one card): step "
          f"median {rank_ms:.1f} ms, collectives {100 * share:.1f}% of it; "
          f"one process {one_ms:.1f} ms; losses {[x['loss'] for x in r0['record']]}"
          f" vs {[x['loss'] for x in record]}; params max |d| {worst:.3g}; "
          f"step 1 gradients worst ||d|| / ||g|| {g_worst:.3e}, updates "
          f"worst cosine {c_worst:.6f}; rank 0's checkpoint loads into one "
          f"process [{smi}]")
    # serving: tokens, counts and images per rank; logits against one
    # process
    with open(CONFIG) as f:
        raw = json.load(f)
    tcfg = TransformerConfig.from_dict(raw["transformer"])
    steps = tcfg.image_length - 1
    s0, s1 = r0["serve"], r1["serve"]
    require(s0["tokens"] == s1["tokens"], "tp: the ranks sampled other "
            "tokens")
    for r, srv in enumerate((s0, s1)):
        # model rank 0 alone decodes the images (B4)
        exact_counts(srv["counts"],
                     dict(B1=tcfg.num_layers, B2=tcfg.num_layers * steps,
                          B3=tcfg.num_layers * steps,
                          B4=srv["n_gns"] if r == 0 else 0),
                     f"tp serving rank {r}")
    require(s0["images"] == [[4, 256, 256, 3], True] and s1["images"] is None,
            f"tp images {s0['images']} / {s1['images']}")
    got = [torch.load(os.path.join(tmp, f"tp_rank{r}.json.logits.pt"))
           for r in range(TP_MODEL)]
    require(torch.equal(got[0], got[1]), "tp: the ranks' gathered logits "
            "differ")
    transformer, vq, text, seg = tp_pipeline(raw)
    want = tp_forced_logits(transformer, text, seg).cpu()
    reset_counts()
    imgs, one_secs = run_slice(raw, transformer, vq, text, seg, seed=1)
    total = {k: total.get(k, 0) + v for k, v in read_counts().items()}
    del transformer, vq, imgs
    gc.collect()
    torch.cuda.empty_cache()
    diff = (got[0] - want).abs()
    scale = float(want.abs().max())
    margin = 4 * 2.0 ** (math.floor(math.log2(scale)) - 7)
    best = want.topk(2, dim=-1).values
    decided = (best[..., 0] - best[..., 1]) > margin
    same = (got[0].argmax(-1) == want.argmax(-1))[decided]
    top1 = float(same.float().mean()) if same.numel() else 0.0
    print(f"phase 16 sample_256 teacher-forced ({TP_FORCED} steps, 8 rows), "
          f"2 ranks vs one process: max |d| {float(diff.max()):.4e}, max "
          f"|logit| {scale:.4e}, top-1 agreement {top1:.4f} over the "
          f"{same.numel()} of {decided.numel()} positions decided by > 4 "
          "bf16 ulps")
    require(same.numel() > 0, "tp teacher-forced: some position is decided")
    require(float(diff.max()) <= 0.1 * scale, "tp teacher-forced logits")
    require(top1 >= 0.9, "tp teacher-forced top-1 agreement >= 90%")
    print(f"phase 16 sample_256 batch 4, rank 0: {s0['secs']:.3f} s a batch, "
          f"collectives {100 * s0['coll_ms'] / 1e3 / s0['secs']:.1f}% of it "
          f"(rank 1 {s1['secs']:.3f} s); one process {one_secs:.3f} s "
          f"[{smi}]")
    shutil.rmtree(ck_dir, ignore_errors=True)
    with open(train[1]) as f:
        shutil.rmtree(json.load(f)["train"]["checkpoint_dir"],
                      ignore_errors=True)
    print(f"phase 16 (tensor parallel) took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return total


def main(argv) -> int:
    modes = {"--decode-times": decode_times, "--norm-times": norm_times,
             "--vq-times": vq_times, "--vq-paths": vq_paths,
             "--mha-outputs": mha_outputs}
    if argv[:1] == ["--rank-worker"]:
        # one rank of phase 15, started by launch_ranks
        return rank_worker(argv[1])
    if argv[:1] == ["--tp-worker"]:
        # one rank of phase 16, started by launch_ranks
        return tp_worker(argv[1])
    if argv[:1] and argv[0] in modes:
        # the decode reads and writes, B4, B7 and B8, B5, or the paths of
        # B4 and B5, of the mas_tpu_torch under argv[1] alone
        sys.path.insert(0, os.path.abspath(argv[1]))
        smi = phase_device()
        print(json.dumps({"tree": argv[1], "card": smi,
                          argv[0][2:].replace("-", "_"): modes[argv[0]]()}))
        return 0
    smi = phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = phase_kernels(gen)
    with tempfile.TemporaryDirectory() as tmp:
        seg_tmp = os.path.join(tmp, "seg")
        paths = [phase_slice(gen), phase_train(smi, seg_tmp),
                 phase_tokenize(gen, smi)]
        counts, checkpoint = phase_train_transformer(smi, tmp)
        paths += [counts, phase_serve_512(gen, smi, checkpoint)]
        paths += [phase_packed(gen, smi), phase_ln_producer(gen, smi)]
        img_tmp = os.path.join(tmp, "img")
        os.makedirs(img_tmp)
        paths.append(phase_train_image(smi, img_tmp))
        paths.append(phase_eval_show_export(
            gen, smi, seg_training_configs(seg_tmp)[0].checkpoint_dir,
            os.path.dirname(checkpoint), tmp))
        paths.append(phase_data(
            smi, os.path.join(tmp, "data"),
            img_training_configs(img_tmp)[0].checkpoint_dir))
        paths.append(phase_variants(gen, smi, os.path.join(tmp, "variants")))
        paths.append(phase_parallel(smi, os.path.join(tmp, "parallel")))
        paths.append(phase_tensor_parallel(smi, os.path.join(tmp, "tp")))
    for row in rows:
        row["launches"] = sum(counts[row["id"]] for counts in paths)
        require(row["launches"] > 0, f"{row['id']} launched on no path")
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
