// Prefix-bidirectional causal attention backward (kernel B6).
//
// Replaces: mas_tpu/ops/attention.py::_bwd_dkv_kernel and _bwd_dq_kernel
// (launched by _flash_bwd), the Pallas flash-attention backward of the
// transformer train step.
//
// Computes, from q, k, v, out, dout [B, H, T, D] (bf16 or fp32, D = 64,
// 128, 256 or a multiple of 256: the wrapper zero-pads any head dim d up to
// one of them and passes scale = 1/sqrt(d) of the true d; any T) and the
// forward's lse [B, H, T] (fp32, kernel B1):
//   P  = exp(q k^T scale - lse), masked: row i sees keys [0, bound) with
//        bound = prefix for i < prefix, else i + 1
//   dV = P^T dO     dP = dO V^T     delta = rowsum(dO * O)
//   dS = P * (dP - delta)    dQ = dS K scale    dK = dS^T Q scale
// and writes dQ, dK, dV in q's dtype into one [B, T, 3, H, D] buffer, the
// layout of the fused qkv projection's output, so its gradient needs no
// concatenation.
//
// What bounds it on the H100: at the training shape (T = 1408, prefix 384)
// the work is O(T^2 d) multiply-adds per (b, h) against O(T d) bytes, so it
// is compute bound; only the tensor cores come near the bound.
//
// Three launches, so no block needs atomics and the result does not depend
// on launch order:
//   1. delta: one warp per row, delta = rowsum(dO * O) in fp32, computed once
//      and read by both kernels (not once per (q-tile, k-tile) pair);
//   2. dK/dV: one block per (b*h, 64-key tile), looping over the q-tiles that
//      can see the tile (from the first tile when the keys meet the prefix,
//      else from the causal start, mas_tpu/ops/attention.py:391-400);
//   3. dQ: one block per (b*h, 64-row q tile), looping over the k-tiles up to
//      max(causal bound, prefix bound) (mas_tpu/ops/attention.py:435-441),
//      as B1 does.
// The split recomputes S and dP in the dQ kernel: 7 tile products per
// visible (q tile, k tile) pair where a single kernel with atomic dQ sums
// (FlashAttention-2) has 5, i.e. 40% more tensor-core work for
// deterministic gradients without atomics.
//
// bf16 (flash_bwd_dkv_kernel_bf16, flash_bwd_dq_kernel_bf16): every product
// runs on the tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate,
// fragments and swizzle of flash_mma.cuh), four warps per block, 16 keys
// (dK/dV) or 16 q rows (dQ) per warp, fp32 accumulators in registers.  At
// D = 128 the accumulators alone take 128 registers a thread, so each
// 64-wide q tile (dK/dV) or key tile (dQ) is taken in two passes of 32,
// which halves the live S and dP fragments; the dK/dV kernel sweeps the q
// tiles twice, dV first, then dK (recomputing S^T), so that one
// accumulator is live at a time; and the dQ kernel reloads its Q and dO
// fragments from shared memory at each use instead of keeping them in
// registers.  Both stay below 255 registers without spills.  At D = 64:
// one pass of 64, one sweep, Q and dO fragments in registers.  At D = 256
// as at 128, and each accumulator covers 128 of the 256 columns: dK/dV
// sweeps the q tiles four times (dV's halves, then dK's), dQ the key tiles
// twice, each sweep recomputing S (and dP), so no thread holds more than
// 64 accumulator registers; 192 KB of shared memory give one block an SM.
//   dK/dV: K and V stay in shared memory; Q, dO, lse and delta tiles stream
//   through a two-stage cp.async ring.  S^T = K Q^T and dP^T = V dO^T put
//   the keys on the mma rows, so P^T = exp(S^T scale - lse) (masked) and
//   dS^T = P^T (dP^T - delta) sit in the accumulators, and dV += P^T dO,
//   dK += dS^T Q take them, rounded to bf16, as A operands straight from
//   registers; Q and dO give their B fragments by ldmatrix (for S^T, dP^T)
//   and ldmatrix.trans (for dV, dK).
//   dQ: Q and dO stay in registers as A fragments; K/V tiles stream through
//   the ring; dS is rounded to bf16 in registers for dQ += dS K (K by
//   ldmatrix.trans).
// Both round P and dS to bf16 as tensor-core operands, where the Pallas
// kernels keep them fp32 (they upcast, attention.py:361-369): a relative
// error of at most 2^-9 per operand, summed over the keys or rows as the
// kernel sums.  Results go out through shared memory as 16-byte rows.
//
// fp32 (flash_bwd_dkv_kernel, flash_bwd_dq_kernel) keeps the CUDA-core
// kernels: TF32 tensor cores would not hold the fp32 path to its tolerance,
// and no configuration trains attention in fp32.  Every tile sits in shared
// memory as fp32 rows with a stride of 68 floats, and 256 threads hold a
// 4 x 4 register tile each of every 64 x 64 product.  At D = 256 the four
// 64 x 256 tiles would not fit the 227 KB a block may have: the head dim
// is taken in two column chunks of 128, S and dP summed over the chunks
// in column order, and each chunk's tiles reloaded for the dV, dK (dQ)
// products.
//
// Above d 256 (D = 256 nc): bf16 in the *_wide kernels, each block one
// pass of 128 output columns with S and dP summed over the nc chunks of 256
// dims, staged through shared memory in turn; fp32 in the same kernels as
// D = 256, S and dP summed over all 2 nc chunks of 128 and blockIdx.z
// picking the pass of 256 columns.  Every pass recomputes S (and dP).
//
// A ragged last tile (T not a multiple of 64) is zero-filled on load, its
// lse and delta too: a padded q row then has P = 1 but dO = 0 and dP =
// delta = 0, so it adds nothing to dK or dV; padded keys are masked, and
// rows past T are never stored.
//
// Inputs are addressed by strides (last dim contiguous), so q, k, v can be
// views into the fused qkv projection; the bf16 kernels need every (b, h,
// t) stride a multiple of 8 elements and 16-byte aligned data (the wrapper
// checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "flash_mma.cuh"

namespace {

using namespace flash_mma;

constexpr int BT = 64;  // rows of a q tile, keys of a k tile

struct Strides {
  long long qb, qh, qt, kb, kh, kt, vb, vh, vt, ob, oh, ot, gb, gh, gt;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// delta[bh][i] = sum_c dO[b, h, i, c] * O[b, h, i, c]; one warp per row
constexpr int DELTA_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(DELTA_THREADS)
flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ delta, Strides st, int H,
                       int t_len, long long rows, int width) {
  const long long row =
      (long long)blockIdx.x * (DELTA_THREADS / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int i = static_cast<int>(row % t_len);
  const long long bh = row / t_len;
  const int b = static_cast<int>(bh / H), h = static_cast<int>(bh % H);
  const T* op = out + b * st.ob + h * st.oh + i * st.ot;
  const T* gp = dout + b * st.gb + h * st.gh + i * st.gt;
  float s = 0.f;
  for (int c = lane; c < width; c += 32) s += to_f(op[c]) * to_f(gp[c]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) delta[row] = s;
}

// --- bf16: tensor cores ------------------------------------------------------

constexpr int MT = 128;     // threads per block: 4 warps x 16 rows
constexpr int STAGES = 2;   // ring depth

// a dK/dV ring stage: Q tile, dO tile, lse[64], delta[64]
template <int D>
__host__ __device__ constexpr int qstage_bytes() {
  return 2 * tile_bytes<D>() + 2 * BT * 4;
}
template <int D>
__host__ __device__ constexpr int dkv_smem() {
  return 2 * tile_bytes<D>() + STAGES * qstage_bytes<D>();
}
// the dQ kernel: Q and dO tiles, then STAGES x (K tile, V tile)
template <int D>
__host__ __device__ constexpr int dq_smem() {
  return 2 * tile_bytes<D>() * (1 + STAGES);
}
// columns of a pass: the q rows (dK/dV) or keys (dQ) of a 64-wide tile
// taken at once
template <int D>
__host__ __device__ constexpr int pass_cols() { return D == 64 ? 64 : 32; }
// head-dim columns of one accumulator: all of them up to D = 128, one half
// at D = 256 (a sweep per half)
template <int D>
__host__ __device__ constexpr int acc_cols() { return D > 128 ? 128 : D; }

template <int N>
__device__ __forceinline__ void zero(float (&a)[N][4]) {
#pragma unroll
  for (int nt = 0; nt < N; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[nt][e] = 0.f;
}

// acc (16 x NN per warp) += A B^T over D dims: A fragments loaded from the
// swizzled tile `a_tile` at rows [r0, r0 + 16), B from rows [n0, n0 + NN)
// of `b_tile`, held [n][k]
template <int D, int NN>
__device__ __forceinline__ void mma_rows_nk(float (&acc)[NN / 8][4],
                                            uint32_t a_tile, int r0,
                                            uint32_t b_tile, int n0,
                                            int lane) {
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    uint32_t a[4];
    load_a<D>(a, a_tile, r0, j, lane);
#pragma unroll
    for (int np = 0; np < NN / 16; ++np) {
      uint32_t bb[4];
      load_b_nk<D>(bb, b_tile, n0 + 16 * np, j, lane);
      mma(acc[2 * np], a, bb[0], bb[1]);
      mma(acc[2 * np + 1], a, bb[2], bb[3]);
    }
  }
}

// acc (16 x 8 NA per warp: columns [col0, col0 + 8 NA) of the head dim) +=
// A B over rows [k0, k0 + NK) of `b_tile` (held [k][n]), with A the bf16
// rounding of the C fragments `c` (16 x NK)
template <int D, int NK, int NA>
__device__ __forceinline__ void mma_regs_kn(float (&acc)[NA][4],
                                            const float (&c)[NK / 8][4],
                                            uint32_t b_tile, int k0,
                                            int col0, int lane) {
#pragma unroll
  for (int j = 0; j < NK / 16; ++j) {
    uint32_t a[4];
    c_to_a(a, c[2 * j], c[2 * j + 1]);
#pragma unroll
    for (int np = 0; np < NA / 2; ++np) {
      uint32_t bb[4];
      load_b_kn<D>(bb, b_tile, col0 + 16 * np, k0 / 16 + j, lane);
      mma(acc[2 * np], a, bb[0], bb[1]);
      mma(acc[2 * np + 1], a, bb[2], bb[3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(MT, 2)
flash_bwd_dkv_kernel_bf16(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dqkv, Strides st,
                          int H, int t_len, int prefix, float scale) {
  constexpr int TB = tile_bytes<D>();
  constexpr int QS = qstage_bytes<D>();
  constexpr int QC = pass_cols<D>();
  constexpr int DA = acc_cols<D>();
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sk = smem_addr(smem), sv = sk + TB;
  const uint32_t ring = sv + TB;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * BT;  // low key tiles see the most q tiles
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int pfx = min(prefix, t_len);

  const __nv_bfloat16* qp = q + b * st.qb + h * st.qh;
  const __nv_bfloat16* gp = dout + b * st.gb + h * st.gh;
  const float* lp = lse + (long long)bh * t_len;
  const float* dp_ = delta + (long long)bh * t_len;

  // stage s <- Q, dO, lse, delta of the q tile at q0 (rows past T: zeros)
  auto load_q = [&](int s, int q0) {
    const uint32_t base = ring + s * QS;
    load_tile<MT, D>(base, qp, st.qt, q0, t_len);
    load_tile<MT, D>(base + TB, gp, st.gt, q0, t_len);
    const int i = threadIdx.x & (BT - 1);  // threads 0-63 lse, 64-127 delta
    const bool ok = q0 + i < t_len;
    cp_async4(base + 2 * TB + (threadIdx.x / BT) * BT * 4 + 4 * i,
              (threadIdx.x < BT ? lp : dp_) + (ok ? q0 + i : 0), ok);
  };

  load_tile<MT, D>(sk, k + b * st.kb + h * st.kh, st.kt, k0, t_len);
  load_tile<MT, D>(sv, v + b * st.vb + h * st.vh, st.vt, k0, t_len);
  // q-tiles that see a key of this tile: all when the keys meet the prefix,
  // else those from the tile holding row k0 on (rows i >= key)
  const int q_lo = k0 < pfx ? 0 : k0 / BT;
  const int nq = (t_len + BT - 1) / BT - q_lo;
  const int key_lo = k0 + warp * 16 + grp;  // and key_lo + 8
  const float sl2 = scale * LOG2E;

  // One sweep over the q tiles, accumulating columns [col0, col0 + DA) of
  // dV (what & 1) and / or dK (what & 2).  At D = 64 one sweep takes both.
  // At D = 128 the two 16 x 128 accumulators of a warp leave too few of
  // the 255 registers for the rest and spill: dV takes a first sweep, dK a
  // second, which recomputes S^T (one more of the four products per tile
  // pair).  At D = 256 each of the two takes two sweeps, one per half.
  // (dk, dv: float [DA / 8][4]; spelled so, the parameter types made
  // nvcc 12.9's front end, cudafe++, crash)
  auto sweep = [&](auto what, int col0, auto& dk, auto& dv) {
    constexpr int W = decltype(what)::value;
    load_q(0, q_lo * BT);
    cp_async_commit();
    for (int i = 0; i < nq; ++i) {
      const int q0 = (q_lo + i) * BT;
      if (i + 1 < nq) load_q((i + 1) % STAGES, q0 + BT);
      cp_async_commit();
      cp_async_wait<1>();  // K, V and this q tile have landed
      __syncthreads();
      const uint32_t sq = ring + (i % STAGES) * QS;
      const uint32_t sg = sq + TB;
      const float* lse_s = reinterpret_cast<const float*>(
          smem + (sq - sk) + 2 * TB);
      const float* del_s = lse_s + BT;
      const bool masked = k0 + BT > row_bound(q0, pfx);

#pragma unroll
      for (int c0 = 0; c0 < BT; c0 += QC) {
        // S^T = K Q^T and dP^T = V dO^T: 16 keys x QC q rows per warp
        float s[QC / 8][4], dpt[QC / 8][4];
        zero(s);
        mma_rows_nk<D, QC>(s, sk, warp * 16, sq, c0, lane);
        if constexpr ((W & 2) != 0) {
          zero(dpt);
          mma_rows_nk<D, QC>(dpt, sv, warp * 16, sg, c0, lane);
        }

        // P^T and dS^T in place; column (q row) c = c0 + 8 nt + 2 tig +
        // (e & 1)
#pragma unroll
        for (int nt = 0; nt < QC / 8; ++nt) {
          const int c = c0 + nt * 8 + 2 * tig;
          const float2 ls = *reinterpret_cast<const float2*>(lse_s + c);
          const float2 ds = *reinterpret_cast<const float2*>(del_s + c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float l2 = (e & 1) ? ls.y : ls.x;
            const float dl = (e & 1) ? ds.y : ds.x;
            float p = exp2f(fmaf(s[nt][e], sl2, -l2 * LOG2E));
            if (masked &&
                key_lo + 8 * (e >> 1) >= row_bound(q0 + c + (e & 1), pfx))
              p = 0.f;
            s[nt][e] = p;
            if constexpr ((W & 2) != 0) dpt[nt][e] = p * (dpt[nt][e] - dl);
          }
        }

        // dV += P^T dO, dK += dS^T Q (q unscaled: dK takes the scale at
        // the end)
        if constexpr ((W & 1) != 0)
          mma_regs_kn<D, QC>(dv, s, sg, c0, col0, lane);
        if constexpr ((W & 2) != 0)
          mma_regs_kn<D, QC>(dk, dpt, sq, c0, col0, lane);
      }
      __syncthreads();  // every warp is done with this stage
    }
  };

  // columns [col0, col0 + DA) of 64 rows of dK (which 0) or dV (which 1)
  // from the swizzled shared tile at `tile` to dqkv, 16 bytes a thread at a
  // time; rows past T are not stored
  constexpr int CPR = DA / 8;  // 16-byte chunks per row
  const long long row_stride = 3LL * H * D;
  __nv_bfloat16* base =
      dqkv + ((long long)b * t_len + k0) * row_stride + h * D;
  auto write_rows = [&](int which, const unsigned char* tile, int col0) {
    for (unsigned idx = threadIdx.x; idx < BT * CPR; idx += MT) {
      const int r = idx / CPR, c = col0 / 8 + idx % CPR;
      if (k0 + r < t_len)
        *reinterpret_cast<uint4*>(base + r * row_stride +
                                  (1 + which) * H * D + c * 8) =
            *reinterpret_cast<const uint4*>(tile + swz<D>(r, c));
    }
  };

  if constexpr (D == 64) {
    float dk[D / 8][4], dv[D / 8][4];
    zero(dk);
    zero(dv);
    sweep(std::integral_constant<int, 3>(), 0, dk, dv);
    // dK, dV rows through the (consumed) K and V tiles
    store_rows<D>(smem, dk, scale, scale, warp * 16, lane);
    store_rows<D>(smem + TB, dv, 1.f, 1.f, warp * 16, lane);
    __syncthreads();
    write_rows(0, smem, 0);
    write_rows(1, smem + TB, 0);
  } else {
    // each sweep's columns go out through the free ring before the next
    // sweep refills it: dV's (which 1), then dK's (which 0, times scale)
    float acc[DA / 8][4];
    unsigned char* stage = smem + (ring - sk);
    for (int which = 1; which >= 0; --which) {
      for (int col0 = 0; col0 < D; col0 += DA) {
        zero(acc);
        if (which)
          sweep(std::integral_constant<int, 1>(), col0, acc, acc);
        else
          sweep(std::integral_constant<int, 2>(), col0, acc, acc);
        const float mul = which ? 1.f : scale;
        store_rows<D>(stage, acc, mul, mul, warp * 16, lane, col0 / 8);
        __syncthreads();
        write_rows(which, stage, col0);
        __syncthreads();
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(MT, 2)
flash_bwd_dq_kernel_bf16(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dqkv, Strides st,
                         int H, int t_len, int prefix, float scale) {
  constexpr int TB = tile_bytes<D>();
  constexpr int NJ = D / 16;
  constexpr int KC = pass_cols<D>();
  constexpr int DA = acc_cols<D>();
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sq = smem_addr(smem), sg = sq + TB;
  const uint32_t ring = sg + TB;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BT;  // heaviest first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int pfx = min(prefix, t_len);

  const __nv_bfloat16* kp = k + b * st.kb + h * st.kh;
  const __nv_bfloat16* vp = v + b * st.vb + h * st.vh;
  auto load_kv = [&](int s, int k0) {
    const uint32_t base = ring + s * 2 * TB;
    load_tile<MT, D>(base, kp, st.kt, k0, t_len);
    load_tile<MT, D>(base + TB, vp, st.vt, k0, t_len);
  };

  load_tile<MT, D>(sq, q + b * st.qb + h * st.qh, st.qt, q0, t_len);
  load_tile<MT, D>(sg, dout + b * st.gb + h * st.gh, st.gt, q0, t_len);
  load_kv(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // Q and dO as A fragments (16 rows a warp): kept in registers at D = 64;
  // from D = 128 on they would take 64 registers more than the 255 allow,
  // so they are loaded again from the resident Q and dO tiles at each use
  constexpr bool KEEP_A = D == 64;
  uint32_t qa[KEEP_A ? NJ : 1][4], ga[KEEP_A ? NJ : 1][4];
  if constexpr (KEEP_A) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      load_a<D>(qa[j], sq, warp * 16, j, lane);
      load_a<D>(ga[j], sg, warp * 16, j, lane);
    }
  }

  // the k-tiles any row of this q tile can see
  int hi = q0 + BT;
  if (q0 < pfx) hi = max(hi, pfx);
  const int nk = (hi + BT - 1) / BT;

  const int row_lo = q0 + warp * 16 + grp;  // and row_lo + 8
  const int bnd[2] = {row_bound(row_lo, pfx), row_bound(row_lo + 8, pfx)};
  const float sl2 = scale * LOG2E;
  float lse2[2], dl[2];  // rows past T: zeros (they are not stored)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    const long long at = (long long)bh * t_len + row;
    lse2[r] = row < t_len ? lse[at] * LOG2E : 0.f;
    dl[r] = row < t_len ? delta[at] : 0.f;
  }
  const int tile_bound = row_bound(q0, pfx);

  // columns [col0, col0 + DA) of dQ * scale through the free ring, then
  // 16-byte stores
  constexpr int CPR = DA / 8;
  const long long row_stride = 3LL * H * D;
  __nv_bfloat16* base =
      dqkv + ((long long)b * t_len + q0) * row_stride + h * D;
  unsigned char* stage = smem + (ring - sq);
  float dq[DA / 8][4];

  // one sweep over the key tiles per DA columns of dQ (two at D = 256,
  // each recomputing S and dP)
  for (int col0 = 0; col0 < D; col0 += DA) {
    if (col0 > 0) {
      load_kv(0, 0);
      cp_async_commit();
    }
    zero(dq);
    for (int t = 0; t < nk; ++t) {
      const int k0 = t * BT;
      if (t + 1 < nk) load_kv((t + 1) % STAGES, k0 + BT);
      cp_async_commit();
      cp_async_wait<1>();  // this K/V tile has landed
      __syncthreads();
      const uint32_t sk = ring + (t % STAGES) * 2 * TB;
      const uint32_t sv = sk + TB;
      const bool masked = k0 + BT > tile_bound;

#pragma unroll
      for (int c0 = 0; c0 < BT; c0 += KC) {
        // S = Q K^T, dP = dO V^T: 16 q rows x KC keys per warp
        float s[KC / 8][4], dp[KC / 8][4];
        zero(s);
        zero(dp);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          uint32_t qj[4], gj[4];
          if constexpr (KEEP_A) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              qj[e] = qa[j][e];
              gj[e] = ga[j][e];
            }
          } else {
            load_a<D>(qj, sq, warp * 16, j, lane);
            load_a<D>(gj, sg, warp * 16, j, lane);
          }
#pragma unroll
          for (int np = 0; np < KC / 16; ++np) {
            uint32_t kb[4], vb[4];
            load_b_nk<D>(kb, sk, c0 + 16 * np, j, lane);
            mma(s[2 * np], qj, kb[0], kb[1]);
            mma(s[2 * np + 1], qj, kb[2], kb[3]);
            load_b_nk<D>(vb, sv, c0 + 16 * np, j, lane);
            mma(dp[2 * np], gj, vb[0], vb[1]);
            mma(dp[2 * np + 1], gj, vb[2], vb[3]);
          }
        }

        // dS in place of S
#pragma unroll
        for (int nt = 0; nt < KC / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = exp2f(fmaf(s[nt][e], sl2, -lse2[e >> 1]));
            if (masked &&
                k0 + c0 + nt * 8 + 2 * tig + (e & 1) >= bnd[e >> 1])
              p = 0.f;
            s[nt][e] = p * (dp[nt][e] - dl[e >> 1]);
          }

        // dQ += dS K
        mma_regs_kn<D, KC>(dq, s, sk, c0, col0, lane);
      }
      __syncthreads();  // every warp is done with this stage
    }

    store_rows<D>(stage, dq, scale, scale, warp * 16, lane, col0 / 8);
    __syncthreads();
    for (unsigned idx = threadIdx.x; idx < BT * CPR; idx += MT) {
      const int r = idx / CPR, c = col0 / 8 + idx % CPR;
      if (q0 + r < t_len)
        *reinterpret_cast<uint4*>(base + r * row_stride + c * 8) =
            *reinterpret_cast<const uint4*>(stage + swz<D>(r, c));
    }
    __syncthreads();  // the ring is free for the next sweep's loads
  }
}

// --- bf16 above d 256: column passes ----------------------------------------

// A head dim of 256 nc (nc > 1): each block computes PW = 128 output
// columns (blockIdx.z) of dK and dV (one sweep over the q tiles each) or of
// dQ, recomputing S (and dP) over the full head dim in every pass: the nc
// chunks of 256 dims of each tile pair are staged through shared memory in
// turn and their products summed in chunk order (mma_chunk), then the
// pass's 128 columns of dO, Q (dK/dV) or K (dQ) take P or dS.  Loads are
// not pipelined (speed above d 256 is not a goal).
constexpr int PW = 128;   // output columns of a pass

// acc (16 x NN per warp) += A B^T over one chunk of 256 dims: A fragments
// from rows [r0, r0 + 16) of `a_tile`, B from rows [0, NN) of `b_tile`
// (held [n][k]), one k16 slice at a time: unrolled over the 16 slices,
// ptxas kept every slice's fragment addresses live and spilled
template <int NN>
__device__ __forceinline__ void mma_chunk(float (&acc)[NN / 8][4],
                                          uint32_t a_tile, int r0,
                                          uint32_t b_tile, int lane) {
#pragma unroll 1
  for (int j = 0; j < 256 / 16; ++j) {
    uint32_t a[4];
    load_a<256>(a, a_tile, r0, j, lane);
#pragma unroll
    for (int np = 0; np < NN / 16; ++np) {
      uint32_t bb[4];
      load_b_nk<256>(bb, b_tile, 16 * np, j, lane);
      mma(acc[2 * np], a, bb[0], bb[1]);
      mma(acc[2 * np + 1], a, bb[2], bb[3]);
    }
  }
}

// K, V, Q, dO chunk tiles, the pass's tile, lse and delta
constexpr int wide_smem() {
  return 4 * tile_bytes<256>() + tile_bytes<PW>() + 2 * BT * 4;
}

__global__ void __launch_bounds__(MT)
flash_bwd_dkv_kernel_bf16_wide(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               const __nv_bfloat16* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               __nv_bfloat16* __restrict__ dqkv, Strides st,
                               int H, int t_len, int prefix, float scale,
                               int nc) {
  constexpr int TB = tile_bytes<256>();
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sk = smem_addr(smem), sv = sk + TB, sq = sv + TB,
                 sg = sq + TB, sp = sg + TB;
  const float* lse_s =
      reinterpret_cast<const float*>(smem + 4 * TB + tile_bytes<PW>());
  const float* del_s = lse_s + BT;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * BT;
  const int col0 = blockIdx.z * PW;
  const int width = 256 * nc;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int pfx = min(prefix, t_len);

  const __nv_bfloat16* qp = q + b * st.qb + h * st.qh;
  const __nv_bfloat16* kp = k + b * st.kb + h * st.kh;
  const __nv_bfloat16* vp = v + b * st.vb + h * st.vh;
  const __nv_bfloat16* gp = dout + b * st.gb + h * st.gh;
  const float* lp = lse + (long long)bh * t_len;
  const float* dp_ = delta + (long long)bh * t_len;

  const int q_lo = k0 < pfx ? 0 : k0 / BT;
  const int nq = (t_len + BT - 1) / BT - q_lo;
  const int key_lo = k0 + warp * 16 + grp;  // and key_lo + 8
  const float sl2 = scale * LOG2E;
  const long long row_stride = 3LL * H * width;
  __nv_bfloat16* base =
      dqkv + ((long long)b * t_len + k0) * row_stride + h * width + col0;

  // which 1: dV = P^T dO; which 0: dK = dS^T Q scale
  for (int which = 1; which >= 0; --which) {
    float acc[PW / 8][4];
    zero(acc);
    for (int i = 0; i < nq; ++i) {
      const int q0 = (q_lo + i) * BT;
      float s[BT / 8][4], dpt[BT / 8][4];
      zero(s);
      zero(dpt);
      for (int c = 0; c < nc; ++c) {
        __syncthreads();  // every warp is done with the previous tiles
        load_tile_rolled<MT, 256>(sk, kp + c * 256, st.kt, k0, t_len);
        load_tile_rolled<MT, 256>(sq, qp + c * 256, st.qt, q0, t_len);
        if (which == 0) {
          load_tile_rolled<MT, 256>(sv, vp + c * 256, st.vt, k0, t_len);
          load_tile_rolled<MT, 256>(sg, gp + c * 256, st.gt, q0, t_len);
        }
        if (c == 0) {
          if (which)
            load_tile_rolled<MT, PW>(sp, gp + col0, st.gt, q0, t_len);
          else
            load_tile_rolled<MT, PW>(sp, qp + col0, st.qt, q0, t_len);
          const int r = threadIdx.x & (BT - 1);  // 0-63 lse, 64-127 delta
          const bool ok = q0 + r < t_len;
          cp_async4(smem_addr(lse_s) + (threadIdx.x / BT) * BT * 4 + 4 * r,
                    (threadIdx.x < BT ? lp : dp_) + (ok ? q0 + r : 0), ok);
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        // S^T = K Q^T and dP^T = V dO^T over this chunk: 16 keys x 64 q
        // rows per warp
        mma_chunk<BT>(s, sk, warp * 16, sq, lane);
        if (which == 0) mma_chunk<BT>(dpt, sv, warp * 16, sg, lane);
      }
      const bool masked = k0 + BT > row_bound(q0, pfx);
#pragma unroll
      for (int nt = 0; nt < BT / 8; ++nt) {
        const int c = nt * 8 + 2 * tig;
        const float2 ls = *reinterpret_cast<const float2*>(lse_s + c);
        const float2 ds = *reinterpret_cast<const float2*>(del_s + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float l2 = (e & 1) ? ls.y : ls.x;
          const float dl = (e & 1) ? ds.y : ds.x;
          float p = exp2f(fmaf(s[nt][e], sl2, -l2 * LOG2E));
          if (masked &&
              key_lo + 8 * (e >> 1) >= row_bound(q0 + c + (e & 1), pfx))
            p = 0.f;
          s[nt][e] = p;
          dpt[nt][e] = p * (dpt[nt][e] - dl);
        }
      }
      // dV += P^T dO[:, pass], dK += dS^T Q[:, pass]
      if (which)
        mma_regs_kn<PW, BT>(acc, s, sp, 0, 0, lane);
      else
        mma_regs_kn<PW, BT>(acc, dpt, sp, 0, 0, lane);
    }
    // the pass's columns through the (consumed) Q chunk tile
    __syncthreads();
    const float mul = which ? 1.f : scale;
    store_rows<PW>(smem + 2 * TB, acc, mul, mul, warp * 16, lane);
    __syncthreads();
    constexpr int CPR = PW / 8;
    for (unsigned idx = threadIdx.x; idx < BT * CPR; idx += MT) {
      const int r = idx / CPR, c = idx % CPR;
      if (k0 + r < t_len)
        *reinterpret_cast<uint4*>(base + r * row_stride +
                                  (1 + which) * H * width + c * 8) =
            *reinterpret_cast<const uint4*>(smem + 2 * TB + swz<PW>(r, c));
    }
  }
}

__global__ void __launch_bounds__(MT)
flash_bwd_dq_kernel_bf16_wide(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dqkv, Strides st,
                              int H, int t_len, int prefix, float scale,
                              int nc) {
  constexpr int TB = tile_bytes<256>();
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sq = smem_addr(smem), sg = sq + TB, sk = sg + TB,
                 sv = sk + TB, sp = sv + TB;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BT;  // heaviest first
  const int col0 = blockIdx.z * PW;
  const int width = 256 * nc;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int pfx = min(prefix, t_len);

  const __nv_bfloat16* qp = q + b * st.qb + h * st.qh;
  const __nv_bfloat16* gp = dout + b * st.gb + h * st.gh;
  const __nv_bfloat16* kp = k + b * st.kb + h * st.kh;
  const __nv_bfloat16* vp = v + b * st.vb + h * st.vh;

  int hi = q0 + BT;
  if (q0 < pfx) hi = max(hi, pfx);
  const int nk = (hi + BT - 1) / BT;

  const int row_lo = q0 + warp * 16 + grp;  // and row_lo + 8
  const int bnd[2] = {row_bound(row_lo, pfx), row_bound(row_lo + 8, pfx)};
  const float sl2 = scale * LOG2E;
  float lse2[2], dl[2];  // rows past T: zeros (they are not stored)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    const long long at = (long long)bh * t_len + row;
    lse2[r] = row < t_len ? lse[at] * LOG2E : 0.f;
    dl[r] = row < t_len ? delta[at] : 0.f;
  }
  const int tile_bound = row_bound(q0, pfx);

  float dq[PW / 8][4];
  zero(dq);
  for (int t = 0; t < nk; ++t) {
    const int k0 = t * BT;
    float s[BT / 8][4], dp[BT / 8][4];
    zero(s);
    zero(dp);
    for (int c = 0; c < nc; ++c) {
      __syncthreads();  // every warp is done with the previous tiles
      load_tile_rolled<MT, 256>(sq, qp + c * 256, st.qt, q0, t_len);
      load_tile_rolled<MT, 256>(sg, gp + c * 256, st.gt, q0, t_len);
      load_tile_rolled<MT, 256>(sk, kp + c * 256, st.kt, k0, t_len);
      load_tile_rolled<MT, 256>(sv, vp + c * 256, st.vt, k0, t_len);
      if (c == 0) load_tile_rolled<MT, PW>(sp, kp + col0, st.kt, k0, t_len);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      // S = Q K^T, dP = dO V^T over this chunk: 16 q rows x 64 keys a warp
      mma_chunk<BT>(s, sq, warp * 16, sk, lane);
      mma_chunk<BT>(dp, sg, warp * 16, sv, lane);
    }
    const bool masked = k0 + BT > tile_bound;
#pragma unroll
    for (int nt = 0; nt < BT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[nt][e], sl2, -lse2[e >> 1]));
        if (masked && k0 + nt * 8 + 2 * tig + (e & 1) >= bnd[e >> 1])
          p = 0.f;
        s[nt][e] = p * (dp[nt][e] - dl[e >> 1]);
      }
    // dQ += dS K[:, pass]
    mma_regs_kn<PW, BT>(dq, s, sp, 0, 0, lane);
  }

  __syncthreads();
  store_rows<PW>(smem, dq, scale, scale, warp * 16, lane);
  __syncthreads();
  const long long row_stride = 3LL * H * width;
  __nv_bfloat16* base =
      dqkv + ((long long)b * t_len + q0) * row_stride + h * width + col0;
  constexpr int CPR = PW / 8;
  for (unsigned idx = threadIdx.x; idx < BT * CPR; idx += MT) {
    const int r = idx / CPR, c = idx % CPR;
    if (q0 + r < t_len)
      *reinterpret_cast<uint4*>(base + r * row_stride + c * 8) =
          *reinterpret_cast<const uint4*>(smem + swz<PW>(r, c));
  }
}

// --- fp32: CUDA cores --------------------------------------------------------

constexpr int NT = 256;          // threads per block: 16 x 16
constexpr int LDP = BT + 4;      // shared row stride of P, dS tiles (floats)

// shared row stride of a [64][C] tile in floats
template <int C>
__host__ __device__ constexpr int ld_of() { return C + 4; }
// head-dim columns of the tiles held in shared memory at once: all of
// them up to D = 128, one chunk of 128 at D = 256
template <int D>
__host__ __device__ constexpr int chunk_cols() { return D > 128 ? 128 : D; }
// dK/dV: K, V, Q, dO tiles [64][C + 4], P and dS [64][68]
template <int D>
__host__ __device__ constexpr int dkv_f32_smem() {
  return (4 * BT * ld_of<chunk_cols<D>()>() + 2 * BT * LDP) * 4;
}
// dQ: Q, dO, K, V tiles [64][C + 4], dS^T [64][68]
template <int D>
__host__ __device__ constexpr int dq_f32_smem() {
  return (4 * BT * ld_of<chunk_cols<D>()>() + BT * LDP) * 4;
}

// dst[r][c] = src[(row0 + r) * row_stride + c] * mul, for a 64 x C tile;
// rows at or past t_len are zero
template <int C>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long row_stride, int row0,
                                              int t_len, float mul) {
  for (int idx = threadIdx.x; idx < BT * C; idx += NT) {
    const int r = idx / C, c = idx % C;
    dst[r * ld_of<C>() + c] =
        row0 + r < t_len ? src[(row0 + r) * row_stride + c] * mul : 0.f;
  }
}

// acc[a][b] += sum_c A[ty + 16a][c] * B[tx + 16b][c] over C columns
template <int C>
__device__ __forceinline__ void mma_nt(float (&acc)[4][4], const float* a,
                                       const float* b, int ty, int tx) {
  constexpr int LD = ld_of<C>();
#pragma unroll 4
  for (int c = 0; c < C; c += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = *reinterpret_cast<const float4*>(&a[(ty + 16 * i) * LD + c]);
      bv[i] = *reinterpret_cast<const float4*>(&b[(tx + 16 * i) * LD + c]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
      }
  }
}

// acc[a][4 g + b] += sum_r A[r][4 ty + a] * B[r][64 g + 4 tx + b] over the
// 64 tile rows; A [64][LDP], B [64][C + 4], g < C / 64
template <int C>
__device__ __forceinline__ void mma_tn(float (&acc)[4][C / 16],
                                       const float* a, const float* b,
                                       int ty, int tx) {
  constexpr int LD = ld_of<C>();
#pragma unroll 8
  for (int r = 0; r < BT; ++r) {
    const float4 av = *reinterpret_cast<const float4*>(&a[r * LDP + 4 * ty]);
    const float ar[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
    for (int g = 0; g < C / 64; ++g) {
      const float4 bv =
          *reinterpret_cast<const float4*>(&b[r * LD + 64 * g + 4 * tx]);
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][4 * g + j] = fmaf(ar[i], br[j], acc[i][4 * g + j]);
    }
  }
}

template <int NC, int N>
__device__ __forceinline__ void zero_f32(float (&a)[NC][4][N]) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) a[c][i][j] = 0.f;
}

template <int D>
__global__ void __launch_bounds__(NT, D == 64 ? 2 : 1)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dqkv,
                     Strides st, int H, int t_len, int prefix, float scale,
                     int nc_arg) {
  constexpr int C = chunk_cols<D>();
  constexpr int NC = D / C;     // column chunks of a pass
  constexpr int LD = ld_of<C>();
  // a head dim of 256 nc: S and dP are summed over all 2 nc chunks, and
  // blockIdx.z picks the pass of D columns (NC chunks) this block writes
  const int nct = D == 256 ? 2 * nc_arg : NC;
  const int c_lo = D == 256 ? static_cast<int>(blockIdx.z) * NC : 0;
  const int width = C * nct;
  extern __shared__ __align__(16) float smemf[];
  float* ks = smemf;            // K [key][c]
  float* vs = ks + BT * LD;     // V [key][c]
  float* qs = vs + BT * LD;     // Q * scale [row][c]
  float* gs = qs + BT * LD;     // dO [row][c]
  float* ps = gs + BT * LD;     // P [row][key]
  float* dss = ps + BT * LDP;   // dS [row][key]
  __shared__ float lse_s[BT], delta_s[BT];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int pfx = min(prefix, t_len);

  const float* qp = q + b * st.qb + h * st.qh;
  const float* kp = k + b * st.kb + h * st.kh;
  const float* vp = v + b * st.vb + h * st.vh;
  const float* gp = dout + b * st.gb + h * st.gh;
  const float* lp = lse + (long long)bh * t_len;
  const float* dp_ = delta + (long long)bh * t_len;

  // one chunk holds the head dim: K and V stay in shared memory
  if constexpr (NC == 1) {
    load_tile_f32<C>(ks, kp, st.kt, k0, t_len, 1.f);
    load_tile_f32<C>(vs, vp, st.vt, k0, t_len, 1.f);
  }

  float dk[NC][4][C / 16], dv[NC][4][C / 16];
  zero_f32(dk);
  zero_f32(dv);

  // q-tiles that see a key of this tile: all when the keys meet the prefix,
  // else those from the tile holding row k0 on (rows i >= key)
  const int q_lo = k0 < pfx ? 0 : k0 / BT;
  const int nq = (t_len + BT - 1) / BT;
  for (int qi = q_lo; qi < nq; ++qi) {
    const int q0 = qi * BT;
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    // S = (Q scale) K^T and dP = dO V^T, summed over the chunks in order
    for (int c = 0; c < nct; ++c) {
      __syncthreads();  // the previous tiles' Q, dO, P, dS are consumed
      if constexpr (NC > 1) {
        load_tile_f32<C>(ks, kp + c * C, st.kt, k0, t_len, 1.f);
        load_tile_f32<C>(vs, vp + c * C, st.vt, k0, t_len, 1.f);
      }
      load_tile_f32<C>(qs, qp + c * C, st.qt, q0, t_len, scale);
      load_tile_f32<C>(gs, gp + c * C, st.gt, q0, t_len, 1.f);
      if (c == 0 && threadIdx.x < BT) {
        const int row = q0 + threadIdx.x;
        lse_s[threadIdx.x] = row < t_len ? lp[row] : 0.f;
        delta_s[threadIdx.x] = row < t_len ? dp_[row] : 0.f;
      }
      __syncthreads();
      mma_nt<C>(s, qs, ks, ty, tx);   // rows ty + 16i, keys tx + 16j
      mma_nt<C>(dp, gs, vs, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int bound = row_bound(q0 + r, pfx);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = (k0 + c < bound) ? expf(s[i][j] - lse_s[r]) : 0.f;
        ps[r * LDP + c] = p;
        dss[r * LDP + c] = p * (dp[i][j] - delta_s[r]);
      }
    }
    __syncthreads();
    // dV += P^T dO, dK += dS^T (Q scale), this pass's chunks from the last
    // (the last chunk of the head dim is still in shared memory)
#pragma unroll
    for (int cc = NC - 1; cc >= 0; --cc) {
      const int c = c_lo + cc;
      if (c != nct - 1) {
        __syncthreads();
        load_tile_f32<C>(qs, qp + c * C, st.qt, q0, t_len, scale);
        load_tile_f32<C>(gs, gp + c * C, st.gt, q0, t_len, 1.f);
        __syncthreads();
      }
      mma_tn<C>(dv[cc], ps, gs, ty, tx);  // keys 4ty + i, dims 64g + 4tx + j
      mma_tn<C>(dk[cc], dss, qs, ty, tx);
    }
  }

  // dK = dS^T (Q scale) is complete: q was scaled on load
  const long long row_stride = 3LL * H * width;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * ty + i;
    if (key >= t_len) continue;
    float* base = dqkv + ((long long)b * t_len + key) * row_stride +
                  h * width + c_lo * C;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < C / 16; ++j) {
        const int col = c * C + 64 * (j / 4) + 4 * tx + j % 4;
        base[H * width + col] = dk[c][i][j];
        base[2 * H * width + col] = dv[c][i][j];
      }
  }
}

template <int D>
__global__ void __launch_bounds__(NT, D == 64 ? 2 : 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dqkv,
                    Strides st, int H, int t_len, int prefix, float scale,
                    int nc_arg) {
  constexpr int C = chunk_cols<D>();
  constexpr int NC = D / C;     // column chunks of a pass
  constexpr int LD = ld_of<C>();
  // a head dim of 256 nc: as the dK/dV kernel
  const int nct = D == 256 ? 2 * nc_arg : NC;
  const int c_lo = D == 256 ? static_cast<int>(blockIdx.z) * NC : 0;
  const int width = C * nct;
  extern __shared__ __align__(16) float smemf[];
  float* qs = smemf;            // Q * scale [row][c]
  float* gs = qs + BT * LD;     // dO [row][c]
  float* ks = gs + BT * LD;     // K [key][c]
  float* vs = ks + BT * LD;     // V [key][c]
  float* dst = vs + BT * LD;    // dS^T [key][row]
  __shared__ float lse_s[BT], delta_s[BT];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int pfx = min(prefix, t_len);

  const float* qp = q + b * st.qb + h * st.qh;
  const float* gp = dout + b * st.gb + h * st.gh;
  const float* kp = k + b * st.kb + h * st.kh;
  const float* vp = v + b * st.vb + h * st.vh;
  // one chunk holds the head dim: Q and dO stay in shared memory
  if constexpr (NC == 1) {
    load_tile_f32<C>(qs, qp, st.qt, q0, t_len, scale);
    load_tile_f32<C>(gs, gp, st.gt, q0, t_len, 1.f);
  }
  if (threadIdx.x < BT) {
    const int row = q0 + threadIdx.x;
    const long long at = (long long)bh * t_len + row;
    lse_s[threadIdx.x] = row < t_len ? lse[at] : 0.f;
    delta_s[threadIdx.x] = row < t_len ? delta[at] : 0.f;
  }

  float dq[NC][4][C / 16];
  zero_f32(dq);

  // the last k-tile any row of this q tile can see
  int hi = (q0 + BT - 1) / BT + 1;
  if (q0 < pfx) hi = max(hi, (pfx + BT - 1) / BT);
  for (int kj = 0; kj < hi; ++kj) {
    const int k0 = kj * BT;
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int c = 0; c < nct; ++c) {
      __syncthreads();  // the previous tile's K and dS^T are consumed
      if constexpr (NC > 1) {
        load_tile_f32<C>(qs, qp + c * C, st.qt, q0, t_len, scale);
        load_tile_f32<C>(gs, gp + c * C, st.gt, q0, t_len, 1.f);
      }
      load_tile_f32<C>(ks, kp + c * C, st.kt, k0, t_len, 1.f);
      load_tile_f32<C>(vs, vp + c * C, st.vt, k0, t_len, 1.f);
      __syncthreads();
      mma_nt<C>(s, qs, ks, ty, tx);   // rows ty + 16i, keys tx + 16j
      mma_nt<C>(dp, gs, vs, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int bound = row_bound(q0 + r, pfx);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = (k0 + c < bound) ? expf(s[i][j] - lse_s[r]) : 0.f;
        dst[c * LDP + r] = p * (dp[i][j] - delta_s[r]);
      }
    }
    __syncthreads();
    // dQ += dS K, this pass's chunks from the last (the last chunk of the
    // head dim is still in shared memory)
#pragma unroll
    for (int cc = NC - 1; cc >= 0; --cc) {
      const int c = c_lo + cc;
      if (c != nct - 1) {
        __syncthreads();
        load_tile_f32<C>(ks, kp + c * C, st.kt, k0, t_len, 1.f);
        __syncthreads();
      }
      mma_tn<C>(dq[cc], dst, ks, ty, tx);  // rows 4ty + i, dims 64g + 4tx + j
    }
  }

  const long long row_stride = 3LL * H * width;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= t_len) continue;
    float* base = dqkv + ((long long)b * t_len + row) * row_stride +
                  h * width + c_lo * C;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < C / 16; ++j)
        base[c * C + 64 * (j / 4) + 4 * tx + j % 4] = dq[c][i][j] * scale;
  }
}

// launch kernel with smem bytes of dynamic shared memory
template <typename Kernel, typename... Args>
cudaError_t launch_big(Kernel kernel, dim3 grid, int threads, int smem,
                       cudaStream_t s, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, s>>>(args...);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_delta(const void* out, const void* dout, void* delta,
                         const Strides& st, int batch, int heads, int t_len,
                         int width, cudaStream_t s) {
  const long long rows = (long long)batch * heads * t_len;
  const int rows_per_block = DELTA_THREADS / 32;
  flash_bwd_delta_kernel<T><<<(rows + rows_per_block - 1) / rows_per_block,
                              DELTA_THREADS, 0, s>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout),
      static_cast<float*>(delta), st, heads, t_len, rows, width);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* out, const void* dout, const void* lse,
                       void* delta, void* dqkv, const Strides& st, int batch,
                       int heads, int t_len, int prefix, float scale,
                       int is_bf16, cudaStream_t s, int nc = 1) {
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int tiles = (t_len + BT - 1) / BT;
  cudaError_t err;
  if (is_bf16) {
    using bf = __nv_bfloat16;
    err = launch_delta<bf>(out, dout, delta, st, batch, heads, t_len, D * nc,
                           s);
    if (err != cudaSuccess) return err;
    const bf *qb = static_cast<const bf*>(q), *kb = static_cast<const bf*>(k),
             *vb = static_cast<const bf*>(v), *gb = static_cast<const bf*>(dout);
    bf* g = static_cast<bf*>(dqkv);
    if (nc > 1) {
      const dim3 grid(batch * heads, tiles, D * nc / PW);
      err = launch_big(flash_bwd_dkv_kernel_bf16_wide, grid, MT, wide_smem(),
                       s, qb, kb, vb, gb, l, dl, g, st, heads, t_len, prefix,
                       scale, nc);
      if (err != cudaSuccess) return err;
      return launch_big(flash_bwd_dq_kernel_bf16_wide, grid, MT, wide_smem(),
                        s, qb, kb, vb, gb, l, dl, g, st, heads, t_len, prefix,
                        scale, nc);
    }
    const dim3 grid(batch * heads, tiles);
    err = launch_big(flash_bwd_dkv_kernel_bf16<D>, grid, MT, dkv_smem<D>(),
                     s, qb, kb, vb, gb, l, dl, g, st, heads, t_len, prefix,
                     scale);
    if (err != cudaSuccess) return err;
    return launch_big(flash_bwd_dq_kernel_bf16<D>, grid, MT, dq_smem<D>(), s,
                      qb, kb, vb, gb, l, dl, g, st, heads, t_len, prefix,
                      scale);
  }
  err = launch_delta<float>(out, dout, delta, st, batch, heads, t_len, D * nc,
                            s);
  if (err != cudaSuccess) return err;
  const dim3 grid(tiles, batch * heads, nc);
  const float *qf = static_cast<const float*>(q),
              *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v),
              *gf = static_cast<const float*>(dout);
  float* g = static_cast<float*>(dqkv);
  err = launch_big(flash_bwd_dkv_kernel<D>, grid, NT, dkv_f32_smem<D>(), s,
                   qf, kf, vf, gf, l, dl, g, st, heads, t_len, prefix, scale,
                   nc);
  if (err != cudaSuccess) return err;
  return launch_big(flash_bwd_dq_kernel<D>, grid, NT, dq_f32_smem<D>(), s,
                    qf, kf, vf, gf, l, dl, g, st, heads, t_len, prefix,
                    scale, nc);
}

}  // namespace

// strides: (b, h, t) element strides of q, k, v, out and dout, in that
// order; delta is fp32 scratch of B * H * T values; dqkv is a contiguous
// [B, T, 3, H, head_dim] buffer in q's dtype; head_dim 64, 128 or a
// multiple of 256, any T; scale = 1 / sqrt(d) of the true head dim d.
extern "C" int mas_flash_bwd(const void* q, const void* k, const void* v,
                             const void* out, const void* dout,
                             const void* lse, void* delta, void* dqkv,
                             const long long* strides, int batch, int heads,
                             int t_len, int prefix, int head_dim, float scale,
                             int is_bf16, void* stream) {
  Strides st;
  st.qb = strides[0]; st.qh = strides[1]; st.qt = strides[2];
  st.kb = strides[3]; st.kh = strides[4]; st.kt = strides[5];
  st.vb = strides[6]; st.vh = strides[7]; st.vt = strides[8];
  st.ob = strides[9]; st.oh = strides[10]; st.ot = strides[11];
  st.gb = strides[12]; st.gh = strides[13]; st.gt = strides[14];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (head_dim == 64) {
    err = launch_bwd<64>(q, k, v, out, dout, lse, delta, dqkv, st, batch,
                         heads, t_len, prefix, scale, is_bf16, s);
  } else if (head_dim == 128) {
    err = launch_bwd<128>(q, k, v, out, dout, lse, delta, dqkv, st, batch,
                          heads, t_len, prefix, scale, is_bf16, s);
  } else if (head_dim >= 256 && head_dim % 256 == 0) {
    err = launch_bwd<256>(q, k, v, out, dout, lse, delta, dqkv, st, batch,
                          heads, t_len, prefix, scale, is_bf16, s,
                          head_dim / 256);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
