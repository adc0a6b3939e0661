// Prefix-bidirectional causal attention forward (kernel B1).
//
// Replaces: mas_tpu/ops/attention.py::_fwd_kernel (launched by
// _flash_fwd), the Pallas flash-attention forward of the transformer
// prefill and training step.
//
// Computes, for q, k, v [B, H, T, D] (bf16 or fp32, D = 64, 128, 256 or a
// multiple of 256: the wrapper zero-pads any head dim d up to one of them
// and passes scale = 1/sqrt(d) of the true d), out = softmax(q k^T scale)
// v and lse = logsumexp of the scaled scores, where row i sees the keys
// [0, bound): bound = prefix for i < prefix, else i + 1 (the visible span
// is always contiguous, mas_tpu/ops/attention.py::_row_bound).
//
// What bounds it on the H100: per (b, h) the work is O(T^2 d) multiply-adds
// on O(T d) bytes (at T = 384, d = 64: ~150 operations per byte read), so it
// is compute bound, and only the tensor cores (989 TFLOP/s in bf16, against
// 67 on the fp32 cores) come near the bound.  Both kernels are templates
// over D.
//
// bf16 (flash_fwd_kernel_bf16), FlashAttention-2 style: one block of four
// warps per (b*h, 64-row q tile), 16 q rows per warp; heaviest q tiles are
// launched first (causal rows have unequal work).  The q tile is copied
// once with cp.async, moved into mma A fragments with ldmatrix and scaled
// there, rounded to bf16 once, as the Pallas kernel's q * asarray(scale,
// q.dtype) (the host passes the scale rounded to bf16; 1/8 at d 64 is
// exact).  64-key K/V tiles stream through a two-stage cp.async ring
// (16-byte copies, rows past T zero-filled), so the next tile's load
// overlaps this tile's products.  S = q K^T and O += P V run on the tensor
// cores (mma.sync m16n8k16, bf16 in, fp32 accumulate; K fragments by
// ldmatrix, V by ldmatrix.trans, both free of bank conflicts through the
// XOR swizzle of flash_mma.cuh).  The online softmax works on the S
// accumulators in registers: row max and sum over the four lanes that share
// a row (shuffles), exp2 with log2(e) folded into one fma, fp32 m and l.
// P is rounded to bf16 in registers, as the Pallas kernel's
// p.astype(v.dtype), and is P V's A operand as it stands: it never touches
// shared memory.  Only tiles that straddle a row's bound are masked, and
// tiles past max(causal bound, prefix bound) of the q tile are never
// loaded (mas_tpu/ops/attention.py:173-177).  The epilogue divides by l,
// rounds once, and writes out through shared memory as 16-byte rows.
// At D = 256 the output accumulator alone takes 128 registers a thread, so
// the scaled q tile is written back to shared memory once and its A
// fragments are loaded again at each use instead of held in registers
// (64 registers fewer); 160 KB of shared memory give one block an SM.
//
// fp32 (flash_fwd_kernel) keeps the CUDA-core kernel: TF32 tensor cores
// would not hold the fp32 path to its 1e-5 tolerance, and no configuration
// runs attention in fp32.  One block per (b*h, 32-row q tile), four threads
// per q row, each with its fp32 accumulator in registers and every fourth
// key of a 64-key tile; the scaled q rows and the K/V tiles sit in shared
// memory.  The four partial softmax states of a row merge through
// shuffles.  At D = 256 a thread's accumulator would take all 256
// registers: each block computes the output columns of one half of the
// head dim (blockIdx.z) over the full scores, so the two halves compute
// the same softmax, bit for bit, and the first writes lse.  A head dim of
// 256 nc (the WIDE instance) runs as 4 nc such passes of 64 columns, each
// summing the scores over nc chunks of 256 dims, the chunks' q and K tiles
// loaded in turn.
//
// Inputs are addressed by strides (last dim contiguous), so q, k, v can be
// views into the fused qkv projection and out can be written in
// [B, T, H, d] order; the bf16 kernel needs every (b, h, t) stride a
// multiple of 8 elements and 16-byte aligned data (the wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_mma.cuh"

namespace {

using namespace flash_mma;

struct Strides {
  long long qb, qh, qt, kb, kh, kt, vb, vh, vt, ob, oh, ot;
};

// --- bf16: tensor cores ------------------------------------------------------

constexpr int MQ = 64;          // q rows per block, 16 per warp
constexpr int MK = 64;          // keys per K/V tile
constexpr int MT = 128;         // threads per block
constexpr int STAGES = 2;       // K/V ring depth

// shared memory: the Q tile, then STAGES x (K tile, V tile); static at
// D = 64 (40 KB, as the kernel was before head dims were templated),
// dynamic at D = 128 and 256 (80 and 160 KB, above the 48 KB a static array
// may take)
template <int D>
__host__ __device__ constexpr int fwd_smem() {
  return (1 + 2 * STAGES) * tile_bytes<D>();
}
template <int D>
__host__ __device__ constexpr int fwd_dynamic_smem() {
  return D == 64 ? 0 : fwd_smem<D>();
}

template <int D>
__global__ void __launch_bounds__(MT)
flash_fwd_kernel_bf16(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, Strides st, int H, int t_len,
                      int prefix, float scale) {
  constexpr int TB = tile_bytes<D>();
  constexpr int NJ = D / 16;    // k16 slices of the head dim
  __shared__ __align__(128) unsigned char
      smem_static[fwd_dynamic_smem<D>() ? 16 : fwd_smem<D>()];
  extern __shared__ __align__(128) unsigned char smem_dynamic[];
  unsigned char* smem = fwd_dynamic_smem<D>() ? smem_dynamic : smem_static;
  const uint32_t sq = smem_addr(smem);
  const uint32_t skv = sq + TB;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * MQ;  // heaviest first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int pfx = min(prefix, t_len);

  const __nv_bfloat16* kp = k + b * st.kb + h * st.kh;
  const __nv_bfloat16* vp = v + b * st.vb + h * st.vh;

  // the last key any row of this q tile can see
  int hi = min(q0 + MQ, t_len);
  if (q0 < pfx) hi = max(hi, pfx);
  const int ntiles = (hi + MK - 1) / MK;

  load_tile<MT, D>(sq, q + b * st.qb + h * st.qh, st.qt, q0, t_len);
  cp_async_commit();
  load_tile<MT, D>(skv, kp, st.kt, 0, t_len);
  load_tile<MT, D>(skv + TB, vp, st.vt, 0, t_len);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // q * scale as A fragments: 16 rows x NJ slices of 16 dims, kept in
  // registers up to D = 128; at D = 256 scaled in place in shared memory
  // and loaded at each use
  constexpr bool KEEP_Q = D <= 128;
  uint32_t qa[KEEP_Q ? NJ : 1][4];
  if constexpr (KEEP_Q) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      load_a<D>(qa[j], sq, warp * 16, j, lane);
#pragma unroll
      for (int e = 0; e < 4; ++e) qa[j][e] = scale_pair(qa[j][e], scale);
    }
  } else {
    for (unsigned idx = threadIdx.x; idx < MQ * D / 8; idx += MT) {
      uint4* p = reinterpret_cast<uint4*>(smem + 16 * idx);
      uint4 x = *p;
      x.x = scale_pair(x.x, scale);
      x.y = scale_pair(x.y, scale);
      x.z = scale_pair(x.z, scale);
      x.w = scale_pair(x.w, scale);
      *p = x;
    }
    __syncthreads();
  }

  // this thread's rows: grp and grp + 8 of the warp's 16
  const int row_lo = q0 + warp * 16 + grp;
  const int bnd[2] = {row_bound(row_lo, pfx), row_bound(row_lo + 8, pfx)};
  const int tile_bound = row_bound(q0, pfx);  // least bound of the tile

  float o[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      const uint32_t nxt = skv + ((t + 1) % STAGES) * 2 * TB;
      load_tile<MT, D>(nxt, kp, st.kt, (t + 1) * MK, t_len);
      load_tile<MT, D>(nxt + TB, vp, st.vt, (t + 1) * MK, t_len);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile t has landed
    __syncthreads();
    const uint32_t sk = skv + (t % STAGES) * 2 * TB;
    const uint32_t sv = sk + TB;
    const int k0 = t * MK;

    // S = (q scale) K^T: 16 rows x 64 keys per warp
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      uint32_t qj[4];
      if constexpr (KEEP_Q) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qj[e] = qa[j][e];
      } else {
        load_a<D>(qj, sq, warp * 16, j, lane);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kb[4];
        load_b_nk<D>(kb, sk, 16 * np, j, lane);
        mma(s[2 * np], qj, kb[0], kb[1]);
        mma(s[2 * np + 1], qj, kb[2], kb[3]);
      }
    }

    // mask only a tile that reaches past some row's bound (keys past T
    // included: every real row's bound is <= T)
    if (k0 + MK > tile_bound) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + nt * 8 + 2 * tig + (e & 1) >= bnd[e >> 1])
            s[nt][e] = -INFINITY;
    }

    // online softmax; key 0 is visible to every row, so m is finite from
    // the first tile on
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
    float ms[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float alpha = exp2f((m[r] - mx[r]) * LOG2E);
      l[r] *= alpha;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        o[nt][2 * r] *= alpha;
        o[nt][2 * r + 1] *= alpha;
      }
      m[r] = mx[r];
      ms[r] = mx[r] * LOG2E;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(fmaf(s[nt][e], LOG2E, -ms[e >> 1]));
        l[e >> 1] += s[nt][e];
      }

    // O += P V, P rounded to bf16 in registers
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t pa[4];
      c_to_a(pa, s[2 * j], s[2 * j + 1]);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t vb[4];
        load_b_kn<D>(vb, sv, 16 * np, j, lane);
        mma(o[2 * np], pa, vb[0], vb[1]);
        mma(o[2 * np + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  // out rows through the (consumed) Q tile, then 16-byte coalesced stores
  store_rows<D>(smem, o, 1.f / l[0], 1.f / l[1], warp * 16, lane);
  if (tig == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row_lo + 8 * r < t_len)
        lse[(long long)bh * t_len + row_lo + 8 * r] = m[r] + logf(l[r]);
  }
  __syncthreads();
  __nv_bfloat16* op = out + b * st.ob + h * st.oh;
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (unsigned idx = threadIdx.x; idx < MQ * CPR; idx += MT) {
    const int r = idx / CPR, c = idx % CPR;
    if (q0 + r < t_len)
      *reinterpret_cast<uint4*>(op + (q0 + r) * st.ot + c * 8) =
          *reinterpret_cast<const uint4*>(smem + swz<D>(r, c));
  }
}

// --- bf16 above d 256: column passes ----------------------------------------

// A head dim of 256 nc (nc > 1) in output passes of PW = 128 columns
// (blockIdx.z), each over the full scores: per key tile, S = (q scale) K^T
// is summed over the nc chunks of 256 dims, each chunk's Q and K tiles
// staged through shared memory; P V then takes the pass's 128 V columns.
// Loads are not pipelined (speed above d 256 is not a goal); every pass
// computes the same S, m and l bit for bit, and pass 0 writes lse.
constexpr int PW = 128;   // output columns of a pass

constexpr int wide_fwd_smem() {
  return 2 * tile_bytes<256>() + tile_bytes<PW>();   // Q, K chunks; V pass
}

__global__ void __launch_bounds__(MT)
flash_fwd_kernel_bf16_wide(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ out,
                           float* __restrict__ lse, Strides st, int H,
                           int t_len, int prefix, float scale, int nc) {
  constexpr int NJ = 256 / 16;   // k16 slices of a chunk
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sq = smem_addr(smem);
  const uint32_t sk = sq + tile_bytes<256>();
  const uint32_t sv = sk + tile_bytes<256>();

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * MQ;  // heaviest first
  const int col0 = blockIdx.z * PW;                   // this pass's columns
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int pfx = min(prefix, t_len);

  const __nv_bfloat16* qp = q + b * st.qb + h * st.qh;
  const __nv_bfloat16* kp = k + b * st.kb + h * st.kh;
  const __nv_bfloat16* vp = v + b * st.vb + h * st.vh + col0;

  int hi = min(q0 + MQ, t_len);
  if (q0 < pfx) hi = max(hi, pfx);
  const int ntiles = (hi + MK - 1) / MK;

  const int row_lo = q0 + warp * 16 + grp;
  const int bnd[2] = {row_bound(row_lo, pfx), row_bound(row_lo + 8, pfx)};
  const int tile_bound = row_bound(q0, pfx);

  float o[PW / 8][4];
#pragma unroll
  for (int nt = 0; nt < PW / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * MK;
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    for (int c = 0; c < nc; ++c) {
      __syncthreads();  // every warp is done with the previous tiles
      load_tile<MT, 256>(sq, qp + c * 256, st.qt, q0, t_len);
      load_tile<MT, 256>(sk, kp + c * 256, st.kt, k0, t_len);
      if (c == 0) load_tile<MT, PW>(sv, vp, st.vt, k0, t_len);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < NJ; ++j) {
        uint32_t qj[4];
        load_a<256>(qj, sq, warp * 16, j, lane);
#pragma unroll
        for (int e = 0; e < 4; ++e) qj[e] = scale_pair(qj[e], scale);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t kb[4];
          load_b_nk<256>(kb, sk, 16 * np, j, lane);
          mma(s[2 * np], qj, kb[0], kb[1]);
          mma(s[2 * np + 1], qj, kb[2], kb[3]);
        }
      }
    }

    if (k0 + MK > tile_bound) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + nt * 8 + 2 * tig + (e & 1) >= bnd[e >> 1])
            s[nt][e] = -INFINITY;
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
    float ms[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float alpha = exp2f((m[r] - mx[r]) * LOG2E);
      l[r] *= alpha;
#pragma unroll
      for (int nt = 0; nt < PW / 8; ++nt) {
        o[nt][2 * r] *= alpha;
        o[nt][2 * r + 1] *= alpha;
      }
      m[r] = mx[r];
      ms[r] = mx[r] * LOG2E;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(fmaf(s[nt][e], LOG2E, -ms[e >> 1]));
        l[e >> 1] += s[nt][e];
      }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t pa[4];
      c_to_a(pa, s[2 * j], s[2 * j + 1]);
#pragma unroll
      for (int np = 0; np < PW / 16; ++np) {
        uint32_t vb[4];
        load_b_kn<PW>(vb, sv, 16 * np, j, lane);
        mma(o[2 * np], pa, vb[0], vb[1]);
        mma(o[2 * np + 1], pa, vb[2], vb[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  __syncthreads();  // the V tile is free: out rows go through it
  store_rows<PW>(smem + 2 * tile_bytes<256>(), o, 1.f / l[0], 1.f / l[1],
                 warp * 16, lane);
  if (tig == 0 && blockIdx.z == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row_lo + 8 * r < t_len)
        lse[(long long)bh * t_len + row_lo + 8 * r] = m[r] + logf(l[r]);
  }
  __syncthreads();
  __nv_bfloat16* op = out + b * st.ob + h * st.oh + col0;
  constexpr int CPR = PW / 8;
  const unsigned char* tile = smem + 2 * tile_bytes<256>();
  for (unsigned idx = threadIdx.x; idx < MQ * CPR; idx += MT) {
    const int r = idx / CPR, c = idx % CPR;
    if (q0 + r < t_len)
      *reinterpret_cast<uint4*>(op + (q0 + r) * st.ot + c * 8) =
          *reinterpret_cast<const uint4*>(tile + swz<PW>(r, c));
  }
}

// --- fp32: CUDA cores --------------------------------------------------------

constexpr int BQ = 32;         // q rows per block
constexpr int BK = 64;         // keys per shared-memory tile
constexpr int SUB = 4;         // threads per q row
constexpr int NT = BQ * SUB;   // threads per block
constexpr int KPT = BK / SUB;  // keys per thread per tile
constexpr float NEG = -1e30f;  // masked score, as the Pallas kernel

// output columns a block computes: all up to D = 128, one half at 256, a
// quarter of each chunk of 256 above (WIDE: the chunk loop's live scores
// leave no room for 128 accumulators)
template <int D, bool WIDE>
__host__ __device__ constexpr int fwd_f32_cols() {
  return WIDE ? 64 : D > 128 ? 128 : D;
}

// dynamic shared memory: the K tile [BK][D + 4], the V tile [BK][DV + 4]
// (this block's DV output columns), the q tile [BQ][D + 4]
template <int D, bool WIDE>
__host__ __device__ constexpr int fwd_f32_smem() {
  return ((BK + BQ) * (D + 4) + BK * (fwd_f32_cols<D, WIDE>() + 4)) * 4;
}

template <int D, bool WIDE>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, Strides st, int H, int t_len,
                 int prefix, float scale, int nc_arg) {
  constexpr int KPAD = D + 4;    // shared row stride in floats
  constexpr int DV = fwd_f32_cols<D, WIDE>();
  constexpr int VPAD = DV + 4;
  extern __shared__ __align__(16) float smf[];
  float* ks = smf;
  float* vs = ks + BK * KPAD;    // V columns [v0, v0 + DV)
  float* qs = vs + BK * VPAD;    // q * scale [row][c]
  // WIDE, a head dim of D nc: the scores summed over nc chunks of D dims,
  // each chunk's q and K tiles loaded in turn; blockIdx.z picks the DV
  // output columns
  const int nc = WIDE ? nc_arg : 1;
  const int v0 = blockIdx.z * DV;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int sub = tid % SUB;
  const int i = q0 + tid / SUB;  // this thread's query row
  const bool row_ok = i < t_len;
  const int pfx = min(prefix, t_len);
  const int bound = row_ok ? row_bound(i, pfx) : 0;

  const float* qp = q + b * st.qb + h * st.qh;
  const float* kp = k + b * st.kb + h * st.kh;
  const float* vp = v + b * st.vb + h * st.vh;

  auto load_q = [&](int c) {
    for (int idx = tid; idx < BQ * D; idx += NT) {
      const int r = idx / D, cc = idx % D;
      qs[r * KPAD + cc] =
          q0 + r < t_len ? qp[(q0 + r) * st.qt + c * D + cc] * scale : 0.f;
    }
  };
  if constexpr (!WIDE) load_q(0);
  const float4* qr = reinterpret_cast<const float4*>(&qs[(tid / SUB) * KPAD]);

  // the last tile any row of this q tile can see
  const int q_last = min(q0 + BQ, t_len) - 1;
  int hi = q_last + 1;
  if (q0 < pfx) hi = max(hi, pfx);
  const int ntiles = (hi + BK - 1) / BK;

  float m = NEG, l = 0.f;
  float acc[DV];
#pragma unroll
  for (int c = 0; c < DV; ++c) acc[c] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    float s[KPT];
    float tmax = NEG;
    if constexpr (!WIDE) {
      __syncthreads();  // every thread is done with the previous tile
      for (int idx = tid; idx < BK * D; idx += NT) {
        const int j = idx / D, c = idx % D;
        const int kj = k0 + j;
        ks[j * KPAD + c] = kj < t_len ? kp[kj * st.kt + c] : 0.f;
        if (DV == D || (c >= v0 && c < v0 + DV))
          vs[j * VPAD + c - v0] = kj < t_len ? vp[kj * st.vt + c] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < KPT; ++u) {
        const int j = u * SUB + sub;
        const float4* kr = reinterpret_cast<const float4*>(&ks[j * KPAD]);
        float dot = 0.f;
        // all of q in registers at D = 256 would spill: 8 float4 at a time
#pragma unroll (D > 128 ? 8 : D / 4)
        for (int c4 = 0; c4 < D / 4; ++c4) {
          const float4 kk = kr[c4];
          const float4 qq = qr[c4];
          dot = fmaf(qq.x, kk.x, dot);
          dot = fmaf(qq.y, kk.y, dot);
          dot = fmaf(qq.z, kk.z, dot);
          dot = fmaf(qq.w, kk.w, dot);
        }
        s[u] = (k0 + j < bound) ? dot : NEG;
        tmax = fmaxf(tmax, s[u]);
      }
    } else {
#pragma unroll
      for (int u = 0; u < KPT; ++u) s[u] = 0.f;
      for (int c = 0; c < nc; ++c) {
        __syncthreads();  // every thread is done with the previous tiles
        for (int idx = tid; idx < BK * D; idx += NT) {
          const int j = idx / D, cc = idx % D;
          const int kj = k0 + j;
          ks[j * KPAD + cc] = kj < t_len ? kp[kj * st.kt + c * D + cc] : 0.f;
        }
        if (c == 0) {
          for (int idx = tid; idx < BK * DV; idx += NT) {
            const int j = idx / DV, cc = idx % DV;
            const int kj = k0 + j;
            vs[j * VPAD + cc] = kj < t_len ? vp[kj * st.vt + v0 + cc] : 0.f;
          }
        }
        load_q(c);
        __syncthreads();
#pragma unroll
        for (int u = 0; u < KPT; ++u) {
          const int j = u * SUB + sub;
          const float4* kr = reinterpret_cast<const float4*>(&ks[j * KPAD]);
          float dot = 0.f;
#pragma unroll 8
          for (int c4 = 0; c4 < D / 4; ++c4) {
            const float4 kk = kr[c4];
            const float4 qq = qr[c4];
            dot = fmaf(qq.x, kk.x, dot);
            dot = fmaf(qq.y, kk.y, dot);
            dot = fmaf(qq.z, kk.z, dot);
            dot = fmaf(qq.w, kk.w, dot);
          }
          s[u] += dot;
        }
      }
#pragma unroll
      for (int u = 0; u < KPT; ++u) {
        s[u] = (k0 + u * SUB + sub < bound) ? s[u] : NEG;
        tmax = fmaxf(tmax, s[u]);
      }
    }
    if (tmax > NEG) {  // this thread sees at least one key of the tile
      const float m_new = fmaxf(m, tmax);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int c = 0; c < DV; ++c) acc[c] *= alpha;
#pragma unroll
      for (int u = 0; u < KPT; ++u) {
        const float p = (s[u] > NEG) ? expf(s[u] - m_new) : 0.f;
        l += p;
        const float4* vr =
            reinterpret_cast<const float4*>(&vs[(u * SUB + sub) * VPAD]);
#pragma unroll
        for (int c4 = 0; c4 < DV / 4; ++c4) {
          const float4 vv = vr[c4];
          acc[4 * c4 + 0] = fmaf(p, vv.x, acc[4 * c4 + 0]);
          acc[4 * c4 + 1] = fmaf(p, vv.y, acc[4 * c4 + 1]);
          acc[4 * c4 + 2] = fmaf(p, vv.z, acc[4 * c4 + 2]);
          acc[4 * c4 + 3] = fmaf(p, vv.w, acc[4 * c4 + 3]);
        }
      }
      m = m_new;
    }
  }

  // merge the SUB partial softmax states of this row (adjacent lanes)
  const unsigned full = 0xffffffffu;
  float m_all = m;
#pragma unroll
  for (int o = 1; o < SUB; o <<= 1)
    m_all = fmaxf(m_all, __shfl_xor_sync(full, m_all, o));
  const float f = expf(m - m_all);  // 0 for a thread that saw no key
  float l_all = l * f;
#pragma unroll
  for (int o = 1; o < SUB; o <<= 1) l_all += __shfl_xor_sync(full, l_all, o);
#pragma unroll
  for (int c = 0; c < DV; ++c) {
    float a = acc[c] * f;
#pragma unroll
    for (int o = 1; o < SUB; o <<= 1) a += __shfl_xor_sync(full, a, o);
    acc[c] = a;
  }
  if (!row_ok) return;
  const float inv = 1.f / l_all;
  float* op = out + b * st.ob + h * st.oh + i * st.ot + v0;
#pragma unroll
  for (int c = 0; c < DV; ++c)
    if (c / (DV / SUB) == sub) op[c] = acc[c] * inv;
  if (sub == 0 && blockIdx.z == 0)
    lse[(long long)bh * t_len + i] = m_all + logf(l_all);
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

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out,
                       void* lse, const Strides& st, int batch, int heads,
                       int t_len, int prefix, float scale, int is_bf16,
                       cudaStream_t s, int nc = 1) {
  if (is_bf16 && nc > 1) {
    using bf = __nv_bfloat16;
    const dim3 grid(batch * heads, (t_len + MQ - 1) / MQ, 256 * nc / PW);
    return launch_big(flash_fwd_kernel_bf16_wide, grid, MT, wide_fwd_smem(),
                      s, static_cast<const bf*>(q), static_cast<const bf*>(k),
                      static_cast<const bf*>(v), static_cast<bf*>(out),
                      static_cast<float*>(lse), st, heads, t_len, prefix,
                      scale, nc);
  }
  if (is_bf16) {
    using bf = __nv_bfloat16;
    const dim3 grid(batch * heads, (t_len + MQ - 1) / MQ);
    return launch_big(flash_fwd_kernel_bf16<D>, grid, MT,
                      fwd_dynamic_smem<D>(), s,
                      static_cast<const bf*>(q), static_cast<const bf*>(k),
                      static_cast<const bf*>(v), static_cast<bf*>(out),
                      static_cast<float*>(lse), st, heads, t_len, prefix,
                      scale);
  }
  const float *qf = static_cast<const float*>(q),
              *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v);
  float *of = static_cast<float*>(out), *lf = static_cast<float*>(lse);
  if (nc > 1) {
    const dim3 grid((t_len + BQ - 1) / BQ, batch * heads,
                    D * nc / fwd_f32_cols<D, true>());
    return launch_big(flash_fwd_kernel<D, true>, grid, NT,
                      fwd_f32_smem<D, true>(), s, qf, kf, vf, of, lf, st,
                      heads, t_len, prefix, scale, nc);
  }
  const dim3 grid((t_len + BQ - 1) / BQ, batch * heads,
                  D / fwd_f32_cols<D, false>());
  return launch_big(flash_fwd_kernel<D, false>, grid, NT,
                    fwd_f32_smem<D, false>(), s, qf, kf, vf, of, lf, st,
                    heads, t_len, prefix, scale, 1);
}

}  // namespace

// head_dim 64, 128 or a multiple of 256; scale = 1 / sqrt(d) of the true
// head dim d
// (bf16: rounded to bf16 by the caller)
extern "C" int mas_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, const long long* strides,
                             int batch, int heads, int t_len, int prefix,
                             int head_dim, float scale, int is_bf16,
                             void* stream) {
  Strides st;
  st.qb = strides[0]; st.qh = strides[1]; st.qt = strides[2];
  st.kb = strides[3]; st.kh = strides[4]; st.kt = strides[5];
  st.vb = strides[6]; st.vh = strides[7]; st.vt = strides[8];
  st.ob = strides[9]; st.oh = strides[10]; st.ot = strides[11];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (head_dim == 64) {
    err = launch_fwd<64>(q, k, v, out, lse, st, batch, heads, t_len, prefix,
                         scale, is_bf16, s);
  } else if (head_dim == 128) {
    err = launch_fwd<128>(q, k, v, out, lse, st, batch, heads, t_len, prefix,
                          scale, is_bf16, s);
  } else if (head_dim >= 256 && head_dim % 256 == 0) {
    err = launch_fwd<256>(q, k, v, out, lse, st, batch, heads, t_len, prefix,
                          scale, is_bf16, s, head_dim / 256);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* mas_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
