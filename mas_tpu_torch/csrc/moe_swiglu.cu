// Kernel B12: the grouped SwiGLU expert product of a routed mixture of
// experts, in two launches of one template (moe_swiglu_kernel).
//
// B12 replaces no kernel of the JAX package, which has no mixture of
// experts: it was added for LFM2-MoE's feed-forward (models/hybrid.py),
// where each token's k chosen experts compute w_e W2_e (silu(x W1_e) *
// x W3_e).  Plain twin: ops/moe.py::expert_swiglu_plain.
//
// Input: the (token, slot) pairs ordered by expert on the device
// (ops/moe.py::group): order [P] int32 pair ids (pair p is token p / k,
// slot p % k), offsets [E + 1] int32 where each expert's pairs start.
//   up:   h[r] = silu(x[tok(r)] W1_e^T) * (x[tok(r)] W3_e^T), bf16, rows r
//         in expert order; W1, W3 [E, F, D]
//   down: y[order[r]] = weight[order[r]] * (h[r] W2_e^T), fp32, rows in
//         pair order; W2 [E, D, F]
// so the weighted sum over a token's k pairs is a plain reduction in a
// fixed order (no atomics: replays are bitwise equal).
//
// What bounds it on the H100: in the decode step, bytes (a b384 step
// routes 3,072 pairs over 32 experts, so every expert is touched and each
// call reads all of W1, W3 and W2: 32 x 3 x 2048 x 1792 bf16 = 705 MB a
// layer, 0.21 ms at 3.35 TB/s); in the prefill, operations (6 x 2048 x
// 1792 a pair; a 65,536-token chunk 5.8 ms at 989 TFLOP/s).
//
// What the design does about it:
// - A block computes a BM x BN tile of one expert's rows (pairs) and
//   output columns (the up launch: BN columns of W1 and of W3 together,
//   so x is read once for both), K in steps of 64 through a STAGES-deep
//   cp.async ring of swizzled tiles in shared memory; its warps run
//   mma.sync m16n8k16 (bf16 in, fp32 accumulate) on ldmatrix fragments
//   (flash_mma.cuh).  The up launch gathers its A rows by token, so the
//   permuted input is never written; the down launch reads h in place.
// - The grid covers the worst case, ceil(P / BM) + E row tiles for P
//   pairs: each block finds its expert by walking the per-expert offsets
//   on the device, and blocks past the last tile return at once.  The
//   launch shape depends on P alone, so a CUDA graph replays it.
// - Columns are the grid's fastest axis: the blocks of one row tile run
//   together and share its A rows in L2, and the row tiles of one expert
//   follow each other and share its weights there, so in the decode step
//   each weight is read from device memory about once.
// - One tile shape (TileShape) serves the decode step and the prefill:
//   the decode step's 96 pairs an expert fill a 128-row tile.
// - Given a counter buffer, the up launch's first thread also adds the
//   routing to the model's counters (pairs per expert, experts with a
//   pair, calls, the busiest expert's pairs): no launch of its own inside
//   the replayed step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace {

using flash_mma::cp_async16;
using flash_mma::swz;

constexpr int BK = 64;            // K a stage: one 128-byte row of bf16
constexpr int ROW_BYTES = 2 * BK;
constexpr int MAX_EXPERTS = 256;

struct Args {
  const __nv_bfloat16* a;   // up: x [T, K]; down: h [P, K]
  const __nv_bfloat16* w0;  // up: W1; down: W2; [E, N, K]
  const __nv_bfloat16* w1;  // up: W3
  void* out;                // up: h bf16 [P, N]; down: y fp32 [P, N]
  const float* weight;      // down: routing weights [P] by pair id
  const int* order;         // [P]
  const int* offsets;       // [E + 1]
  int* routed;              // up: counters [E + 3], or null
  int n, k, topk, experts;
};

// a tile shape: BM rows x BN columns a block, WM x WN warps
template <int BM_, int BN_, int WM_, int WN_, int STAGES_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int STAGES = STAGES_;
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int MT = BM / WM / 16;  // m16 tiles a warp
  static constexpr int NT = BN / WN / 8;   // n8 tiles a warp and matrix
  static_assert(BM % (16 * WM) == 0 && BN % (16 * WN) == 0, "warp tiles");
  static_assert(BM * 8 % THREADS == 0 && BN * 8 % THREADS == 0,
                "whole 16-byte chunks a thread");
  __host__ __device__ static constexpr int stage_bytes(int mats) {
    return (BM + mats * BN) * ROW_BYTES;
  }
};

// 128 x 128, 8 warps of 64 x 32, 3 stages (144 KB for the up launch): of
// the shapes timed on the card (64 or 128 rows, 64 or 128 columns, 2 to 4
// stages) the fastest both at a decode step's 3,072 pairs and at a
// prefill chunk's 262,144
using TileShape = Tile<128, 128, 2, 4, 3>;

// the routing's counts added to the counters [E + 3]: pairs per expert,
// experts with a pair, one call, the busiest expert's pairs
__device__ void add_counts(const Args& p, const int* offs) {
  int active = 0, most = 0;
  for (int e = 0; e < p.experts; ++e) {
    const int c = offs[e + 1] - offs[e];
    p.routed[e] += c;
    active += c > 0;
    most = max(most, c);
  }
  p.routed[p.experts] += active;
  p.routed[p.experts + 1] += 1;
  p.routed[p.experts + 2] += most;
}

__device__ __forceinline__ float silu(float v) {
  return v / (1.0f + expf(-v));
}

template <class T, bool UP>
__global__ void __launch_bounds__(T::THREADS)
    moe_swiglu_kernel(const Args p) {
  constexpr int MATS = UP ? 2 : 1;
  constexpr int BM = T::BM, BN = T::BN, MT = T::MT, NT = T::NT;
  constexpr int STAGES = T::STAGES;
  constexpr int A_BYTES = BM * ROW_BYTES, B_BYTES = BN * ROW_BYTES;
  constexpr int STAGE = T::stage_bytes(MATS);
  constexpr int RSTEP = T::THREADS / 8;  // rows a copy pass covers
  constexpr int A_CH = BM / RSTEP, B_CH = BN / RSTEP;
  const int tid = threadIdx.x;
  // the offsets in shared memory, read at once: the walk below would wait
  // on one global load an expert
  __shared__ int offs[MAX_EXPERTS + 1];
  for (int i = tid; i <= p.experts; i += T::THREADS) offs[i] = p.offsets[i];
  __syncthreads();
  if (UP && p.routed != nullptr && blockIdx.x == 0 && blockIdx.y == 0 &&
      tid == 0)
    add_counts(p, offs);

  // this block's expert and its row tile within the expert's pairs
  int e = 0, before = 0;
  for (; e < p.experts; ++e) {
    const int tiles = (offs[e + 1] - offs[e] + BM - 1) / BM;
    if (static_cast<int>(blockIdx.y) < before + tiles) break;
    before += tiles;
  }
  if (e == p.experts) return;
  const int row0 = offs[e] + (blockIdx.y - before) * BM;
  const int row_end = offs[e + 1];
  const int col0 = blockIdx.x * BN;
  const int K = p.k;

  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = flash_mma::smem_addr(smem);

  // each thread copies 16-byte chunk `chunk` of rows tid / 8 + i RSTEP
  const int chunk = tid & 7, r_copy = tid >> 3;
  const __nv_bfloat16* a_src[A_CH];
  bool a_ok[A_CH];
#pragma unroll
  for (int i = 0; i < A_CH; ++i) {
    const int r = row0 + r_copy + i * RSTEP;
    a_ok[i] = r < row_end;
    long long row = 0;
    if (a_ok[i]) row = UP ? p.order[r] / p.topk : r;
    a_src[i] = p.a + row * K + chunk * 8;
  }
  const size_t w_off =
      (static_cast<size_t>(e) * p.n + col0 + r_copy) * K + chunk * 8;

  auto load = [&](int stage, int kt) {
    const uint32_t s = base + stage * STAGE;
#pragma unroll
    for (int i = 0; i < A_CH; ++i)
      cp_async16(s + swz<BK>(r_copy + i * RSTEP, chunk), a_src[i] + kt * BK,
                 a_ok[i]);
#pragma unroll
    for (int m = 0; m < MATS; ++m) {
      const __nv_bfloat16* w = (m == 0 ? p.w0 : p.w1) + w_off + kt * BK;
#pragma unroll
      for (int i = 0; i < B_CH; ++i)
        cp_async16(s + A_BYTES + m * B_BYTES + swz<BK>(r_copy + i * RSTEP,
                                                       chunk),
                   w + static_cast<size_t>(i) * RSTEP * K, true);
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int r_warp = (warp / T::WN) * (BM / T::WM);
  const int c_warp = (warp % T::WN) * (BN / T::WN);
  float acc[MATS][MT][NT][4];
#pragma unroll
  for (int m = 0; m < MATS; ++m)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][mt][nt][c] = 0.0f;

  const int KT = K / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    flash_mma::cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    flash_mma::cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1 is free to refill
    if (kt + STAGES - 1 < KT)
      load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    flash_mma::cp_async_commit();
    const uint32_t s = base + (kt % STAGES) * STAGE;
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        flash_mma::load_a<BK>(a[mt], s, r_warp + 16 * mt, j, lane);
#pragma unroll
      for (int m = 0; m < MATS; ++m)
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t b[4];
          flash_mma::load_b_nk<BK>(b, s + A_BYTES + m * B_BYTES,
                                   c_warp + 16 * np, j, lane);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            flash_mma::mma(acc[m][mt][2 * np], a[mt], b[0], b[1]);
            flash_mma::mma(acc[m][mt][2 * np + 1], a[mt], b[2], b[3]);
          }
        }
    }
  }
  flash_mma::cp_async_wait<0>();

  // C fragments: c0, c1 at (row grp, columns 2 tig, 2 tig + 1), c2, c3 at
  // row grp + 8
  const int grp = lane >> 2, tig = lane & 3;
  const int col = col0 + c_warp + 2 * tig;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + r_warp + 16 * mt + grp + 8 * half;
      if (r >= row_end) continue;
      if constexpr (UP) {
        __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) +
                             static_cast<size_t>(r) * p.n + col;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float(&g)[4] = acc[0][mt][nt];
          const float(&u)[4] = acc[MATS - 1][mt][nt];
          *reinterpret_cast<uint32_t*>(out + 8 * nt) = flash_mma::pack_bf16(
              silu(g[2 * half]) * u[2 * half],
              silu(g[2 * half + 1]) * u[2 * half + 1]);
        }
      } else {
        const int pair = p.order[r];
        const float w = p.weight[pair];
        float* out = static_cast<float*>(p.out) +
                     static_cast<size_t>(pair) * p.n + col;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          *reinterpret_cast<float2*>(out + 8 * nt) =
              make_float2(acc[0][mt][nt][2 * half] * w,
                          acc[0][mt][nt][2 * half + 1] * w);
        }
      }
    }
}

template <class T, bool UP>
int launch(const Args& p, int pairs, cudaStream_t stream) {
  constexpr int smem = T::stage_bytes(UP ? 2 : 1) * T::STAGES;
  static bool ready = false;  // the shared-memory opt-in, once a kernel
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        moe_swiglu_kernel<T, UP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const long long rows = (pairs + T::BM - 1) / T::BM + p.experts;
  if (p.n % T::BN != 0 || p.k % BK != 0 || rows > 65535 ||
      p.experts > MAX_EXPERTS)
    return cudaErrorInvalidValue;
  const dim3 grid(p.n / T::BN, static_cast<unsigned>(rows));
  moe_swiglu_kernel<T, UP><<<grid, T::THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// One launch of B12: up (1: x, W1, W3 -> h) or down (0: h, W2 -> y); `n`
// the output columns (a multiple of 128), `k` the reduced dim (of 64),
// `topk` the pairs a token.  Returns a cudaError_t.
extern "C" int mas_moe_swiglu(const void* a, const void* w0, const void* w1,
                              void* out, const void* weight, const void* order,
                              const void* offsets, void* routed, int pairs,
                              int n, int k, int topk, int experts, int up,
                              void* stream) {
  const Args p{static_cast<const __nv_bfloat16*>(a),
               static_cast<const __nv_bfloat16*>(w0),
               static_cast<const __nv_bfloat16*>(w1),
               out,
               static_cast<const float*>(weight),
               static_cast<const int*>(order),
               static_cast<const int*>(offsets),
               static_cast<int*>(routed),
               n, k, topk, experts};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return up ? launch<TileShape, true>(p, pairs, s)
            : launch<TileShape, false>(p, pairs, s);
}
