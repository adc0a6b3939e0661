// LayerNorm over the last axis, forward and backward (kernel B7).
//
// Replaces: mas_tpu/ops/pallas/layer_norm.py::_fwd_kernel and _bwd_kernel
// (launched by _ln_fwd_pallas / _ln_bwd_pallas), the opt-in
// layernorm_impl "pallas" LayerNorm of the transformer.
//
// Computes, for rows x [N, d] (bf16 or fp32, contiguous) with fp32 scale w
// and bias b [d]:
//   mean = sum x / d,  rstd = rsqrt(sum (x - mean)^2 / d + eps)  (fp32,
//   two passes over registers),  x^ = (x - mean) rstd
//   forward:  y = x^ w + b, rounded once to x's dtype
//   backward: from x and the output gradient g (nothing saved but x),
//             dx = rstd (g w - mean(g w) - x^ mean(g w x^)) in x's dtype,
//             dscale = sum_rows g x^, dbias = sum_rows g in fp32.
//
// What bounds it on the H100: bytes.  At the train step's [11264, 1024]
// bf16 the forward reads and writes 23 MB each, the backward reads x and g
// and writes dx (69 MB), with ~10 flops per element in between.  The step
// that calls it waits for the host, so each launch's host time counts too.
// The forward also serves every LayerNorm of sampling: a decode step's
// [768, 1024] (3 MB, shorter than a launch) and a prefill's [294912,
// 1024].  There, two warps a row took 5% less time at the largest shape
// and one warp a row 1% more; four warps a row were the fastest at the
// decode rows, so every row count keeps the geometry below.
//
// What the design does about it:
// - A row sits in registers, at most 32 values a thread: up to d = 32 E
//   (E = 16 bytes of values: 8 bf16, 4 fp32) one warp a row and four rows
//   a block; up to 128 E a block of four warps a row, one 16-byte vector
//   a thread; above, eight warps a row, 1 to 8 vectors a thread (d <=
//   8192).  Thread t's j-th vector is elements [(TPR j + t) E, +E) of the
//   row (TPR threads a row), so loads and stores are contiguous across
//   the threads, and so are the scale and bias (float4 loads).  A d that
//   is not a multiple of E (rows not 16-byte aligned) takes element loads;
//   values past d are zero and masked out of the sums.  Sums are shuffle
//   reductions over the warp, then, with several warps a row, over shared
//   memory in warp order.
// - Forward: one launch, one read and one write of each element.
// - Backward: one launch.  A block owns a fixed run of BWD_ROWS = 24 rows
//   (the run depends on N only: at the train step's 11,264 rows that is
//   470 blocks, one wave at four blocks of 128 threads an SM; a run of 64
//   gave 176 blocks, each walking its rows one after another, and took
//   twice as long as the Triton kernels this replaced).  The raw x and g of the next P rows (four
//   16-byte vectors a thread in all, below four vectors a row) are loaded
//   while a row's dx is computed: with one row in flight each block
//   waited on every row's loads.  With several warps a row, each of a row's three reductions
//   takes one barrier (row_sum).  Each thread keeps its columns' sums of
//   g x^ and g over the block's rows; with four rows a block the warps
//   combine them in shared memory in warp order, and the block writes one
//   [2, d] fp32 partial.  The partials are summed in two levels of about
//   sqrt(blocks) rows each, in index order: the last block of a group of
//   blocks to finish sums its group's partials, and the last group to
//   finish sums the group sums into dscale and dbias (two float4 columns
//   a thread, four rows' loads in flight).  "Last" comes from a ticket
//   counter in device memory, taken after __threadfence() and reset to 0
//   by the block that draws the last ticket; the host keeps one set of
//   counters per device and stream (ops/layer_norm.py).  No atomic
//   touches a sum, so two calls give equal bits.
// - The host reaches both through ctypes with a plain C interface.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BWD_ROWS = 24;     // rows a backward block owns
constexpr int MAX_GROUPS = 1024; // ticket counters of the first level
constexpr int SMALL_WARPS = 4;   // warps a block of warp-wide rows
constexpr int WIDE_WARPS = 8;    // warps a row above 128 E values

__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// two fp32 values rounded to one bf16 pair, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// Geometry: T the element type, NV vectors of E values a thread, WPR warps
// a row.
template <typename T, int NV, int WPR>
struct Geo {
  static constexpr int E = 16 / static_cast<int>(sizeof(T));
  static constexpr int VPT = NV * E;   // values a thread
  static constexpr int TPR = 32 * WPR; // threads a row
  static constexpr int WARPS = WPR == 1 ? SMALL_WARPS : WPR;
  static constexpr int NT = 32 * WARPS;
  static constexpr int ROWS_AT_ONCE = WARPS / WPR;
  // the backward's blocks an SM: four of 128 threads (<= 128 registers)
  static constexpr int MIN_BLOCKS = NT == 128 ? 4 : 1;
};

// the thread's NV vectors of a row as raw 16-byte words (zeros past d); t:
// its index in the row
template <typename T, int NV, int WPR>
__device__ __forceinline__ void load_raw(const T* row, int d, int t,
                                         bool vec, uint4 (&r)[NV]) {
  using G = Geo<T, NV, WPR>;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c0 = (j * G::TPR + t) * G::E;
    if (vec && c0 + G::E <= d) {
      r[j] = *reinterpret_cast<const uint4*>(row + c0);
    } else {
      uint32_t u[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int e = 0; e < G::E; ++e) {
        if (c0 + e < d) {
          if constexpr (sizeof(T) == 2)
            u[e / 2] |= static_cast<uint32_t>(
                            reinterpret_cast<const uint16_t*>(row)[c0 + e])
                        << (16 * (e % 2));
          else
            u[e] = reinterpret_cast<const uint32_t*>(row)[c0 + e];
        }
      }
      r[j] = make_uint4(u[0], u[1], u[2], u[3]);
    }
  }
}

// raw words -> VPT floats
template <typename T, int NV>
__device__ __forceinline__ void unpack_row(const uint4 (&r)[NV], float* v) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const uint32_t u[4] = {r[j].x, r[j].y, r[j].z, r[j].w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (sizeof(T) == 2) {   // bf16 -> fp32 is exact
        v[j * E + 2 * i] = __uint_as_float(u[i] << 16);
        v[j * E + 2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
      } else {
        v[j * E + i] = __uint_as_float(u[i]);
      }
    }
  }
}

// the thread's VPT values of a row (zeros past d)
template <typename T, int NV, int WPR>
__device__ __forceinline__ void load_row(const T* row, int d, int t,
                                         bool vec, float* v) {
  uint4 r[NV];
  load_raw<T, NV, WPR>(row, d, t, vec, r);
  unpack_row<T, NV>(r, v);
}

// store the thread's VPT values (rounded to T) at their columns < d
template <typename T, int NV, int WPR>
__device__ __forceinline__ void store_row(T* row, int d, int t, bool vec,
                                          const float* v) {
  using G = Geo<T, NV, WPR>;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c0 = (j * G::TPR + t) * G::E;
    if (vec && c0 + G::E <= d) {
      uint32_t u[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (sizeof(T) == 2)
          u[i] = pack_bf16(v[j * G::E + 2 * i], v[j * G::E + 2 * i + 1]);
        else
          u[i] = __float_as_uint(v[j * G::E + i]);
      }
      *reinterpret_cast<uint4*>(row + c0) = make_uint4(u[0], u[1], u[2], u[3]);
    } else {
#pragma unroll
      for (int e = 0; e < G::E; ++e)
        if (c0 + e < d) store_f(row + c0 + e, v[j * G::E + e]);
    }
  }
}

// the thread's VPT values of an fp32 [d] vector (zeros past d)
template <typename T, int NV, int WPR>
__device__ __forceinline__ void load_param(const float* p, int d, int t,
                                           float* v) {
  using G = Geo<T, NV, WPR>;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c0 = (j * G::TPR + t) * G::E;
    if (d % 4 == 0 && c0 + G::E <= d) {
#pragma unroll
      for (int i = 0; i < G::E / 4; ++i) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(p + c0) + i);
        v[j * G::E + 4 * i] = a.x;
        v[j * G::E + 4 * i + 1] = a.y;
        v[j * G::E + 4 * i + 2] = a.z;
        v[j * G::E + 4 * i + 3] = a.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < G::E; ++e)
        v[j * G::E + e] = c0 + e < d ? __ldg(p + c0 + e) : 0.f;
    }
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// v[0 .. N) each summed over the threads of one row.  With several warps a
// row, the warps' sums go through buf, one of three [N][WPR] shared
// buffers that the calls for a row take in turn: one barrier a call, and a
// buffer is written again only after two more barriers, when every warp
// has read it.
template <int WPR, int N>
__device__ __forceinline__ void row_sum(float (&v)[N], float* buf) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = warp_sum(v[i]);
  if constexpr (WPR > 1) {
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) {
#pragma unroll
      for (int i = 0; i < N; ++i) buf[i * WPR + warp] = v[i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < N; ++i) {
      v[i] = 0.f;
#pragma unroll
      for (int w = 0; w < WPR; ++w) v[i] += buf[i * WPR + w];
    }
  }
}

// mean and rstd of the row whose values (zeros past d) the thread holds;
// red: the three row_sum buffers (the first two taken here)
template <typename T, int NV, int WPR>
__device__ __forceinline__ void row_stats(const float* v, int d, int t,
                                          float eps, float* red, float& mean,
                                          float& rstd) {
  using G = Geo<T, NV, WPR>;
  float s[1] = {0.f};
#pragma unroll
  for (int i = 0; i < G::VPT; ++i) s[0] += v[i];
  row_sum<WPR, 1>(s, red);
  mean = s[0] / static_cast<float>(d);
  float q[1] = {0.f};
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < G::E; ++e) {
      const int c = (j * G::TPR + t) * G::E + e;
      const float xc = v[j * G::E + e] - mean;
      q[0] += c < d ? xc * xc : 0.f;
    }
  row_sum<WPR, 1>(q, red + 2 * WPR);
  rstd = rsqrtf(q[0] / static_cast<float>(d) + eps);
}

template <typename T, int NV, int WPR>
__global__ void __launch_bounds__(Geo<T, NV, WPR>::NT)
layer_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ b, T* __restrict__ y, int n,
                      int d, float eps) {
  using G = Geo<T, NV, WPR>;
  __shared__ float red[3 * 2 * WPR];
  const int t = threadIdx.x % G::TPR;
  const long long row =
      (long long)blockIdx.x * G::ROWS_AT_ONCE + threadIdx.x / G::TPR;
  if (row >= n) return;   // whole rows: with WPR > 1 a block is one row
  const bool vec = d % G::E == 0;
  float v[G::VPT];
  load_row<T, NV, WPR>(x + row * d, d, t, vec, v);
  float mean, rstd;
  row_stats<T, NV, WPR>(v, d, t, eps, red, mean, rstd);
  float wv[G::VPT], bv[G::VPT];
  load_param<T, NV, WPR>(w, d, t, wv);
  load_param<T, NV, WPR>(b, d, t, bv);
#pragma unroll
  for (int i = 0; i < G::VPT; ++i) v[i] = (v[i] - mean) * rstd * wv[i] + bv[i];
  store_row<T, NV, WPR>(y + row * d, d, t, vec, v);
}

// The block that draws the last of `total` tickets from *counter (one per
// block taking part) gets true, after every block's writes before the call
// are visible to it; it resets the counter to 0 for the next launch.
__device__ __forceinline__ bool last_ticket(unsigned* counter,
                                            unsigned total) {
  __shared__ bool last;
  __threadfence();   // this thread's writes reach device scope first
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1u) == total - 1;
    if (last) atomicExch(counter, 0u);
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// dst[c] = sum over rows r in [r0, r1), in order, of src[r * stride + c],
// c < width (fp32 rows written by other blocks: read past L1).  A thread
// takes two float4 columns and loads four rows of them (eight float4)
// before it adds any; width and stride multiples of 4, src 16-byte
// aligned.
__device__ __forceinline__ void sum_rows4(const float* src, int r0, int r1,
                                          int stride, int width, float* dst) {
  constexpr int K = 2, Q = 4;   // columns a thread, rows a batch
  const int w4 = width / 4, s4 = stride / 4;
  const float4* p = reinterpret_cast<const float4*>(src);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = threadIdx.x; c0 < w4; c0 += K * blockDim.x) {
    float4 acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = zero;
    for (int r = r0; r < r1; r += Q) {
      float4 a[Q][K];
#pragma unroll
      for (int q = 0; q < Q; ++q)
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int c = c0 + k * blockDim.x;
          a[q][k] = r + q < r1 && c < w4
                        ? __ldcg(p + (long long)(r + q) * s4 + c)
                        : zero;
        }
#pragma unroll
      for (int q = 0; q < Q; ++q)
#pragma unroll
        for (int k = 0; k < K; ++k) {
          acc[k].x += a[q][k].x;
          acc[k].y += a[q][k].y;
          acc[k].z += a[q][k].z;
          acc[k].w += a[q][k].w;
        }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = c0 + k * blockDim.x;
      if (c < w4) reinterpret_cast<float4*>(dst)[c] = acc[k];
    }
  }
}

// the same for any width and stride, element by element
__device__ __forceinline__ void sum_rows1(const float* src, int r0, int r1,
                                          int stride, int width, float* dst) {
  for (int c = threadIdx.x; c < width; c += blockDim.x) {
    float acc = 0.f;
#pragma unroll 4
    for (int r = r0; r < r1; ++r)
      acc += __ldcg(src + (long long)r * stride + c);
    dst[c] = acc;
  }
}

template <typename T, int NV, int WPR>
__global__ void __launch_bounds__(Geo<T, NV, WPR>::NT,
                                  Geo<T, NV, WPR>::MIN_BLOCKS)
layer_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                      const float* __restrict__ w, T* __restrict__ dx,
                      float* __restrict__ part, unsigned* __restrict__ tickets,
                      float* __restrict__ dscale, float* __restrict__ dbias,
                      int n, int d, float eps, int group_blocks,
                      int n_groups) {
  using G = Geo<T, NV, WPR>;
  constexpr int VPT = G::VPT;
  // rows whose raw x and g are in flight: four vectors' worth a thread;
  // none ahead from four vectors on (32 values a thread), whose registers
  // hold a row's x, g and sums and spilled with one more row beside them
  constexpr int P = NV >= 4 ? 0 : 4 / NV;
  constexpr int COVER = G::TPR * VPT;   // columns a row's threads hold
  __shared__ float red[3 * 2 * WPR];
  // WPR = 1: the warps' column sums [warp][g x^ | g][column], combined in
  // warp order
  __shared__ float cols[WPR == 1 ? G::WARPS * 2 * COVER : 1];
  const int t = threadIdx.x % G::TPR;
  const int sub = threadIdx.x / G::TPR;   // the thread's row slot
  const bool vec = d % G::E == 0;
  float wv[VPT];
  load_param<T, NV, WPR>(w, d, t, wv);
  float acc_gx[VPT], acc_g[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) acc_gx[i] = acc_g[i] = 0.f;

  // this thread's rows: first, first + ROWS_AT_ONCE, ... below r_end; the
  // raw x and g of the next P of them are in flight
  const int first = blockIdx.x * BWD_ROWS + sub;
  const int r_end = min(n, (blockIdx.x + 1) * BWD_ROWS);
  const int rows = r_end > first ? (r_end - first - 1) / G::ROWS_AT_ONCE + 1
                                 : 0;
  uint4 rx[P > 0 ? P : 1][NV], rg[P > 0 ? P : 1][NV];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    if (k < rows) {
      const long long off = (long long)(first + k * G::ROWS_AT_ONCE) * d;
      load_raw<T, NV, WPR>(x + off, d, t, vec, rx[k]);
      load_raw<T, NV, WPR>(g + off, d, t, vec, rg[k]);
    }
  }
  constexpr int STEP = P > 0 ? P : 1;
  for (int i0 = 0; i0 < rows; i0 += STEP) {
#pragma unroll
    for (int k = 0; k < STEP; ++k) {
      const int i = i0 + k;
      if (i < rows) {
        const long long row = first + i * G::ROWS_AT_ONCE;
        float xv[VPT], gv[VPT];
        if constexpr (P == 0) {
          load_row<T, NV, WPR>(x + row * d, d, t, vec, xv);
          load_row<T, NV, WPR>(g + row * d, d, t, vec, gv);
        } else {
          unpack_row<T, NV>(rx[k], xv);
          unpack_row<T, NV>(rg[k], gv);
          if (i + P < rows) {
            const long long off =
                (long long)(first + (i + P) * G::ROWS_AT_ONCE) * d;
            load_raw<T, NV, WPR>(x + off, d, t, vec, rx[k]);
            load_raw<T, NV, WPR>(g + off, d, t, vec, rg[k]);
          }
        }
        float mean, rstd;
        row_stats<T, NV, WPR>(xv, d, t, eps, red, mean, rstd);
        float m[2] = {0.f, 0.f};   // mean(g w), mean(g w x^)
#pragma unroll
        for (int v = 0; v < VPT; ++v) {
          xv[v] = (xv[v] - mean) * rstd;   // x^ (any value past d: g is 0)
          const float gs = gv[v] * wv[v];
          m[0] += gs;
          m[1] += gs * xv[v];
        }
        row_sum<WPR, 2>(m, red + 4 * WPR);
        const float m1 = m[0] / static_cast<float>(d);
        const float m2 = m[1] / static_cast<float>(d);
#pragma unroll
        for (int v = 0; v < VPT; ++v) {
          const float gs = gv[v] * wv[v];
          acc_gx[v] += gv[v] * xv[v];
          acc_g[v] += gv[v];
          xv[v] = rstd * (gs - m1 - xv[v] * m2);
        }
        store_row<T, NV, WPR>(dx + row * d, d, t, vec, xv);
      }
    }
  }

  // this block's [2, d] partial: row blockIdx.x of part
  float* mine = part + (long long)blockIdx.x * 2 * d;
  if constexpr (WPR == 1) {
    const int warp = threadIdx.x / 32;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = ((i / G::E) * 32 + t) * G::E + i % G::E;
      cols[(warp * 2) * COVER + c] = acc_gx[i];
      cols[(warp * 2 + 1) * COVER + c] = acc_g[i];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < d; c += G::NT) {
      float sx = 0.f, sg = 0.f;
#pragma unroll
      for (int wp = 0; wp < G::WARPS; ++wp) {
        sx += cols[(wp * 2) * COVER + c];
        sg += cols[(wp * 2 + 1) * COVER + c];
      }
      mine[c] = sx;
      mine[d + c] = sg;
    }
  } else {
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < G::E; ++e) {
        const int c = (j * G::TPR + t) * G::E + e;
        if (c < d) {
          mine[c] = acc_gx[j * G::E + e];
          mine[d + c] = acc_g[j * G::E + e];
        }
      }
  }

  // level 1: the last block of this group sums the group's partials into
  // its group row (rows [gridDim.x, gridDim.x + n_groups) of part)
  const int grp = blockIdx.x / group_blocks;
  const int first_block = grp * group_blocks;
  const int last_block = min(first_block + group_blocks, (int)gridDim.x);
  if (!last_ticket(tickets + grp, last_block - first_block)) return;
  float* group_rows = part + (long long)gridDim.x * 2 * d;
  float* mine_group = group_rows + (long long)grp * 2 * d;
  if (d % 2 == 0)
    sum_rows4(part, first_block, last_block, 2 * d, 2 * d, mine_group);
  else
    sum_rows1(part, first_block, last_block, 2 * d, 2 * d, mine_group);
  // level 2: the last group sums the group rows' halves into dscale, dbias
  if (!last_ticket(tickets + n_groups, n_groups)) return;
  if (d % 4 == 0) {
    sum_rows4(group_rows, 0, n_groups, 2 * d, d, dscale);
    sum_rows4(group_rows + d, 0, n_groups, 2 * d, d, dbias);
  } else {
    sum_rows1(group_rows, 0, n_groups, 2 * d, d, dscale);
    sum_rows1(group_rows + d, 0, n_groups, 2 * d, d, dbias);
  }
}

struct Args {
  const void *x, *g, *w, *b;
  void *y, *part, *tickets, *dscale, *dbias;
  int n, d;
  float eps;
  int group_blocks, n_groups;
  cudaStream_t s;
};

// The backward's reduction geometry for n rows, which depends on n alone:
// blocks of BWD_ROWS rows, and groups of group_blocks blocks whose last
// block sums the group: about sqrt(blocks) rows at each level, at most
// MAX_GROUPS groups.
struct Grid {
  int blocks, group_blocks, n_groups;
};

Grid bwd_grid(int n) {
  Grid r;
  r.blocks = (n + BWD_ROWS - 1) / BWD_ROWS;
  int root = 1;   // the least root with root * root >= blocks
  while ((long long)root * root < r.blocks) ++root;
  const int capped = (r.blocks + MAX_GROUPS - 1) / MAX_GROUPS;
  r.group_blocks = root > capped ? root : capped;
  r.n_groups = (r.blocks + r.group_blocks - 1) / r.group_blocks;
  return r;
}

template <typename T, int NV, int WPR>
cudaError_t launch(const Args& a, int bwd) {
  using G = Geo<T, NV, WPR>;
  if (bwd) {
    layer_norm_bwd_kernel<T, NV, WPR>
        <<<(a.n + BWD_ROWS - 1) / BWD_ROWS, G::NT, 0, a.s>>>(
            static_cast<const T*>(a.x), static_cast<const T*>(a.g),
            static_cast<const float*>(a.w), static_cast<T*>(a.y),
            static_cast<float*>(a.part), static_cast<unsigned*>(a.tickets),
            static_cast<float*>(a.dscale), static_cast<float*>(a.dbias), a.n,
            a.d, a.eps, a.group_blocks, a.n_groups);
  } else {
    layer_norm_fwd_kernel<T, NV, WPR>
        <<<(a.n + G::ROWS_AT_ONCE - 1) / G::ROWS_AT_ONCE, G::NT, 0, a.s>>>(
            static_cast<const T*>(a.x), static_cast<const float*>(a.w),
            static_cast<const float*>(a.b), static_cast<T*>(a.y), a.n, a.d,
            a.eps);
  }
  return cudaGetLastError();
}

// the instance for d: a warp a row up to d = 32 E, four warps a row (one
// vector a thread) up to 128 E, eight warps a row above, with NV the least
// power of two of vectors a thread that covers the row
template <typename T>
cudaError_t dispatch(const Args& a, int bwd) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  if (a.d <= 32 * E) return launch<T, 1, 1>(a, bwd);
  if (a.d <= 128 * E) return launch<T, 1, 4>(a, bwd);
  const int nv = (a.d + 32 * WIDE_WARPS * E - 1) / (32 * WIDE_WARPS * E);
  if (nv <= 1) return launch<T, 1, WIDE_WARPS>(a, bwd);
  if (nv <= 2) return launch<T, 2, WIDE_WARPS>(a, bwd);
  if (nv <= 4) return launch<T, 4, WIDE_WARPS>(a, bwd);
  if constexpr (E == 4) {   // fp32: 32 values a thread at eight vectors
    if (nv <= 8) return launch<T, 8, WIDE_WARPS>(a, bwd);
  }
  return cudaErrorInvalidValue;
}

cudaError_t run(const Args& a, int bwd, int is_bf16) {
  if (a.n < 1 || a.d < 1 || a.d > 32 * WIDE_WARPS * 32)
    return cudaErrorInvalidValue;
  return is_bf16 ? dispatch<__nv_bfloat16>(a, bwd) : dispatch<float>(a, bwd);
}

}  // namespace

// Forward: x, y [n, d] contiguous bf16 (is_bf16 = 1) or fp32, d <= 8192;
// w, b fp32 [d].
extern "C" int mas_layer_norm_fwd(const void* x, const void* w, const void* b,
                                  void* y, int n, int d, float eps,
                                  int is_bf16, void* stream) {
  Args a = {};
  a.x = x; a.w = w; a.b = b; a.y = y;
  a.n = n; a.d = d; a.eps = eps;
  a.s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(run(a, 0, is_bf16));
}

// Scratch of the backward for n rows of d values: the fp32 partials, one
// [2, d] row a block and a group.
extern "C" long long mas_layer_norm_bwd_scratch(int n, int d) {
  const Grid r = bwd_grid(n);
  return ((long long)r.blocks + r.n_groups) * 2 * d;
}

// Ticket counters the backward takes: one a group and one for the groups.
extern "C" int mas_layer_norm_bwd_tickets() { return MAX_GROUPS + 1; }

// Backward: x, g, dx [n, d] as the forward's x; w fp32 [d]; part fp32
// scratch of mas_layer_norm_bwd_scratch(n, d) values; tickets:
// mas_layer_norm_bwd_tickets() zeroed uint32 counters, left zeroed (the
// launches that share them must run one after another); dscale, dbias fp32
// [d].
extern "C" int mas_layer_norm_bwd(const void* x, const void* g, const void* w,
                                  void* dx, void* part, void* tickets,
                                  void* dscale, void* dbias, int n, int d,
                                  float eps, int is_bf16, void* stream) {
  const Grid r = bwd_grid(n);
  Args a = {};
  a.x = x; a.g = g; a.w = w; a.y = dx; a.part = part; a.tickets = tickets;
  a.dscale = dscale; a.dbias = dbias;
  a.n = n; a.d = d; a.eps = eps;
  a.group_blocks = r.group_blocks; a.n_groups = r.n_groups;
  a.s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(run(a, 1, is_bf16));
}
