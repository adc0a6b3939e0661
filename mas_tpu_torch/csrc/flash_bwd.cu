// Prefix-bidirectional causal attention backward (kernel B6).
//
// Replaces: mas_tpu/ops/attention.py::_bwd_dkv_kernel and _bwd_dq_kernel
// (launched by _flash_bwd), the Pallas flash-attention backward of the
// transformer train step.
//
// Computes, from q, k, v, out, dout [B, H, T, 64] (bf16 or fp32) and the
// forward's lse [B, H, T] (fp32, kernel B1), with q pre-scaled by
// scale = 1/sqrt(64) as in the forward:
//   P  = exp(q k^T scale - lse), masked: row i sees keys [0, bound) with
//        bound = prefix for i < prefix, else i + 1
//   dV = P^T dO     dP = dO V^T     delta = rowsum(dO * O)
//   dS = P * (dP - delta)    dQ = dS K scale    dK = dS^T Q scale
// and writes dQ, dK, dV in q's dtype into one [B, T, 3, H, 64] buffer, the
// layout of the fused qkv projection's output, so its gradient needs no
// concatenation.
//
// What bounds it on the H100: at the training shape (T = 1408, prefix 384)
// the work is O(T^2 d) multiply-adds per (b, h) against O(T d) bytes, so it
// is compute bound.  This first version runs the products on the fp32 CUDA
// cores, not the tensor cores (wgmma comes later).
//
// What the design does about it: the standard split into two kernels, so no
// block needs atomics and the result does not depend on launch order, plus a
// small pre-pass:
//   1. delta: one warp per row, delta = rowsum(dO * O) in fp32, computed once
//      and read by both kernels (not once per (q-tile, k-tile) pair);
//   2. dK/dV: one block per (b*h, 64-key tile); k and v stay in shared memory
//      while the block loops over the q-tiles that can see the tile (from the
//      first tile when the keys meet the prefix, else from the causal start,
//      mas_tpu/ops/attention.py:391-400);
//   3. dQ: one block per (b*h, 64-row q tile); q and dO stay in shared memory
//      while the block loops over the k-tiles up to max(causal bound, prefix
//      bound) (mas_tpu/ops/attention.py:435-441), as B1 does.
// Every tile sits in shared memory as fp32 rows of 64 values with a stride of
// 68 floats.  256 threads hold a 4 x 4 register tile each of every 64 x 64
// product.  Products that reduce over the head dim (S, dP) give each thread
// the rows ty + 16a and columns tx + 16b and read both operands as 16-byte
// vectors along the head dim: with the stride of 68, the 16 rows a warp
// reads at once fall on distinct banks.  Products that reduce over rows (dV,
// dK, dQ) give each thread 4 adjacent rows and 4 adjacent columns and read
// 16-byte vectors along those.  Inputs are addressed by strides (last dim
// contiguous), so q, k, v can be views into the fused qkv projection.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int D = 64;            // head dim
constexpr int BT = 64;           // rows of a q tile, keys of a k tile
constexpr int NT = 256;          // threads per block: 16 x 16
constexpr int LD = D + 4;        // shared row stride in floats
constexpr int TILE = BT * LD;    // floats per shared tile

struct Strides {
  long long qb, qh, qt, kb, kh, kt, vb, vh, vt, ob, oh, ot, gb, gh, gt;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// dst[r][c] = src[(row0 + r) * row_stride + c] * mul, for a 64 x 64 tile
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int row0,
                                          float mul) {
  for (int idx = threadIdx.x; idx < BT * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    dst[r * LD + c] = to_f(src[(row0 + r) * row_stride + c]) * mul;
  }
}

// acc[a][b] += sum_c A[ty + 16a][c] * B[tx + 16b][c] over the head dim
__device__ __forceinline__ void mma_nt(float (&acc)[4][4], const float* a,
                                       const float* b, int ty, int tx) {
#pragma unroll 4
  for (int c = 0; c < D; c += 4) {
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

// acc[a][b] += sum_r A[r][4 ty + a] * B[r][4 tx + b] over the 64 tile rows
__device__ __forceinline__ void mma_tn(float (&acc)[4][4], const float* a,
                                       const float* b, int ty, int tx) {
#pragma unroll 8
  for (int r = 0; r < BT; ++r) {
    const float4 av = *reinterpret_cast<const float4*>(&a[r * LD + 4 * ty]);
    const float4 bv = *reinterpret_cast<const float4*>(&b[r * LD + 4 * tx]);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
  }
}

__device__ __forceinline__ int row_bound(int row, int pfx) {
  return row < pfx ? pfx : row + 1;
}

// delta[bh][i] = sum_c dO[b, h, i, c] * O[b, h, i, c]; one warp per row
template <typename T>
__global__ void __launch_bounds__(NT)
flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ delta, Strides st, int H,
                       int t_len, long long rows) {
  const long long row = (long long)blockIdx.x * (NT / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int i = static_cast<int>(row % t_len);
  const long long bh = row / t_len;
  const int b = static_cast<int>(bh / H), h = static_cast<int>(bh % H);
  const T* op = out + b * st.ob + h * st.oh + i * st.ot;
  const T* gp = dout + b * st.gb + h * st.gh + i * st.gt;
  float s = to_f(op[lane]) * to_f(gp[lane]) +
            to_f(op[lane + 32]) * to_f(gp[lane + 32]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) delta[row] = s;
}

template <typename T>
__global__ void __launch_bounds__(NT, 2)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dqkv,
                     Strides st, int H, int t_len, int prefix, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;             // K [key][c]
  float* vs = ks + TILE;        // V [key][c]
  float* qs = vs + TILE;        // Q * scale [row][c]
  float* gs = qs + TILE;        // dO [row][c]
  float* ps = gs + TILE;        // P [row][key]
  float* dss = ps + TILE;       // dS [row][key]
  __shared__ float lse_s[BT], delta_s[BT];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int pfx = min(prefix, t_len);

  const T* qp = q + b * st.qb + h * st.qh;
  const T* kp = k + b * st.kb + h * st.kh;
  const T* vp = v + b * st.vb + h * st.vh;
  const T* gp = dout + b * st.gb + h * st.gh;
  const float* lp = lse + (long long)bh * t_len;
  const float* dp_ = delta + (long long)bh * t_len;

  load_tile(ks, kp, st.kt, k0, 1.f);
  load_tile(vs, vp, st.vt, k0, 1.f);

  float dk[4][4], dv[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[i][j] = dv[i][j] = 0.f;

  // q-tiles that see a key of this tile: all when the keys meet the prefix,
  // else those from the tile holding row k0 on (rows i >= key)
  const int q_lo = k0 < pfx ? 0 : k0 / BT;
  const int nq = t_len / BT;
  for (int qi = q_lo; qi < nq; ++qi) {
    const int q0 = qi * BT;
    __syncthreads();  // the previous tile's Q, dO, P, dS are consumed
    load_tile(qs, qp, st.qt, q0, scale);
    load_tile(gs, gp, st.gt, q0, 1.f);
    if (threadIdx.x < BT) {
      lse_s[threadIdx.x] = lp[q0 + threadIdx.x];
      delta_s[threadIdx.x] = dp_[q0 + threadIdx.x];
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    mma_nt(s, qs, ks, ty, tx);   // rows ty + 16i, keys tx + 16j
    mma_nt(dp, gs, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int bound = row_bound(q0 + r, pfx);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = (k0 + c < bound) ? expf(s[i][j] - lse_s[r]) : 0.f;
        ps[r * LD + c] = p;
        dss[r * LD + c] = p * (dp[i][j] - delta_s[r]);
      }
    }
    __syncthreads();
    mma_tn(dv, ps, gs, ty, tx);   // keys 4ty + i, dims 4tx + j
    mma_tn(dk, dss, qs, ty, tx);
  }

  // dK = dS^T (Q scale) is complete: q was scaled on load
  const long long row_stride = 3LL * H * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * ty + i;
    T* base = dqkv + ((long long)b * t_len + key) * row_stride + h * D;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 4 * tx + j;
      store_f(base + H * D + c, dk[i][j]);
      store_f(base + 2 * H * D + c, dv[i][j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 2)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dqkv,
                    Strides st, int H, int t_len, int prefix, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;             // Q * scale [row][c]
  float* gs = qs + TILE;        // dO [row][c]
  float* ks = gs + TILE;        // K [key][c]
  float* vs = ks + TILE;        // V [key][c]
  float* dst = vs + TILE;       // dS^T [key][row]
  __shared__ float lse_s[BT], delta_s[BT];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int pfx = min(prefix, t_len);

  const T* kp = k + b * st.kb + h * st.kh;
  const T* vp = v + b * st.vb + h * st.vh;
  load_tile(qs, q + b * st.qb + h * st.qh, st.qt, q0, scale);
  load_tile(gs, dout + b * st.gb + h * st.gh, st.gt, q0, 1.f);
  if (threadIdx.x < BT) {
    lse_s[threadIdx.x] = lse[(long long)bh * t_len + q0 + threadIdx.x];
    delta_s[threadIdx.x] = delta[(long long)bh * t_len + q0 + threadIdx.x];
  }

  float dq[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dq[i][j] = 0.f;

  // the last k-tile any row of this q tile can see
  int hi = (q0 + BT - 1) / BT + 1;
  if (q0 < pfx) hi = max(hi, (pfx + BT - 1) / BT);
  for (int kj = 0; kj < hi; ++kj) {
    const int k0 = kj * BT;
    __syncthreads();  // the previous tile's K and dS^T are consumed
    load_tile(ks, kp, st.kt, k0, 1.f);
    load_tile(vs, vp, st.vt, k0, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    mma_nt(s, qs, ks, ty, tx);   // rows ty + 16i, keys tx + 16j
    mma_nt(dp, gs, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int bound = row_bound(q0 + r, pfx);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = (k0 + c < bound) ? expf(s[i][j] - lse_s[r]) : 0.f;
        dst[c * LD + r] = p * (dp[i][j] - delta_s[r]);
      }
    }
    __syncthreads();
    mma_tn(dq, dst, ks, ty, tx);  // rows 4ty + i, dims 4tx + j
  }

  const long long row_stride = 3LL * H * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    T* base = dqkv + ((long long)b * t_len + row) * row_stride + h * D;
#pragma unroll
    for (int j = 0; j < 4; ++j) store_f(base + 4 * tx + j, dq[i][j] * scale);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const void* lse, void* delta, void* dqkv,
           const Strides& st, int batch, int heads, int t_len, int prefix,
           cudaStream_t s) {
  const float scale = 0.125f;  // 1 / sqrt(64)
  const long long rows = (long long)batch * heads * t_len;
  const int rows_per_block = NT / 32;
  flash_bwd_delta_kernel<T><<<(rows + rows_per_block - 1) / rows_per_block,
                              NT, 0, s>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout),
      static_cast<float*>(delta), st, heads, t_len, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid(t_len / BT, batch * heads);
  const int dkv_smem = 6 * TILE * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dkv_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv_kernel<T><<<grid, NT, dkv_smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dqkv), st, heads, t_len, prefix, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int dq_smem = 5 * TILE * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dq_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<T><<<grid, NT, dq_smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dqkv), st, heads, t_len, prefix, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: (b, h, t) element strides of q, k, v, out and dout, in that
// order; delta is fp32 scratch of B * H * T values; dqkv is a contiguous
// [B, T, 3, H, 64] buffer in q's dtype.  T must be a multiple of 64.
extern "C" int mas_flash_bwd(const void* q, const void* k, const void* v,
                             const void* out, const void* dout,
                             const void* lse, void* delta, void* dqkv,
                             const long long* strides, int batch, int heads,
                             int t_len, int prefix, int is_bf16,
                             void* stream) {
  Strides st;
  st.qb = strides[0]; st.qh = strides[1]; st.qt = strides[2];
  st.kb = strides[3]; st.kh = strides[4]; st.kt = strides[5];
  st.vb = strides[6]; st.vh = strides[7]; st.vt = strides[8];
  st.ob = strides[9]; st.oh = strides[10]; st.ot = strides[11];
  st.gb = strides[12]; st.gh = strides[13]; st.gt = strides[14];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, out, dout, lse, delta, dqkv, st,
                                 batch, heads, t_len, prefix, s);
  return launch<float>(q, k, v, out, dout, lse, delta, dqkv, st, batch,
                       heads, t_len, prefix, s);
}
