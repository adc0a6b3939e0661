// Nearest codebook entry per latent row (kernel B5).
//
// Replaces: mas_tpu/ops/vq.py::_vq_kernel (launched by _vq_argmin_pallas),
// the fused distance + argmin of vector quantization.
//
// Computes, for z [N, D] and a codebook [K, D] (both fp32, or both bf16
// widened to fp32 in registers) with cb_sq[k] = ||e_k||^2 given in fp32:
//   idx[n] = argmin_k (cb_sq[k] - 2 z_n . e_k)
// ||z_n||^2 is the same for every k and is left out, as in the Pallas
// kernel.  The [N, K] distance matrix never reaches device memory.  On equal
// distances the lower index wins, as jnp.argmin's first-index rule.
//
// What bounds it on the H100: fp32 FMA throughput at tokenization size
// (N = 8192 latents of 8 images at 512^2, K = 8192, D = 256: 34 GFLOP);
// launch latency at seg training size (N = 512, K = 1024).
//
// What the design does about it: one block of 256 threads per tile of 64
// latent rows stages the tile in shared memory once, then streams the
// codebook through shared memory in tiles of 64 codes.  With D = 256 both
// tiles take 128 KB, so the kernel asks for dynamic shared memory above
// 48 KB.  Rows are padded by one float so the 16 threads that read 16
// different codes at one d hit 16 different banks.  Each thread holds a
// 4 x 4 register tile of fp32 dot products (rows ty + 16 i, codes tx + 16 j)
// and a running (min, argmin) per row; the 16 threads of a row merge theirs
// through shuffles at the end.  The tensor cores are not used: TF32 keeps
// about three decimal digits and would flip near-ties against the fp32
// reference; a 3xTF32 or wgmma design is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BN = 64;   // latent rows per block
constexpr int BK = 64;   // codes per shared-memory tile
constexpr int TX = 16;   // threads along codes
constexpr int TY = 16;   // threads along rows
constexpr int TM = BN / TY;
constexpr int TN = BK / TX;
constexpr int NT = TX * TY;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// (d, i) beats (best, bi): smaller distance, or equal and lower index
__device__ __forceinline__ bool better(float d, int i, float best, int bi) {
  return d < best || (d == best && i < bi);
}

template <typename T>
__global__ void __launch_bounds__(NT)
vq_argmin_kernel(const T* __restrict__ z, const T* __restrict__ cb,
                 const float* __restrict__ cb_sq, int* __restrict__ out,
                 int n, int k_len, int d_len) {
  extern __shared__ float smem[];
  const int ld = d_len + 1;
  float* zs = smem;            // [BN][ld]
  float* cs = smem + BN * ld;  // [BK][ld]
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int n0 = blockIdx.x * BN;

  for (int r = 0; r < BN; ++r) {
    const int row = n0 + r;
    for (int d = tid; d < d_len; d += NT)
      zs[r * ld + d] = row < n ? to_f(z[(long long)row * d_len + d]) : 0.f;
  }

  float best[TM];
  int bidx[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    best[i] = INFINITY;
    bidx[i] = 0;
  }

  for (int k0 = 0; k0 < k_len; k0 += BK) {
    __syncthreads();  // the previous codebook tile is consumed
    for (int r = 0; r < BK; ++r) {
      const int code = k0 + r;
      for (int d = tid; d < d_len; d += NT)
        cs[r * ld + d] =
            code < k_len ? to_f(cb[(long long)code * d_len + d]) : 0.f;
    }
    __syncthreads();

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    for (int d = 0; d < d_len; ++d) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = zs[(ty + TY * i) * ld + d];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = cs[(tx + TX * j) * ld + d];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }

    // codes in increasing order: a strict < keeps the first of equal ones
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int code = k0 + tx + TX * j;
      if (code < k_len) {
        const float e = cb_sq[code];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float dist = e - 2.f * acc[i][j];
          if (dist < best[i]) {
            best[i] = dist;
            bidx[i] = code;
          }
        }
      }
    }
  }

  // merge the TX threads of each row (16 neighbouring lanes of one warp)
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int o = 1; o < TX; o <<= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[i], o);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx[i], o);
      if (better(ob, oi, best[i], bidx[i])) {
        best[i] = ob;
        bidx[i] = oi;
      }
    }
    const int row = n0 + ty + TY * i;
    if (tx == 0 && row < n) out[row] = bidx[i];
  }
}

template <typename T>
int launch(const void* z, const void* cb, const void* cb_sq, void* out,
           int n, int k_len, int d_len, cudaStream_t s) {
  const size_t smem = sizeof(float) * (BN + BK) * (d_len + 1);
  cudaError_t err = cudaFuncSetAttribute(
      vq_argmin_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + BN - 1) / BN);
  vq_argmin_kernel<T><<<grid, NT, smem, s>>>(
      static_cast<const T*>(z), static_cast<const T*>(cb),
      static_cast<const float*>(cb_sq), static_cast<int*>(out), n, k_len,
      d_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mas_vq_argmin(const void* z, const void* cb, const void* cb_sq,
                             void* out, int n, int k_len, int d_len,
                             int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(z, cb, cb_sq, out, n, k_len, d_len, s);
  return launch<float>(z, cb, cb_sq, out, n, k_len, d_len, s);
}
