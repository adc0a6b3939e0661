// Nearest codebook entry per latent row (kernel B5).
//
// Replaces: mas_tpu/ops/vq.py::_vq_kernel (launched by _vq_argmin_pallas),
// the fused distance + argmin of vector quantization.
//
// Computes, for z [N, D] and a codebook [K, D] (both bf16 or both fp32, any
// D), with cb_sq[k] = ||e_k||^2 in fp32:
//   idx[n] = argmin_k (cb_sq[k] - 2 z_n . e_k)
// ||z_n||^2 is the same for every k and is left out, as in the Pallas
// kernel.  The [N, K] distance matrix never reaches device memory.  On equal
// distances the lower index wins, as jnp.argmin's first-index rule.
//
// What bounds it on the H100: the products.  At tokenization size (N = 8192
// latents of 8 images at 512^2, K = 8192, D = 256, bf16) they are 34 GFLOP,
// 0.035 ms on the bf16 tensor cores; the bytes (8 MB) take 0.0025 ms.  At
// seg training size (N = 512, K = 1024, D = 256, fp32) the launches.
//
// What the design does about it:
// - cb_sq comes from a first launch, a warp per code (lanes over d in
//   order, then a shuffle tree): a fixed order per row, so equal codebook
//   rows get equal norms.
// - bf16 (vq_argmin_mma_kernel): mma.sync m16n8k16, bf16 in, fp32
//   accumulate.  A bf16 x bf16 product is exact in fp32, so the dot
//   products differ from an fp32 product of the same values in summation
//   order only.  A block of 8 warps takes 128 latent rows against a run of
//   128-code tiles; a warp holds a 64 x 32 accumulator.  (z, code) chunks
//   of 64 dims stream through a three-stage cp.async ring in
//   flash_mma.cuh's swizzled layout (ldmatrix free of bank conflicts),
//   zero-filled past N, K and D, so any D that is a multiple of 8 runs (the
//   wrapper zero-pads any other).  At the end of each code tile the
//   epilogue folds cb_sq and a running (min, argmin) per row straight from
//   the accumulator fragments, codes in increasing order with a strict <;
//   at the end the four lanes of a row and the four warps along the codes
//   merge theirs, lower index first on equal distances.
// - fp32 (vq_argmin_fp32_kernel) keeps fp32 products, on the CUDA cores:
//   a single TF32 pass keeps 10 mantissa bits and flips near-ties beyond
//   the agreement rule's 1e-5 relative scale, and at the seg shape (0.27
//   GFLOP) the launches, not the products, set the time.  A block of 256
//   threads takes 64 rows against a run of 64-code tiles, 64-dim chunks of
//   both staged in shared memory, each thread a 4 x 4 register tile of
//   fmaf chains in d order.
// - Filling the card: the codebook is split into S runs of tiles, as many
//   as make about two blocks an SM (N = 8192: 64 row blocks x 4 runs), and
//   each (row block, run) writes its rows' (min, argmin) to partials
//   [S, N]; a last launch merges the runs in order with the same rule.
//   Every code's dot product follows one summation order in any tile and
//   any run, so exact copies of a codebook row give equal distances, and
//   the merge keeps the lower index.  No atomics: two calls give equal
//   bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace {

using namespace flash_mma;

// (d, i) beats (best, bi): smaller distance, or equal and lower index
__device__ __forceinline__ bool better(float d, int i, float best, int bi) {
  return d < best || (d == best && i < bi);
}

// --- cb_sq: a warp per code -------------------------------------------------

constexpr int NORM_THREADS = 256;

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(NORM_THREADS)
vq_code_norms_kernel(const T* __restrict__ cb, float* __restrict__ cb_sq,
                     int k_len, int d_len) {
  const int code = blockIdx.x * (NORM_THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (code >= k_len) return;
  const T* row = cb + (long long)code * d_len;
  float s = 0.f;
  for (int d = lane; d < d_len; d += 32) {
    const float v = to_f(row[d]);
    s = fmaf(v, v, s);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) cb_sq[code] = s;
}

// --- bf16: tensor cores -----------------------------------------------------

constexpr int MM = 128;        // latent rows a block
constexpr int MN = 128;        // codes a tile
constexpr int MC = 64;         // dims a chunk
constexpr int MMA_THREADS = 256;
constexpr int MMA_STAGES = 3;
constexpr int CHUNK_BYTES = MM * MC * 2;              // one operand's chunk
constexpr int MMA_SMEM = MMA_STAGES * 2 * CHUNK_BYTES;   // 96 KB

// rows [row0, row0 + 128) x dims [k0, k0 + 64) of a [*, D] bf16 matrix into
// a swizzled chunk at `dst`; rows at or past `rows` and dims at or past D
// zero-filled (D a multiple of 8: a 16-byte piece is all in or all out)
__device__ __forceinline__ void load_chunk(uint32_t dst,
                                           const __nv_bfloat16* src,
                                           int d_len, int row0, int rows,
                                           int k0) {
  const unsigned tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < MM * (MC / 8) / MMA_THREADS; ++i) {
    const unsigned idx = tid + i * MMA_THREADS;
    const int r = idx / (MC / 8), c = idx % (MC / 8);
    const bool ok = row0 + r < rows && k0 + c * 8 < d_len;
    const __nv_bfloat16* g =
        src + (ok ? (long long)(row0 + r) * d_len + k0 + c * 8 : 0);
    cp_async16(dst + swz<MC>(r, c), g, ok);
  }
}

struct Job {
  const void* z;
  const void* cb;
  const float* cb_sq;
  float* part_d;    // [S, N] when S > 1
  int* part_i;
  int* out;         // [N] when S == 1
  int n, k_len, d_len, tiles_per_run;
};

__global__ void __launch_bounds__(MMA_THREADS, 2)
vq_argmin_mma_kernel(Job job) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_addr(smem);
  const __nv_bfloat16* z = static_cast<const __nv_bfloat16*>(job.z);
  const __nv_bfloat16* cb = static_cast<const __nv_bfloat16*>(job.cb);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;     // 2 along rows, 4 along codes
  const int row0 = blockIdx.x * MM;
  const int code_tiles = (job.k_len + MN - 1) / MN;
  const int t0 = blockIdx.y * job.tiles_per_run;
  const int t1 = min(t0 + job.tiles_per_run, code_tiles);
  const int chunks = (job.d_len + MC - 1) / MC;
  const int steps = (t1 - t0) * chunks;

  auto stage = [&](int s) { return base + s * 2 * CHUNK_BYTES; };
  auto prefetch = [&](int f) {
    if (f < steps) {
      const int tile = t0 + f / chunks, k0 = (f % chunks) * MC;
      load_chunk(stage(f % MMA_STAGES), z, job.d_len, row0, job.n, k0);
      load_chunk(stage(f % MMA_STAGES) + CHUNK_BYTES, cb, job.d_len,
                 tile * MN, job.k_len, k0);
    }
    cp_async_commit();
  };

  float best[4][2];
  int bidx[4][2];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      best[mi][h] = INFINITY;
      bidx[mi][h] = 0;
    }
  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

#pragma unroll
  for (int s = 0; s < MMA_STAGES - 1; ++s) prefetch(s);

  for (int f = 0; f < steps; ++f) {
    cp_async_wait<MMA_STAGES - 2>();
    __syncthreads();   // chunk f landed; chunk f - 1's stage is free
    prefetch(f + MMA_STAGES - 1);
    const uint32_t zs = stage(f % MMA_STAGES), cs = zs + CHUNK_BYTES;
    const int kc = f % chunks;
#pragma unroll
    for (int j = 0; j < MC / 16; ++j) {
      if (kc * MC + 16 * j < job.d_len) {   // the same for the whole block
        uint32_t a[4][4], b[2][4];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
          load_a<MC>(a[mi], zs, 64 * wm + 16 * mi, j, lane);
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
          load_b_nk<MC>(b[nb], cs, 32 * wn + 16 * nb, j, lane);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma(acc[mi][ni], a[mi], b[ni >> 1][(ni & 1) * 2],
                b[ni >> 1][(ni & 1) * 2 + 1]);
      }
    }
    if (kc == chunks - 1) {
      // the tile's distances, codes in increasing order per thread
      const int tile = t0 + f / chunks;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int code = tile * MN + 32 * wn + 8 * ni + 2 * tig + e;
          if (code < job.k_len) {
            const float sq = __ldg(job.cb_sq + code);
#pragma unroll
            for (int mi = 0; mi < 4; ++mi)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float dist = sq - 2.f * acc[mi][ni][2 * h + e];
                if (dist < best[mi][h]) {
                  best[mi][h] = dist;
                  bidx[mi][h] = code;
                }
              }
          }
        }
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free for the merge

  // the four lanes of a row (same grp), then the four warps along codes
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best[mi][h], o);
        const int oi = __shfl_xor_sync(0xffffffffu, bidx[mi][h], o);
        if (better(ob, oi, best[mi][h], bidx[mi][h])) {
          best[mi][h] = ob;
          bidx[mi][h] = oi;
        }
      }
  float* sd = reinterpret_cast<float*>(smem);          // [4][MM]
  int* si = reinterpret_cast<int*>(smem) + 4 * MM;     // [4][MM]
  if (tig == 0) {
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 64 * wm + 16 * mi + 8 * h + grp;
        sd[wn * MM + r] = best[mi][h];
        si[wn * MM + r] = bidx[mi][h];
      }
  }
  __syncthreads();
  const int r = threadIdx.x;
  if (r < MM && row0 + r < job.n) {
    float bd = sd[r];
    int bi = si[r];
#pragma unroll
    for (int w = 1; w < 4; ++w)
      if (better(sd[w * MM + r], si[w * MM + r], bd, bi)) {
        bd = sd[w * MM + r];
        bi = si[w * MM + r];
      }
    if (gridDim.y == 1) {
      job.out[row0 + r] = bi;
    } else {
      job.part_d[(long long)blockIdx.y * job.n + row0 + r] = bd;
      job.part_i[(long long)blockIdx.y * job.n + row0 + r] = bi;
    }
  }
}

// --- fp32: CUDA cores -------------------------------------------------------

constexpr int BN = 64;   // latent rows a block
constexpr int BK = 64;   // codes a tile
constexpr int BD = 64;   // dims a chunk
constexpr int TX = 16;   // threads along codes
constexpr int TY = 16;   // threads along rows
constexpr int TM = BN / TY;
constexpr int TN = BK / TX;
constexpr int NT = TX * TY;

__global__ void __launch_bounds__(NT)
vq_argmin_fp32_kernel(Job job) {
  // rows padded by one float: the 16 threads that read 16 codes at one d
  // hit 16 banks
  __shared__ float zs[BN][BD + 1];
  __shared__ float cs[BK][BD + 1];
  const float* z = static_cast<const float*>(job.z);
  const float* cb = static_cast<const float*>(job.cb);
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int n0 = blockIdx.x * BN;
  const int code_tiles = (job.k_len + BK - 1) / BK;
  const int t0 = blockIdx.y * job.tiles_per_run;
  const int t1 = min(t0 + job.tiles_per_run, code_tiles);

  float best[TM];
  int bidx[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    best[i] = INFINITY;
    bidx[i] = 0;
  }

  for (int tile = t0; tile < t1; ++tile) {
    const int k0 = tile * BK;
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    for (int d0 = 0; d0 < job.d_len; d0 += BD) {
      const int dl = min(BD, job.d_len - d0);
      __syncthreads();   // the previous chunk is consumed
      for (int i = tid; i < BN * BD; i += NT) {
        const int r = i / BD, d = i % BD;
        const bool in = d < dl;
        zs[r][d] = in && n0 + r < job.n
                       ? z[(long long)(n0 + r) * job.d_len + d0 + d]
                       : 0.f;
        cs[r][d] = in && k0 + r < job.k_len
                       ? cb[(long long)(k0 + r) * job.d_len + d0 + d]
                       : 0.f;
      }
      __syncthreads();
      for (int d = 0; d < dl; ++d) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = zs[ty + TY * i][d];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = cs[tx + TX * j][d];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    // codes in increasing order: a strict < keeps the first of equal ones
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int code = k0 + tx + TX * j;
      if (code < job.k_len) {
        const float e = __ldg(job.cb_sq + code);
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
    if (tx == 0 && row < job.n) {
      if (gridDim.y == 1) {
        job.out[row] = bidx[i];
      } else {
        job.part_d[(long long)blockIdx.y * job.n + row] = best[i];
        job.part_i[(long long)blockIdx.y * job.n + row] = bidx[i];
      }
    }
  }
}

// --- the runs' merge --------------------------------------------------------

__global__ void __launch_bounds__(256)
vq_merge_kernel(const float* __restrict__ part_d,
                const int* __restrict__ part_i, int* __restrict__ out, int n,
                int runs) {
  const int row = blockIdx.x * 256 + threadIdx.x;
  if (row >= n) return;
  float bd = part_d[row];
  int bi = part_i[row];
  for (int s = 1; s < runs; ++s) {
    const float d = part_d[(long long)s * n + row];
    const int i = part_i[(long long)s * n + row];
    if (better(d, i, bd, bi)) {
      bd = d;
      bi = i;
    }
  }
  out[row] = bi;
}

// The split of the codebook: runs of code tiles, as many as make about
// `blocks_per_sm` blocks an SM with the row blocks, each at least a tile.
struct Split {
  int row_blocks, runs, tiles_per_run;
};

Split split(int n, int k_len, int sms, bool bf16) {
  const int rows = bf16 ? MM : BN, codes = bf16 ? MN : BK;
  Split sp;
  sp.row_blocks = (n + rows - 1) / rows;
  const int tiles = (k_len + codes - 1) / codes;
  int runs = 2 * sms / sp.row_blocks;
  runs = runs < 1 ? 1 : (runs > tiles ? tiles : runs);
  sp.tiles_per_run = (tiles + runs - 1) / runs;
  sp.runs = (tiles + sp.tiles_per_run - 1) / sp.tiles_per_run;
  return sp;
}

bool valid(int n, int k_len, int d_len, int is_bf16) {
  return n >= 1 && k_len >= 1 && d_len >= 1 && (!is_bf16 || d_len % 8 == 0);
}

}  // namespace

// One-time set-up on CUDA device `device` (the bf16 kernel's dynamic
// shared memory above 48 KB); returns its SM count, 0 if a call fails.
extern "C" int mas_vq_argmin_prepare(int device) {
  int sms = 0, was = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      cudaGetDevice(&was) != cudaSuccess || cudaSetDevice(device) != cudaSuccess)
    return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      vq_argmin_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MMA_SMEM);
  if (cudaSetDevice(was) != cudaSuccess || err != cudaSuccess) return 0;
  return sms;
}

// Scratch floats of a launch: cb_sq [K], then, when the codebook is split,
// the partial distances and indices [S, N] each; -1 for a shape the kernel
// does not take.
extern "C" long long mas_vq_argmin_scratch(int n, int k_len, int d_len,
                                           int is_bf16, int sms) {
  if (!valid(n, k_len, d_len, is_bf16) || sms < 1) return -1;
  const Split sp = split(n, k_len, sms, is_bf16);
  return k_len + (sp.runs > 1 ? 2LL * sp.runs * n : 0LL);
}

// z [N, D], cb [K, D] contiguous, both bf16 (is_bf16 = 1: D a multiple of
// 8, 16-byte aligned) or both fp32; scratch of mas_vq_argmin_scratch(...)
// floats; out int32 [N]; sms from mas_vq_argmin_prepare for the stream's
// device.
extern "C" int mas_vq_argmin(const void* z, const void* cb, void* scratch,
                             void* out, int n, int k_len, int d_len,
                             int is_bf16, int sms, void* stream) {
  if (!valid(n, k_len, d_len, is_bf16) || sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Split sp = split(n, k_len, sms, is_bf16);
  float* cb_sq = static_cast<float*>(scratch);
  Job job;
  job.z = z;
  job.cb = cb;
  job.cb_sq = cb_sq;
  job.part_d = cb_sq + k_len;
  job.part_i = reinterpret_cast<int*>(job.part_d + (long long)sp.runs * n);
  job.out = static_cast<int*>(out);
  job.n = n;
  job.k_len = k_len;
  job.d_len = d_len;
  job.tiles_per_run = sp.tiles_per_run;
  const int norm_blocks = (k_len + NORM_THREADS / 32 - 1) / (NORM_THREADS / 32);
  if (is_bf16)
    vq_code_norms_kernel<<<norm_blocks, NORM_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(cb), cb_sq, k_len, d_len);
  else
    vq_code_norms_kernel<<<norm_blocks, NORM_THREADS, 0, s>>>(
        static_cast<const float*>(cb), cb_sq, k_len, d_len);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(sp.row_blocks, sp.runs);
  if (is_bf16)
    vq_argmin_mma_kernel<<<grid, MMA_THREADS, MMA_SMEM, s>>>(job);
  else
    vq_argmin_fp32_kernel<<<grid, NT, 0, s>>>(job);
  err = cudaGetLastError();
  if (err != cudaSuccess || sp.runs == 1) return static_cast<int>(err);
  vq_merge_kernel<<<(n + 255) / 256, 256, 0, s>>>(job.part_d, job.part_i,
                                                 job.out, n, sp.runs);
  return static_cast<int>(cudaGetLastError());
}
