// Shared by the GroupNorm+swish kernels B4 (forward, gn_swish_fwd.cu) and
// B8 (backward, gn_swish_bwd.cu) over NHWC [B, HW, C]: a thread's E
// channels of one row as one vector load or store, or as E element loads
// where C is not a multiple of E or the data is not aligned for the
// vector; the item map of their cooperative launches; and the launch.
//
// Item map.  An image's C channels are cut into `slabs` slabs of `width`
// channels (a multiple of E; the last slab may be narrower), each as wide
// as the NT threads of a block cover or as C, and its rows into `slices`
// slices.  Item ((b S + s) slabs + k) is slab k of slice s of image b.  In
// a slab, vps = width / E threads cover a row and the block takes step =
// NT / vps rows at once: thread t takes channels (t % vps) E .. + E of
// rows t / vps, t / vps + step, ...; threads past step * vps, and those
// whose channels lie past C, idle.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gn {

constexpr int NT = 256;   // threads a block

// E values of T as one load: 16 bytes (fp32 x 4, bf16 x 8) or 8 (bf16 x 4)
template <typename T, int E>
struct Raw;
template <>
struct Raw<float, 4> {
  using type = uint4;
};
template <>
struct Raw<__nv_bfloat16, 4> {
  using type = uint2;
};
template <>
struct Raw<__nv_bfloat16, 8> {
  using type = uint4;
};

__device__ __forceinline__ void words(const uint2 w, uint32_t (&u)[2]) {
  u[0] = w.x;
  u[1] = w.y;
}
__device__ __forceinline__ void words(const uint4 w, uint32_t (&u)[4]) {
  u[0] = w.x;
  u[1] = w.y;
  u[2] = w.z;
  u[3] = w.w;
}
__device__ __forceinline__ uint2 from_words(const uint32_t (&u)[2]) {
  return make_uint2(u[0], u[1]);
}
__device__ __forceinline__ uint4 from_words(const uint32_t (&u)[4]) {
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// two fp32 values rounded to one bf16 pair, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One row's E values of a thread as loaded, so that several rows' loads
// are in flight before any is used.  VEC: one aligned vector of E values,
// all in range; otherwise E elements, those at or past `valid` zero.
template <typename T, int E, bool VEC>
struct Row {
  using W = typename Raw<T, E>::type;
  W w;
  __device__ __forceinline__ void fetch(const T* p, int /*valid*/) {
    w = *reinterpret_cast<const W*>(p);
  }
  __device__ __forceinline__ void get(float* v) const {
    constexpr int N = sizeof(W) / 4;
    uint32_t u[N];
    words(w, u);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if constexpr (sizeof(T) == 2) {   // bf16 -> fp32 is exact
        v[2 * i] = __uint_as_float(u[i] << 16);
        v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
      } else {
        v[i] = __uint_as_float(u[i]);
      }
    }
  }
};

template <typename T, int E>
struct Row<T, E, false> {
  T w[E];
  __device__ __forceinline__ void fetch(const T* p, int valid) {
#pragma unroll
    for (int e = 0; e < E; ++e) w[e] = e < valid ? p[e] : from_f<T>(0.f);
  }
  __device__ __forceinline__ void get(float* v) const {
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = to_f(w[e]);
  }
};

// the E values v rounded to T and stored at p (the first `valid` of them
// unless VEC); `stream`: an evict-first store (output not read again)
template <typename T, int E, bool VEC, bool STREAM = false>
__device__ __forceinline__ void put(T* p, int valid, const float* v) {
  if constexpr (VEC) {
    using W = typename Raw<T, E>::type;
    constexpr int N = sizeof(W) / 4;
    uint32_t u[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if constexpr (sizeof(T) == 2)
        u[i] = pack_bf16(v[2 * i], v[2 * i + 1]);
      else
        u[i] = __float_as_uint(v[i]);
    }
    W* dst = reinterpret_cast<W*>(p);
    if constexpr (STREAM)
      __stcs(dst, from_words(u));
    else
      *dst = from_words(u);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (e < valid) p[e] = from_f<T>(v[e]);
  }
}

// The item map of the module comment.
struct Items {
  int rows, channels, slices, slabs, width;   // rows * slices < 2^31

  // first row of slice s of an image (32-bit: no 64-bit division)
  __device__ __forceinline__ int slice_start(int s) const {
    return rows * s / slices;
  }

  // item -> image b, rows [lo, hi), channels [c0, c1)
  __device__ __forceinline__ void bounds(int item, int& b, int& lo, int& hi,
                                         int& c0, int& c1) const {
    const int k = item % slabs;
    const int bs = item / slabs;
    b = bs / slices;
    const int s = bs % slices;
    lo = slice_start(s);
    hi = slice_start(s + 1);
    c0 = k * width;
    c1 = c0 + width < channels ? c0 + width : channels;
  }
};

// at most `slices`, and few enough that rows * slices < 2^31
inline int slice_cap(int rows, int slices) {
  const int most = 0x7fffffff / rows;
  return slices < most ? slices : most;
}

// slabs of an image's C channels, each at most NT * E wide, and their
// width (a multiple of E)
inline void slab_split(int channels, int e, int& slabs, int& width) {
  const int widest = NT * e;
  slabs = (channels + widest - 1) / widest;
  width = ((channels + slabs - 1) / slabs + e - 1) / e * e;
}

// the blocks of `kernel` (NT threads, `smem` bytes) that can be resident
// on CUDA device `device` at once, at most `cap` an SM; 0 if a query
// fails
template <typename K>
int resident(int device, K kernel, size_t smem, int cap) {
  int sms = 0, per_sm = 0, was = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      cudaGetDevice(&was) != cudaSuccess || cudaSetDevice(device) != cudaSuccess)
    return 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, smem);
  if (cudaSetDevice(was) != cudaSuccess || err != cudaSuccess) return 0;
  return sms * (per_sm < cap ? per_sm : cap);
}

// a cooperative launch of `grid` blocks of NT threads
template <typename P>
cudaError_t launch_cooperative(void (*kernel)(P), const P& p, int grid,
                               size_t smem, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, p);
}

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace gn
