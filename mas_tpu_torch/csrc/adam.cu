// Kernel B13: Adam's update over a list of fp32 tensors, in one pass
// (adam_update_kernel).
//
// B13 replaces no Pallas kernel: the JAX package leaves Adam to optax
// (mas_tpu/train/state.py:35, optax.adam), which XLA fuses under jit.  It
// was added because the port's eager update made 15 launches a tensor,
// 5,970 a transformer_512 step over its 398 tensors.  Plain twin:
// ops/adam.py::adam_update_plain, whose arithmetic this repeats operation
// by operation in fp32 (wrapper: ops/adam.py::adam_update):
//   mu = (1 - b1) g + b1 mu
//   nu = (1 - b2) g^2 + b2 nu
//   p  = p - lr (mu / bc1) / (sqrt(nu / bc2) + eps)
// The scalars are the fp32 roundings of the doubles the twin uses, and each
// step rounds where PyTorch's CUDA kernels round: a tensor times a scalar
// once, g^2 once, a sum once; a tensor divided by a Python scalar is a
// product with the scalar's fp32 reciprocal (div_true_kernel_cuda), computed
// on the host here as there; sqrt and the tensor division are IEEE; p's
// update is `self + alpha * other` with alpha = -lr, which nvcc contracts
// into one fma in PyTorch's add kernel.  __fmul_rn / __fadd_rn keep every
// other product and sum from being contracted.
//
// What bounds it on the H100: bytes.  Each element reads p, g, mu and nu
// and writes p, mu and nu, 28 bytes; at transformer_512's 337.4 M
// parameters that is 9.45 GB, 2.82 ms at 3.35 TB/s, with ~10 operations an
// element in between.  The eager update moved ~5 times as many bytes (every
// operation a pass) and spent ~65 ms of host time on its launches.
//
// What the design does about it:
// - One launch covers up to MAX_TENSORS tensors, whose table (the four
//   pointers, numel and first tile of each) is the kernel's parameter,
//   passed by value: no device-side table, no host-to-device copy, no
//   allocation, so the launch can be captured in a CUDA graph.  The table
//   is held under the 4,096-byte kernel-parameter limit that every CUDA
//   toolkit accepts (12.1 raised it to 32,764 bytes on Volta and later; the
//   port does not rely on that): 90 tensors a launch, 5 launches for
//   transformer_512's 398 tensors.
// - Each tensor is cut into tiles of TILE elements, numbered across the
//   launch's tensors (tile_start, from ops/adam.py::launch_plan); the grid,
//   BLOCKS_PER_SM blocks an SM, walks the tiles grid-strided, and a block
//   finds a tile's tensor by walking tile_start forwards (its tiles only
//   increase), so the search is uniform over the block and amortised.
// - A tile whose four pointers are 16-byte aligned takes float4 loads and
//   stores, UNROLL vectors of each array a thread in flight; the last tile
//   of a tensor whose length is not a multiple of 4, and a tensor at an
//   unaligned address, take element loads.  Nothing is reused, so nothing
//   is staged in shared memory.
// - The launch runs on the caller's stream and never synchronizes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 2;                      // float4s of each array in flight
constexpr int TILE = THREADS * 4 * UNROLL;     // elements a tile
constexpr int MAX_TENSORS = 90;                // tensors a launch
constexpr int BLOCKS_PER_SM = 4;
constexpr int PARAM_LIMIT = 4096;              // bytes of kernel parameters

struct Scalars {
  float c1, b1, c2, b2;   // 1 - b1, b1, 1 - b2, b2
  float inv1, inv2;       // fp32 reciprocals of the bias corrections
  float eps, alpha;       // eps, -lr
};

struct Table {
  float* p[MAX_TENSORS];
  const float* g[MAX_TENSORS];
  float* m[MAX_TENSORS];
  float* v[MAX_TENSORS];
  long long numel[MAX_TENSORS];
  int tile_start[MAX_TENSORS + 1];   // tensor i's tiles: [start[i], start[i + 1])
  int count;
  Scalars s;
};

// ops/adam.py::PARAM_BYTES computes the same size
static_assert(sizeof(Table) == 44 * MAX_TENSORS + 40, "table layout");
static_assert(sizeof(Table) <= PARAM_LIMIT, "kernel parameter limit");

__device__ __forceinline__ void update(const Scalars& s, float g, float& p,
                                       float& m, float& v) {
  m = __fadd_rn(__fmul_rn(s.c1, g), __fmul_rn(s.b1, m));
  v = __fadd_rn(__fmul_rn(s.c2, __fmul_rn(g, g)), __fmul_rn(s.b2, v));
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v, s.inv2)), s.eps);
  p = __fmaf_rn(s.alpha, __fdiv_rn(__fmul_rn(m, s.inv1), den), p);
}

__device__ __forceinline__ void update4(const Scalars& s, const float4& g,
                                        float4& p, float4& m, float4& v) {
  update(s, g.x, p.x, m.x, v.x);
  update(s, g.y, p.y, m.y, v.y);
  update(s, g.z, p.z, m.z, v.z);
  update(s, g.w, p.w, m.w, v.w);
}

__device__ __forceinline__ void update_at(const Scalars& s, const float* g,
                                          float* p, float* m, float* v,
                                          long long e) {
  float pe = p[e], me = m[e], ve = v[e];
  update(s, g[e], pe, me, ve);
  p[e] = pe;
  m[e] = me;
  v[e] = ve;
}

__global__ void __launch_bounds__(THREADS)
    adam_update_kernel(const __grid_constant__ Table t) {
  const Scalars& s = t.s;
  const int tiles = t.tile_start[t.count];
  int i = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    while (tile >= t.tile_start[i + 1]) ++i;
    const long long lo = static_cast<long long>(tile - t.tile_start[i]) * TILE;
    const long long rest = t.numel[i] - lo;
    const int n = rest < TILE ? static_cast<int>(rest) : TILE;
    float* p = t.p[i] + lo;
    const float* g = t.g[i] + lo;
    float* m = t.m[i] + lo;
    float* v = t.v[i] + lo;
    const bool aligned = ((reinterpret_cast<uintptr_t>(p) |
                           reinterpret_cast<uintptr_t>(g) |
                           reinterpret_cast<uintptr_t>(m) |
                           reinterpret_cast<uintptr_t>(v)) & 15) == 0;
    if (aligned && n == TILE) {
      float4 gr[UNROLL], pr[UNROLL], mr[UNROLL], vr[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int e = 4 * (u * THREADS + threadIdx.x);
        gr[u] = *reinterpret_cast<const float4*>(g + e);
        pr[u] = *reinterpret_cast<const float4*>(p + e);
        mr[u] = *reinterpret_cast<const float4*>(m + e);
        vr[u] = *reinterpret_cast<const float4*>(v + e);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int e = 4 * (u * THREADS + threadIdx.x);
        update4(s, gr[u], pr[u], mr[u], vr[u]);
        *reinterpret_cast<float4*>(p + e) = pr[u];
        *reinterpret_cast<float4*>(m + e) = mr[u];
        *reinterpret_cast<float4*>(v + e) = vr[u];
      }
    } else if (aligned) {
      const int vecs = n / 4;
      for (int j = threadIdx.x; j < vecs; j += THREADS) {
        const int e = 4 * j;
        const float4 gv = *reinterpret_cast<const float4*>(g + e);
        float4 pv = *reinterpret_cast<const float4*>(p + e);
        float4 mv = *reinterpret_cast<const float4*>(m + e);
        float4 vv = *reinterpret_cast<const float4*>(v + e);
        update4(s, gv, pv, mv, vv);
        *reinterpret_cast<float4*>(p + e) = pv;
        *reinterpret_cast<float4*>(m + e) = mv;
        *reinterpret_cast<float4*>(v + e) = vv;
      }
      for (int e = 4 * vecs + threadIdx.x; e < n; e += THREADS)
        update_at(s, g, p, m, v, e);
    } else {
      for (int e = threadIdx.x; e < n; e += THREADS)
        update_at(s, g, p, m, v, e);
    }
  }
}

int sm_count(int device) {
  static int cached[64] = {0};
  if (device < 0 || device >= 64) return 0;
  if (cached[device] == 0) {
    int sms = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               device) != cudaSuccess)
      return 0;
    cached[device] = sms;
  }
  return cached[device];
}

}  // namespace

// One launch over tensors first .. first + count - 1 of a list of `total`.
// ptrs [4][total] holds the addresses of the parameters, the gradients,
// the first moments and the second moments, each row in tensor order;
// numels[count] and tile_starts[count + 1] are the launch's, from
// ops/adam.py::launch_plan.  The scalars are fp32 roundings of the update's
// doubles: 1 - b1, b1, 1 - b2, b2, the bias corrections bc1 and bc2, eps
// and -lr.
extern "C" int mas_adam_update(const long long* ptrs, int total, int first,
                               int count, const long long* numels,
                               const int* tile_starts, float c1, float b1,
                               float c2, float b2, float bc1, float bc2,
                               float eps, float alpha, int device,
                               void* stream) {
  if (count < 1 || count > MAX_TENSORS) return cudaErrorInvalidValue;
  const int sms = sm_count(device);
  if (sms == 0) return cudaErrorInvalidDevice;
  Table t;
  if (first < 0 || first + count > total) return cudaErrorInvalidValue;
  for (int j = 0; j < count; ++j) {
    const long long* at = ptrs + first + j;
    t.p[j] = reinterpret_cast<float*>(at[0]);
    t.g[j] = reinterpret_cast<const float*>(at[total]);
    t.m[j] = reinterpret_cast<float*>(at[2 * total]);
    t.v[j] = reinterpret_cast<float*>(at[3 * total]);
    t.numel[j] = numels[j];
    t.tile_start[j] = tile_starts[j];
  }
  t.tile_start[count] = tile_starts[count];
  t.count = count;
  // PyTorch's CUDA division by a Python scalar: opmath_t(1.0) / b on the host
  t.s = Scalars{c1, b1, c2, b2, 1.0f / bc1, 1.0f / bc2, eps, alpha};
  const int tiles = tile_starts[count];
  if (tiles == 0) return cudaSuccess;
  const int grid = tiles < BLOCKS_PER_SM * sms ? tiles : BLOCKS_PER_SM * sms;
  adam_update_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}
