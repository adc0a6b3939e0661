// Kernel B14: the Mamba2 decode step's state update (ssm_update_kernel).
//
// B14 replaces no Pallas kernel: the JAX package has no state-space layer.
// It was added for Granite 4.0-H's Mamba2 layers (models/hybrid.py::Mamba2),
// where each decode step advances every row's state by one position.  With
// one group of B and C, head h of row r keeps S [P, N] fp32 and the step
// computes, for its x [P], B [N], C [N], Delta and the head's A and D:
//   S = exp(Delta A) S + (Delta x) (x) B          (outer product over P, N)
//   y = S C + D x                                   (y [P])
// Plain twin: ops/ssm.py::ssm_update_plain (wrapper ops/ssm.py::ssm_update).
// The state's update rounds as the twin's PyTorch kernels round: the decay
// times S once, Delta times x once, that times B once, the sum once
// (__fmul_rn / __fadd_rn keep nvcc from contracting them into fmas), so the
// two states agree bit for bit; y's sum over N runs in another order.
//
// What bounds it on the H100: bytes.  Each step reads and writes every
// state once: at Granite-4.0-H-Small's widths (H 128, P 64, N 128) that is
// 4 MiB a row each way, 4.29 GB a call at 512 rows, 1.28 ms at 3.35 TB/s,
// with x, B, C, Delta in and y out ~1% beside it and 5 operations a state
// element.  An update written as PyTorch operations makes four or five
// passes over the state.
//
// What the design does about it:
// - One block a (head, row): the state's [P, N] tile is contiguous, and
//   each of the block's WARPS warps takes rows p of it, one float4 of N a
//   lane (N <= 128; lanes past N / 4 hold no columns but join the sums).
// - A warp loads ROWS_IN_FLIGHT state rows before it computes any, so
//   every thread keeps 8 independent 16-byte loads in flight; the loads and
//   stores are streaming (__ldcs / __stcs): no state byte is read again in
//   the step, so it should not push x, B, C or the other layers' weights
//   out of L2.
// - B and C are read once a thread into registers, x one value a row (a
//   broadcast within the warp); y_p is a warp-shuffle sum, written by lane 0.
// - Nothing is staged in shared memory; the launch runs on the caller's
//   stream, allocates nothing and never synchronizes, so a CUDA graph
//   captures it.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS_IN_FLIGHT = 8;
constexpr int MAX_N = 128;               // a float4 of N a lane
constexpr int MAX_GRID_Y = 65535;        // rows of the batch, blockIdx.y

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float4 advance(float4 s, float decay, float dx,
                                          float4 b) {
  s.x = __fadd_rn(__fmul_rn(s.x, decay), __fmul_rn(dx, b.x));
  s.y = __fadd_rn(__fmul_rn(s.y, decay), __fmul_rn(dx, b.y));
  s.z = __fadd_rn(__fmul_rn(s.z, decay), __fmul_rn(dx, b.z));
  s.w = __fadd_rn(__fmul_rn(s.w, decay), __fmul_rn(dx, b.w));
  return s;
}

// state [rows, heads, p_dim, n]; xbc [rows, heads * p_dim + 2 n] (x, B, C);
// dt [rows, heads]; a, d [heads]; y [rows, heads * p_dim]
__global__ void __launch_bounds__(THREADS)
ssm_update_kernel(float* __restrict__ state, const float* __restrict__ xbc,
                  const float* __restrict__ dt, const float* __restrict__ a,
                  const float* __restrict__ d, float* __restrict__ y,
                  int heads, int p_dim, int n) {
  const int h = blockIdx.x;
  const int row = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool has_cols = lane * 4 < n;
  const long long inner = static_cast<long long>(heads) * p_dim;
  const float* xr = xbc + static_cast<long long>(row) * (inner + 2 * n);
  const float* xh = xr + static_cast<long long>(h) * p_dim;
  float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 c = b;
  if (has_cols) {
    b = *reinterpret_cast<const float4*>(xr + inner + lane * 4);
    c = *reinterpret_cast<const float4*>(xr + inner + n + lane * 4);
  }
  const long long head_row = static_cast<long long>(row) * heads + h;
  const float delta = dt[head_row];
  const float decay = expf(__fmul_rn(delta, a[h]));
  const float skip = d[h];
  float* s = state + head_row * p_dim * n + lane * 4;
  float* yh = y + head_row * p_dim;

  for (int p0 = warp; p0 < p_dim; p0 += WARPS * ROWS_IN_FLIGHT) {
    float4 v[ROWS_IN_FLIGHT];
    float xv[ROWS_IN_FLIGHT];
#pragma unroll
    for (int i = 0; i < ROWS_IN_FLIGHT; ++i) {
      const int p = p0 + i * WARPS;
      v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      xv[i] = 0.f;
      if (p < p_dim) {
        xv[i] = xh[p];
        if (has_cols)
          v[i] = __ldcs(reinterpret_cast<const float4*>(
              s + static_cast<long long>(p) * n));
      }
    }
#pragma unroll
    for (int i = 0; i < ROWS_IN_FLIGHT; ++i) {
      const int p = p0 + i * WARPS;
      if (p >= p_dim) break;                 // uniform over the warp
      float acc = 0.f;
      if (has_cols) {
        const float4 nv = advance(v[i], decay, __fmul_rn(delta, xv[i]), b);
        __stcs(reinterpret_cast<float4*>(s + static_cast<long long>(p) * n),
               nv);
        acc = nv.x * c.x + nv.y * c.y + nv.z * c.z + nv.w * c.w;
      }
      acc = warp_sum(acc);
      if (lane == 0) yh[p] = __fadd_rn(acc, __fmul_rn(skip, xv[i]));
    }
  }
}

}  // namespace

extern "C" int mas_ssm_update(float* state, const float* xbc, const float* dt,
                              const float* a, const float* d, float* y,
                              int rows, int heads, int p_dim, int n,
                              void* stream) {
  if (rows < 1 || rows > MAX_GRID_Y || heads < 1 || p_dim < 1 || n < 4 ||
      n > MAX_N || n % 4)
    return cudaErrorInvalidValue;
  const dim3 grid(heads, rows);
  ssm_update_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      state, xbc, dt, a, d, y, heads, p_dim, n);
  return static_cast<int>(cudaGetLastError());
}
