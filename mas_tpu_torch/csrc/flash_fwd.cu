// Prefix-bidirectional causal attention forward (kernel B1).
//
// Replaces: mas_tpu/ops/attention.py::_fwd_kernel (launched by
// _flash_fwd), the Pallas flash-attention forward of the transformer
// prefill.
//
// Computes, for q, k, v [B, H, T, 64] (bf16 or fp32), out = softmax(q k^T /
// sqrt(d)) v and lse = logsumexp of the scaled scores, where row i sees the
// keys [0, bound): bound = prefix for i < prefix, else i + 1 (the visible
// span is always contiguous, mas_tpu/ops/attention.py::_row_bound).
//
// What bounds it on the H100: at the prefill shape (T = 384, d = 64) the
// work is O(T^2 d) multiply-adds on 2 * T * d inputs per (b, h), so it is
// compute bound; this first version runs the products on the fp32 CUDA
// cores, not the tensor cores (wgmma comes later), and its inner loops are
// bound by shared-memory reads of k and v.
//
// What the design does about it: one block per (b*h, 32-row q tile), four
// threads per q row.  Each thread keeps its q row (pre-scaled) and its own
// fp32 output accumulator in registers, and owns every fourth key of each
// 64-key tile staged in shared memory as fp32.  It runs its own online
// softmax (running max and sum), and the four partial states of a row merge
// through warp shuffles at the end.  Reads of k and v rows are 16-byte
// vectors; the row stride of 68 floats puts the four rows a warp reads at
// once on distinct banks, and the eight threads reading the same row get a
// broadcast.  K-tiles past max(causal bound, prefix bound) of the q tile are
// never loaded (mas_tpu/ops/attention.py:173-177).  Inputs are addressed by
// strides (last dim contiguous), so q, k, v can be views into the fused qkv
// projection and out can be written in [B, T, H, d] order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int D = 64;          // head dim
constexpr int BQ = 32;         // q rows per block
constexpr int BK = 64;         // keys per shared-memory tile
constexpr int SUB = 4;         // threads per q row
constexpr int NT = BQ * SUB;   // threads per block
constexpr int KPAD = D + 4;    // shared row stride in floats
constexpr int KPT = BK / SUB;  // keys per thread per tile
constexpr float NEG = -1e30f;  // masked score, as the Pallas kernel

struct Strides {
  long long qb, qh, qt, kb, kh, kt, vb, vh, vt, ob, oh, ot;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, Strides st, int H, int t_len,
                 int prefix, float scale) {
  __shared__ __align__(16) float ks[BK * KPAD];
  __shared__ __align__(16) float vs[BK * KPAD];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int sub = tid % SUB;
  const int i = q0 + tid / SUB;  // this thread's query row
  const bool row_ok = i < t_len;
  const int pfx = min(prefix, t_len);
  const int bound = row_ok ? (i < pfx ? pfx : i + 1) : 0;

  const T* qp = q + b * st.qb + h * st.qh;
  const T* kp = k + b * st.kb + h * st.kh;
  const T* vp = v + b * st.vb + h * st.vh;

  float qr[D];
#pragma unroll
  for (int c = 0; c < D; ++c)
    qr[c] = row_ok ? to_f(qp[i * st.qt + c]) * scale : 0.f;

  // the last tile any row of this q tile can see
  const int q_last = min(q0 + BQ, t_len) - 1;
  int hi = q_last + 1;
  if (q0 < pfx) hi = max(hi, pfx);
  const int ntiles = (hi + BK - 1) / BK;

  float m = NEG, l = 0.f;
  float acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int j = idx / D, c = idx % D;
      const int kj = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kj < t_len) {
        kv = to_f(kp[kj * st.kt + c]);
        vv = to_f(vp[kj * st.vt + c]);
      }
      ks[j * KPAD + c] = kv;
      vs[j * KPAD + c] = vv;
    }
    __syncthreads();

    float s[KPT];
    float tmax = NEG;
#pragma unroll
    for (int u = 0; u < KPT; ++u) {
      const int j = u * SUB + sub;
      const float4* kr = reinterpret_cast<const float4*>(&ks[j * KPAD]);
      float dot = 0.f;
#pragma unroll
      for (int c4 = 0; c4 < D / 4; ++c4) {
        const float4 kk = kr[c4];
        dot = fmaf(qr[4 * c4 + 0], kk.x, dot);
        dot = fmaf(qr[4 * c4 + 1], kk.y, dot);
        dot = fmaf(qr[4 * c4 + 2], kk.z, dot);
        dot = fmaf(qr[4 * c4 + 3], kk.w, dot);
      }
      s[u] = (k0 + j < bound) ? dot : NEG;
      tmax = fmaxf(tmax, s[u]);
    }
    if (tmax > NEG) {  // this thread sees at least one key of the tile
      const float m_new = fmaxf(m, tmax);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] *= alpha;
#pragma unroll
      for (int u = 0; u < KPT; ++u) {
        const float p = (s[u] > NEG) ? expf(s[u] - m_new) : 0.f;
        l += p;
        const float4* vr =
            reinterpret_cast<const float4*>(&vs[(u * SUB + sub) * KPAD]);
#pragma unroll
        for (int c4 = 0; c4 < D / 4; ++c4) {
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
  for (int c = 0; c < D; ++c) {
    float a = acc[c] * f;
#pragma unroll
    for (int o = 1; o < SUB; o <<= 1) a += __shfl_xor_sync(full, a, o);
    acc[c] = a;
  }
  if (!row_ok) return;
  const float inv = 1.f / l_all;
  T* op = out + b * st.ob + h * st.oh + i * st.ot;
#pragma unroll
  for (int c = 0; c < D; ++c)
    if (c / (D / SUB) == sub) store_f(op + c, acc[c] * inv);
  if (sub == 0) lse[(long long)bh * t_len + i] = m_all + logf(l_all);
}

}  // namespace

extern "C" int mas_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, const long long* strides,
                             int batch, int heads, int t_len, int prefix,
                             int is_bf16, void* stream) {
  Strides st;
  st.qb = strides[0]; st.qh = strides[1]; st.qt = strides[2];
  st.kb = strides[3]; st.kh = strides[4]; st.kt = strides[5];
  st.vb = strides[6]; st.vh = strides[7]; st.vt = strides[8];
  st.ob = strides[9]; st.oh = strides[10]; st.ot = strides[11];
  const dim3 grid((t_len + BQ - 1) / BQ, batch * heads);
  const float scale = 0.125f;  // 1 / sqrt(64)
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    flash_fwd_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), st,
        heads, t_len, prefix, scale);
  } else {
    flash_fwd_kernel<float><<<grid, NT, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out),
        static_cast<float*>(lse), st, heads, t_len, prefix, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mas_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
