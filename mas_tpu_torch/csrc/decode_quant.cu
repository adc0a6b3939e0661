// Single-token decode attention over an int8 or int4 KV cache (kernel B2)
// and over a float cache (kernel B9): one template, two instances.
//
// B2 replaces: mas_tpu/ops/quant.py::_int8_decode_kernel (launched by
// _decode_attention_int8_pallas), the fused quantized-cache read.
// B9 replaces: mas_tpu/ops/decode_attention.py::_decode_kernel (launched by
// _decode_attention_pallas), the read of the float ("compute") cache.
//
// Computes, for one query row per (b, h) and positions t <= index:
//   s[t] = (q . k[t]) * ks[t] / sqrt(d)        (k scale folds in after the dot)
//   p    = softmax(s)
//   out  = sum_t (p[t] * vs[t]) * v[t]          (v scale folds into p)
// with ks = vs = 1 for a float cache (no scale is read).  p stays fp32, as
// in the Pallas kernels; the output is rounded to q's dtype once.
// Cache layout (the port's own): values [B, H, T, *] with the d values of a
// position contiguous: int8 [.., d], int4 [.., d/2] uint8 with two nibbles
// per byte (low nibble = even dim), bf16 or fp32 [.., d]; scales [B, H, T]
// fp32.  Positions are ``pos_stride`` bytes apart and rows of one (b, h)
// are T * pos_stride bytes apart, so the k and v halves of the packed
// [B, H, T, 2d] cache are read in place through strided views (pos_stride
// 2d bytes for int8, d for int4); the lane caches have pos_stride = the
// bytes of one position.  ``index`` is a 1-element int32 device tensor, so
// the launch needs no host value of the decode position.
//
// What bounds both on the H100: bytes.  Every valid cache position is read
// once (d/2, d or 2d bytes, plus a 4-byte scale when quantized, for k and
// for v) and feeds only 2 * d multiply-adds, far below the card's
// ops-per-byte balance.
//
// What the design does about it: only positions <= index are read (the
// Pallas kernels' ceil((index+1)/128) blocks, at position granularity), and
// quantized values are dequantized in registers, so the device-memory
// stream stays at one byte, one nibble or one float per element.  One block
// per (b, h): at the serving batch (64 images, 128 rows with guidance) that
// is 2048 blocks over the 132 SMs.  Eight lanes share one position, each
// reading a contiguous 4-, 8- or 16-byte slice of its d values (two 16-byte
// loads for fp32); a warp covers four positions per step, so neighbouring
// lanes read neighbouring bytes.  Each lane group keeps its own online
// softmax state; groups merge through shuffles, warps through shared
// memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 64;             // head dim
constexpr int LPP = 8;            // lanes per cache position
constexpr int DPL = D / LPP;      // dims per lane
constexpr int WARPS = 4;
constexpr int NT = 32 * WARPS;
constexpr int PPW = 32 / LPP;     // positions per warp per step
constexpr int PPB = PPW * WARPS;  // positions per block per step
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// DPL cache values of one lane -> floats.  BITS 8 and 4: int8 / int4
// values, sign-extended; 16: bf16; 32: fp32.
template <int BITS>
__device__ __forceinline__ void unpack(const uint8_t* p, float* out);

template <>
__device__ __forceinline__ void unpack<8>(const uint8_t* p, float* out) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[i] = static_cast<float>(static_cast<int>(w.x << (24 - 8 * i)) >> 24);
    out[4 + i] =
        static_cast<float>(static_cast<int>(w.y << (24 - 8 * i)) >> 24);
  }
}

template <>
__device__ __forceinline__ void unpack<4>(const uint8_t* p, float* out) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // byte i: low nibble = dim 2i, high nibble = dim 2i + 1
    out[2 * i] = static_cast<float>(static_cast<int>(w << (28 - 8 * i)) >> 28);
    out[2 * i + 1] =
        static_cast<float>(static_cast<int>(w << (24 - 8 * i)) >> 28);
  }
}

template <>
__device__ __forceinline__ void unpack<16>(const uint8_t* p, float* out) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // bf16 -> fp32 is exact: the 16 bits become the high half of the word
    out[2 * i] = __uint_as_float(u[i] << 16);
    out[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

template <>
__device__ __forceinline__ void unpack<32>(const uint8_t* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 16);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// The body of both kernels, for the block of one (b, h).  BITS 8 / 4: a
// quantized cache with per-position scales (B2); 16 / 32: a bf16 / fp32
// cache without scales (B9).  pos_stride: bytes between positions.
template <int BITS, typename TQ>
__device__ __forceinline__ void decode_block(
    const TQ* __restrict__ q, const uint8_t* __restrict__ kq,
    const float* __restrict__ ks, const uint8_t* __restrict__ vq,
    const float* __restrict__ vs, const int* __restrict__ index,
    TQ* __restrict__ out, int H, int t_len, int pos_stride, int q_sb,
    int q_sh, float scale) {
  constexpr bool SCALED = BITS <= 8;      // quantized: fold in the scales
  constexpr int LBYTES = DPL * BITS / 8;  // bytes per lane
  __shared__ float sm_m[WARPS], sm_l[WARPS];
  __shared__ float sm_acc[WARPS][D];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int grp = lane / LPP;   // position slot in the warp
  const int part = lane % LPP;  // which DPL dims
  const int valid = min(index[0] + 1, t_len);

  float qr[DPL];
  const TQ* qp = q + (long long)b * q_sb + (long long)h * q_sh + part * DPL;
#pragma unroll
  for (int c = 0; c < DPL; ++c) qr[c] = to_f(qp[c]) * scale;

  const long long row = (long long)bh * t_len;
  const uint8_t* kb = kq + row * pos_stride + part * LBYTES;
  const uint8_t* vb = vq + row * pos_stride + part * LBYTES;
  const float* ksb = SCALED ? ks + row : nullptr;  // float caches: no scales
  const float* vsb = SCALED ? vs + row : nullptr;

  float m = NEG, l = 0.f;
  float acc[DPL];
#pragma unroll
  for (int c = 0; c < DPL; ++c) acc[c] = 0.f;

  // warp-uniform trip count: every lane reaches the shuffles
  for (int base = warp * PPW; base < valid; base += PPB) {
    const int pos = base + grp;
    const bool ok = pos < valid;
    float dot = 0.f;
    if (ok) {
      float kf[DPL];
      unpack<BITS>(kb + (long long)pos * pos_stride, kf);
#pragma unroll
      for (int c = 0; c < DPL; ++c) dot = fmaf(qr[c], kf[c], dot);
    }
#pragma unroll
    for (int o = 1; o < LPP; o <<= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if (ok) {
      const float s = SCALED ? dot * ksb[pos] : dot;
      const float m_new = fmaxf(m, s);
      const float alpha = expf(m - m_new);
      const float p = expf(s - m_new);
      l = l * alpha + p;
      const float pv = SCALED ? p * vsb[pos] : p;
      float vf[DPL];
      unpack<BITS>(vb + (long long)pos * pos_stride, vf);
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[c] = fmaf(pv, vf[c], acc[c] * alpha);
      m = m_new;
    }
  }

  // merge the PPW position groups of the warp (lanes 8 and 16 apart)
  float m_w = m;
#pragma unroll
  for (int o = LPP; o < 32; o <<= 1)
    m_w = fmaxf(m_w, __shfl_xor_sync(0xffffffffu, m_w, o));
  const float f = expf(m - m_w);
  l *= f;
#pragma unroll
  for (int o = LPP; o < 32; o <<= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
#pragma unroll
  for (int c = 0; c < DPL; ++c) {
    float a = acc[c] * f;
#pragma unroll
    for (int o = LPP; o < 32; o <<= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
    acc[c] = a;
  }
  if (grp == 0) {
#pragma unroll
    for (int c = 0; c < DPL; ++c) sm_acc[warp][part * DPL + c] = acc[c];
    if (part == 0) {
      sm_m[warp] = m_w;
      sm_l[warp] = l;
    }
  }
  __syncthreads();

  // merge the warps; one thread per output dim
  if (tid < D) {
    float mm = sm_m[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) mm = fmaxf(mm, sm_m[w]);
    float ll = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float e = expf(sm_m[w] - mm);
      ll += sm_l[w] * e;
      a += sm_acc[w][tid] * e;
    }
    store_f(out + (long long)bh * D + tid, a / ll);
  }
}

// B2 (two kernel names, so a profile tells the two kernels apart)
template <int BITS, typename TQ>
__global__ void __launch_bounds__(NT)
decode_quant_kernel(const TQ* q, const uint8_t* kq, const float* ks,
                    const uint8_t* vq, const float* vs, const int* index,
                    TQ* out, int H, int t_len, int pos_stride, int q_sb,
                    int q_sh, float scale) {
  decode_block<BITS, TQ>(q, kq, ks, vq, vs, index, out, H, t_len, pos_stride,
                         q_sb, q_sh, scale);
}

// B9
template <int BITS, typename TQ>
__global__ void __launch_bounds__(NT)
decode_float_kernel(const TQ* q, const uint8_t* k, const uint8_t* v,
                    const int* index, TQ* out, int H, int t_len, int q_sb,
                    int q_sh, float scale) {
  decode_block<BITS, TQ>(q, k, nullptr, v, nullptr, index, out, H, t_len,
                         D * BITS / 8, q_sb, q_sh, scale);
}

template <int BITS>
void launch(const void* q, const void* kq, const void* ks, const void* vq,
            const void* vs, const void* index, void* out, int batch,
            int heads, int t_len, int pos_stride, int q_sb, int q_sh,
            int is_bf16, cudaStream_t s) {
  const float scale = 0.125f;  // 1 / sqrt(64)
  const dim3 grid(batch * heads);
  const uint8_t* k8 = static_cast<const uint8_t*>(kq);
  const uint8_t* v8 = static_cast<const uint8_t*>(vq);
  const float* ksf = static_cast<const float*>(ks);
  const float* vsf = static_cast<const float*>(vs);
  const int* idx = static_cast<const int*>(index);
  if (is_bf16) {
    decode_quant_kernel<BITS, __nv_bfloat16><<<grid, NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), k8, ksf, v8, vsf, idx,
        static_cast<__nv_bfloat16*>(out), heads, t_len, pos_stride, q_sb,
        q_sh, scale);
  } else {
    decode_quant_kernel<BITS, float><<<grid, NT, 0, s>>>(
        static_cast<const float*>(q), k8, ksf, v8, vsf, idx,
        static_cast<float*>(out), heads, t_len, pos_stride, q_sb, q_sh,
        scale);
  }
}

template <int BITS>
void launch_float(const void* q, const void* k, const void* v,
                  const void* index, void* out, int batch, int heads,
                  int t_len, int q_sb, int q_sh, int is_bf16,
                  cudaStream_t s) {
  const float scale = 0.125f;  // 1 / sqrt(64)
  const dim3 grid(batch * heads);
  const uint8_t* k8 = static_cast<const uint8_t*>(k);
  const uint8_t* v8 = static_cast<const uint8_t*>(v);
  const int* idx = static_cast<const int*>(index);
  if (is_bf16) {
    decode_float_kernel<BITS, __nv_bfloat16><<<grid, NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), k8, v8, idx,
        static_cast<__nv_bfloat16*>(out), heads, t_len, q_sb, q_sh, scale);
  } else {
    decode_float_kernel<BITS, float><<<grid, NT, 0, s>>>(
        static_cast<const float*>(q), k8, v8, idx, static_cast<float*>(out),
        heads, t_len, q_sb, q_sh, scale);
  }
}

}  // namespace

// B2: bits 8 or 4; fp32 scales [B, H, T]; values pos_stride bytes apart.
extern "C" int mas_decode_quant(const void* q, const void* kq, const void* ks,
                                const void* vq, const void* vs,
                                const void* index, void* out, int batch,
                                int heads, int t_len, int pos_stride,
                                int q_sb, int q_sh, int bits, int is_bf16,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits == 4) {
    launch<4>(q, kq, ks, vq, vs, index, out, batch, heads, t_len, pos_stride,
              q_sb, q_sh, is_bf16, s);
  } else if (bits == 8) {
    launch<8>(q, kq, ks, vq, vs, index, out, batch, heads, t_len, pos_stride,
              q_sb, q_sh, is_bf16, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// B9: a contiguous bf16 (cache_bf16 = 1) or fp32 cache [B, H, T, 64]; q
// and out bf16 (is_bf16 = 1) or fp32.
extern "C" int mas_decode_float(const void* q, const void* k, const void* v,
                                const void* index, void* out, int batch,
                                int heads, int t_len, int q_sb, int q_sh,
                                int cache_bf16, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cache_bf16) {
    launch_float<16>(q, k, v, index, out, batch, heads, t_len, q_sb, q_sh,
                     is_bf16, s);
  } else {
    launch_float<32>(q, k, v, index, out, batch, heads, t_len, q_sb, q_sh,
                     is_bf16, s);
  }
  return static_cast<int>(cudaGetLastError());
}
