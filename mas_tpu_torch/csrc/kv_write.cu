// Quantize one decode token's k and v and write them into the int8/int4
// decode caches (kernels B3 and B10): one template, two kernel names.
//
// B3 replaces: mas_tpu/ops/decode_cache.py::_lane_write_kernel (launched by
// _lane_write_pallas), the write into the two lane caches of a layer.
// B10 replaces: mas_tpu/ops/decode_cache.py::_write_kernel (launched by
// _cache_write_pallas), the write into the packed cache of a layer.
//
// Computes, for every (b, h) row and for x = the row's new k, then v:
//   amax  = max_c |x[c]| over the head dim d
//   scale = max(amax, 1e-8) / qmax             (IEEE division)
//   q[c]  = clip(rint(x[c] / scale), -qmax, qmax)   (IEEE division, round
//           half to even), qmax 127 (int8) or 7 (int4)
// and stores q and scale in place at position *index of the cache, as
// mas_tpu/ops/quant.py:60-66 quantizes.  bf16 scales (the lane caches of
// kv_scale_dtype "bfloat16"): the fp32 scale is rounded to bf16 (nearest
// even) first, and x is divided by the rounded scale, so the stored values
// sit on the grid of the stored scale (mas_tpu/ops/quant.py:62-64).  int4 packs column 2i into the low
// nibble and 2i + 1 into the high nibble of one byte (two's complement).
// The division is __fdiv_rn and the rounding rintf whatever the build's
// flags, so the stored bits equal the plain twins' (which divide a tensor
// by a tensor: PyTorch's CUDA division by a Python float multiplies by its
// reciprocal, which can differ in the last bit).
//
// Cache layout (the port's own, ops/quant.py): values [B, H, T, W] with W =
// D (int8) or D / 2 (int4) bytes a position, D the width that holds d (32,
// 64, 128, or the least multiple of 256 >= d) and the bytes of columns past
// d left as they are (zero: an odd d's last byte of int4 pairs column d - 1
// with a zero nibble); scales [B, H, T] fp32, or bf16 for the lane caches.  The lane caches (B3) are two
// such buffers, positions W bytes apart.  The packed cache (B10) is one
// buffer of 2W-byte positions, k at byte 0 and v at byte W, and its scales
// [2, B, H, T] (k's, then v's); the host passes the v pointers into it.
//
// What bounds it on the H100: nothing but the launch.  A call reads B * H
// * 2 d values and writes B * H * 2 (W + 4) bytes (~130 KB at the 256^2
// serving batch, 0.04 us at 3.35 TB/s) and does one reduction over d per
// row; the device takes a few microseconds, the host's launch path more.
//
// What the design does about it:
// - One warp per (b, h) row, for k and v, WARPS rows per block; the launch
//   shape depends on B * H only (16 blocks at 128 rows, 256 at 2,048), and
//   the position is read on the device from *index, so one launch can be
//   captured in a CUDA graph and replayed at every position.
// - Lane l holds the VPL = max(2, D / 32) columns [l VPL, l VPL + VPL) of
//   the row: one vector load (4 to 32 bytes) when the chunk lies within d
//   and is aligned, element by element otherwise (zeros past d).  amax is
//   a shuffle reduction over the warp.  The lane's even/odd pairs become
//   its int4 bytes in registers: no strided gathers.  Each lane stores its
//   bytes once (lanes whose columns all lie past d store nothing, so the
//   padding stays as it is); lane 0 stores the two scales.
// - Above 256 columns the warp takes a position in chunks of 256 (the D =
//   256 instance and a chunk count): one sweep over the chunks for the
//   amax, a second that loads each chunk again, quantizes and stores it.
// - The host reaches it through ctypes with a plain C interface and no
//   Python launcher: the caches' layouts are checked once and kept
//   (ops/quant.py::QuantCache.layout), so a call checks only the new k, v
//   and the index tensor.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int WARPS = 8;         // (b, h) rows per block, one warp each
constexpr int NT = 32 * WARPS;

// columns per lane and lanes with columns for instance D
template <int D>
struct Lanes {
  static constexpr int VPL = D / 32 < 2 ? 2 : D / 32;
  static constexpr int ACTIVE = D / VPL;
};

// NW 32-bit words from p (aligned to min(4 NW, 16) bytes) by vector loads
template <int NW>
__device__ __forceinline__ void load_words(const void* p, uint32_t (&w)[NW]) {
  if constexpr (NW == 1) {
    w[0] = *static_cast<const uint32_t*>(p);
  } else if constexpr (NW == 2) {
    const uint2 a = *static_cast<const uint2*>(p);
    w[0] = a.x;
    w[1] = a.y;
  } else {
    static_assert(NW % 4 == 0, "whole 16-byte loads");
#pragma unroll
    for (int i = 0; i < NW / 4; ++i) {
      const uint4 a = static_cast<const uint4*>(p)[i];
      w[4 * i] = a.x;
      w[4 * i + 1] = a.y;
      w[4 * i + 2] = a.z;
      w[4 * i + 3] = a.w;
    }
  }
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// a scale as TS stores it, back in fp32 (bf16: rounded to nearest even)
__device__ __forceinline__ float stored(float x, const float*) { return x; }
__device__ __forceinline__ float stored(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ void store_scale(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_scale(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);   // exact: x is already a bf16 value
}

// columns [c0, c0 + VPL) of a row as floats, zero past d
template <typename T, int VPL>
__device__ __forceinline__ void load_chunk(const T* row, int c0, int d,
                                           float (&x)[VPL]) {
  constexpr int BYTES = VPL * static_cast<int>(sizeof(T));
  constexpr int ALIGN = BYTES < 16 ? BYTES : 16;
  const T* p = row + c0;
  if (c0 + VPL <= d && reinterpret_cast<uintptr_t>(p) % ALIGN == 0) {
    uint32_t w[BYTES / 4];
    load_words<BYTES / 4>(p, w);
#pragma unroll
    for (int i = 0; i < BYTES / 4; ++i) {
      if constexpr (sizeof(T) == 2) {  // bf16 -> fp32 is exact
        x[2 * i] = __uint_as_float(w[i] << 16);
        x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      } else {
        x[i] = __uint_as_float(w[i]);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < VPL; ++i) x[i] = c0 + i < d ? to_f(p[i]) : 0.f;
  }
}

// store the low 8 N bits of v at p (aligned to N bytes)
template <int N>
__device__ __forceinline__ void store_bytes(uint8_t* p, uint64_t v) {
  if constexpr (N == 1) {
    *p = static_cast<uint8_t>(v);
  } else if constexpr (N == 2) {
    *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(v);
  } else if constexpr (N == 4) {
    *reinterpret_cast<uint32_t*>(p) = static_cast<uint32_t>(v);
  } else {
    static_assert(N == 8, "1, 2, 4 or 8 bytes");
    *reinterpret_cast<uint2*>(p) =
        make_uint2(static_cast<uint32_t>(v), static_cast<uint32_t>(v >> 32));
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// quantize x (this lane's VPL columns, scale of the row) and store the
// lane's bytes at dst, the position's first byte
template <int BITS, int VPL>
__device__ __forceinline__ void quantize_store(const float (&x)[VPL],
                                               float scale, uint8_t* dst,
                                               int c0) {
  constexpr float QMAX = BITS == 4 ? 7.f : 127.f;
  uint64_t bytes = 0;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const float q = fminf(fmaxf(rintf(__fdiv_rn(x[i], scale)), -QMAX), QMAX);
    const uint64_t u = static_cast<uint64_t>(static_cast<int>(q));
    if constexpr (BITS == 8)
      bytes |= (u & 0xffu) << (8 * i);
    else  // column 2j -> low nibble of byte j, 2j + 1 -> high nibble
      bytes |= (u & 0xfu) << (4 * i);
  }
  if constexpr (BITS == 8)
    store_bytes<VPL>(dst + c0, bytes);
  else
    store_bytes<VPL / 2>(dst + c0 / 2, bytes);
}

// The body of both kernels: rows of new k and v [B, H, d] in T (strides
// in elements, last dim contiguous) -> caches at *index.  A position is nc
// chunks of D columns (nc > 1 only for the D = 256 instance, which serves
// every width 256 nc); PACKED: one position holds k and v (B10), else k or
// v alone (B3).  TS: the scales' type, float or __nv_bfloat16.
template <int BITS, int D, bool PACKED, typename T, typename TS>
__device__ __forceinline__ void write_row(
    const T* __restrict__ k_new, const T* __restrict__ v_new,
    uint8_t* __restrict__ kq, TS* __restrict__ ks,
    uint8_t* __restrict__ vq, TS* __restrict__ vs,
    const int* __restrict__ index, int rows, int heads, long long k_sb,
    long long k_sh, long long v_sb, long long v_sh, int t_len, int d,
    int nc_arg) {
  using L = Lanes<D>;
  constexpr int W = BITS == 4 ? D / 2 : D;      // bytes of a chunk of k
  const int nc = D == 256 ? nc_arg : 1;
  const long long stride = (PACKED ? 2LL : 1LL) * W * nc;  // position bytes
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int idx = *index;
  if (row >= rows || idx < 0 || idx >= t_len) return;
  const int b = row / heads, h = row % heads;
  const int c0 = lane * L::VPL;
  const bool has = lane < L::ACTIVE;
  const T* kr = k_new + b * k_sb + h * k_sh;
  const T* vr = v_new + b * v_sb + h * v_sh;

  // amax over every chunk; with one chunk its values stay in registers
  float kx[L::VPL], vx[L::VPL];
  float ka = 0.f, va = 0.f;
  for (int ch = 0; ch < nc; ++ch) {
    if (has) {
      load_chunk<T, L::VPL>(kr, ch * D + c0, d, kx);
      load_chunk<T, L::VPL>(vr, ch * D + c0, d, vx);
#pragma unroll
      for (int i = 0; i < L::VPL; ++i) {
        ka = fmaxf(ka, fabsf(kx[i]));
        va = fmaxf(va, fabsf(vx[i]));
      }
    }
  }
  constexpr float QMAX = BITS == 4 ? 7.f : 127.f;
  const float k_scale =
      stored(__fdiv_rn(fmaxf(warp_max(ka), 1e-8f), QMAX), ks);
  const float v_scale =
      stored(__fdiv_rn(fmaxf(warp_max(va), 1e-8f), QMAX), vs);

  const long long pos = (long long)row * t_len + idx;
  for (int ch = 0; ch < nc; ++ch) {
    const int col = ch * D + c0;
    if (has && col < d) {
      if (nc > 1) {
        load_chunk<T, L::VPL>(kr, col, d, kx);
        load_chunk<T, L::VPL>(vr, col, d, vx);
      }
      quantize_store<BITS, L::VPL>(kx, k_scale, kq + pos * stride + ch * W,
                                   c0);
      quantize_store<BITS, L::VPL>(vx, v_scale, vq + pos * stride + ch * W,
                                   c0);
    }
  }
  if (lane == 0) {
    store_scale(ks + pos, k_scale);
    store_scale(vs + pos, v_scale);
  }
}

// B3 (two kernel names, so a profile tells the two kernels apart)
template <int BITS, int D, typename T, typename TS>
__global__ void __launch_bounds__(NT)
kv_write_lane_kernel(const T* k_new, const T* v_new, uint8_t* kq, TS* ks,
                     uint8_t* vq, TS* vs, const int* index, int rows,
                     int heads, long long k_sb, long long k_sh,
                     long long v_sb, long long v_sh, int t_len, int d,
                     int nc) {
  write_row<BITS, D, false, T, TS>(k_new, v_new, kq, ks, vq, vs, index, rows,
                                   heads, k_sb, k_sh, v_sb, v_sh, t_len, d,
                                   nc);
}

// B10 (fp32 scales only)
template <int BITS, int D, typename T>
__global__ void __launch_bounds__(NT)
kv_write_packed_kernel(const T* k_new, const T* v_new, uint8_t* kq,
                       float* ks, uint8_t* vq, float* vs, const int* index,
                       int rows, int heads, long long k_sb, long long k_sh,
                       long long v_sb, long long v_sh, int t_len, int d,
                       int nc) {
  write_row<BITS, D, true, T, float>(k_new, v_new, kq, ks, vq, vs, index,
                                     rows, heads, k_sb, k_sh, v_sb, v_sh,
                                     t_len, d, nc);
}

struct WriteArgs {
  const void *k_new, *v_new;
  void *kq, *ks, *vq, *vs;
  const void* index;
  int rows, heads;
  long long k_sb, k_sh, v_sb, v_sh;
  int t_len, d, nc;
  cudaStream_t s;
};

template <int BITS, int D, typename T, typename TS>
cudaError_t launch(const WriteArgs& a, int packed) {
  void (*kernel)(const T*, const T*, uint8_t*, TS*, uint8_t*, TS*,
                 const int*, int, int, long long, long long, long long,
                 long long, int, int, int) = kv_write_lane_kernel<BITS, D, T,
                                                                  TS>;
  if (packed) {
    if constexpr (std::is_same<TS, float>::value)
      kernel = kv_write_packed_kernel<BITS, D, T>;
    else
      return cudaErrorInvalidValue;   // the packed cache's scales are fp32
  }
  kernel<<<(a.rows + WARPS - 1) / WARPS, NT, 0, a.s>>>(
      static_cast<const T*>(a.k_new), static_cast<const T*>(a.v_new),
      static_cast<uint8_t*>(a.kq), static_cast<TS*>(a.ks),
      static_cast<uint8_t*>(a.vq), static_cast<TS*>(a.vs),
      static_cast<const int*>(a.index), a.rows, a.heads, a.k_sb, a.k_sh,
      a.v_sb, a.v_sh, a.t_len, a.d, a.nc);
  return cudaGetLastError();
}

template <int BITS, int D, typename T>
cudaError_t launch_s(const WriteArgs& a, int scale_bf16, int packed) {
  return scale_bf16 ? launch<BITS, D, T, __nv_bfloat16>(a, packed)
                    : launch<BITS, D, T, float>(a, packed);
}

template <int BITS, int D>
cudaError_t launch_t(const WriteArgs& a, int scale_bf16, int packed,
                     int is_bf16) {
  return is_bf16 ? launch_s<BITS, D, __nv_bfloat16>(a, scale_bf16, packed)
                 : launch_s<BITS, D, float>(a, scale_bf16, packed);
}

template <int BITS>
cudaError_t launch_d(const WriteArgs& a, int width, int scale_bf16,
                     int packed, int is_bf16) {
  switch (width) {
    case 32: return launch_t<BITS, 32>(a, scale_bf16, packed, is_bf16);
    case 64: return launch_t<BITS, 64>(a, scale_bf16, packed, is_bf16);
    case 128: return launch_t<BITS, 128>(a, scale_bf16, packed, is_bf16);
    default:   // 256 nc columns: the D = 256 instance, chunk by chunk
      if (width % 256) return cudaErrorInvalidValue;
      return launch_t<BITS, 256>(a, scale_bf16, packed, is_bf16);
  }
}

}  // namespace

// B3 (packed = 0) and B10 (packed = 1).  k_new, v_new: [B, H, d] bf16
// (is_bf16 = 1) or fp32, element strides (b, h), last dim contiguous; kq,
// vq: value caches of `width` values a position (32, 64, 128 or a multiple
// of 256, >= d), bits 8 or 4; ks, vs: scales [B, H, T], bf16 when
// scale_bf16 = 1 (lane caches only), else fp32; index: 1-element int32
// device tensor.  Packed: vq = kq + W, vs = ks + B * H * T.
extern "C" int mas_kv_write(const void* k_new, const void* v_new, void* kq,
                            void* ks, void* vq, void* vs, const void* index,
                            int batch, int heads, long long k_sb,
                            long long k_sh, long long v_sb, long long v_sh,
                            int t_len, int d, int width, int bits,
                            int scale_bf16, int packed, int is_bf16,
                            void* stream) {
  if (d < 1 || d > width) return static_cast<int>(cudaErrorInvalidValue);
  const WriteArgs a = {k_new, v_new, kq, ks, vq, vs, index, batch * heads,
                       heads, k_sb, k_sh, v_sb, v_sh, t_len, d,
                       width >= 256 ? width / 256 : 1,
                       static_cast<cudaStream_t>(stream)};
  cudaError_t err = cudaErrorInvalidValue;
  if (bits == 4) err = launch_d<4>(a, width, scale_bf16, packed, is_bf16);
  if (bits == 8) err = launch_d<8>(a, width, scale_bf16, packed, is_bf16);
  return static_cast<int>(err);
}
