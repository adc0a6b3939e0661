// Single-token decode attention over an int8 or int4 KV cache (kernel B2)
// and over a float cache (kernel B9): one template, two kernel names.
//
// B2 replaces: mas_tpu/ops/quant.py::_int8_decode_kernel (launched by
// _decode_attention_int8_pallas), the fused quantized-cache read.
// B9 replaces: mas_tpu/ops/decode_attention.py::_decode_kernel (launched by
// _decode_attention_pallas), the read of the float ("compute") cache.
//
// Computes, for one query row per (b, h) and positions t <= index:
//   s[t] = (q' . k[t]) * ks[t]                 (k scale folds in after the dot)
//   p    = softmax(s)
//   out  = sum_t (p[t] * vs[t]) * v[t]          (v scale folds into p)
// with ks = vs = 1 for a float cache (no scale is read).  q' = q / sqrt(d):
// B2 scales in fp32 (mas_tpu/ops/quant.py:204); B9 scales in q's dtype, as
// the Pallas kernel's q * asarray(scale, q.dtype) (the host passes the
// scale rounded to that dtype; the product is rounded to it once).  p stays
// fp32, as in the Pallas kernels; the output is rounded to q's dtype once.
// Cache layout (the port's own): values [B, H, T, *] with the D values of
// a position contiguous: int8 [.., D], int4 [.., D/2] uint8 with two
// nibbles per byte (low nibble = even dim), bf16 or fp32 [.., D]; scales
// [B, H, T] fp32.  D is the width that holds the head dim d (32, 64, 128,
// or the least multiple of 256 >= d); the columns past d are zero, q is
// read at its d columns (zeros past them) and the output [B, H, 1, d] is
// written at d columns.
// Positions are ``pos_stride`` bytes apart and rows of one (b, h) are T *
// pos_stride bytes apart, so the k and v halves of the packed [B, H, T,
// 2D] cache are read in place through strided views; the lane
// caches have pos_stride = the bytes of one position.  ``index`` is a
// 1-element int32 device tensor: no launch parameter depends on it.
//
// What bounds both on the H100: bytes.  Every valid cache position is read
// once (d/2, d, 2d or 4d bytes, plus a 4-byte scale when quantized, for k
// and for v) and feeds only 2 d multiply-adds, far below the card's
// operations-per-byte balance.  MHA gives each (b, h) one query row, so
// the tensor cores have nothing to do.  The levers are bytes in flight and
// enough blocks on every SM.
//
// What the design does about it:
// - A ring of tiles in shared memory.  Each block copies tiles of P
//   positions of k, v (and their scales) with cp.async into a STAGES-deep
//   ring, STAGES - 1 tiles ahead of the one it computes on, so no global
//   load ever waits on the softmax, and every block keeps 24 KB in flight.
//   The math reads shared memory only.  A stage is 8 KB of values for
//   every (bits, d): P = 4096 / (bytes of one position).
// - A split over positions inside a thread-block cluster.  The launch has
//   B * H * S blocks, S consecutive blocks (one cluster) per (b, h).  The
//   host picks S from B * H alone (ops/quant.py::decode_split): enough
//   blocks for every SM at batch 4, S = 1 at the serving batch.  Block
//   rank j takes the positions [j c, (j + 1) c) of [0, valid) with
//   c = ceil(valid / S), computed on the device from ``index``, so the
//   launch shape never changes with the decode position (a CUDA graph can
//   hold it).  A chunk may be empty (valid < S): it contributes m = -1e30,
//   l = 0 and no NaN.  Each block merges its warps' online-softmax states
//   into (m, l, acc[d]) in shared memory; rank 0 reads its peers' states
//   through distributed shared memory (cluster.map_shared_rank), merges
//   them in rank order and writes the output; a second cluster.sync keeps
//   every block alive until rank 0 has read it.  No global workspace, no
//   counter to reset, and the chunking depends on B * H and valid only,
//   so the packed read and the lane read of the same values give the same
//   bits.
// - Lane mapping: every lane works on 16 bytes of one position (bf16: 8
//   values, fp32: 4, int8: 16), 8 for int4 (16 values), so a warp's
//   shared-memory reads are contiguous and free of bank conflicts (32
//   bytes for an fp32 position of 256 values).  Each lane group keeps its
//   own online-softmax state and rescales once per tile.  int8 and int4
//   values become floats by the 2^23 magic-number trick (exact for these
//   small integers), not by the quarter-rate integer-to-float conversion.
// - The instance width D is a template parameter: 32, 64, 128 and 256.  At
//   D = 256 a bf16 position is 512 bytes, a whole warp of 16-byte lanes; an
//   fp32 one takes 32 bytes a lane.
// - A wider position (256 nc columns) goes through the D = 256 instance in
//   chunks: a tile's sub-tile c brings chunk c of its k values, and each
//   lane sums its part of q . k over the chunks before the scores are
//   reduced; the last sub-tile also brings the v values of the block's
//   output pass (blockIdx.y: columns [256 pass, 256 pass + 256)), so the
//   registers stay those of D = 256 and each pass recomputes the scores.
//   The launch shape still depends on B * H (and the width) only.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 4;
constexpr int NT = 32 * WARPS;
constexpr int STAGES = 4;         // ring depth: STAGES - 1 tiles in flight
constexpr int STAGE_VALUES = 8192;  // bytes of k and v values per stage
constexpr int MAX_SPLIT = 8;      // portable cluster size
constexpr float NEG = -1e30f;     // masked score, as the Pallas kernels

// geometry of one (bits, head dim) instance.  A lane works on 16 bytes of
// a position, 8 for int4: 32 int4 values a lane took 109 registers (q and
// accumulator alone 64), four blocks an SM; 16 values take 84, five.  An
// fp32 position of 256 values (1 KB) takes 32 bytes a lane.
template <int BITS, int D>
struct Geo {
  static constexpr int W = D * BITS / 8;   // bytes of one position (k or v)
  static constexpr int UNIT = BITS == 4 ? 8 : 16;  // bytes of one unpack
  static constexpr int LB = W / 32 > UNIT ? W / 32 : UNIT;  // bytes a lane
  static constexpr int LPP = W / LB;       // lanes per position
  static constexpr int VPL = LB * 8 / BITS;  // values per lane
  static constexpr int PPW = 32 / LPP;     // positions per warp step
  static constexpr int PPB = PPW * WARPS;  // positions per block step
  static constexpr int P = STAGE_VALUES / (2 * W);  // positions per tile
  static constexpr int STEPS = P / PPB;    // block steps per tile
  static constexpr int CPP = W / 16;       // 16-byte copies per position
  static constexpr int VAL_BYTES = 2 * P * W;                   // k, v
  static constexpr int STAGE_BYTES = VAL_BYTES + (BITS <= 8 ? 8 * P : 0);
  static_assert(LPP >= 1 && LPP <= 32 && (LPP & (LPP - 1)) == 0,
                "a position spans a power of two of lanes");
  static_assert(VPL * LPP == D, "lanes cover the head dim");
  static_assert(CPP >= 1 && P * CPP % NT == 0,
                "whole 16-byte copies per thread");
  static_assert(STEPS >= 1 && STEPS * PPB == P, "whole steps per tile");
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// x rounded to TQ (round to nearest even) and back
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared; zero-filled when !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The cache bytes of one lane (in shared memory) -> VPL floats.  BITS 8:
// 16 int8 values; 4: 8 bytes of int4 values (two's complement); 16: 8
// bf16; 32: 4 fp32.
template <int BITS>
__device__ __forceinline__ void unpack(const uint8_t* p, float* out);

template <>
__device__ __forceinline__ void unpack<8>(const uint8_t* p, float* out) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // byte b + 128 as the low byte of 2^23: float 2^23 + 128 + b, exactly
    const uint32_t x = u[i] ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[4 * i + j] =
          __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440 + j)) -
          8388736.0f;
  }
}

template <>
__device__ __forceinline__ void unpack<4>(const uint8_t* p, float* out) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const uint32_t u[2] = {w.x, w.y};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // byte j of a word holds dims 8 i + 2 j (low nibble) and 8 i + 2 j + 1
    // (high nibble); each nibble n + 8 becomes the low byte of 2^23: float
    // 2^23 + 8 + n, exactly
    const uint32_t lo = (u[i] & 0x0F0F0F0Fu) ^ 0x08080808u;
    const uint32_t hi = ((u[i] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      out[8 * i + 2 * j] =
          __uint_as_float(__byte_perm(lo, 0x4B000000u, 0x7440 + j)) -
          8388616.0f;
      out[8 * i + 2 * j + 1] =
          __uint_as_float(__byte_perm(hi, 0x4B000000u, 0x7440 + j)) -
          8388616.0f;
    }
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
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
}

// a lane's LB bytes: LB / UNIT unpacks of UNIT bytes each
template <int BITS, int D>
__device__ __forceinline__ void unpack_lane(const uint8_t* p, float* out) {
  using G = Geo<BITS, D>;
  constexpr int VPU = G::UNIT * 8 / BITS;  // values of one unpack
#pragma unroll
  for (int u = 0; u < G::LB / G::UNIT; ++u)
    unpack<BITS>(p + u * G::UNIT, out + u * VPU);
}

// The body of both kernels, for block rank j of the cluster of one (b, h).
// BITS 8 / 4: a quantized cache with per-position scales (B2); 16 / 32: a
// bf16 / fp32 cache without scales (B9).  pos_stride: bytes between
// positions; d: the head dim (<= D nc), q's and out's columns.  A position
// is nc chunks of D columns (nc > 1 only for the D = 256 instance); the
// block computes output columns [D pass, D pass + D), pass = blockIdx.y,
// from the scores over all nc chunks.
template <int BITS, int D, typename TQ>
__device__ __forceinline__ void decode_block(
    const TQ* __restrict__ q, const uint8_t* __restrict__ kq,
    const float* __restrict__ ks, const uint8_t* __restrict__ vq,
    const float* __restrict__ vs, const int* __restrict__ index,
    TQ* __restrict__ out, int H, int t_len, int pos_stride, int q_sb,
    int q_sh, int d, float scale, int nc_arg) {
  using G = Geo<BITS, D>;
  constexpr bool SCALED = BITS <= 8;   // quantized: fold in the scales
  constexpr int VPL = G::VPL;
  __shared__ __align__(16) uint8_t ring[STAGES * G::STAGE_BYTES];
  __shared__ float sm_m[WARPS], sm_l[WARPS];
  __shared__ float sm_acc[WARPS][D];
  __shared__ float part_m, part_l;   // this block's state, read by rank 0
  __shared__ float part_acc[D];

  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int nc = D == 256 ? nc_arg : 1;
  const int pass = D == 256 ? static_cast<int>(blockIdx.y) : 0;
  const int bh = blockIdx.x / split;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int grp = lane / G::LPP;   // position slot in the warp
  const int part = lane % G::LPP;  // which LB bytes of the position

  // this block's positions: [lo, hi) of [0, valid)
  const int valid = min(index[0] + 1, t_len);
  const int chunk = (valid + split - 1) / split;
  const int lo = min(rank * chunk, valid);
  const int hi = min(lo + chunk, valid);
  const int ntiles = (hi - lo + G::P - 1) / G::P;
  const int nsub = ntiles * nc;   // sub-tiles: a tile's nc column chunks

  const long long row = (long long)bh * t_len;
  const uint8_t* kb = kq + row * pos_stride;
  const uint8_t* vb = vq + row * pos_stride + pass * G::W;
  const float* ksb = SCALED ? ks + row : nullptr;  // float caches: no scales
  const float* vsb = SCALED ? vs + row : nullptr;

  // sub-tile u (chunk c = u % nc of tile u / nc) -> ring slot `slot`: chunk
  // c of the k values [P][W]; with the last chunk, the v values of this
  // block's pass [P][W], then k and v scales [P] each; positions past hi
  // zero-filled
  auto load_sub = [&](int u, int slot) {
    const int c = u % nc;
    const bool last = c == nc - 1;
    const int p0 = lo + (u / nc) * G::P;
    const uint32_t st = smem_addr(ring + slot * G::STAGE_BYTES);
#pragma unroll
    for (int i = 0; i < G::P * G::CPP / NT; ++i) {
      const int cc = tid + i * NT;
      const int p = cc / G::CPP, off = (cc % G::CPP) * 16;
      const bool ok = p0 + p < hi;
      const long long src = (long long)(ok ? p0 + p : 0) * pos_stride + off;
      cp_async16(st + p * G::W + off, kb + src + c * G::W, ok);
      if (last) cp_async16(st + G::P * G::W + p * G::W + off, vb + src, ok);
    }
    if constexpr (SCALED) {
      for (int p = tid; last && p < G::P; p += NT) {
        const bool ok = p0 + p < hi;
        const int pos = ok ? p0 + p : 0;
        cp_async4(st + G::VAL_BYTES + 4 * p, ksb + pos, ok);
        cp_async4(st + G::VAL_BYTES + 4 * (G::P + p), vsb + pos, ok);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsub) load_sub(s, s);
    cp_async_commit();
  }

  // q' of chunk c: VPL dims per lane, zeros past the head dim d
  float qr[VPL];
  const TQ* qp = q + (long long)(bh / H) * q_sb + (long long)(bh % H) * q_sh +
                 part * VPL;
  auto load_q = [&](int c) {
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int col = c * D + part * VPL + i;
      const float x = col < d ? to_f(qp[c * D + i]) * scale : 0.f;
      qr[i] = SCALED ? x : round_to(x, q);
    }
  };
  load_q(0);   // while the first tiles are in flight

  float m = NEG, l = 0.f;
  float acc[VPL];
#pragma unroll
  for (int c = 0; c < VPL; ++c) acc[c] = 0.f;
  float dots[G::STEPS];   // this lane's part of each position's q . k

  for (int u = 0; u < nsub; ++u) {
    if (u + STAGES - 1 < nsub)
      load_sub(u + STAGES - 1, (u + STAGES - 1) % STAGES);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // sub-tile u has landed
    __syncthreads();
    const int c = u % nc;
    const uint8_t* st = ring + (u % STAGES) * G::STAGE_BYTES;
    if (nc > 1 && u > 0) load_q(c);

    // this lane's part of the dot products of its STEPS positions
#pragma unroll
    for (int j = 0; j < G::STEPS; ++j) {
      const int p = j * G::PPB + warp * G::PPW + grp;
      float kf[VPL];
      unpack_lane<BITS, D>(st + p * G::W + part * G::LB, kf);
      // four partial sums: a chain of VPL dependent fmas would stall
      float dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int cc = 0; cc < VPL; ++cc)
        dp[cc % 4] = fmaf(qr[cc], kf[cc], dp[cc % 4]);
      const float dot = (dp[0] + dp[1]) + (dp[2] + dp[3]);
      dots[j] = c == 0 ? dot : dots[j] + dot;
    }
    if (c == nc - 1) {
      // scores of this lane group's STEPS positions; one rescale per tile
      const float* kss = reinterpret_cast<const float*>(st + G::VAL_BYTES);
      const int p0 = lo + (u / nc) * G::P;
      float sc[G::STEPS];
      float tmax = NEG;
#pragma unroll
      for (int j = 0; j < G::STEPS; ++j) {
        const int p = j * G::PPB + warp * G::PPW + grp;
        float dot = dots[j];
#pragma unroll
        for (int o = 1; o < G::LPP; o <<= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        const float s = SCALED ? dot * kss[p] : dot;
        sc[j] = p0 + p < hi ? s : NEG;
        tmax = fmaxf(tmax, sc[j]);
      }
      if (tmax > m) {
        const float alpha = expf(m - tmax);
        l *= alpha;
#pragma unroll
        for (int cc = 0; cc < VPL; ++cc) acc[cc] *= alpha;
        m = tmax;
      }
#pragma unroll
      for (int j = 0; j < G::STEPS; ++j) {
        const int p = j * G::PPB + warp * G::PPW + grp;
        if (p0 + p < hi) {
          const float pr = expf(sc[j] - m);
          l += pr;
          const float pv = SCALED ? pr * kss[G::P + p] : pr;
          float vf[VPL];
          unpack_lane<BITS, D>(st + G::P * G::W + p * G::W + part * G::LB,
                               vf);
#pragma unroll
          for (int cc = 0; cc < VPL; ++cc) acc[cc] = fmaf(pv, vf[cc], acc[cc]);
        }
      }
    }
    __syncthreads();  // every warp is done with this slot
  }

  // merge the PPW position groups of the warp (lanes LPP apart)
  float m_w = m;
#pragma unroll
  for (int o = G::LPP; o < 32; o <<= 1)
    m_w = fmaxf(m_w, __shfl_xor_sync(0xffffffffu, m_w, o));
  const float f = expf(m - m_w);
  l *= f;
#pragma unroll
  for (int o = G::LPP; o < 32; o <<= 1)
    l += __shfl_xor_sync(0xffffffffu, l, o);
#pragma unroll
  for (int c = 0; c < VPL; ++c) {
    float a = acc[c] * f;
#pragma unroll
    for (int o = G::LPP; o < 32; o <<= 1)
      a += __shfl_xor_sync(0xffffffffu, a, o);
    acc[c] = a;
  }
  if (grp == 0) {
#pragma unroll
    for (int c = 0; c < VPL; ++c) sm_acc[warp][part * VPL + c] = acc[c];
    if (part == 0) {
      sm_m[warp] = m_w;
      sm_l[warp] = l;
    }
  }
  __syncthreads();

  // merge the warps into this block's state; one thread per dim (two at
  // D = 256)
  for (int c = tid; c < D; c += NT) {
    float mm = sm_m[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) mm = fmaxf(mm, sm_m[w]);
    float ll = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float e = expf(sm_m[w] - mm);
      ll += sm_l[w] * e;
      a += sm_acc[w][c] * e;
    }
    part_acc[c] = a;
    if (c == 0) {
      part_m = mm;
      part_l = ll;
    }
  }
  cluster.sync();  // every block's state is written

  // rank 0 merges the cluster's states in rank order and writes out this
  // pass's columns below d; the remote reads of all ranks are issued before
  // any is used
  const int cols = min(D, d - pass * D);
  for (int c = tid; rank == 0 && c < cols; c += NT) {
    float rm[MAX_SPLIT], rl[MAX_SPLIT], ra[MAX_SPLIT];
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r) {
      const bool in = r < split;
      const int rr = in ? r : 0;   // a rank of the cluster, read or not
      const float m_r = *cluster.map_shared_rank(&part_m, rr);
      const float l_r = *cluster.map_shared_rank(&part_l, rr);
      const float a_r = cluster.map_shared_rank(part_acc, rr)[c];
      rm[r] = in ? m_r : NEG;
      rl[r] = in ? l_r : 0.f;
      ra[r] = in ? a_r : 0.f;
    }
    float mm = rm[0];
#pragma unroll
    for (int r = 1; r < MAX_SPLIT; ++r) mm = fmaxf(mm, rm[r]);
    float ll = 0.f, a = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r) {
      const float e = expf(rm[r] - mm);
      ll += rl[r] * e;
      a += ra[r] * e;
    }
    store_f(out + (long long)bh * d + pass * D + c, a / ll);
  }
  cluster.sync();  // no block leaves while rank 0 reads its shared memory
}

// B2 (two kernel names, so a profile tells the two kernels apart)
template <int BITS, int D, typename TQ>
__global__ void __launch_bounds__(NT)
decode_quant_kernel(const TQ* q, const uint8_t* kq, const float* ks,
                    const uint8_t* vq, const float* vs, const int* index,
                    TQ* out, int H, int t_len, int pos_stride, int q_sb,
                    int q_sh, int d, float scale, int nc) {
  decode_block<BITS, D, TQ>(q, kq, ks, vq, vs, index, out, H, t_len,
                            pos_stride, q_sb, q_sh, d, scale, nc);
}

// B9
template <int BITS, int D, typename TQ>
__global__ void __launch_bounds__(NT)
decode_float_kernel(const TQ* q, const uint8_t* k, const uint8_t* v,
                    const int* index, TQ* out, int H, int t_len, int q_sb,
                    int q_sh, int d, float scale, int nc) {
  decode_block<BITS, D, TQ>(q, k, nullptr, v, nullptr, index, out, H, t_len,
                            D * BITS / 8 * nc, q_sb, q_sh, d, scale, nc);
}

// rows * split x passes blocks of NT threads, clusters of `split` blocks
// along x
template <typename... KArgs, typename... Args>
cudaError_t launch_split(void (*kernel)(KArgs...), int rows, int split,
                         int passes, cudaStream_t s, Args... args) {
  if (split < 1 || split > MAX_SPLIT) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rows * split, passes);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

struct QuantArgs {
  const void *q, *kq, *ks, *vq, *vs, *index;
  void* out;
  int rows, heads, t_len, pos_stride, q_sb, q_sh, d, split, nc;
  float scale;
  cudaStream_t s;
};

template <int BITS, int D, typename TQ>
cudaError_t launch_quant(const QuantArgs& a) {
  return launch_split(
      decode_quant_kernel<BITS, D, TQ>, a.rows, a.split, a.nc, a.s,
      static_cast<const TQ*>(a.q), static_cast<const uint8_t*>(a.kq),
      static_cast<const float*>(a.ks), static_cast<const uint8_t*>(a.vq),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.index),
      static_cast<TQ*>(a.out), a.heads, a.t_len, a.pos_stride, a.q_sb,
      a.q_sh, a.d, a.scale, a.nc);
}

template <int BITS, int D>
cudaError_t launch_quant_q(const QuantArgs& a, int is_bf16) {
  return is_bf16 ? launch_quant<BITS, D, __nv_bfloat16>(a)
                 : launch_quant<BITS, D, float>(a);
}

template <int BITS>
cudaError_t launch_quant_d(const QuantArgs& a, int head_dim, int is_bf16) {
  switch (head_dim) {
    case 32: return launch_quant_q<BITS, 32>(a, is_bf16);
    case 64: return launch_quant_q<BITS, 64>(a, is_bf16);
    case 128: return launch_quant_q<BITS, 128>(a, is_bf16);
    default:   // 256 nc columns: the D = 256 instance, chunk by chunk
      if (head_dim % 256) return cudaErrorInvalidValue;
      return launch_quant_q<BITS, 256>(a, is_bf16);
  }
}

template <int BITS, int D, typename TQ>
cudaError_t launch_float(const QuantArgs& a) {
  return launch_split(
      decode_float_kernel<BITS, D, TQ>, a.rows, a.split, a.nc, a.s,
      static_cast<const TQ*>(a.q), static_cast<const uint8_t*>(a.kq),
      static_cast<const uint8_t*>(a.vq), static_cast<const int*>(a.index),
      static_cast<TQ*>(a.out), a.heads, a.t_len, a.q_sb, a.q_sh, a.d,
      a.scale, a.nc);
}

template <int BITS, int D>
cudaError_t launch_float_q(const QuantArgs& a, int is_bf16) {
  return is_bf16 ? launch_float<BITS, D, __nv_bfloat16>(a)
                 : launch_float<BITS, D, float>(a);
}

template <int BITS>
cudaError_t launch_float_d(const QuantArgs& a, int head_dim, int is_bf16) {
  switch (head_dim) {
    case 32: return launch_float_q<BITS, 32>(a, is_bf16);
    case 64: return launch_float_q<BITS, 64>(a, is_bf16);
    case 128: return launch_float_q<BITS, 128>(a, is_bf16);
    default:   // 256 nc columns: the D = 256 instance, chunk by chunk
      if (head_dim % 256) return cudaErrorInvalidValue;
      return launch_float_q<BITS, 256>(a, is_bf16);
  }
}

}  // namespace

// B2: bits 8 or 4, width 32, 64, 128 or a multiple of 256 holding head dim
// d (values a position);
// fp32 scales [B, H, T]; values pos_stride bytes apart; q [B, H, 1, d] and
// out (contiguous [B, H, 1, d]) bf16 (is_bf16 = 1) or fp32; `split` blocks
// per (b, h), 1 to 8; `scale` = 1 / sqrt(d) in fp32.
extern "C" int mas_decode_quant(const void* q, const void* kq, const void* ks,
                                const void* vq, const void* vs,
                                const void* index, void* out, int batch,
                                int heads, int t_len, int pos_stride,
                                int q_sb, int q_sh, int width, int d,
                                int bits, int is_bf16, int split, float scale,
                                void* stream) {
  if (d < 1 || d > width) return static_cast<int>(cudaErrorInvalidValue);
  const QuantArgs a = {q, kq, ks, vq, vs, index, out, batch * heads, heads,
                       t_len, pos_stride, q_sb, q_sh, d, split,
                       width >= 256 ? width / 256 : 1, scale,
                       static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (bits == 4) {
    err = launch_quant_d<4>(a, width, is_bf16);
  } else if (bits == 8) {
    err = launch_quant_d<8>(a, width, is_bf16);
  } else {
    err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// B9: a contiguous bf16 (cache_bf16 = 1) or fp32 cache [B, H, T, width]
// with width 32, 64, 128 or a multiple of 256 holding head dim d; q
// [B, H, 1, d] and out
// (contiguous) bf16 (is_bf16 = 1) or fp32; `scale` = 1 / sqrt(d) rounded
// to q's dtype.
extern "C" int mas_decode_float(const void* q, const void* k, const void* v,
                                const void* index, void* out, int batch,
                                int heads, int t_len, int q_sb, int q_sh,
                                int width, int d, int cache_bf16, int is_bf16,
                                int split, float scale, void* stream) {
  if (d < 1 || d > width) return static_cast<int>(cudaErrorInvalidValue);
  const QuantArgs a = {q, k, nullptr, v, nullptr, index, out, batch * heads,
                       heads, t_len, 0, q_sb, q_sh, d, split,
                       width >= 256 ? width / 256 : 1, scale,
                       static_cast<cudaStream_t>(stream)};
  const cudaError_t err = cache_bf16 ? launch_float_d<16>(a, width, is_bf16)
                                     : launch_float_d<32>(a, width, is_bf16);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
