// Tensor-core building blocks of the bf16 flash-attention kernels (B1, B6).
//
// Tiles of D bf16 values per row (the head dim, D = 64, 128 or 256, a
// template parameter) sit in shared memory as 2D-byte rows of D / 8
// 16-byte chunks, chunk c of row r stored at chunk c ^ (r & 7).  The eight
// rows an 8 x 8 ldmatrix reads at one logical chunk then fall on eight
// physical chunks that differ in their low three bits, i.e. on all 32
// banks: loads of A fragments, B fragments and their transposes are free
// of bank conflicts.
//
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate), per warp, with lane
// = 4 * grp + tig:
//   A [16 x 16]: a0 = (grp, 2tig..+1), a1 = (grp + 8, 2tig..), a2 = (grp,
//                8 + 2tig..), a3 = (grp + 8, 8 + 2tig..)
//   B [16 x 8]:  b0 = (k 2tig..+1, n grp), b1 = (k 8 + 2tig.., n grp)
//   C [16 x 8]:  c0, c1 = (grp, 2tig..+1), c2, c3 = (grp + 8, 2tig..+1)
// So the C fragments of two neighbouring n8 tiles, rounded to bf16 in
// pairs, are the A fragment of one k16 slice: a product's result feeds the
// next product from registers.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace flash_mma {

// bytes of a 64-row bf16 tile of head dim D
template <int D>
__host__ __device__ constexpr int tile_bytes() { return 64 * D * 2; }
constexpr float LOG2E = 1.4426950408889634f;

// byte offset of 16-byte chunk c of row r in a swizzled tile of head dim D
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * (2 * D) + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x through an opaque move: what is computed from the result stays where
// it is computed, instead of being hoisted out of the enclosing loops and
// kept in registers
__device__ __forceinline__ int opaque(int x) {
  int r;
  asm volatile("mov.b32 %0, %1;\n" : "=r"(r) : "r"(x));
  return r;
}

// rows [row0, row0 + 64) of a [*, D] bf16 matrix with the given row stride
// (elements, a multiple of 8) into a swizzled tile; rows at or past t_len
// are zero-filled.  NTHREADS threads share the 8 D chunks.  From D = 128
// on the addresses are computed at each call: hoisted out of the callers'
// loops they would hold 16 (32 at D = 256) addresses per tile in
// registers.
template <int NTHREADS, int D>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int row0,
                                          int t_len) {
  constexpr int CPR = D / 8;  // chunks per row
  static_assert(64 * CPR % NTHREADS == 0, "whole chunks per thread");
  // unsigned: the divisions by the power of two CPR are shifts
  const unsigned tid = D == 64 ? threadIdx.x : opaque(threadIdx.x);
#pragma unroll
  for (int i = 0; i < 64 * CPR / NTHREADS; ++i) {
    const unsigned idx = tid + i * NTHREADS;
    const int r = idx / CPR, c = idx % CPR;
    const bool ok = row0 + r < t_len;
    const __nv_bfloat16* g =
        src + (ok ? row0 + r : 0) * row_stride + c * 8;
    cp_async16(dst + swz<D>(r, c), g, ok);
  }
}

// load_tile without unrolling, for kernels that hold many accumulators
// across several tile loads (the backward's passes above d 256): the
// unrolled copies' addresses did not fit beside them
template <int NTHREADS, int D>
__device__ __forceinline__ void load_tile_rolled(uint32_t dst,
                                                 const __nv_bfloat16* src,
                                                 long long row_stride,
                                                 int row0, int t_len) {
  constexpr int CPR = D / 8;  // chunks per row
#pragma unroll 1
  for (unsigned idx = threadIdx.x; idx < 64 * CPR; idx += NTHREADS) {
    const int r = idx / CPR, c = idx % CPR;
    const bool ok = row0 + r < t_len;
    const __nv_bfloat16* g =
        src + (ok ? row0 + r : 0) * row_stride + c * 8;
    cp_async16(dst + swz<D>(r, c), g, ok);
  }
}

// 4 bytes global -> shared (through L1); zero-filled when !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The three fragment loads, for a warp whose lane is `lane`, from a
// swizzled [rows][D] tile at `tile`:
// A of the 16 x 16 block at rows [r0, r0 + 16), dims [16 j, 16 j + 16)
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], uint32_t tile,
                                       int r0, int j, int lane) {
  ldsm_x4(a, tile + swz<D>(r0 + (lane & 15), 2 * j + (lane >> 4)));
}

// B of two n8 tiles (n = rows [n0, n0 + 16) of the tile, k = dims [16 j,
// 16 j + 16)): the tile holds B transposed ([n][k], e.g. K for Q K^T).
// b[0], b[1] serve n tile n0, b[2], b[3] n tile n0 + 8.
template <int D>
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], uint32_t tile,
                                          int n0, int j, int lane) {
  ldsm_x4(b, tile + swz<D>(n0 + (lane & 7) + ((lane >> 4) << 3),
                           2 * j + ((lane >> 3) & 1)));
}

// B of two n8 tiles (k = rows [16 j, 16 j + 16) of the tile, n = dims
// [n0, n0 + 16)): the tile holds B as it is ([k][n], e.g. V for P V).
template <int D>
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], uint32_t tile,
                                          int n0, int j, int lane) {
  ldsm_x4_t(b, tile + swz<D>(16 * j + (lane & 15), (n0 >> 3) + (lane >> 4)));
}

// d += a b, one m16n8k16 tensor-core product
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values rounded to one bf16 pair, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// a bf16 pair times `scale`, rounded to bf16 once (exact when scale is a
// power of two)
__device__ __forceinline__ uint32_t scale_pair(uint32_t x, float scale) {
  return pack_bf16(__uint_as_float(x << 16) * scale,
                   __uint_as_float(x & 0xffff0000u) * scale);
}

// The A fragment of k16 slice j from the C fragments of n8 tiles 2j, 2j+1
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4],
                                       const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// acc [16 rows x 8 N] of this warp (C fragments of N n8 tiles, N = D / 8
// unless the accumulator holds a column slice) -> bf16 rows r0.. r0 + 15,
// chunks [chunk0, chunk0 + N) of a swizzled tile at `tile` (generic pointer
// to shared)
template <int D, int N>
__device__ __forceinline__ void store_rows(unsigned char* tile,
                                           const float (&acc)[N][4],
                                           float mul_lo, float mul_hi,
                                           int r0, int lane, int chunk0 = 0) {
  const int grp = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int nt = 0; nt < N; ++nt) {
    *reinterpret_cast<uint32_t*>(tile + swz<D>(r0 + grp, chunk0 + nt) +
                                 4 * tig) =
        pack_bf16(acc[nt][0] * mul_lo, acc[nt][1] * mul_lo);
    *reinterpret_cast<uint32_t*>(tile + swz<D>(r0 + grp + 8, chunk0 + nt) +
                                 4 * tig) =
        pack_bf16(acc[nt][2] * mul_hi, acc[nt][3] * mul_hi);
  }
}

__device__ __forceinline__ int row_bound(int row, int pfx) {
  return row < pfx ? pfx : row + 1;
}

}  // namespace flash_mma
