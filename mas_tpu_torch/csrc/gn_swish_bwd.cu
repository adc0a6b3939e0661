// Backward of the fused GroupNorm + swish over NHWC (kernel B8).
//
// Replaces: mas_tpu/ops/pallas/gn_swish.py::_bwd_reduce_kernel and
// _bwd_apply_kernel (launched by _gn_swish_bwd_pallas).
//
// Computes, for x, g [B, HW, C] (bf16 or fp32, contiguous NHWC), fp32 scale
// w and bias b [C] and the forward's fp32 stats [B, 2, G] (mean, rstd per
// (b, group), kernel B4), per element with c's group gr:
//   x^ = (x - mean) rstd,  a = x^ w + b,  s = sigmoid(a)
//   ga = g s (1 + a (1 - s)),  dx^ = ga w
//   S1 = sum dx^, S2 = sum dx^ x^   over the group of one image (N values)
//   dx = rstd (dx^ - (S1 + x^ S2) / N)            in x's dtype
//   dscale[c] = sum ga x^, dbias[c] = sum ga       over all B * HW rows, fp32
//
// What bounds it on the H100: bytes.  x and g are read twice and dx written
// once: 335 MB at the seg encoder's [2, 256, 256, 128] fp32, 0.100 ms at
// 3.35 TB/s.
//
// What the design does about it: one persistent, cooperative launch in
// three phases, so nothing but the partial sums goes to device memory
// between the two reads.
// - The grid is what can be resident at once (at most two blocks of 256
//   threads an SM: a third adds partials and was no faster, nor were eight
//   rows in flight in place of four), launched cooperatively.  A thread takes E = 4
//   channels (16 bytes of fp32, 8 of bf16: with 16 bytes of bf16 the eight
//   channels' constants did not fit beside four rows in flight); a slab is
//   the channels 256 threads cover, or all of C.  The rows of image b are
//   cut into S = max(1, grid / (B slabs)) slices; item ((b S + s) slabs + k)
//   is slab k of slice s of image b (gn_swish.cuh's map, shared with B4),
//   and block i takes items i, i + grid, ...  The map depends on the grid
//   size only.  Any C that the groups divide: where C is not a multiple of
//   E, or x, g or dx is not aligned for the vector, an instance with
//   element loads (the slab's ragged tail masked) takes the call.
// - Phase 1: a block walks its items' rows, 256 / (slab vectors) rows at a
//   time, loading four rows' x and g before it uses any.  It recomputes x^
//   and dx^ (scale, bias, mean and rstd of its four channels in registers;
//   the sigmoid by __expf and __fdividef, whose error of a few ulps is far
//   inside the fp32 tolerance: the full-precision ones made the bf16 case
//   instruction-bound) and keeps per-channel sums of dx^, dx^ x^, ga and ga
//   x^ in registers; the block's threads combine them in shared memory in
//   row order and write the item's slab of the (b, s) partial [4, C] in
//   fp32.
// - Grid barrier (cooperative_groups::this_grid().sync()).
// - Phase 2: all blocks share the merge.  A unit is 32 channels of one
//   image's S1/S2 inputs, or 32 channels of dscale/dbias; each warp of the
//   unit's block sums every 8th partial (eight loads in flight), lane c its
//   channel, and the block's warps combine in warp order: per-(b, c) sums
//   of dx^ and dx^ x^ into scratch [B, 2, C], and dscale, dbias.
// - Grid barrier.
// - Phase 3: each block takes its items, and their rows, in reverse order
//   (the rows phase 1 read last are still in the 50 MB L2), sums the
//   scratch over the channels of each group its slab touches into S1, S2
//   (a fixed order: strided lanes, then a shuffle tree), and writes dx,
//   again four rows at a time.  Any C and any number of groups: nothing
//   of a whole image's channels is staged in shared memory.
// No atomic touches a sum, so two calls on one card give equal bits.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gn_swish.cuh"

namespace cg = cooperative_groups;

namespace {

using gn::NT;
constexpr int E = 4;                   // channels a thread
constexpr int MAX_BLOCKS_PER_SM = 2;
constexpr int U = 4;                   // rows whose loads are in flight

struct Params {
  const void* x;
  const void* g;
  const float* w;
  const float* b;
  const float* stats;   // [B, 2, G]
  void* dx;
  float* part;          // [B, S, 4, C]
  float* bc;            // [B, 2, C]
  float* dscale;
  float* dbias;
  gn::Items items;
  int batch, groups;
  float inv_count;      // 1 / (HW * C / G)
};

// Shared memory: the per-thread sums [NT][4 E], combined in row order (in
// phase 3: S1, S2 of the groups of a slab, at most 2 NT E values).
constexpr int SMEM_FLOATS = NT * 4 * E;

// the constants of a thread's E channels for one image
struct Consts {
  float w[E], b[E], mean[E], rstd[E];
};

// x^, ga and dx^ of one thread's E values of a row
__device__ __forceinline__ void recompute(const float* xv, const float* gv,
                                          const Consts& k, float* xh,
                                          float* ga, float* dxh) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    xh[e] = (xv[e] - k.mean[e]) * k.rstd[e];
    const float a = xh[e] * k.w[e] + k.b[e];
    const float s = __fdividef(1.f, 1.f + __expf(-a));
    ga[e] = gv[e] * (s * (1.f + a * (1.f - s)));
    dxh[e] = ga[e] * k.w[e];
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(NT, MAX_BLOCKS_PER_SM)
gn_swish_bwd_kernel(Params p) {
  using Row = gn::Row<T, E, VEC>;
  extern __shared__ __align__(16) float smem[];   // SMEM_FLOATS
  cg::grid_group grid = cg::this_grid();
  const gn::Items& map = p.items;
  const int C = map.channels, R = map.rows, G = p.groups;
  const int vps = map.width / E;          // threads a slab row (<= NT)
  const int tid = threadIdx.x;
  const int step = NT / vps;              // rows at once
  const int trow = tid / vps;
  const int j = (tid % vps) * E;          // this thread's channels in the slab
  const int cpg = C / G;
  const int items = p.batch * map.slices * map.slabs;
  const T* x = static_cast<const T*>(p.x);
  const T* g = static_cast<const T*>(p.g);
  T* dx = static_cast<T*>(p.dx);

  // rows of [lo, hi) this thread takes: lo + trow + r step, r < mine
  auto rows_of = [&](int lo, int hi, int valid) {
    return valid > 0 && trow < step && hi - lo > trow
               ? (hi - lo - trow - 1) / step + 1
               : 0;
  };
  // scale, bias, mean and rstd of this thread's channels of image b (a
  // channel past the slab repeats its last, and is not stored)
  auto consts = [&](int b, int c0, int c1, Consts& k) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int c = min(c0 + j + e, c1 - 1), gr = c / cpg;
      k.w[e] = __ldg(p.w + c);
      k.b[e] = __ldg(p.b + c);
      k.mean[e] = __ldg(p.stats + (long long)b * 2 * G + gr);
      k.rstd[e] = __ldg(p.stats + (long long)b * 2 * G + G + gr);
    }
  };

  // --- phase 1: per-item partial sums -------------------------------------
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    int b, lo, hi, c0, c1;
    map.bounds(item, b, lo, hi, c0, c1);
    const int valid = min(E, c1 - c0 - j);
    Consts k;
    consts(b, c0, c1, k);
    float acc[4][E];
#pragma unroll
    for (int f = 0; f < 4; ++f)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[f][e] = 0.f;
    const long long base = (long long)b * R * C + c0 + j;
    const int mine = rows_of(lo, hi, valid);
    for (int r0 = 0; r0 < mine; r0 += U) {
      Row xr[U], gr[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (r0 + u < mine) {
          const long long off =
              base + (long long)(lo + trow + (r0 + u) * step) * C;
          xr[u].fetch(x + off, valid);
          gr[u].fetch(g + off, valid);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (r0 + u < mine) {
          float xv[E], gv[E], xh[E], ga[E], dxh[E];
          xr[u].get(xv);
          gr[u].get(gv);
          recompute(xv, gv, k, xh, ga, dxh);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            acc[0][e] += dxh[e];
            acc[1][e] += dxh[e] * xh[e];
            acc[2][e] += ga[e];
            acc[3][e] += ga[e] * xh[e];
          }
        }
      }
    }
    __syncthreads();   // the previous item's sums are read
#pragma unroll
    for (int f = 0; f < 4; ++f)
#pragma unroll
      for (int e = 0; e < E; ++e) smem[(f * NT + tid) * E + e] = acc[f][e];
    __syncthreads();
    // field f, slab channel c: the sum over the row slots in order, into
    // the (b, s) partial
    const int width = c1 - c0;
    float* out = p.part + (long long)(item / map.slabs) * 4 * C + c0;
    for (int i = tid; i < 4 * width; i += NT) {
      const int f = i / width, c = i % width;
      const int v = c / E, e = c % E;
      float s = 0.f;
      for (int r = 0; r < step; ++r) s += smem[(f * NT + r * vps + v) * E + e];
      out[f * C + c] = s;
    }
  }
  grid.sync();

  // --- phase 2: merge the partials ----------------------------------------
  {
    constexpr int NW = NT / 32;
    const int warp = tid / 32, lane = tid % 32;
    const int chunks = (C + 31) / 32;
    const int units = (p.batch + 1) * chunks;
    const int per_b = map.slices;            // (b, s) partials of an image
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int b = u / chunks;   // b == batch: dscale and dbias
      const int c = (u % chunks) * 32 + lane;
      // lanes past C read channel 0 and write nothing, so the loop below
      // is the same for every lane
      const bool live = c < C;
      const bool params = b == p.batch;
      const int first = params ? 0 : b * per_b;
      const int count = params ? p.batch * per_b : per_b;
      const int f0 = params ? 2 : 0;   // fields (f0, f0 + 1)
      float s0 = 0.f, s1 = 0.f;
#pragma unroll 8
      for (int i = warp; i < count; i += NW) {
        const float* src =
            p.part + ((long long)(first + i) * 4 + f0) * C + (live ? c : 0);
        s0 += __ldcg(src);
        s1 += __ldcg(src + C);
      }
      __syncthreads();   // the previous unit's sums are read
      smem[(warp * 2) * 32 + lane] = s0;
      smem[(warp * 2 + 1) * 32 + lane] = s1;
      __syncthreads();
      if (warp == 0 && live) {
        float t0 = 0.f, t1 = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          t0 += smem[(w * 2) * 32 + lane];
          t1 += smem[(w * 2 + 1) * 32 + lane];
        }
        if (params) {
          p.dbias[c] = t0;    // sum ga
          p.dscale[c] = t1;   // sum ga x^
        } else {
          p.bc[(long long)b * 2 * C + c] = t0;       // sum dx^
          p.bc[(long long)b * 2 * C + C + c] = t1;   // sum dx^ x^
        }
      }
    }
  }
  grid.sync();

  // --- phase 3: dx, items and rows in reverse order -----------------------
  const int count = blockIdx.x < items
                        ? (items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                        : 0;
  for (int it = count - 1; it >= 0; --it) {
    const int item = blockIdx.x + it * gridDim.x;
    int b, lo, hi, c0, c1;
    map.bounds(item, b, lo, hi, c0, c1);
    const int valid = min(E, c1 - c0 - j);
    Consts k;
    consts(b, c0, c1, k);
    // S1, S2 of the ng groups that the slab's channels belong to, from
    // the per-(b, c) sums (in L2): L lanes a (field, group), L the largest
    // power of two up to min(C / G, 32), each adding every L-th channel of
    // the group in order, then a shuffle tree over the L lanes (aligned
    // within a warp), into smem [2][ng]
    const int g0 = c0 / cpg;
    const int ng = (c1 - 1) / cpg - g0 + 1;
    const int lanes = 1 << (31 - __clz(cpg < 32 ? cpg : 32));
    __syncthreads();   // the previous item is done with smem
    for (int v0 = 0; v0 < 2 * ng * lanes; v0 += NT) {
      const int v = v0 + tid, pair = v / lanes, l = v % lanes;
      float s = 0.f;
      if (pair < 2 * ng) {
        const float* src = p.bc + (long long)b * 2 * C + (pair / ng) * C +
                           (long long)(g0 + pair % ng) * cpg;
        for (int c = l; c < cpg; c += lanes) s += __ldcg(src + c);
      }
      for (int o = lanes / 2; o > 0; o >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      if (pair < 2 * ng && l == 0) smem[pair] = s;
    }
    __syncthreads();
    float sa[E], sb[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int gr = min(c0 + j + e, c1 - 1) / cpg - g0;
      sa[e] = smem[gr];
      sb[e] = smem[ng + gr];
    }
    const long long base = (long long)b * R * C + c0 + j;
    const int mine = rows_of(lo, hi, valid);
    for (int r0 = mine - 1; r0 >= 0; r0 -= U) {
      Row xr[U], gr[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (r0 - u >= 0) {
          const long long off =
              base + (long long)(lo + trow + (r0 - u) * step) * C;
          xr[u].fetch(x + off, valid);
          gr[u].fetch(g + off, valid);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (r0 - u >= 0) {
          float xv[E], gv[E], xh[E], ga[E], dxh[E];
          xr[u].get(xv);
          gr[u].get(gv);
          recompute(xv, gv, k, xh, ga, dxh);
#pragma unroll
          for (int e = 0; e < E; ++e)
            xv[e] = k.rstd[e] *
                    (dxh[e] - (sa[e] + xh[e] * sb[e]) * p.inv_count);
          const long long off =
              base + (long long)(lo + trow + (r0 - u) * step) * C;
          gn::put<T, E, VEC>(dx + off, valid, xv);
        }
      }
    }
  }
}

// The launch geometry: the grid (what can be resident, at most
// MAX_BLOCKS_PER_SM an SM), slabs of an image's channels and slices of its
// rows.
struct Geometry {
  int grid, slabs, width, slices;
};

Geometry geometry(int batch, int rows, int channels, int grid) {
  Geometry geo;
  geo.grid = grid;
  gn::slab_split(channels, E, geo.slabs, geo.width);
  const int per_slice = batch * geo.slabs;
  geo.slices = gn::slice_cap(rows, per_slice >= grid ? 1 : grid / per_slice);
  return geo;
}

// any C that the groups divide
bool valid(int batch, int channels, int groups) {
  return batch >= 1 && channels >= 1 && groups >= 1 &&
         channels % groups == 0;
}

template <typename T, bool VEC>
int resident_of(int device) {
  return gn::resident(device, gn_swish_bwd_kernel<T, VEC>, SMEM_FLOATS * 4,
                      MAX_BLOCKS_PER_SM);
}

template <typename T>
cudaError_t launch(const Params& p, bool vec, int grid, cudaStream_t s) {
  // below the 48 KB default of dynamic shared memory
  return vec ? gn::launch_cooperative(gn_swish_bwd_kernel<T, true>, p, grid,
                                      SMEM_FLOATS * 4, s)
             : gn::launch_cooperative(gn_swish_bwd_kernel<T, false>, p, grid,
                                      SMEM_FLOATS * 4, s);
}

}  // namespace

// The grid of a launch on CUDA device `device`: the blocks that can be
// resident there at once, the fewer of the vector and the element kernel's
// (at most MAX_BLOCKS_PER_SM an SM); 0 if a query fails.  Ask once per
// device and dtype.
extern "C" int mas_gn_swish_bwd_grid(int device, int is_bf16) {
  const int a = is_bf16 ? resident_of<__nv_bfloat16, true>(device)
                        : resident_of<float, true>(device);
  const int b = is_bf16 ? resident_of<__nv_bfloat16, false>(device)
                        : resident_of<float, false>(device);
  return a < b ? a : b;
}

// Scratch floats a launch of `grid` blocks needs: partials [B, S, 4, C] and
// the per-(b, c) sums [B, 2, C]; -1 for a shape the kernel does not take.
extern "C" long long mas_gn_swish_bwd_scratch(int batch, int rows,
                                              int channels, int groups,
                                              int grid) {
  if (!valid(batch, channels, groups) || rows < 1 || grid < 1) return -1;
  const Geometry geo = geometry(batch, rows, channels, grid);
  return ((long long)batch * geo.slices * 4 + (long long)batch * 2) *
         channels;
}

// x, g, dx [B, HW, C] contiguous bf16 (is_bf16 = 1) or fp32, with C and
// groups as `valid` takes them; w, b fp32 [C]; stats fp32 [B, 2, groups];
// grid from mas_gn_swish_bwd_grid for the stream's device; scratch of
// mas_gn_swish_bwd_scratch(B, HW, C, groups, grid) floats; dscale, dbias fp32
// [C].
extern "C" int mas_gn_swish_bwd(const void* x, const void* g, const void* w,
                                const void* b, const void* stats, void* dx,
                                void* scratch, void* dscale, void* dbias,
                                int batch, int rows, int channels, int groups,
                                float inv_count, int grid, int is_bf16,
                                void* stream) {
  if (!valid(batch, channels, groups) || rows < 1 || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry geo = geometry(batch, rows, channels, grid);
  Params p;
  p.x = x;
  p.g = g;
  p.w = static_cast<const float*>(w);
  p.b = static_cast<const float*>(b);
  p.stats = static_cast<const float*>(stats);
  p.dx = dx;
  p.part = static_cast<float*>(scratch);
  p.bc = p.part + (long long)batch * geo.slices * 4 * channels;
  p.dscale = static_cast<float*>(dscale);
  p.dbias = static_cast<float*>(dbias);
  p.items.rows = rows;
  p.items.channels = channels;
  p.items.slices = geo.slices;
  p.items.slabs = geo.slabs;
  p.items.width = geo.width;
  p.batch = batch;
  p.groups = groups;
  p.inv_count = inv_count;
  // vector loads: C a multiple of E, x, g and dx aligned for E values
  const int bytes = E * (is_bf16 ? 2 : 4);
  const bool vec = channels % E == 0 && gn::aligned(x, bytes) &&
                   gn::aligned(g, bytes) && gn::aligned(dx, bytes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? launch<__nv_bfloat16>(p, vec, grid, s)
                                  : launch<float>(p, vec, grid, s));
}
