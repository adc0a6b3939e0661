// Fused GroupNorm + swish forward over NHWC (kernel B4).
//
// Replaces: mas_tpu/ops/pallas/gn_swish.py::_kernel (launched by
// _gn_swish_fwd_stats_pallas / _gn_swish_fwd_pallas), the prologue of every
// ResnetBlock conv and of norm_out in the VQ encoder and decoder.
//
// Computes, for x [B, HW, C] (bf16 or fp32, contiguous NHWC, any C that the
// G groups divide), fp32 scale w and bias b [C], per (b, group) of N = HW *
// C / G values:
//   mean = sum x / N,  var = sum (x - mean)^2 / N,  rstd = rsqrt(var + eps)
//   y = swish((x - mean) rstd w + b)                  in x's dtype
//   stats [B, 2, G] = (mean, rstd)                     fp32, for B8
//
// What bounds it on the H100: bytes.  x is read and y written once: 134 MB
// at the VQ decoder's largest [4, 256, 256, 128] bf16, 0.040 ms at 3.35
// TB/s.  The statistics need a pass over x before any y can be written,
// so the kernel reads x twice (201 MB), the second time partly from L2.
//
// What the design does about it: one cooperative launch in three phases
// (B8's design), so nothing but per-slice partials goes to device memory
// between the two reads.
// - The grid is what can be resident at once (at most two blocks of 256
//   threads an SM), capped at the number of items: a slice holds at least
//   one round of U rows for every thread.  A thread takes E = 16 bytes of
//   channels (4 fp32, 8 bf16) and loads U = 8 rows before it uses any; the
//   item map is gn_swish.cuh's.  Where C is not a multiple of E, or x or y
//   is not 16-byte aligned, an instance with element loads (the slab's
//   ragged tail masked) and U = 4 takes the call.
// - Images of few rows (the decoder's [4, 16, 16, 512] and [4, 32, 32,
//   512]: at most two rounds a thread) take slabs of whole groups, as
//   narrow as 32 bytes a row allow, and one slice: a block then holds every
//   value of its groups, computes their stats itself and writes y, with no
//   grid barrier (128 blocks for those two shapes).  Two barriers cost more
//   than the whole of such a call.
// - Phase 1: per channel, a thread keeps (mean, M2) of its rows in fp32
//   registers: each round of U rows gives a round mean and sum of squared
//   deviations from it, merged into the running pair by Chan's formula
//   (never sum x^2 - mean^2, which cancels for bf16 inputs with a large
//   mean).  The block's threads merge theirs in shared memory in row order
//   (two passes: the weighted mean, then M2 about it) and write the item's
//   slab of the (b, slice) partial [2, C] (mean, M2).
// - Grid barrier.  Phase 2: a warp per (b, group) merges the partials of
//   its slices and channels, again the weighted mean, then M2 about it,
//   and writes the stats.
// - Grid barrier.  Phase 3: each block takes its items, and their rows, in
//   reverse order (the rows phase 1 read last are still in the 50 MB L2),
//   and writes y with evict-first stores; the sigmoid by __expf and
//   __fdividef, as B8.
// No atomic touches a sum, so two calls on one card give equal bits.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gn_swish.cuh"

namespace cg = cooperative_groups;

namespace {

using gn::NT;
constexpr int MAX_BLOCKS_PER_SM = 2;

// channels a thread: 16 bytes
template <typename T>
__host__ __device__ constexpr int lanes_of() {
  return 16 / static_cast<int>(sizeof(T));
}
// rows whose loads are in flight: fewer for element loads, which hold a
// register per value
template <bool VEC>
__host__ __device__ constexpr int rounds_of() {
  return VEC ? 8 : 4;
}

struct Params {
  const void* x;
  const float* w;
  const float* b;
  void* y;
  float* stats;   // [B, 2, G]
  float* part;    // [B, S, 2, C]
  gn::Items items;
  int batch, groups;
  int local;      // slabs of whole groups, one slice: no grid barrier
  float eps;
};

// rows of an item [lo, hi) that row slot t of `step` takes
__device__ __forceinline__ int slot_rows(int lo, int hi, int t, int step) {
  return t < step && hi - lo > t ? (hi - lo - t - 1) / step + 1 : 0;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;   // the same bits in every lane: each step adds a + b = b + a
}

// shared memory: the threads' (mean, M2) pairs [2][NT][E], then the
// slab's per-channel pairs [2][NT E] (local: also the groups' stats)
template <typename T>
__host__ __device__ constexpr int smem_floats() {
  return 4 * NT * lanes_of<T>();
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(NT, MAX_BLOCKS_PER_SM)
gn_swish_fwd_kernel(Params p) {
  constexpr int E = lanes_of<T>();
  constexpr int U = rounds_of<VEC>();
  constexpr int NW = NT / 32;
  extern __shared__ __align__(16) float smem[];
  float* pairs = smem;                  // [2][NT][E]
  float* chan = smem + 2 * NT * E;      // [2][NT E]
  const gn::Items& map = p.items;
  const int C = map.channels, R = map.rows, G = p.groups, cpg = C / G;
  const int vps = map.width / E;          // threads a slab row
  const int step = NT / vps;              // rows at once
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int trow = tid / vps;
  const int j = (tid % vps) * E;          // this thread's channels in a slab
  // the slab's channels are merged by `tpc` neighbouring threads each (a
  // power of two up to 32), each taking every tpc-th row slot
  const int tpc = 1 << (31 - __clz(max(1, min(32, NT / map.width))));
  const int items = p.batch * map.slices * map.slabs;
  const T* x = static_cast<const T*>(p.x);
  T* y = static_cast<T*>(p.y);

  // phase 1 of an item: each channel's (mean, M2) over the item's rows,
  // into chan (and, unless local, the item's slab of the (b, s) partial)
  auto partial = [&](int item) {
    int b, lo, hi, c0, c1;
    map.bounds(item, b, lo, hi, c0, c1);
    const int valid = min(E, c1 - c0 - j);
    const int mine = valid > 0 ? slot_rows(lo, hi, trow, step) : 0;
    float mean[E], m2[E], n = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) mean[e] = m2[e] = 0.f;
    const T* src = x + ((long long)b * R + lo + trow) * C + c0 + j;
    for (int r0 = 0; r0 < mine; r0 += U) {
      gn::Row<T, E, VEC> xr[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (r0 + u < mine) xr[u].fetch(src + (long long)(r0 + u) * step * C,
                                       valid);
      const int nb = min(U, mine - r0);
      float bm[E], q[E], v[E];
#pragma unroll
      for (int e = 0; e < E; ++e) bm[e] = q[e] = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u < nb) {
          xr[u].get(v);
#pragma unroll
          for (int e = 0; e < E; ++e) bm[e] += v[e];
        }
      }
      const float inv = 1.f / (float)nb;
#pragma unroll
      for (int e = 0; e < E; ++e) bm[e] *= inv;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u < nb) {
          xr[u].get(v);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const float d = v[e] - bm[e];
            q[e] = fmaf(d, d, q[e]);
          }
        }
      }
      // Chan et al.: merge the round (nb, bm, q) into (n, mean, m2)
      const float n_new = n + (float)nb;
      const float f = (float)nb / n_new;
      const float nf = n * f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float delta = bm[e] - mean[e];
        mean[e] = fmaf(delta, f, mean[e]);
        m2[e] += q[e] + delta * delta * nf;
      }
      n = n_new;
    }
    __syncthreads();   // the previous item's pairs and chan are read
#pragma unroll
    for (int e = 0; e < E; ++e) {
      pairs[tid * E + e] = mean[e];
      pairs[(NT + tid) * E + e] = m2[e];
    }
    __syncthreads();
    // slab channel c: its row slots merged by tpc threads, then a shuffle
    // tree (the weighted mean, then M2 about it); every thread takes part
    // in each round, so the shuffles see whole warps
    const float count = (float)(hi - lo);
    float* out = p.part + (long long)(item / map.slabs) * 2 * C + c0;
    for (int t0 = 0; t0 < (c1 - c0) * tpc; t0 += NT) {
      const int t = t0 + tid, c = t / tpc, sub = t % tpc;
      const bool live = c < c1 - c0;
      const int v = c / E, e = c % E;
      float tot = 0.f;
      for (int r = sub; live && r < step; r += tpc)
        tot += (float)slot_rows(lo, hi, r, step) * pairs[(r * vps + v) * E + e];
      for (int o = tpc / 2; o > 0; o >>= 1)
        tot += __shfl_xor_sync(0xffffffffu, tot, o);
      const float mu = tot / count;
      float m = 0.f;
      for (int r = sub; live && r < step; r += tpc) {
        const int nr = slot_rows(lo, hi, r, step);
        if (nr) {
          const float d = pairs[(r * vps + v) * E + e] - mu;
          m += pairs[(NT + r * vps + v) * E + e] + (float)nr * d * d;
        }
      }
      for (int o = tpc / 2; o > 0; o >>= 1)
        m += __shfl_xor_sync(0xffffffffu, m, o);
      if (live && sub == 0) {
        if (p.local) {
          chan[c] = mu;
          chan[NT * E + c] = m;
        } else {
          out[c] = mu;
          out[C + c] = m;
        }
      }
    }
  };

  // phase 3 of an item: y from the stats of its groups (local: pairs of
  // (mean, rstd) in shared memory from group c0 / cpg on; else p.stats),
  // rows in reverse order
  auto apply = [&](int item) {
    int b, lo, hi, c0, c1;
    map.bounds(item, b, lo, hi, c0, c1);
    const int valid = min(E, c1 - c0 - j);
    const int mine = valid > 0 ? slot_rows(lo, hi, trow, step) : 0;
    if (mine == 0) return;
    float kw[E], kb[E], kmean[E];   // kw: rstd * scale
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int c = min(c0 + j + e, c1 - 1), gr = c / cpg;
      float rstd;
      if (p.local) {
        kmean[e] = pairs[2 * (gr - c0 / cpg)];
        rstd = pairs[2 * (gr - c0 / cpg) + 1];
      } else {
        kmean[e] = __ldcg(p.stats + (long long)b * 2 * G + gr);
        rstd = __ldcg(p.stats + (long long)b * 2 * G + G + gr);
      }
      kw[e] = rstd * __ldg(p.w + c);
      kb[e] = __ldg(p.b + c);
    }
    const long long off0 = ((long long)b * R + lo + trow) * C + c0 + j;
    for (int r0 = mine - 1; r0 >= 0; r0 -= U) {
      gn::Row<T, E, VEC> xr[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (r0 - u >= 0)
          xr[u].fetch(x + off0 + (long long)(r0 - u) * step * C, valid);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (r0 - u >= 0) {
          float v[E];
          xr[u].get(v);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const float a = (v[e] - kmean[e]) * kw[e] + kb[e];
            v[e] = a * __fdividef(1.f, 1.f + __expf(-a));
          }
          gn::put<T, E, VEC, true>(y + off0 + (long long)(r0 - u) * step * C,
                                   valid, v);
        }
      }
    }
  };

  // (mean, rstd) of group g of image b, by a warp, from the (mean, M2) of
  // its channels c over the slices s at base + s slice_stride + c and + c2
  // (in shared memory if local, else in L2): the weighted mean, then M2
  // about it.  Lane 0 writes them to p.stats and returns them.
  auto group_stats = [&](int b, int g, const float* base,
                         long long slice_stride, int c2) {
    const int n_pairs = map.slices * cpg;
    const float count = (float)R * (float)cpg;
    auto at = [&](int i, int field) {
      const int s = i / cpg, c = g * cpg + i % cpg;
      const float* q = base + s * slice_stride + c + field * c2;
      return p.local ? *q : __ldcg(q);
    };
    auto rows_of = [&](int i) {
      const int s = i / cpg;
      return (float)(map.slice_start(s + 1) - map.slice_start(s));
    };
    float tot = 0.f;
    for (int i = lane; i < n_pairs; i += 32) tot += rows_of(i) * at(i, 0);
    const float mu = warp_sum(tot) / count;
    float m = 0.f;
    for (int i = lane; i < n_pairs; i += 32) {
      const float d = at(i, 0) - mu;
      m += at(i, 1) + rows_of(i) * d * d;
    }
    const float rstd = rsqrtf(warp_sum(m) / count + p.eps);
    if (lane == 0) {
      p.stats[(long long)b * 2 * G + g] = mu;
      p.stats[(long long)b * 2 * G + G + g] = rstd;
    }
    return make_float2(mu, rstd);
  };

  if (p.local) {
    // an item holds whole groups and every row of an image: its block
    // computes their stats from chan and needs no barrier
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      partial(item);
      __syncthreads();   // chan holds the slab's channels
      int b, lo, hi, c0, c1;
      map.bounds(item, b, lo, hi, c0, c1);
      const int g0 = c0 / cpg;
      for (int g = warp; g < (c1 - c0) / cpg; g += NW) {
        const float2 st = group_stats(b, g0 + g, chan - g0 * cpg, 0, NT * E);
        if (lane == 0) {   // pairs is free until the next item
          pairs[2 * g] = st.x;
          pairs[2 * g + 1] = st.y;
        }
      }
      __syncthreads();
      apply(item);
    }
    return;
  }

  cg::grid_group grid = cg::this_grid();
  for (int item = blockIdx.x; item < items; item += gridDim.x) partial(item);
  grid.sync();
  // phase 2: a warp per (b, group), from the partials in L2
  for (int u = blockIdx.x * NW + warp; u < p.batch * G; u += gridDim.x * NW)
    group_stats(u / G, u % G, p.part + (long long)(u / G) * map.slices * 2 * C,
                2LL * C, C);
  grid.sync();
  // phase 3: items in reverse order
  const int count = blockIdx.x < items
                        ? (items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                        : 0;
  for (int it = count - 1; it >= 0; --it) apply(blockIdx.x + it * gridDim.x);
}

// The launch geometry.  Where the rows of an image are few (at most two
// rounds a thread over a slab of whole groups), a slab of the narrowest
// width that holds whole groups, is a multiple of E and spans at least 32
// bytes a row, one slice, and no barrier ("local").  Otherwise slabs as
// gn::slab_split gives them; slices so that the grid of resident blocks
// has an item each, but at least one round of U rows a thread in every
// slice.  The grid is capped at the items.
struct Geometry {
  int grid, slabs, width, slices, local;
};

template <typename T, bool VEC>
Geometry geometry(int batch, int rows, int channels, int groups,
                  int resident) {
  constexpr int E = lanes_of<T>();
  constexpr int U = rounds_of<VEC>();
  Geometry geo;
  const int cpg = channels / groups;
  int unit = cpg;   // lcm(E, cpg)
  while (unit % E) unit += cpg;
  int width = unit;
  while (width * (int)sizeof(T) < 32) width += unit;
  if (width >= channels) width = (channels + E - 1) / E * E;
  const int local_step = width <= NT * E ? NT / (width / E) : 0;
  geo.local = local_step > 0 && (rows + local_step - 1) / local_step <= 2 * U;
  if (geo.local) {
    geo.width = width;
    geo.slabs = (channels + width - 1) / width;
    geo.slices = 1;
  } else {
    gn::slab_split(channels, E, geo.slabs, geo.width);
    const int step = NT / (geo.width / E);
    const int per_slice = batch * geo.slabs;
    int slices = per_slice >= resident ? 1 : resident / per_slice;
    const int most = rows / (step * U);
    slices = min(slices, most > 1 ? most : 1);
    geo.slices = gn::slice_cap(rows, slices);
  }
  const long long items = (long long)batch * geo.slabs * geo.slices;
  geo.grid = items < resident ? (int)items : resident;
  return geo;
}

bool valid(int batch, int rows, int channels, int groups) {
  return batch >= 1 && rows >= 1 && channels >= 1 && groups >= 1 &&
         channels % groups == 0;
}

template <typename T, bool VEC>
int resident_of(int device) {
  return gn::resident(device, gn_swish_fwd_kernel<T, VEC>,
                      smem_floats<T>() * sizeof(float), MAX_BLOCKS_PER_SM);
}

template <typename T, bool VEC>
cudaError_t launch(Params p, int resident, cudaStream_t s) {
  const Geometry geo = geometry<T, VEC>(p.batch, p.items.rows,
                                        p.items.channels, p.groups, resident);
  p.items.slabs = geo.slabs;
  p.items.width = geo.width;
  p.items.slices = geo.slices;
  p.local = geo.local;
  return gn::launch_cooperative(gn_swish_fwd_kernel<T, VEC>, p, geo.grid,
                                smem_floats<T>() * sizeof(float), s);
}

// vector loads: C a multiple of a thread's channels, x and y aligned
template <typename T>
bool vector_ok(const void* x, const void* y, int channels) {
  return channels % lanes_of<T>() == 0 && gn::aligned(x, 16) &&
         gn::aligned(y, 16);
}

}  // namespace

// The resident blocks on CUDA device `device` for a launch, the fewer of
// the vector and the element kernel's (at most MAX_BLOCKS_PER_SM an SM);
// 0 if a query fails.  Ask once per device and dtype.
extern "C" int mas_gn_swish_fwd_grid(int device, int is_bf16) {
  const int a = is_bf16 ? resident_of<__nv_bfloat16, true>(device)
                        : resident_of<float, true>(device);
  const int b = is_bf16 ? resident_of<__nv_bfloat16, false>(device)
                        : resident_of<float, false>(device);
  return a < b ? a : b;
}

// Scratch floats of a launch: the partials [B, S, 2, C], S the more slices
// of the vector and the element kernel's geometry; -1 for a shape the
// kernel does not take.
extern "C" long long mas_gn_swish_fwd_scratch(int batch, int rows,
                                              int channels, int groups,
                                              int resident, int is_bf16) {
  if (!valid(batch, rows, channels, groups) || resident < 1) return -1;
  const Geometry a =
      is_bf16
          ? geometry<__nv_bfloat16, true>(batch, rows, channels, groups,
                                          resident)
          : geometry<float, true>(batch, rows, channels, groups, resident);
  const Geometry e =
      is_bf16
          ? geometry<__nv_bfloat16, false>(batch, rows, channels, groups,
                                           resident)
          : geometry<float, false>(batch, rows, channels, groups, resident);
  const int slices = a.slices > e.slices ? a.slices : e.slices;
  return (long long)batch * slices * 2 * channels;
}

// x, y [B, HW, C] contiguous bf16 (is_bf16 = 1) or fp32, C divisible by
// `groups`; w, b fp32 [C]; stats fp32 [B, 2, groups]; resident from
// mas_gn_swish_fwd_grid for the stream's device; scratch of
// mas_gn_swish_fwd_scratch(...) floats.
extern "C" int mas_gn_swish_fwd(const void* x, const void* w, const void* b,
                                void* y, void* stats, void* scratch,
                                int batch, int rows, int channels, int groups,
                                float eps, int resident, int is_bf16,
                                void* stream) {
  if (!valid(batch, rows, channels, groups) || resident < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = x;
  p.w = static_cast<const float*>(w);
  p.b = static_cast<const float*>(b);
  p.y = y;
  p.stats = static_cast<float*>(stats);
  p.part = static_cast<float*>(scratch);
  p.items.rows = rows;
  p.items.channels = channels;
  p.batch = batch;
  p.groups = groups;
  p.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16)
    err = vector_ok<__nv_bfloat16>(x, y, channels)
              ? launch<__nv_bfloat16, true>(p, resident, s)
              : launch<__nv_bfloat16, false>(p, resident, s);
  else
    err = vector_ok<float>(x, y, channels) ? launch<float, true>(p, resident, s)
                                           : launch<float, false>(p, resident, s);
  return static_cast<int>(err);
}
