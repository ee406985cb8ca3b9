// Slot walks shared by the edge-tile kernels: K3 and K11 walk one tile of
// a TiledGraph per warp, the grouped kernels K9, K10 and K12 one sub-tile
// of a GroupedTiledGraph chunk per warp (K1 has its own, row-owned walk
// in spmm_tiles.cu).  A tile is ET slots of
// (src_local, dst_local[, weight]); slot e holds edge
// (col0 + src_local[e]) -> (row0 + dst_local[e]), and pad slots carry
// src == C or dst == R.
//
// The warp reads 32 slots at a time and keeps the live ones by ballot, so a
// pad slot is never addressed (the pad row x[col0 + C] is never read) and its
// weight is never loaded.  spmm_walk, and the other walks with `prefix`, rely
// on the tile's edges filling a prefix of its slots, as the host builders
// place them (slot = offset of the edge in its block, mod ET): the walk stops
// at the first 32 slots without an edge, so an empty sub-tile costs one read
// of its first 32 index pairs.  Sums go to y / acc by float32 global atomics,
// whose order varies from run to run (f32 rounding only).  Both walks that sum
// first sum each run of slots with one receiver in registers (the builders
// sort a tile's slots by receiver) and add it once per run.  A hub row of 2e5
// edges then takes a few hundred atomic adds of run sums instead of 2e5 of
// single terms, and a multigraph row that repeats one edge hundreds of times
// (the smoke's graph sends ~600 copies of i -> hub into some rows), whose
// float32 sum rounds the same way at every add and so drifts by ~n/4 ulps
// rather than sqrt(n), drifts only over a run (at most ET slots) and over the
// few run sums.
#pragma once
#include "common.cuh"

namespace gta {

// Features each lane holds per pass of spmm_walk at width F: the next power
// of two >= F / 32, at most 8 (one pass per 256 features beyond that).
inline int spmm_lane_features(int F) {
  int k = 1;
  while (k < 8 && 32 * k < F) k *= 2;
  return k;
}

template <int KF>
__device__ __forceinline__ void spmm_flush_run(float* __restrict__ yr, int f0, int F,
                                               const float* sum, int lane) {
#pragma unroll
  for (int k = 0; k < KF; ++k) {
    const int f = f0 + lane + 32 * k;
    if (f < F) atomicAdd(yr + f, sum[k]);
  }
}

// y[row0 + d] += round_to<XT>(w * x[col0 + s]) for each live slot; a null
// `weight` means every edge weighs 1 (the weight stream is not read).  One
// pass per 32 KF features: lane l holds features f0 + l, f0 + l + 32, ...
// of the current run's sum and adds it into y when the receiver changes
// and after the walk.  w * x is rounded before the sum (__fmul_rn: never
// contracted into an FMA), as the plain version computes it.
template <typename XT, typename WT, int KF>
__device__ __forceinline__ void spmm_walk(
    const int16_t* __restrict__ src_local, const int16_t* __restrict__ dst_local,
    const WT* __restrict__ weight, int64_t base, int ET, int R, int C, int64_t row0,
    int64_t col0, const XT* __restrict__ x, float* __restrict__ y, int F, int64_t n_x,
    int64_t n_out, int lane) {
  for (int f0 = 0; f0 < F; f0 += 32 * KF) {
    float sum[KF] = {};
    int64_t cur = -1;  // the current run's receiver (the same in every lane)
    for (int e0 = 0; e0 < ET; e0 += 32) {
      const int e = e0 + lane;
      int s = C, d = R;
      if (e < ET) {
        s = src_local[base + e];
        d = dst_local[base + e];
      }
      const bool real = s >= 0 && s < C && d >= 0 && d < R;
      if (__ballot_sync(0xffffffffu, real) == 0u) break;  // past the edges
      const bool live = real && col0 + s < n_x && row0 + d < n_out;
      const float w = live && weight != nullptr ? to_f(weight[base + e]) : 1.f;
      unsigned todo = __ballot_sync(0xffffffffu, live);
      while (todo) {
        const int j = __ffs(todo) - 1;
        todo &= todo - 1;
        const int sj = __shfl_sync(0xffffffffu, s, j);
        const int64_t r = row0 + __shfl_sync(0xffffffffu, d, j);
        const float wj = __shfl_sync(0xffffffffu, w, j);
        if (r != cur) {
          if (cur >= 0) spmm_flush_run<KF>(y + cur * F, f0, F, sum, lane);
          cur = r;
#pragma unroll
          for (int k = 0; k < KF; ++k) sum[k] = 0.f;
        }
        const XT* xr = x + (col0 + sj) * F;
#pragma unroll
        for (int k = 0; k < KF; ++k) {
          const int f = f0 + lane + 32 * k;
          if (f < F) sum[k] += round_to<XT>(__fmul_rn(wj, to_f(xr[f])));
        }
      }
    }
    if (cur >= 0) spmm_flush_run<KF>(y + cur * F, f0, F, sum, lane);
  }
}

constexpr int GAT_MAXF = 8;  // features per lane: HD <= 256

// GAT softmax-aggregate of each live slot src -> r under the global shift
// bound (see gat_tiles.cu): adds [p * h[src] | p] into acc[r], p per head
//   p = m * exp(min(leaky(a_s + a_d) - leaky(msrc + a_d), 60)),
// m the slot's multiplicity (1 when `mult` is null).  Derive mode: a_s =
// h[src] . w_s (w_s [HD, H] f32 in shared memory, values of h's dtype),
// a warp reduction per head; values mode: a_s = a_src[src].  p * h and p
// round to h's dtype before the f32 sum, as on the TPU.  The sums of a
// run of slots with one receiver are held in registers (lane l: features
// l, l + 32, ...; lane h < H: head h's den) and added to acc[r] when the
// receiver changes and after the walk.
__device__ __forceinline__ void gat_flush_run(float* __restrict__ acc, int64_t r, int W,
                                              int HD, int H, const float* num, float den,
                                              int lane) {
  float* arow = acc + r * W;
#pragma unroll
  for (int k = 0; k < GAT_MAXF; ++k) {
    const int f = lane + 32 * k;
    if (f < HD) atomicAdd(arow + f, num[k]);
  }
  if (lane < H) atomicAdd(arow + HD + lane, den);
}

template <typename HT, typename MT>
__device__ __forceinline__ void gat_walk(
    const int16_t* __restrict__ src_local, const int16_t* __restrict__ dst_local,
    const MT* __restrict__ mult, int64_t base, int ET, int R, int C, int64_t row0,
    int64_t col0, const HT* __restrict__ h, const float* w_s, bool derive,
    const HT* __restrict__ a_src, const float* __restrict__ a_dst, const float* m_s,
    float* __restrict__ acc, int HD, int H, int64_t n_h, int64_t n_a, int64_t n_out,
    float slope, bool prefix, int lane) {
  const int W = HD + H, D = HD / H;
  float num[GAT_MAXF], den = 0.f;  // the current run's sums
  int64_t cur = -1;                // its receiver (the same in every lane)
  for (int e0 = 0; e0 < ET; e0 += 32) {
    const int e = e0 + lane;
    int s = C, d = R;
    if (e < ET) {
      s = src_local[base + e];
      d = dst_local[base + e];
    }
    const bool real = s >= 0 && s < C && d >= 0 && d < R;
    if (prefix && __ballot_sync(0xffffffffu, real) == 0u) break;
    const bool live = real && col0 + s < n_h && row0 + d < n_out;
    const float m = live && mult != nullptr ? to_f(mult[base + e]) : 1.f;
    unsigned todo = __ballot_sync(0xffffffffu, live);
    while (todo) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      const int64_t src = col0 + __shfl_sync(0xffffffffu, s, j);
      const int64_t r = row0 + __shfl_sync(0xffffffffu, d, j);
      const float mj = __shfl_sync(0xffffffffu, m, j);
      if (r != cur) {
        if (cur >= 0) gat_flush_run(acc, cur, W, HD, H, num, den, lane);
        cur = r;
        den = 0.f;
#pragma unroll
        for (int k = 0; k < GAT_MAXF; ++k) num[k] = 0.f;
      }
      float hv[GAT_MAXF];
#pragma unroll
      for (int k = 0; k < GAT_MAXF; ++k) {
        const int f = lane + 32 * k;
        hv[k] = f < HD ? to_f(h[src * HD + f]) : 0.f;
      }
      // lane hh < H ends up holding a_s[hh]
      float my_as = 0.f;
      if (derive) {
        for (int hh = 0; hh < H; ++hh) {
          float part = 0.f;
#pragma unroll
          for (int k = 0; k < GAT_MAXF; ++k) {
            const int f = lane + 32 * k;
            if (f < HD) part = fmaf(hv[k], w_s[f * H + hh], part);
          }
          part = warp_sum(part);
          if (lane == hh) my_as = part;
        }
      } else if (lane < H) {
        my_as = to_f(a_src[src * H + lane]);
      }
      float p = 0.f;
      if (lane < H) {
        const float ad = r < n_a ? a_dst[r * H + lane] : 0.f;
        const float z = leaky(my_as + ad, slope) - leaky(m_s[lane] + ad, slope);
        p = expf(fminf(z, 60.f)) * mj;
      }
#pragma unroll
      for (int k = 0; k < GAT_MAXF; ++k) {
        const int f = lane + 32 * k;
        const float pf = __shfl_sync(0xffffffffu, p, f < HD ? f / D : 0);
        if (f < HD) num[k] += round_to<HT>(pf * hv[k]);
      }
      if (lane < H) den += round_to<HT>(p);
    }
  }
  if (cur >= 0) gat_flush_run(acc, cur, W, HD, H, num, den, lane);
}

// Per-head edge dots of each live slot, written once (no atomics):
//   out[h * plane + base + e] = sum over head h's P = F / heads features f
//                               of prod(x_src[col0 + s, f], x_dst[row0 + d, f])
// prod is the float32 product of the two values (exact for bf16 inputs),
// rounded to XT first when `round_prod` (the grouped TPU kernel's
// astype(dt) before its head sum).  Pad slots are not written: the caller
// zero-fills `out`.  P >= 32: each head is a warp reduction of its lanes'
// partial sums.  P < 32: the warp stages the slot's F products in `prod`
// (F floats of shared memory) and lane h sums head h's P products.
template <typename XT>
__device__ __forceinline__ void sddmm_walk(
    const int16_t* __restrict__ src_local, const int16_t* __restrict__ dst_local,
    int64_t base, int ET, int R, int C, int64_t row0, int64_t col0,
    const XT* __restrict__ x_src, const XT* __restrict__ x_dst, float* __restrict__ out,
    int64_t plane, int F, int heads, int64_t n_src, int64_t n_dst, bool round_prod,
    float* prod, bool prefix, int lane) {
  const int P = F / heads;
  for (int e0 = 0; e0 < ET; e0 += 32) {
    const int e = e0 + lane;
    int s = C, d = R;
    if (e < ET) {
      s = src_local[base + e];
      d = dst_local[base + e];
    }
    const bool real = s >= 0 && s < C && d >= 0 && d < R;
    if (prefix && __ballot_sync(0xffffffffu, real) == 0u) break;
    const bool live = real && col0 + s < n_src && row0 + d < n_dst;
    unsigned todo = __ballot_sync(0xffffffffu, live);
    while (todo) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      const XT* a = x_src + (col0 + __shfl_sync(0xffffffffu, s, j)) * F;
      const XT* b = x_dst + (row0 + __shfl_sync(0xffffffffu, d, j)) * F;
      float* o = out + base + e0 + j;
      if (P >= 32) {
        for (int hh = 0; hh < heads; ++hh) {
          float part = 0.f;
          for (int i = lane; i < P; i += 32) {
            const int f = hh * P + i;
            const float p = to_f(a[f]) * to_f(b[f]);
            part += round_prod ? round_to<XT>(p) : p;
          }
          part = warp_sum(part);
          if (lane == 0) o[hh * plane] = part;
        }
      } else {
        for (int f = lane; f < F; f += 32) {
          const float p = to_f(a[f]) * to_f(b[f]);
          prod[f] = round_prod ? round_to<XT>(p) : p;
        }
        __syncwarp();
        for (int hh = lane; hh < heads; hh += 32) {
          float acc = 0.f;
          for (int i = 0; i < P; ++i) acc += prod[hh * P + i];
          o[hh * plane] = acc;
        }
        __syncwarp();
      }
    }
  }
}

}  // namespace gta
