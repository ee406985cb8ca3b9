// Slot walks shared by the edge-tile kernels: K1, K3, K11 and K14 walk one
// tile of a TiledGraph per warp, the grouped kernels K9, K10 and K12 one
// sub-tile of a GroupedTiledGraph chunk per warp (K1 and K9 by the one
// SpMM walk, spmm_walk; K3, K10 and K14 by gat_prefix_walk).  A tile is ET
// slots of (src_local, dst_local[, weight]); slot e holds edge
// (col0 + src_local[e]) -> (row0 + dst_local[e]), and pad slots carry
// src == C or dst == R.
//
// The warp reads 32 slots at a time and keeps the live ones by ballot, so a
// pad slot is never addressed (the pad row x[col0 + C] is never read) and its
// weight is never loaded.  Every walk relies on the tile's edges filling a
// prefix of its slots, as the host builders place them (slot = offset of
// the edge in its block, mod ET): the walk stops at the first 32 slots
// without an edge, so an empty sub-tile costs one read of its first 32
// index pairs.  Sums go to y / acc by float32 global atomics, whose order
// varies from run to run (f32 rounding only).  The walks that sum first
// sum each run of slots with one receiver in registers (the builders sort
// a tile's slots by receiver) and add it once per run.  A hub row of 2e5
// edges then takes a few hundred atomic adds of run sums instead of 2e5 of
// single terms, and a multigraph row that repeats one edge hundreds of times
// (the smoke's graph sends ~600 copies of i -> hub into some rows), whose
// float32 sum rounds the same way at every add and so drifts by ~n/4 ulps
// rather than sqrt(n), drifts only over a run (at most ET slots) and over the
// few run sums.  The SDDMM walks (K11, K12) write each slot's dots once,
// with plain stores.
#pragma once
#include "common.cuh"

namespace gta {

// ---- the SpMM walk of K1 and K9 -------------------------------------------

// VEC values of x in one aligned load, kept packed until they are summed
// (value i of a packed bf16 load is half i % 2 of its word i / 2; an
// unpacking through memory would put the loads in local memory)
template <typename T, int VEC> struct VecLoad;
template <> struct VecLoad<__nv_bfloat16, 4> { using type = uint2; };
template <> struct VecLoad<float, 4> { using type = float4; };
template <typename T> struct VecLoad<T, 1> { using type = T; };

__device__ __forceinline__ float bf16_half(uint32_t w, int h) {
  return __uint_as_float(h ? w & 0xffff0000u : w << 16);
}
__device__ __forceinline__ float unpack(const uint2& v, int i) {
  return bf16_half(i >> 1 ? v.y : v.x, i & 1);
}
__device__ __forceinline__ float unpack(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ float unpack(float v, int) { return v; }
__device__ __forceinline__ float unpack(__nv_bfloat16 v, int) { return __bfloat162float(v); }

template <typename V> __device__ __forceinline__ V zero_of() { return V{}; }
template <> __device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0);
}

template <int VEC>
__device__ __forceinline__ void add_vec(float* p, const float* v) {
  if (VEC == 4)
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  else
    atomicAdd(p, v[0]);
}

constexpr int SPMM_PF = 4;  // row gathers in flight per lane group

// y[row0 + d] += round_to<XT>(w * x[col0 + s]) for each live slot of one
// tile (K1) or sub-tile (K9); a null `weight` means every edge weighs 1
// (the weight stream is not read).  The warp reads the slots 32 at a time,
// keeps the live ones by ballot and stops at the first 32 without an edge.
// E edges per load (1 or 2): the warp splits into E groups of LG = 32 / E
// lanes, each taking its own half of a window's live slots in slot order;
// lane k of a group holds features f0 + (k + LG i) VEC + [0, VEC), i < NV,
// of a pass.  A group takes its live slots SPMM_PF at a time: their
// senders, receivers and weights by shuffle, then the loads of all PF rows
// are issued before the first is used, so each group keeps PF rows in
// flight.  It sums its terms in slot order into register sums of its
// current receiver's run of slots and adds a run's sums into y with one
// float32 atomic per value (float4 atomics where VEC = 4) when the
// receiver changes and after the walk.  w * x is rounded before the sum
// (__fmul_rn: never contracted into an FMA), as the plain version computes
// it.  The launchers pick VEC 4 where F % 4 == 0 and x is aligned for it
// (bf16 rows by half-warps, E = 2, NV = 2: each 8-byte load and float4
// atomic of a half-warp covers 64 contiguous features; float32 rows by
// the whole warp, 16-byte loads), else 1 feature a lane, two a pass.
template <typename XT, typename WT, int VEC, int NV, int E>
__device__ __forceinline__ void spmm_walk(
    const int16_t* __restrict__ src_local, const int16_t* __restrict__ dst_local,
    const WT* __restrict__ weight, int64_t base, int ET, int R, int C, int64_t row0,
    int64_t col0, const XT* __restrict__ x, float* __restrict__ y, int F, int64_t n_x,
    int64_t n_out, int lane) {
  static_assert(E == 1 || E == 2, "one or two lane groups");
  using V = typename VecLoad<XT, VEC>::type;
  constexpr int LG = 32 / E;          // lanes a group
  constexpr int W = LG * VEC * NV;    // features a pass
  const int grp = lane / LG, k = lane % LG;
  for (int f0 = 0; f0 < F; f0 += W) {
    float sum[NV][VEC] = {};
    int64_t cur = -1;  // the group's current run's receiver
    auto flush = [&]() {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int f = f0 + (k + LG * i) * VEC;
        if (f < F) add_vec<VEC>(y + cur * F + f, sum[i]);
      }
    };
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
      const float w = !live ? 0.f : weight != nullptr ? to_f(weight[base + e]) : 1.f;
      const unsigned all = __ballot_sync(0xffffffffu, live);
      // group g takes the g-th half of the live slots, in slot order
      unsigned todo = all;
      if (E > 1) {
        const int n = __popc(all), rank = __popc(all & ((1u << lane) - 1u));
        const unsigned first = __ballot_sync(0xffffffffu, live && rank < (n + 1) / 2);
        todo = grp == 0 ? first : all & ~first;
      }
      while (__any_sync(0xffffffffu, todo != 0u)) {
        int dq[SPMM_PF];
        float wq[SPMM_PF];
        V xv[SPMM_PF][NV];
#pragma unroll
        for (int q = 0; q < SPMM_PF; ++q) {
          const int j = todo ? __ffs(todo) - 1 : -1;  // -1: past the group's last
          todo &= todo - 1;
          const int src = j >= 0 ? j : 0;
          // every lane shuffles: the groups' j differ, and one may be done
          const int sj = __shfl_sync(0xffffffffu, s, src);
          const int dj = __shfl_sync(0xffffffffu, d, src);
          dq[q] = j >= 0 ? dj : -1;
          wq[q] = __shfl_sync(0xffffffffu, w, src);
          const XT* xr = x + (col0 + sj) * F;
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            const int f = f0 + (k + LG * i) * VEC;
            xv[q][i] = j >= 0 && f < F ? *reinterpret_cast<const V*>(xr + f) : zero_of<V>();
          }
        }
#pragma unroll
        for (int q = 0; q < SPMM_PF; ++q) {
          if (dq[q] < 0) break;
          if (row0 + dq[q] != cur) {
            if (cur >= 0) flush();
            cur = row0 + dq[q];
#pragma unroll
            for (int i = 0; i < NV; ++i)
#pragma unroll
              for (int v = 0; v < VEC; ++v) sum[i][v] = 0.f;
          }
#pragma unroll
          for (int i = 0; i < NV; ++i)
#pragma unroll
            for (int v = 0; v < VEC; ++v)
              sum[i][v] += round_to<XT>(__fmul_rn(wq[q], unpack(xv[q][i], v)));
        }
      }
    }
    if (cur >= 0) flush();
  }
}

// Runs launch.template run<VEC, NV, E>() with the walk's configuration for
// x's dtype, width and alignment (see spmm_walk)
template <typename XT, typename Launch>
cudaError_t spmm_walk_config(const void* x, int F, const Launch& launch) {
  if (F % 4 == 0 && reinterpret_cast<uintptr_t>(x) % (4 * sizeof(XT)) == 0) {
    if constexpr (sizeof(XT) == 2)
      return launch.template run<4, 2, 2>();
    else
      return launch.template run<4, 1, 1>();
  }
  return launch.template run<1, 2, 1>();
}

// The logit of an edge of the prefix walk, per head: its softmax term p
// from a_s[src], a_dst[r] and the head's bound term `ms` (bound(msrc, hh),
// read once a pass).  ShiftBound is K3's, under the global per-head shift
// bound leaky(msrc + a_d); StaticShift is K14's, under the static shift
// SHIFT with the logit clamped at SHIFT + 60 (no msrc).
struct ShiftBound {
  static __device__ __forceinline__ float bound(const float* msrc, int hh) { return msrc[hh]; }
  static __device__ __forceinline__ float p(float as, float ad, float ms, float slope) {
    return expf(fminf(leaky(as + ad, slope) - leaky(ms + ad, slope), 60.f));
  }
};
struct StaticShift {
  static constexpr float SHIFT = 12.f;  // ops/gat.py SHIFT
  static __device__ __forceinline__ float bound(const float*, int) { return 0.f; }
  static __device__ __forceinline__ float p(float as, float ad, float, float slope) {
    return expf(fminf(leaky(as + ad, slope), SHIFT + 60.f) - SHIFT);
  }
};

// GAT softmax-aggregate of each live slot src -> r of one tile (K3, and
// K14's walk), with spmm_walk's structure: the warp reads the slots 32 at a
// time, keeps the live ones by ballot and stops at the first 32 without an
// edge; E lane groups of LG = 32 / E lanes take their halves of a window's
// live slots, each SPMM_PF at a time with all PF rows' loads issued before
// the first is used; lane k of a group holds features f0 + (k + LG i) VEC +
// [0, VEC), i < NV, of a pass (VEC = 4 only where D % 4 == 0, so one
// load's features share a head).  a_s is per node ([n_h, H] float32): per
// edge each lane reads a_s[src] and a_dst[r] of the heads of its NV loads
// alongside the row and forms their p = m * Logit::p(a_s, a_d, bound) (K3's
// ShiftBound: exp(min(leaky(a_s + a_d) - leaky(msrc + a_d), 60))) itself,
// m the slot's multiplicity (1 when `mult` is null): no warp reduction and
// no shuffle per feature.  num sums round_to<HT>(p * h) (the product never
// contracted into an FMA), den sums round_to<HT>(p) on the one lane whose
// load starts its head, both in registers over the group's current run of
// slots with one receiver; a run is added into acc [n_out, HD + H] with one
// float32 atomic per value (float4 atomics where VEC = 4 and HD + H is a
// multiple of 4, so the rows are 16-byte aligned) when the receiver changes
// and after the walk.
template <typename HT, typename MT, typename Logit, int VEC, int NV, int E>
__device__ __forceinline__ void gat_prefix_walk(
    const int16_t* __restrict__ src_local, const int16_t* __restrict__ dst_local,
    const MT* __restrict__ mult, int64_t base, int ET, int R, int C, int64_t row0,
    int64_t col0, const HT* __restrict__ h, const float* __restrict__ a_src,
    const float* __restrict__ a_dst, const float* __restrict__ msrc, float* __restrict__ acc,
    int HD, int H, int64_t n_h, int64_t n_a, int64_t n_out, float slope, int lane) {
  static_assert(E == 1 || E == 2, "one or two lane groups");
  using V = typename VecLoad<HT, VEC>::type;
  constexpr int LG = 32 / E;          // lanes a group
  constexpr int W = LG * VEC * NV;    // features a pass
  const int grp = lane / LG, k = lane % LG;
  const int D = HD / H, WA = HD + H;
  for (int f0 = 0; f0 < HD; f0 += W) {
    int hk[NV];      // the head of each of this lane's loads (-1 past HD)
    bool own[NV];    // the load starts its head: this lane sums its den
    float ms[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int f = f0 + (k + LG * i) * VEC;
      hk[i] = f < HD ? f / D : -1;
      own[i] = f < HD && f % D == 0;
      ms[i] = f < HD ? Logit::bound(msrc, hk[i]) : 0.f;
    }
    float num[NV][VEC] = {}, den[NV] = {};
    int64_t cur = -1;  // the group's current run's receiver
    auto flush = [&]() {
      float* arow = acc + cur * WA;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        if (hk[i] < 0) continue;
        float* p = arow + f0 + (k + LG * i) * VEC;
        if (VEC == 1 || WA % 4 == 0) {
          add_vec<VEC>(p, num[i]);
        } else {  // rows of HD + H floats, not 16-byte aligned: one float at a time
#pragma unroll
          for (int v = 0; v < VEC; ++v) atomicAdd(p + v, num[i][v]);
        }
        if (own[i]) atomicAdd(arow + HD + hk[i], den[i]);
      }
    };
    for (int e0 = 0; e0 < ET; e0 += 32) {
      const int e = e0 + lane;
      int s = C, d = R;
      if (e < ET) {
        s = src_local[base + e];
        d = dst_local[base + e];
      }
      const bool real = s >= 0 && s < C && d >= 0 && d < R;
      if (__ballot_sync(0xffffffffu, real) == 0u) break;  // past the edges
      const bool live = real && col0 + s < n_h && row0 + d < n_out;
      const float m = !live ? 0.f : mult != nullptr ? to_f(mult[base + e]) : 1.f;
      const unsigned all = __ballot_sync(0xffffffffu, live);
      // group g takes the g-th half of the live slots, in slot order
      unsigned todo = all;
      if (E > 1) {
        const int n = __popc(all), rank = __popc(all & ((1u << lane) - 1u));
        const unsigned first = __ballot_sync(0xffffffffu, live && rank < (n + 1) / 2);
        todo = grp == 0 ? first : all & ~first;
      }
      while (__any_sync(0xffffffffu, todo != 0u)) {
        int dq[SPMM_PF];
        float mq[SPMM_PF], asq[SPMM_PF][NV], adq[SPMM_PF][NV];
        V xv[SPMM_PF][NV];
#pragma unroll
        for (int q = 0; q < SPMM_PF; ++q) {
          const int j = todo ? __ffs(todo) - 1 : -1;  // -1: past the group's last
          todo &= todo - 1;
          const int src = j >= 0 ? j : 0;
          // every lane shuffles: the groups' j differ, and one may be done
          const int sj = __shfl_sync(0xffffffffu, s, src);
          const int dj = __shfl_sync(0xffffffffu, d, src);
          dq[q] = j >= 0 ? dj : -1;
          mq[q] = __shfl_sync(0xffffffffu, m, src);
          const int64_t node = col0 + sj, r = row0 + dj;
          const HT* xr = h + node * HD;
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            const bool on = j >= 0 && hk[i] >= 0;
            xv[q][i] = on ? *reinterpret_cast<const V*>(xr + f0 + (k + LG * i) * VEC)
                          : zero_of<V>();
            asq[q][i] = on ? a_src[node * H + hk[i]] : 0.f;
            adq[q][i] = on && r < n_a ? a_dst[r * H + hk[i]] : 0.f;
          }
        }
#pragma unroll
        for (int q = 0; q < SPMM_PF; ++q) {
          if (dq[q] < 0) break;
          if (row0 + dq[q] != cur) {
            if (cur >= 0) flush();
            cur = row0 + dq[q];
#pragma unroll
            for (int i = 0; i < NV; ++i) {
              den[i] = 0.f;
#pragma unroll
              for (int v = 0; v < VEC; ++v) num[i][v] = 0.f;
            }
          }
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            const float p = Logit::p(asq[q][i], adq[q][i], ms[i], slope) * mq[q];
#pragma unroll
            for (int v = 0; v < VEC; ++v)
              num[i][v] += round_to<HT>(__fmul_rn(p, unpack(xv[q][i], v)));
            if (own[i]) den[i] += round_to<HT>(p);
          }
        }
      }
    }
    if (cur >= 0) flush();
  }
}

// Runs launch.template run<VEC, NV, E>() with gat_prefix_walk's
// configuration: spmm_walk's (vector loads where HD % 4 == 0 and h is
// aligned for them), and only where D % 4 == 0, so that the four features
// of a load share a head; otherwise one feature a lane, by half-warps two
// edges at a time up to 48 features (the 41 logits of a last layer), else
// by the whole warp
template <typename HT, typename Launch>
cudaError_t gat_walk_config(const void* h, int HD, int H, const Launch& launch) {
  if ((HD / H) % 4 == 0) return spmm_walk_config<HT>(h, HD, launch);
  if (HD <= 48) return launch.template run<1, 3, 2>();
  return launch.template run<1, 2, 1>();
}

// ---- the SDDMM walks: K12's sddmm_walk, K11's sddmm_lane_walk and
// sddmm_group_walk -----------------------------------------------------------

// Per-head edge dots of each live slot of one sub-tile (K12), written once
// (no atomics):
//   out[h * plane + base + e] = sum over head h's P = F / heads features f
//                               of prod(x_src[col0 + s, f], x_dst[row0 + d, f])
// prod is the float32 product of the two values, rounded to XT first when
// `round_prod` (the grouped TPU kernel's astype(dt) before its head sum).
// Pad slots are not written: the caller zero-fills `out`.  The warp takes
// the live slots one at a time.  P >= 32: each head is a warp reduction of
// its lanes' partial sums.  P < 32: the warp stages the slot's F products
// in `prod` (F floats of shared memory) and lane h sums head h's P
// products.
template <typename XT>
__device__ __forceinline__ void sddmm_walk(
    const int16_t* __restrict__ src_local, const int16_t* __restrict__ dst_local,
    int64_t base, int ET, int R, int C, int64_t row0, int64_t col0,
    const XT* __restrict__ x_src, const XT* __restrict__ x_dst, float* __restrict__ out,
    int64_t plane, int F, int heads, int64_t n_src, int64_t n_dst, bool round_prod,
    float* prod, int lane) {
  const int P = F / heads;
  for (int e0 = 0; e0 < ET; e0 += 32) {
    const int e = e0 + lane;
    int s = C, d = R;
    if (e < ET) {
      s = src_local[base + e];
      d = dst_local[base + e];
    }
    const bool real = s >= 0 && s < C && d >= 0 && d < R;
    if (__ballot_sync(0xffffffffu, real) == 0u) break;  // past the edges
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

// K11's walks compute the same dots as sddmm_walk with round_prod false
// (the float32 product of the two values, never contracted into an FMA,
// summed per head in feature order within a lane), stop at the tile's
// edge prefix, and write zeros into every slot that holds no live edge, up
// to ET: the caller need not zero-fill `out`.

// Zeros into slots [e0, ET) of one tile, every head (e0 a multiple of 32):
// float4 stores where ET % 4 == 0, so that each head's slots start 16-byte
// aligned (base = t ET, plane = T ET)
__device__ __forceinline__ void sddmm_zero_slots(float* __restrict__ out, int64_t base,
                                                 int e0, int ET, int64_t plane, int heads,
                                                 int lane) {
  if (ET % 4 == 0) {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int hh = 0; hh < heads; ++hh) {
      float4* o = reinterpret_cast<float4*>(out + hh * plane + base);
      for (int e = e0 + 4 * lane; e < ET; e += 128) o[e >> 2] = z;
    }
  } else {
    for (int hh = 0; hh < heads; ++hh)
      for (int e = e0 + lane; e < ET; e += 32) out[hh * plane + base + e] = 0.f;
  }
}

// A narrow row loaded whole as NW 32-bit words, LB bytes a load
template <int LB> struct WordLoad;
template <> struct WordLoad<4> { using type = uint32_t; };
template <> struct WordLoad<8> { using type = uint2; };
template <> struct WordLoad<16> { using type = uint4; };

template <int NW, int LB>
__device__ __forceinline__ void load_words(const void* p, uint32_t (&w)[NW]) {
  using T = typename WordLoad<LB>::type;
  constexpr int PER = LB / 4;
  const T* q = static_cast<const T*>(p);
#pragma unroll
  for (int k = 0; k < NW / PER; ++k) {
    const T v = q[k];
    if constexpr (PER == 1) {
      w[k] = v;
    } else if constexpr (PER == 2) {
      w[2 * k] = v.x;
      w[2 * k + 1] = v.y;
    } else {
      w[4 * k] = v.x;
      w[4 * k + 1] = v.y;
      w[4 * k + 2] = v.z;
      w[4 * k + 3] = v.w;
    }
  }
}

// element i of a row of XT held as 32-bit words
template <typename XT>
__device__ __forceinline__ float word_elem(const uint32_t* w, int i) {
  if constexpr (sizeof(XT) == 2)
    return bf16_half(w[i >> 1], i & 1);
  else
    return __uint_as_float(w[i]);
}

// K11, narrow rows: lane l takes slot e0 + l of each window of 32 slots.
// It gathers its slot's two rows whole (FN > 0: FN = F features, a power of
// two of at most 32 bytes, in LB-byte loads; FN = 0: F features one at a
// time), sums each head's products in registers and writes its `heads`
// floats: per head, the 32 slots of a window are 32 consecutive floats, so
// the warp's stores coalesce.  No shuffle per edge and no shared memory.
template <typename XT, int FN, int LB>
__device__ __forceinline__ void sddmm_lane_walk(
    const int16_t* __restrict__ src_local, const int16_t* __restrict__ dst_local,
    int64_t base, int ET, int R, int C, int64_t row0, int64_t col0,
    const XT* __restrict__ x_src, const XT* __restrict__ x_dst, float* __restrict__ out,
    int64_t plane, int F, int heads, int64_t n_src, int64_t n_dst, int lane) {
  const int P = F / heads;
  int e0 = 0;
  for (; e0 < ET; e0 += 32) {
    const int e = e0 + lane;
    int s = C, d = R;
    if (e < ET) {
      s = src_local[base + e];
      d = dst_local[base + e];
    }
    const bool real = s >= 0 && s < C && d >= 0 && d < R;
    if (__ballot_sync(0xffffffffu, real) == 0u) break;  // past the edges
    const bool live = real && col0 + s < n_src && row0 + d < n_dst;
    float* o = out + base + e;
    if (live) {
      const XT* a = x_src + (col0 + s) * F;
      const XT* b = x_dst + (row0 + d) * F;
      float acc = 0.f;
      int hh = 0, n = 0;  // the head being summed, its products so far
      if constexpr (FN > 0) {
        constexpr int NW = FN * static_cast<int>(sizeof(XT)) / 4;
        uint32_t wa[NW], wb[NW];
        load_words<NW, LB>(a, wa);
        load_words<NW, LB>(b, wb);
#pragma unroll
        for (int f = 0; f < FN; ++f) {
          acc += __fmul_rn(word_elem<XT>(wa, f), word_elem<XT>(wb, f));
          if (++n == P) {
            o[hh * plane] = acc;
            ++hh;
            n = 0;
            acc = 0.f;
          }
        }
      } else {
        for (int f = 0; f < F; ++f) {
          acc += __fmul_rn(to_f(a[f]), to_f(b[f]));
          if (++n == P) {
            o[hh * plane] = acc;
            ++hh;
            n = 0;
            acc = 0.f;
          }
        }
      }
    } else if (e < ET) {
      for (int hh = 0; hh < heads; ++hh) o[hh * plane] = 0.f;
    }
  }
  sddmm_zero_slots(out, base, e0, ET, plane, heads, lane);
}

constexpr int SDDMM_MAXH = 8;  // heads whose sums a lane holds

// How sddmm_group_walk sums a slot's heads.  The first two hand each
// head's sum to the slot's own lane, which holds at most SDDMM_MAXH.
enum SddmmHeads {
  // a head is whole loads: Q = P / VEC lanes of a load, Q a power of two
  // (a segmented __shfl_xor tree of log2 Q steps a load; past a group's
  // LG lanes, the lanes' loads of a head added first, then a tree over
  // the group)
  HEADS_SEG,
  // any other split: each lane adds its products of each head, then a
  // tree over the group, a head at a time
  HEADS_ANY,
  // a load holds VEC / P whole heads (P divides VEC: MUL's heads = F, any
  // number of heads): the lane writes them itself
  HEADS_OWN,
};

// K11, wide rows, with spmm_walk's structure: E lane groups of LG = 32 / E
// lanes take their halves of a window's live slots in slot order, each
// SPMM_PF slots at a time with the loads of all PF pairs of rows issued
// before the first is used; lane k of a group holds features f0 + (k + LG
// i) VEC + [0, VEC), i < NV, of a pass of W = LG VEC NV features.  The
// passes run inside the slot loop, so a head may span passes.  HEADS_SEG
// and HEADS_ANY form each head's sum of a pass by a __shfl_xor tree, and
// the slot's own lane (lane j takes slot e0 + j) adds it into its register
// res[h]; after the window each lane writes its slot's `heads` floats, so
// a window's outputs leave in one coalesced store per head.
template <typename XT, int VEC, int NV, int E, SddmmHeads HS>
__device__ __forceinline__ void sddmm_group_walk(
    const int16_t* __restrict__ src_local, const int16_t* __restrict__ dst_local,
    int64_t base, int ET, int R, int C, int64_t row0, int64_t col0,
    const XT* __restrict__ x_src, const XT* __restrict__ x_dst, float* __restrict__ out,
    int64_t plane, int F, int heads, int64_t n_src, int64_t n_dst, int lane) {
  static_assert(E == 1 || E == 2, "one or two lane groups");
  using V = typename VecLoad<XT, VEC>::type;
  constexpr int LG = 32 / E;          // lanes a group
  constexpr int W = LG * VEC * NV;    // features a pass
  const int grp = lane / LG, k = lane % LG;
  const int P = F / heads;
  int hk[NV][VEC];  // the head of each feature of a pass (-1 past F)
  auto heads_of = [&](int f0) {
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const int f = f0 + (k + LG * i) * VEC + v;
        hk[i][v] = f < F ? f / P : -1;
      }
  };
  heads_of(0);
  int e0 = 0;
  for (; e0 < ET; e0 += 32) {
    const int e = e0 + lane;
    int s = C, d = R;
    if (e < ET) {
      s = src_local[base + e];
      d = dst_local[base + e];
    }
    const bool real = s >= 0 && s < C && d >= 0 && d < R;
    if (__ballot_sync(0xffffffffu, real) == 0u) break;  // past the edges
    const bool live = real && col0 + s < n_src && row0 + d < n_dst;
    const unsigned all = __ballot_sync(0xffffffffu, live);
    // group g takes the g-th half of the live slots, in slot order; this
    // lane's slot is the step-th of group `from` (its first lane)
    unsigned todo = all, mine = all;
    int from = 0;
    if (E > 1) {
      const int n = __popc(all), rank = __popc(all & ((1u << lane) - 1u));
      const unsigned first = __ballot_sync(0xffffffffu, live && rank < (n + 1) / 2);
      todo = grp == 0 ? first : all & ~first;
      const bool in_first = (first >> lane) & 1u;
      mine = in_first ? first : all & ~first;
      from = in_first ? 0 : LG;
    }
    const int step = __popc(mine & ((1u << lane) - 1u));
    float res[SDDMM_MAXH];
#pragma unroll
    for (int c = 0; c < SDDMM_MAXH; ++c) res[c] = 0.f;
    for (int taken = 0; __any_sync(0xffffffffu, todo != 0u); taken += SPMM_PF) {
      int jq[SPMM_PF];
      const XT* aq[SPMM_PF];
      const XT* bq[SPMM_PF];
#pragma unroll
      for (int q = 0; q < SPMM_PF; ++q) {
        const int j = todo ? __ffs(todo) - 1 : -1;  // -1: past the group's last
        todo &= todo - 1;
        const int src = j >= 0 ? j : 0;
        // every lane shuffles: the groups' j differ, and one may be done
        const int sj = __shfl_sync(0xffffffffu, s, src);
        const int dj = __shfl_sync(0xffffffffu, d, src);
        jq[q] = j;
        aq[q] = x_src + (col0 + sj) * F;
        bq[q] = x_dst + (row0 + dj) * F;
      }
      for (int f0 = 0; f0 < F; f0 += W) {
        if (F > W) heads_of(f0);
        V xa[SPMM_PF][NV], xb[SPMM_PF][NV];
#pragma unroll
        for (int q = 0; q < SPMM_PF; ++q)
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            const int f = f0 + (k + LG * i) * VEC;
            const bool on = jq[q] >= 0 && f < F;
            xa[q][i] = on ? *reinterpret_cast<const V*>(aq[q] + f) : zero_of<V>();
            xb[q][i] = on ? *reinterpret_cast<const V*>(bq[q] + f) : zero_of<V>();
          }
#pragma unroll
        for (int q = 0; q < SPMM_PF; ++q) {
          float pr[NV][VEC];
#pragma unroll
          for (int i = 0; i < NV; ++i)
#pragma unroll
            for (int v = 0; v < VEC; ++v)
              pr[i][v] = __fmul_rn(unpack(xa[q][i], v), unpack(xb[q][i], v));
          const bool mine_q = live && step == taken + q;
          if constexpr (HS == HEADS_SEG) {
            float sl[NV];  // the lane's sum of each load
#pragma unroll
            for (int i = 0; i < NV; ++i) {
              sl[i] = 0.f;
#pragma unroll
              for (int v = 0; v < VEC; ++v) sl[i] += pr[i][v];
            }
            const int Q = P / VEC;
            if (Q <= LG) {  // a head is Q lanes of a load, a pass whole heads
#pragma unroll
              for (int i = 0; i < NV; ++i)
                for (int o = Q >> 1; o > 0; o >>= 1)
                  sl[i] += __shfl_xor_sync(0xffffffffu, sl[i], o);
#pragma unroll
              for (int c = 0; c < SDDMM_MAXH; ++c) {
                if (c >= heads) break;
                // the head starts at feature (kc + LG ic) VEC of the pass
                const int loc = c * P - f0;
                if (loc < 0 || loc >= W) continue;
                const int ic = loc / (LG * VEC), kc = (loc / VEC) % LG;
                float v = sl[0];
#pragma unroll
                for (int i = 1; i < NV; ++i)
                  if (i == ic) v = sl[i];
                const float got = __shfl_sync(0xffffffffu, v, from + kc);
                if (mine_q) res[c] += got;
              }
            } else {  // a head is whole loads of every lane of the group
#pragma unroll
              for (int c = 0; c < SDDMM_MAXH; ++c) {
                if (c >= heads) break;
                if (c * P >= f0 + W || (c + 1) * P <= f0) continue;  // not in this pass
                float part = 0.f;
#pragma unroll
                for (int i = 0; i < NV; ++i)
                  if (hk[i][0] == c) part += sl[i];
#pragma unroll
                for (int o = LG / 2; o > 0; o >>= 1)
                  part += __shfl_xor_sync(0xffffffffu, part, o);
                const float got = __shfl_sync(0xffffffffu, part, from);
                if (mine_q) res[c] += got;
              }
            }
          } else if constexpr (HS == HEADS_ANY) {
#pragma unroll
            for (int c = 0; c < SDDMM_MAXH; ++c) {
              if (c >= heads) break;
              if (c * P >= f0 + W || (c + 1) * P <= f0) continue;  // not in this pass
              float part = 0.f;
#pragma unroll
              for (int i = 0; i < NV; ++i)
#pragma unroll
                for (int v = 0; v < VEC; ++v)
                  if (hk[i][v] == c) part += pr[i][v];
#pragma unroll
              for (int o = LG / 2; o > 0; o >>= 1)
                part += __shfl_xor_sync(0xffffffffu, part, o);
              const float got = __shfl_sync(0xffffffffu, part, from);
              if (mine_q) res[c] += got;
            }
          } else {
            if (jq[q] < 0) continue;
            float* o = out + base + e0 + jq[q];
#pragma unroll
            for (int i = 0; i < NV; ++i) {
              if (hk[i][0] < 0) continue;
              float acc = 0.f;
              int hh = hk[i][0], n = 0;
#pragma unroll
              for (int v = 0; v < VEC; ++v) {
                acc += pr[i][v];
                if (++n == P) {
                  o[hh * plane] = acc;
                  ++hh;
                  n = 0;
                  acc = 0.f;
                }
              }
            }
          }
        }
      }
    }
    if (e < ET) {
      float* o = out + base + e;
      if constexpr (HS != HEADS_OWN) {
#pragma unroll
        for (int c = 0; c < SDDMM_MAXH; ++c)
          if (c < heads) o[c * plane] = live ? res[c] : 0.f;
      } else if (!live) {
        for (int hh = 0; hh < heads; ++hh) o[hh * plane] = 0.f;
      }
    }
  }
  sddmm_zero_slots(out, base, e0, ET, plane, heads, lane);
}

}  // namespace gta
