// K11 sddmm_tiles: per-tile, per-head edge dots (SDDMM) over a TiledGraph,
//   e[h, t, k] = sum over head h's features of x_src[src] * x_dst[dst]
// for the edge src -> dst in slot k of tile t; [heads, T, ET] float32.
//
// Replaces the TPU kernel ops/sddmm.py:sddmm.<kernel> of the JAX package,
// which gathers both operand rows through one-hot matmuls and reduces each
// head with a head-selector matmul at HIGHEST precision.  Hopper gathers
// rows directly, so this kernel reads the same tile arrays and indexes
// x_src and x_dst by the slot's sender and receiver.  Numerics as the TPU
// kernel: the float32 product of the two values (exact for bf16 inputs),
// summed per head in float32.
//
// Bound on the card: memory.  Each live slot reads its two index words and
// two F-wide rows and writes `heads` floats; the whole output, pad slots
// included, is written once.  The tiles are TPU-shaped (3 slots per edge on
// the 1024² / ET 512 tiling the `sddmm` kind builds), so at the ADD form's
// narrow rows the zeros of the pad slots are most of the bytes; at wide
// rows the two gathered rows of every edge are (512 bytes an edge at 128
// bf16 features, where the rows of one tile seldom repeat).
//
// Design: one warp per tile (K1's layout), which stops at the tile's edge
// prefix (the builders put a tile's edges in its first slots): past it, and
// on a dead tile (cb < 0), the warp only writes zeros, by float4 stores, so
// the wrapper leaves the output unfilled.  Each slot's output is written once, with
// plain stores: no atomics, and the result is the same on every run.  The
// walk is picked per launch from (F, heads, dtype, alignment),
// sddmm_config below: a lane per slot where a row fits one 32-byte sector
// (gta::sddmm_lane_walk), else lane groups with rows in flight
// (gta::sddmm_group_walk), both in tile_walk.cuh.
#include <cstdio>

#include "tile_walk.cuh"

namespace {

constexpr int WARPS = 8;

struct Args {
  const int *rb, *cb;
  const int16_t *s, *d;
  const void *xs, *xd;
  float* out;
  int T, R, C, ET, F, heads;
  int64_t n_src, n_dst;
  cudaStream_t st;
};

// The warp's tile t: its row and column offsets, or false for a dead tile
// (whose zeros it writes)
__device__ __forceinline__ bool tile_of(const Args& a, int t, int64_t& row0, int64_t& col0) {
  const int cb = a.cb[t];
  if (cb < 0) {
    gta::sddmm_zero_slots(a.out, static_cast<int64_t>(t) * a.ET, 0, a.ET,
                          static_cast<int64_t>(a.T) * a.ET, a.heads, threadIdx.x & 31);
    return false;
  }
  row0 = static_cast<int64_t>(a.rb[t]) * a.R;
  col0 = static_cast<int64_t>(cb) * a.C;
  return true;
}

template <typename XT, int FN, int LB>
__global__ void __launch_bounds__(WARPS * 32) sddmm_lane_kernel(const __grid_constant__ Args a) {
  const int t = blockIdx.x * WARPS + (threadIdx.x >> 5);
  int64_t row0, col0;
  if (t >= a.T || !tile_of(a, t, row0, col0)) return;
  gta::sddmm_lane_walk<XT, FN, LB>(
      a.s, a.d, static_cast<int64_t>(t) * a.ET, a.ET, a.R, a.C, row0, col0,
      static_cast<const XT*>(a.xs), static_cast<const XT*>(a.xd), a.out,
      static_cast<int64_t>(a.T) * a.ET, a.F, a.heads, a.n_src, a.n_dst,
      threadIdx.x & 31);
}

template <typename XT, int VEC, int NV, int E, gta::SddmmHeads HS>
__global__ void __launch_bounds__(WARPS * 32) sddmm_group_kernel(const __grid_constant__ Args a) {
  const int t = blockIdx.x * WARPS + (threadIdx.x >> 5);
  int64_t row0, col0;
  if (t >= a.T || !tile_of(a, t, row0, col0)) return;
  gta::sddmm_group_walk<XT, VEC, NV, E, HS>(
      a.s, a.d, static_cast<int64_t>(t) * a.ET, a.ET, a.R, a.C, row0, col0,
      static_cast<const XT*>(a.xs), static_cast<const XT*>(a.xd), a.out,
      static_cast<int64_t>(a.T) * a.ET, a.F, a.heads, a.n_src, a.n_dst,
      threadIdx.x & 31);
}

// The walk of the last launch, in words (gta_sddmm_tiles_walk)
char last_walk[96] = "";

// Launches the walk sddmm_config picks and names it in last_walk
template <typename XT>
struct Launch {
  const Args& a;
  unsigned blocks() const { return static_cast<unsigned>((a.T + WARPS - 1) / WARPS); }
  template <int FN, int LB>
  cudaError_t lane() const {
    if (LB > 0)
      snprintf(last_walk, sizeof last_walk, "a lane per slot, %d-byte loads", LB);
    else
      snprintf(last_walk, sizeof last_walk, "a lane per slot, a feature at a time");
    sddmm_lane_kernel<XT, FN, LB><<<blocks(), WARPS * 32, 0, a.st>>>(a);
    return cudaGetLastError();
  }
  template <int VEC, int NV, int E, gta::SddmmHeads HS>
  cudaError_t group() const {
    snprintf(last_walk, sizeof last_walk, "lane groups (%s, %d a load), %s",
             E == 2 ? "half-warps" : "whole warps", VEC,
             HS == gta::HEADS_SEG   ? "head sums by segmented trees"
             : HS == gta::HEADS_ANY ? "head sums by a tree a head"
                                    : "heads within a load");
    sddmm_group_kernel<XT, VEC, NV, E, HS><<<blocks(), WARPS * 32, 0, a.st>>>(a);
    return cudaGetLastError();
  }
  // the group walk at VEC 4 (bf16 by half-warps, float32 by whole warps)
  // or 1 (whole warps, two features a pass)
  template <gta::SddmmHeads HS>
  cudaError_t group(bool v4) const {
    if (!v4) return group<1, 2, 1, HS>();
    if constexpr (sizeof(XT) == 2)
      return group<4, 2, 2, HS>();
    else
      return group<4, 1, 1, HS>();
  }
};

// The walk for (F, heads, XT, alignment).
// - A row of at most 32 bytes (one sector: the ADD form's F = 2 and 8, in
//   either dtype) goes a lane per slot: the lane reads every byte of the
//   sector it fetches and needs no other lane, where a lane group would
//   idle all but F / VEC of its lanes and reduce across them.  A power-of-
//   two F with both operands aligned loads the row in one or two 4-, 8- or
//   16-byte loads, else one feature at a time.
// - A wider row goes by lane groups, spmm_walk's configuration (bf16 by
//   half-warps, 8-byte loads, two slots a load; float32 by the whole warp,
//   16-byte loads; where F % 4 == 0 and both operands are aligned, else one
//   feature a lane, two a pass): a lane per slot would issue tens of
//   dependent loads a slot.  Up to SDDMM_MAXH heads, the head sums travel
//   by shuffle to the slot's lane: by segmented trees where a head is Q =
//   P / VEC lanes, Q a power of two (HEADS_SEG: the GAT tails' 4 heads of
//   32 take 3 steps a load, not 4 trees of 4), else a tree a head
//   (HEADS_ANY); more heads, each within one load (P divides VEC: MUL's
//   heads = F), are written by their lanes (HEADS_OWN); other shapes (more
//   than SDDMM_MAXH heads that straddle loads) go a lane per slot, one
//   feature at a time.
template <typename XT>
cudaError_t sddmm_config(const Args& a) {
  const Launch<XT> l{a};
  const int F = a.F, rb = F * static_cast<int>(sizeof(XT));
  const uintptr_t al = reinterpret_cast<uintptr_t>(a.xs) | reinterpret_cast<uintptr_t>(a.xd);
  if (rb <= 32) {
    const int lb = rb < 16 ? rb : 16;
    if ((F & (F - 1)) == 0 && rb >= 4 && al % lb == 0) {
      if constexpr (sizeof(XT) == 2) {
        if (F == 2) return l.template lane<2, 4>();
        if (F == 4) return l.template lane<4, 8>();
        if (F == 8) return l.template lane<8, 16>();
        return l.template lane<16, 16>();
      } else {
        if (F == 1) return l.template lane<1, 4>();
        if (F == 2) return l.template lane<2, 8>();
        if (F == 4) return l.template lane<4, 16>();
        return l.template lane<8, 16>();
      }
    }
    return l.template lane<0, 0>();
  }
  const bool v4 = F % 4 == 0 && al % (4 * sizeof(XT)) == 0;
  const int vec = v4 ? 4 : 1, P = F / a.heads, Q = P / vec;
  if (a.heads <= gta::SDDMM_MAXH) {
    if (P % vec == 0 && (Q & (Q - 1)) == 0)
      return l.template group<gta::HEADS_SEG>(v4);
    return l.template group<gta::HEADS_ANY>(v4);
  }
  if (vec % P == 0) return l.template group<gta::HEADS_OWN>(v4);
  return l.template lane<0, 0>();
}

}  // namespace

// K11: writes every slot of `out` (zeros where no live edge, dead tiles
// included), which the caller need not fill.
extern "C" int gta_sddmm_tiles(const void* tile_rb, const void* tile_cb,
                               const void* src_local, const void* dst_local,
                               const void* x_src, const void* x_dst, int x_dtype,
                               void* out, int T, int R, int C, int ET, int F,
                               int heads, int64_t n_src, int64_t n_dst,
                               void* stream) {
  if (heads <= 0 || F % heads != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return 0;
  const Args a{static_cast<const int*>(tile_rb), static_cast<const int*>(tile_cb),
               static_cast<const int16_t*>(src_local), static_cast<const int16_t*>(dst_local),
               x_src, x_dst, static_cast<float*>(out), T, R, C, ET, F, heads, n_src, n_dst,
               static_cast<cudaStream_t>(stream)};
  const cudaError_t err =
      x_dtype == gta::BF16 ? sddmm_config<__nv_bfloat16>(a) : sddmm_config<float>(a);
  return static_cast<int>(err);
}

// The walk of the last gta_sddmm_tiles launch, for the smoke's prints
extern "C" const char* gta_sddmm_tiles_walk() { return last_walk; }
