// K12 sddmm_grouped: per-head edge dots (SDDMM) over a stripe-group chunked
// tiling (GroupedTiledGraph): [heads, NC, G*ET] float32, slot k of chunk c's
// sub-tile j at [h, c, j*ET + k], for the edge cb*C + src_local ->
// (grp*G + j)*R + dst_local.
//
// Replaces the TPU kernel ops/sddmm.py:_sddmm_grouped.<kernel> of the JAX
// package, which gathers in the transposed dataflow through one-hot
// matmuls.  Numerics as that kernel, and on purpose not as K11: each
// product of the two values is rounded to the input dtype before the
// per-head float32 sum (`prod = (s * d).astype(dt)`), so for bf16 inputs
// the grouped and per-tile answers differ by that rounding.
//
// Bound on the card: memory, as K11: two index words and two F-wide rows
// per live slot, `heads` floats written per slot, the zeros of the
// format's padding (every chunk carries the deepest level of its G row
// blocks) included.  The G sub-tiles of a chunk share one column block, so
// sender rows repeat within a chunk.
//
// Design: K9's work list and K11's walks.  One warp per sub-tile of
// GroupedTiledGraph.live_sub (the sub-tiles whose slot 0 holds an edge),
// walking it by K11's walk for (F, heads, dtype, alignment),
// gta::sddmm_config (tile_walk.cuh): a lane per slot for rows of at most
// 32 bytes (gta::sddmm_lane_walk), else lane groups with rows in flight
// and segmented head trees (gta::sddmm_group_walk), each with the product
// rounded to XT (RP).  The walk stops at the sub-tile's edge prefix and
// writes the zeros past it; a listed sub-tile of a dead chunk (cb < 0)
// gets zeros only, and blocks after the walk's zero the sub-tiles off the
// list, so the wrapper leaves the output unfilled (faster on the card than
// a zero fill by the wrapper at one head and at four: PERF.md section 6).
// Each slot's output is written once, with plain stores: no atomics, and
// the result is the same on every run.
#include "tile_walk.cuh"

namespace {

constexpr int WARPS = 8;

struct Args {
  const int *live, *grp, *cb;
  const int16_t *s, *d;
  const void *xs, *xd;
  float* out;
  int n_live, G, R, C, ET, F, heads;
  int64_t n_sub, n_src, n_dst;
  int walk_blocks;  // blocks of the walk; the blocks past them zero (below)
  cudaStream_t st;
};

// The warp's role.  In the first walk_blocks blocks a warp takes one listed
// sub-tile: its flat index u and row and column offsets (true), or false
// past the list and for a dead chunk (cb < 0), whose zeros it writes.
// Every later block's warps each take 32 consecutive sub-tiles of the
// whole tiling, lane l the l-th one's slot 0, and write the zeros of those
// that are not on the list (slot 0 holds no edge: the list's own rule), so
// the output needs no fill.  (A warp a sub-tile there would queue tens of
// thousands of short blocks behind the walk's, at the walk's occupancy.)
__device__ __forceinline__ bool sub_of(const Args& a, int64_t& u, int64_t& row0,
                                       int64_t& col0) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t plane = a.n_sub * a.ET;
  if (static_cast<int>(blockIdx.x) >= a.walk_blocks) {
    const int64_t v0 = (static_cast<int64_t>(blockIdx.x - a.walk_blocks) * WARPS + w) * 32;
    bool off = false;
    if (v0 + lane < a.n_sub) {
      const int s0 = a.s[(v0 + lane) * a.ET], d0 = a.d[(v0 + lane) * a.ET];
      off = !(s0 >= 0 && s0 < a.C && d0 >= 0 && d0 < a.R);
    }
    for (unsigned todo = __ballot_sync(0xffffffffu, off); todo; todo &= todo - 1)
      gta::sddmm_zero_slots(a.out, (v0 + __ffs(todo) - 1) * a.ET, 0, a.ET, plane,
                            a.heads, lane);
    return false;
  }
  const int i = blockIdx.x * WARPS + w;
  if (i >= a.n_live) return false;
  u = a.live[i];
  const int64_t c = u / a.G;
  const int cb = a.cb[c];
  if (cb < 0) {
    gta::sddmm_zero_slots(a.out, u * a.ET, 0, a.ET, plane, a.heads, lane);
    return false;
  }
  row0 = (static_cast<int64_t>(a.grp[c]) * a.G + u % a.G) * a.R;
  col0 = static_cast<int64_t>(cb) * a.C;
  return true;
}

template <typename XT, int FN, int LB>
__global__ void __launch_bounds__(WARPS * 32) sddmm_grouped_lane_kernel(const __grid_constant__ Args a) {
  int64_t u, row0, col0;
  if (!sub_of(a, u, row0, col0)) return;
  gta::sddmm_lane_walk<XT, FN, LB, true>(
      a.s, a.d, u * a.ET, a.ET, a.R, a.C, row0, col0, static_cast<const XT*>(a.xs),
      static_cast<const XT*>(a.xd), a.out, a.n_sub * a.ET, a.F, a.heads, a.n_src, a.n_dst,
      threadIdx.x & 31);
}

template <typename XT, int VEC, int NV, int E, gta::SddmmHeads HS>
__global__ void __launch_bounds__(WARPS * 32) sddmm_grouped_group_kernel(const __grid_constant__ Args a) {
  int64_t u, row0, col0;
  if (!sub_of(a, u, row0, col0)) return;
  gta::sddmm_group_walk<XT, VEC, NV, E, HS, true>(
      a.s, a.d, u * a.ET, a.ET, a.R, a.C, row0, col0, static_cast<const XT*>(a.xs),
      static_cast<const XT*>(a.xd), a.out, a.n_sub * a.ET, a.F, a.heads, a.n_src, a.n_dst,
      threadIdx.x & 31);
}

// The walk of the last launch, in words (gta_sddmm_grouped_walk)
char last_walk[96] = "";

// Launches the walk gta::sddmm_config picks: the walk's blocks, then those
// that zero the unlisted sub-tiles
template <typename XT>
struct Launch {
  const Args& a;
  unsigned blocks;
  template <int FN, int LB>
  cudaError_t lane() const {
    sddmm_grouped_lane_kernel<XT, FN, LB><<<blocks, WARPS * 32, 0, a.st>>>(a);
    return cudaGetLastError();
  }
  template <int VEC, int NV, int E, gta::SddmmHeads HS>
  cudaError_t group() const {
    sddmm_grouped_group_kernel<XT, VEC, NV, E, HS><<<blocks, WARPS * 32, 0, a.st>>>(a);
    return cudaGetLastError();
  }
};

template <typename XT>
cudaError_t launch(const Args& a, unsigned blocks) {
  return gta::sddmm_config<XT>(Launch<XT>{a, blocks}, a.xs, a.xd, a.F, a.heads, last_walk);
}

}  // namespace

// K12.  live_sub: int32[n_live] flat indices (chunk * G + sub-tile) of the
// sub-tiles whose slot 0 holds an edge (GroupedTiledGraph.live_sub).  The
// kernel writes every slot of `out` (zeros where no live edge, unlisted
// sub-tiles and dead chunks included), which the caller need not fill.
extern "C" int gta_sddmm_grouped(const void* live_sub, const void* chunk_grp,
                                 const void* chunk_cb, const void* src_local,
                                 const void* dst_local, const void* x_src,
                                 const void* x_dst, int x_dtype, void* out, int n_live,
                                 int NC, int G, int R, int C, int ET, int F, int heads,
                                 int64_t n_src, int64_t n_dst, void* stream) {
  if (heads <= 0 || F % heads != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_sub = static_cast<int64_t>(NC) * G;
  if (n_sub == 0) return 0;
  const int walk_blocks = (n_live + WARPS - 1) / WARPS;
  const int64_t blocks = walk_blocks + (n_sub + 32 * WARPS - 1) / (32 * WARPS);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  const Args a{static_cast<const int*>(live_sub), static_cast<const int*>(chunk_grp),
               static_cast<const int*>(chunk_cb), static_cast<const int16_t*>(src_local),
               static_cast<const int16_t*>(dst_local), x_src, x_dst, static_cast<float*>(out),
               n_live, G, R, C, ET, F, heads, n_sub, n_src, n_dst, walk_blocks,
               static_cast<cudaStream_t>(stream)};
  const unsigned b = static_cast<unsigned>(blocks);
  const cudaError_t err =
      x_dtype == gta::BF16 ? launch<__nv_bfloat16>(a, b) : launch<float>(a, b);
  return static_cast<int>(err);
}

// The walk of the last gta_sddmm_grouped launch, for the smoke's prints
extern "C" const char* gta_sddmm_grouped_walk() { return last_walk; }
