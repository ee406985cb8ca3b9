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
// walk is picked per launch from (F, heads, dtype, alignment) by
// gta::sddmm_config, which K12 shares: a lane per slot where a row fits
// one 32-byte sector (gta::sddmm_lane_walk), else lane groups with rows in
// flight (gta::sddmm_group_walk), all in tile_walk.cuh.
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
  gta::sddmm_lane_walk<XT, FN, LB, false>(
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
  gta::sddmm_group_walk<XT, VEC, NV, E, HS, false>(
      a.s, a.d, static_cast<int64_t>(t) * a.ET, a.ET, a.R, a.C, row0, col0,
      static_cast<const XT*>(a.xs), static_cast<const XT*>(a.xd), a.out,
      static_cast<int64_t>(a.T) * a.ET, a.F, a.heads, a.n_src, a.n_dst,
      threadIdx.x & 31);
}

// The walk of the last launch, in words (gta_sddmm_tiles_walk)
char last_walk[96] = "";

// Launches the walk gta::sddmm_config picks
template <typename XT>
struct Launch {
  const Args& a;
  unsigned blocks() const { return static_cast<unsigned>((a.T + WARPS - 1) / WARPS); }
  template <int FN, int LB>
  cudaError_t lane() const {
    sddmm_lane_kernel<XT, FN, LB><<<blocks(), WARPS * 32, 0, a.st>>>(a);
    return cudaGetLastError();
  }
  template <int VEC, int NV, int E, gta::SddmmHeads HS>
  cudaError_t group() const {
    sddmm_group_kernel<XT, VEC, NV, E, HS><<<blocks(), WARPS * 32, 0, a.st>>>(a);
    return cudaGetLastError();
  }
};

template <typename XT>
cudaError_t launch(const Args& a) {
  return gta::sddmm_config<XT>(Launch<XT>{a}, a.xs, a.xd, a.F, a.heads, last_walk);
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
      x_dtype == gta::BF16 ? launch<__nv_bfloat16>(a) : launch<float>(a);
  return static_cast<int>(err);
}

// The walk of the last gta_sddmm_tiles launch, for the smoke's prints
extern "C" const char* gta_sddmm_tiles_walk() { return last_walk; }
