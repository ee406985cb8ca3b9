// K1 spmm_tiles: edge-tile SpMM, y[r] += w_e * x[s] over the tiles of each
// row block.
//
// Replaces the TPU kernel ops/spmm.py:_spmm_kernel of the JAX package,
// which gathers and scatters through one-hot matmuls because the TPU has no
// fast dynamic gather.  Hopper gathers rows directly, so this kernel reads
// the same host-built tile arrays and indexes x by the sender instead.
//
// Bound on the card: the row gathers and the chain of dependent loads per
// tile (tile words, slot words, rows).  Each live edge reads one x row (F
// elements, a few hundred bytes at most) and its index and weight words,
// and each run of slots with one receiver adds F float32 values into y;
// the tiles are TPU-shaped (512 slots, ~10% full on the sparse tail), so a
// warp that reads every slot and waits on one row at a time leaves the
// card idle.  The atomics are not what bounds it: a row-owned variant (a
// CUDA block summing 64 or 128 rows of a row block in shared memory and
// storing them once, no global atomics) and variants with streaming
// stores or an L2 evict-last hint on x ran no faster on the smoke's GCN
// tail.
//
// Design: one warp per tile, so the work spreads evenly over the card
// whatever the row-block skew; dead tiles (cb < 0) are skipped whole.  The
// walk is gta::spmm_walk (tile_walk.cuh), which K9 shares.  The warp reads the tile's slots 32 at a time, keeps the live ones by ballot
// (pad slots are never addressed), and stops at the first 32 without an
// edge: the builders fill a prefix of each tile's slots, so a tile ~10%
// full costs one read past its edges instead of its ~90% padding.  It takes
// the live slots PF at a time: their senders, receivers and weights by
// shuffle, then the loads of all PF rows are issued before the first is
// used, so each warp keeps PF rows in flight instead of one.  Where F is a
// multiple of 4, bf16 rows go to half-warps, two edges a load (the first
// half of a window's live slots to one half-warp, the rest to the other):
// lane k of a half holds features 4k.. and 64 + 4k.. of a 128-feature
// pass, so each 8-byte load and each float4 atomic of a half-warp covers
// 64 contiguous features, and a warp keeps 2 PF rows in flight (16-byte
// loads of 8 features a lane spread each atomic over half-filled sectors
// and ran slower); float32 rows go to the whole warp, 4 features a
// lane (16-byte loads).  Otherwise lane l holds features l and l + 32.
// Each lane group sums its terms in slot order into register sums of its
// current receiver's run of slots (the builders sort a tile's slots by
// receiver), and a run's sums go into y, zeroed by the wrapper, with one float32
// atomic per value (float4 atomics where VEC = 4) when the receiver
// changes and after the walk.  A row that repeats one edge hundreds of
// times thus drifts only over a run, and y takes run sums, never single
// slots.  As on the TPU, w*x rounds to the input dtype before the f32 sum
// (__fmul_rn: never contracted into an FMA).  The atomics make the f32
// summation order of the run sums vary from run to run: results differ
// from the exact sum by f32 rounding only.
#include "tile_walk.cuh"

namespace {

constexpr int WARPS = 8;   // warps (tiles) per CUDA block

// the walk itself is gta::spmm_walk (tile_walk.cuh), shared with K9
template <typename XT, typename WT, int VEC, int NV, int E>
__global__ void __launch_bounds__(WARPS * 32)
spmm_tiles_kernel(const int* __restrict__ tile_rb, const int* __restrict__ tile_cb,
                  const int16_t* __restrict__ src_local,
                  const int16_t* __restrict__ dst_local, const WT* __restrict__ weight,
                  const XT* __restrict__ x, float* __restrict__ y, int T, int R, int C,
                  int ET, int F, int64_t n_x, int64_t n_out) {
  const int t = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (t >= T) return;
  const int cb = tile_cb[t];
  if (cb < 0) return;  // dead tile
  gta::spmm_walk<XT, WT, VEC, NV, E>(src_local, dst_local, weight,
                                     static_cast<int64_t>(t) * ET, ET, R, C,
                                     static_cast<int64_t>(tile_rb[t]) * R,
                                     static_cast<int64_t>(cb) * C, x, y, F, n_x, n_out,
                                     threadIdx.x & 31);
}

template <typename XT, typename WT>
struct Launch {
  const int *rb, *cb;
  const int16_t *s, *d;
  const void *w, *x;
  float* y;
  int T, R, C, ET, F;
  int64_t n_x, n_out;
  cudaStream_t st;
  template <int VEC, int NV, int E>
  cudaError_t run() const {
    spmm_tiles_kernel<XT, WT, VEC, NV, E><<<(T + WARPS - 1) / WARPS, WARPS * 32, 0, st>>>(
        rb, cb, s, d, static_cast<const WT*>(w), static_cast<const XT*>(x), y, T, R, C,
        ET, F, n_x, n_out);
    return cudaGetLastError();
  }
};

template <typename XT, typename WT>
cudaError_t launch(const int* rb, const int* cb, const int16_t* s,
                   const int16_t* d, const void* w, const void* x, float* y, int T, int R,
                   int C, int ET, int F, int64_t n_x, int64_t n_out, cudaStream_t st) {
  return gta::spmm_walk_config<XT>(
      x, F, Launch<XT, WT>{rb, cb, s, d, w, x, y, T, R, C, ET, F, n_x, n_out, st});
}

}  // namespace
extern "C" const char* gta_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int gta_spmm_tiles(const void* tile_rb, const void* tile_cb,
                              const void* src_local, const void* dst_local,
                              const void* weight, int w_dtype, const void* x, int x_dtype,
                              void* y, int T, int R, int C, int ET, int F, int64_t n_x,
                              int64_t n_out, void* stream) {
  auto rb = static_cast<const int*>(tile_rb);
  auto cb = static_cast<const int*>(tile_cb);
  auto s = static_cast<const int16_t*>(src_local);
  auto d = static_cast<const int16_t*>(dst_local);
  auto yy = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  if (T == 0 || F == 0) return 0;
  const bool xb = x_dtype == gta::BF16, wb = w_dtype == gta::BF16;
  cudaError_t err;
  if (xb && wb)
    err = launch<__nv_bfloat16, __nv_bfloat16>(rb, cb, s, d, weight, x, yy, T, R, C, ET, F, n_x, n_out, st);
  else if (xb)
    err = launch<__nv_bfloat16, float>(rb, cb, s, d, weight, x, yy, T, R, C, ET, F, n_x, n_out, st);
  else if (wb)
    err = launch<float, __nv_bfloat16>(rb, cb, s, d, weight, x, yy, T, R, C, ET, F, n_x, n_out, st);
  else
    err = launch<float, float>(rb, cb, s, d, weight, x, yy, T, R, C, ET, F, n_x, n_out, st);
  return static_cast<int>(err);
}
