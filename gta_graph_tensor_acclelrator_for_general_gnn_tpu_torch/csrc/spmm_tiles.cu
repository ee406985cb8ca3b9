// K1 spmm_tiles: edge-tile SpMM, y[r] += w_e * x[s] over the tiles of each
// row block.
//
// Replaces the TPU kernel ops/spmm.py:_spmm_kernel of the JAX package,
// which gathers and scatters through one-hot matmuls because the TPU has no
// fast dynamic gather.  Hopper gathers rows directly, so this kernel reads
// the same host-built tile arrays and indexes x by the sender instead.
//
// Bound on the card: memory.  Each edge reads one x row (F elements) and
// its three index/weight words and adds F values into y; there is no reuse
// beyond the L2 cache.  The tiles are TPU-shaped (512 slots, ~10% full on
// the sparse tail), and the row blocks are skewed: after the hubs+labels
// reorder a few row blocks own most tiles.
//
// Design: one warp per tile, so the work spreads evenly over the card
// whatever the row-block skew.  The warp walks the tile's slots by
// gta::spmm_walk (tile_walk.cuh): live slots by ballot, pad slots never
// addressed; dead tiles (cb < 0) are skipped whole.  For each live edge its
// lanes gather the x row and add w*x into a register sum of the current
// receiver's run of slots, which goes into y by f32 global atomics
// (coalesced, one row per run; the walk is templated on the features each
// lane holds, KF = 1, 2, 4 or 8).  y is zeroed by the wrapper, so row
// stripes without edges read 0.  The atomics make the f32 summation order
// of the run sums vary from run to run: results differ from the exact sum
// by f32 rounding only.  As on the TPU, w*x rounds to the input dtype
// before the f32 sum.
#include "tile_walk.cuh"

namespace {

constexpr int WARPS = 8;

template <typename XT, typename WT, int KF>
__global__ void __launch_bounds__(WARPS * 32)
spmm_tiles_kernel(const int* __restrict__ tile_rb, const int* __restrict__ tile_cb,
                  const int16_t* __restrict__ src_local,
                  const int16_t* __restrict__ dst_local,
                  const WT* __restrict__ weight, const XT* __restrict__ x,
                  float* __restrict__ y, int T, int R, int C, int ET, int F,
                  int64_t n_x, int64_t n_out) {
  const int t = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (t >= T) return;
  const int cb = tile_cb[t];
  if (cb < 0) return;  // dead tile
  gta::spmm_walk<XT, WT, KF>(src_local, dst_local, weight, static_cast<int64_t>(t) * ET,
                             ET, R, C, static_cast<int64_t>(tile_rb[t]) * R,
                             static_cast<int64_t>(cb) * C, x, y, F, n_x, n_out,
                             /*prefix=*/false, threadIdx.x & 31);
}

template <typename XT, typename WT, int KF>
cudaError_t launch_kf(const int* rb, const int* cb, const int16_t* s, const int16_t* d,
                      const void* w, const void* x, float* y, int T, int R, int C,
                      int ET, int F, int64_t n_x, int64_t n_out, cudaStream_t st) {
  const int blocks = (T + WARPS - 1) / WARPS;
  spmm_tiles_kernel<XT, WT, KF><<<blocks, WARPS * 32, 0, st>>>(
      rb, cb, s, d, static_cast<const WT*>(w), static_cast<const XT*>(x), y, T, R,
      C, ET, F, n_x, n_out);
  return cudaGetLastError();
}

template <typename XT, typename WT>
cudaError_t launch(const int* rb, const int* cb, const int16_t* s, const int16_t* d,
                   const void* w, const void* x, float* y, int T, int R, int C,
                   int ET, int F, int64_t n_x, int64_t n_out, cudaStream_t st) {
  switch (gta::spmm_lane_features(F)) {
    case 1: return launch_kf<XT, WT, 1>(rb, cb, s, d, w, x, y, T, R, C, ET, F, n_x, n_out, st);
    case 2: return launch_kf<XT, WT, 2>(rb, cb, s, d, w, x, y, T, R, C, ET, F, n_x, n_out, st);
    case 4: return launch_kf<XT, WT, 4>(rb, cb, s, d, w, x, y, T, R, C, ET, F, n_x, n_out, st);
    default: return launch_kf<XT, WT, 8>(rb, cb, s, d, w, x, y, T, R, C, ET, F, n_x, n_out, st);
  }
}

}  // namespace

extern "C" const char* gta_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int gta_spmm_tiles(const void* tile_rb, const void* tile_cb,
                              const void* src_local, const void* dst_local,
                              const void* weight, int w_dtype, const void* x,
                              int x_dtype, void* y, int T, int R, int C, int ET,
                              int F, int64_t n_x, int64_t n_out, void* stream) {
  auto rb = static_cast<const int*>(tile_rb);
  auto cb = static_cast<const int*>(tile_cb);
  auto s = static_cast<const int16_t*>(src_local);
  auto d = static_cast<const int16_t*>(dst_local);
  auto yy = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
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
