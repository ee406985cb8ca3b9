// K9 spmm_grouped: SpMM over a stripe-group chunked tiling (GroupedTiledGraph),
// y[(grp*G + j)*R + dst] += round_dt(w * x[cb*C + src]) summed in f32.
//
// Replaces the TPU kernel ops/spmm.py:_spmm_grouped_kernel of the JAX
// package.  On the TPU a chunk is one grid step: one x-panel DMA and one
// grid-step constant serve its G sub-tiles, and a batched one-hot matmul
// gathers and scatters all G*ET slots.  Hopper gathers rows directly and
// has no grid constant to amortise, so this kernel reads the same chunk
// arrays in place and indexes x by the sender, as K1 does per tile.
//
// Bound on the card: memory.  Each edge reads one x row (F elements) and
// its index (and weight) words and adds F values into y.  What makes this
// format costly here is padding: every chunk carries the deepest level of
// its G row blocks, so a whole-graph 512^2/ET128/G16 tiling of the smoke's
// community graph holds ~12 slots per edge, most sub-tiles empty.
//
// Design: one warp per (chunk, sub-tile), G*NC warps in blocks of 8: the
// warp walks its sub-tile's slots by gta::spmm_walk (tile_walk.cuh),
// which stops after the sub-tile's edges, so an empty sub-tile costs one read of its first 32 index
// pairs, a partly filled one stops after its last edge, and pad slots are
// never addressed; live edges add w*x into a register sum of the
// receiver's run of slots, which goes into y by f32 global atomics (the
// sub-tiles of one stripe group share rows, so the run sums reorder from
// run to run: f32 rounding only).  A null weight pointer (tg.weight_all_unit, no
// runtime edge values) drops the weight stream: w = 1, and w*x rounds to x
// itself.  y is zeroed by the wrapper, so rows without edges read 0.
#include "tile_walk.cuh"

namespace {

constexpr int WARPS = 8;

template <typename XT, int KF>
__global__ void __launch_bounds__(WARPS * 32)
spmm_grouped_kernel(const int* __restrict__ chunk_grp, const int* __restrict__ chunk_cb,
                    const int16_t* __restrict__ src_local,
                    const int16_t* __restrict__ dst_local,
                    const float* __restrict__ weight, const XT* __restrict__ x,
                    float* __restrict__ y, int64_t n_sub, int G, int R, int C, int ET,
                    int F, int64_t n_x, int64_t n_out) {
  const int64_t u = static_cast<int64_t>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (u >= n_sub) return;
  const int64_t c = u / G;
  const int j = static_cast<int>(u % G);
  const int64_t row0 = (static_cast<int64_t>(chunk_grp[c]) * G + j) * R;
  gta::spmm_walk<XT, float, KF>(src_local, dst_local, weight, u * ET, ET, R, C, row0,
                                static_cast<int64_t>(chunk_cb[c]) * C, x, y, F, n_x,
                                n_out, threadIdx.x & 31);
}

template <typename XT, int KF>
cudaError_t launch_kf(const int* grp, const int* cb, const int16_t* s, const int16_t* d,
                      const float* w, const void* x, float* y, int NC, int G, int R,
                      int C, int ET, int F, int64_t n_x, int64_t n_out, cudaStream_t st) {
  const int64_t n_sub = static_cast<int64_t>(NC) * G;
  const int64_t blocks = (n_sub + WARPS - 1) / WARPS;
  spmm_grouped_kernel<XT, KF><<<static_cast<unsigned>(blocks), WARPS * 32, 0, st>>>(
      grp, cb, s, d, w, static_cast<const XT*>(x), y, n_sub, G, R, C, ET, F, n_x,
      n_out);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t launch(const int* grp, const int* cb, const int16_t* s, const int16_t* d,
                   const float* w, const void* x, float* y, int NC, int G, int R,
                   int C, int ET, int F, int64_t n_x, int64_t n_out, cudaStream_t st) {
  switch (gta::spmm_lane_features(F)) {
    case 1: return launch_kf<XT, 1>(grp, cb, s, d, w, x, y, NC, G, R, C, ET, F, n_x, n_out, st);
    case 2: return launch_kf<XT, 2>(grp, cb, s, d, w, x, y, NC, G, R, C, ET, F, n_x, n_out, st);
    case 4: return launch_kf<XT, 4>(grp, cb, s, d, w, x, y, NC, G, R, C, ET, F, n_x, n_out, st);
    default: return launch_kf<XT, 8>(grp, cb, s, d, w, x, y, NC, G, R, C, ET, F, n_x, n_out, st);
  }
}

}  // namespace

extern "C" int gta_spmm_grouped(const void* chunk_grp, const void* chunk_cb,
                                const void* src_local, const void* dst_local,
                                const void* weight, const void* x, int x_dtype, void* y,
                                int NC, int G, int R, int C, int ET, int F, int64_t n_x,
                                int64_t n_out, void* stream) {
  auto grp = static_cast<const int*>(chunk_grp);
  auto cb = static_cast<const int*>(chunk_cb);
  auto s = static_cast<const int16_t*>(src_local);
  auto d = static_cast<const int16_t*>(dst_local);
  auto w = static_cast<const float*>(weight);
  auto yy = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      x_dtype == gta::BF16
          ? launch<__nv_bfloat16>(grp, cb, s, d, w, x, yy, NC, G, R, C, ET, F, n_x, n_out, st)
          : launch<float>(grp, cb, s, d, w, x, yy, NC, G, R, C, ET, F, n_x, n_out, st);
  return static_cast<int>(err);
}
