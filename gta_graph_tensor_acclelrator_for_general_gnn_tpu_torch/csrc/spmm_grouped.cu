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
// Bound on the card: the row gathers, as K1.  Each edge reads one x row
// (F elements) and its index (and weight) words and adds F values into y.
// What makes this format costly here is padding: every chunk carries the
// deepest level of its G row blocks, so on the smoke's community graph
// (512^2/ET128/G16) 74% of the 1.07M sub-tiles hold no edge, and the 26%
// that do carry a median of 12 edges while the full ones carry most edges.
//
// Design: a work list of the sub-tiles that hold an edge
// (GroupedTiledGraph.live_sub, flat indices c*G + j, derived once per
// tiling on the device from each sub-tile's slot 0: its live slots are a
// prefix), one warp per listed sub-tile, so no warp is spent on an empty
// one.  The warp walks its sub-tile by K1's walk (gta::spmm_walk,
// tile_walk.cuh): 32 slots at a time up to the first 32 without an edge,
// pad slots never addressed, SPMM_PF rows in flight per lane group (bf16
// rows with F % 4 == 0 by half-warps, two edges a load), each receiver's
// run of slots summed in registers and added into y with float4 atomics
// (the sub-tiles of one stripe group share rows, so the run sums reorder
// from run to run: f32 rounding only).  A null weight pointer
// (tg.weight_all_unit, no runtime edge values) drops the weight stream: w
// = 1, and w*x rounds to x itself.  y is zeroed by the wrapper, so rows
// without edges read 0.
#include "tile_walk.cuh"

namespace {

constexpr int WARPS = 8;

template <typename XT, int VEC, int NV, int E>
__global__ void __launch_bounds__(WARPS * 32)
spmm_grouped_kernel(const int* __restrict__ live_sub, const int* __restrict__ chunk_grp,
                    const int* __restrict__ chunk_cb, const int16_t* __restrict__ src_local,
                    const int16_t* __restrict__ dst_local,
                    const float* __restrict__ weight, const XT* __restrict__ x,
                    float* __restrict__ y, int n_live, int G, int R, int C, int ET,
                    int F, int64_t n_x, int64_t n_out) {
  const int i = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (i >= n_live) return;
  const int64_t u = live_sub[i];
  const int64_t c = u / G;
  const int j = static_cast<int>(u % G);
  gta::spmm_walk<XT, float, VEC, NV, E>(
      src_local, dst_local, weight, u * ET, ET, R, C,
      (static_cast<int64_t>(chunk_grp[c]) * G + j) * R,
      static_cast<int64_t>(chunk_cb[c]) * C, x, y, F, n_x, n_out, threadIdx.x & 31);
}

template <typename XT>
struct Launch {
  const int *live, *grp, *cb;
  const int16_t *s, *d;
  const float* w;
  const void* x;
  float* y;
  int n_live, G, R, C, ET, F;
  int64_t n_x, n_out;
  cudaStream_t st;
  template <int VEC, int NV, int E>
  cudaError_t run() const {
    spmm_grouped_kernel<XT, VEC, NV, E>
        <<<(n_live + WARPS - 1) / WARPS, WARPS * 32, 0, st>>>(
            live, grp, cb, s, d, w, static_cast<const XT*>(x), y, n_live, G, R, C, ET, F,
            n_x, n_out);
    return cudaGetLastError();
  }
};

}  // namespace

// live_sub: int32[n_live] flat indices (chunk * G + sub-tile) of the
// sub-tiles that hold an edge (GroupedTiledGraph.live_sub)
extern "C" int gta_spmm_grouped(const void* live_sub, const void* chunk_grp,
                                const void* chunk_cb, const void* src_local,
                                const void* dst_local, const void* weight, const void* x,
                                int x_dtype, void* y, int n_live, int G, int R, int C,
                                int ET, int F, int64_t n_x, int64_t n_out, void* stream) {
  if (n_live == 0 || F == 0) return 0;
  auto live = static_cast<const int*>(live_sub);
  auto grp = static_cast<const int*>(chunk_grp);
  auto cb = static_cast<const int*>(chunk_cb);
  auto s = static_cast<const int16_t*>(src_local);
  auto d = static_cast<const int16_t*>(dst_local);
  auto w = static_cast<const float*>(weight);
  auto yy = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      x_dtype == gta::BF16
          ? gta::spmm_walk_config<__nv_bfloat16>(
                x, F, Launch<__nv_bfloat16>{live, grp, cb, s, d, w, x, yy, n_live, G, R, C,
                                            ET, F, n_x, n_out, st})
          : gta::spmm_walk_config<float>(
                x, F, Launch<float>{live, grp, cb, s, d, w, x, yy, n_live, G, R, C, ET, F,
                                    n_x, n_out, st});
  return static_cast<int>(err);
}
