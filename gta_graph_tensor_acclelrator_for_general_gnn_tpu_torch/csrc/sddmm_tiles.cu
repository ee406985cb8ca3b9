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
// included, is written once.  The tiles are TPU-shaped (a few slots per
// edge on the whole-graph tilings the `sddmm` kind builds), so the zero
// fill of the pad slots is a large share of the bytes.
//
// Design: one warp per tile (K1's layout), walking its slots by
// gta::sddmm_walk (tile_walk.cuh): live slots by ballot, pad slots never
// addressed, dead tiles (cb < 0) skipped whole.  Each slot's output is
// written by one lane, once: no atomics, and the result is the same on
// every run.  The wrapper zero-fills the output, so pad slots and dead
// tiles read exact zeros.
#include "tile_walk.cuh"

namespace {

constexpr int WARPS = 8;

template <typename XT>
__global__ void __launch_bounds__(WARPS * 32)
sddmm_tiles_kernel(const int* __restrict__ tile_rb, const int* __restrict__ tile_cb,
                   const int16_t* __restrict__ src_local,
                   const int16_t* __restrict__ dst_local, const XT* __restrict__ x_src,
                   const XT* __restrict__ x_dst, float* __restrict__ out, int T, int R,
                   int C, int ET, int F, int heads, int64_t n_src, int64_t n_dst,
                   int stage) {
  extern __shared__ float smem[];
  const int w = threadIdx.x >> 5;
  const int t = blockIdx.x * WARPS + w;
  if (t >= T) return;
  const int cb = tile_cb[t];
  if (cb < 0) return;  // dead tile
  gta::sddmm_walk<XT>(src_local, dst_local, static_cast<int64_t>(t) * ET, ET, R, C,
                      static_cast<int64_t>(tile_rb[t]) * R,
                      static_cast<int64_t>(cb) * C, x_src, x_dst, out,
                      static_cast<int64_t>(T) * ET, F, heads, n_src, n_dst,
                      /*round_prod=*/false, smem + w * stage, /*prefix=*/false,
                      threadIdx.x & 31);
}

template <typename XT>
cudaError_t launch(const int* rb, const int* cb, const int16_t* s, const int16_t* d,
                   const void* xs, const void* xd, float* out, int T, int R, int C,
                   int ET, int F, int heads, int64_t n_src, int64_t n_dst,
                   cudaStream_t st) {
  // per-warp staging of one slot's products, needed when a head is narrower
  // than a warp
  const int stage = F / heads < 32 ? F : 0;
  const size_t smem = static_cast<size_t>(WARPS) * stage * sizeof(float);
  auto k = sddmm_tiles_kernel<XT>;
  cudaError_t err = gta::set_smem(k, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (T + WARPS - 1) / WARPS;
  k<<<blocks, WARPS * 32, smem, st>>>(rb, cb, s, d, static_cast<const XT*>(xs),
                                      static_cast<const XT*>(xd), out, T, R, C, ET, F,
                                      heads, n_src, n_dst, stage);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gta_sddmm_tiles(const void* tile_rb, const void* tile_cb,
                               const void* src_local, const void* dst_local,
                               const void* x_src, const void* x_dst, int x_dtype,
                               void* out, int T, int R, int C, int ET, int F,
                               int heads, int64_t n_src, int64_t n_dst, void* stream) {
  auto rb = static_cast<const int*>(tile_rb);
  auto cb = static_cast<const int*>(tile_cb);
  auto s = static_cast<const int16_t*>(src_local);
  auto d = static_cast<const int16_t*>(dst_local);
  auto o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      x_dtype == gta::BF16
          ? launch<__nv_bfloat16>(rb, cb, s, d, x_src, x_dst, o, T, R, C, ET, F, heads,
                                  n_src, n_dst, st)
          : launch<float>(rb, cb, s, d, x_src, x_dst, o, T, R, C, ET, F, heads, n_src,
                          n_dst, st);
  return static_cast<int>(err);
}
