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
// per live slot, `heads` floats written per slot, the zero fill of the
// format's padding (every chunk carries the deepest level of its G row
// blocks) included.
//
// Design: one warp per (chunk, sub-tile), G*NC warps in blocks of 8 (K9's
// layout), walking its slots by gta::sddmm_walk (tile_walk.cuh), which
// stops at the sub-tile's edge prefix: an empty sub-tile costs one read of
// its first 32 index pairs, and pad slots are never addressed.  Each slot's output is written once by one
// lane; the wrapper zero-fills the output, so pad slots read exact zeros.
#include "tile_walk.cuh"

namespace {

constexpr int WARPS = 8;

template <typename XT>
__global__ void __launch_bounds__(WARPS * 32)
sddmm_grouped_kernel(const int* __restrict__ chunk_grp, const int* __restrict__ chunk_cb,
                     const int16_t* __restrict__ src_local,
                     const int16_t* __restrict__ dst_local,
                     const XT* __restrict__ x_src, const XT* __restrict__ x_dst,
                     float* __restrict__ out, int64_t n_sub, int G, int R, int C, int ET,
                     int F, int heads, int64_t n_src, int64_t n_dst, int stage) {
  extern __shared__ float smem[];
  const int w = threadIdx.x >> 5;
  const int64_t u = static_cast<int64_t>(blockIdx.x) * WARPS + w;
  if (u >= n_sub) return;
  const int64_t c = u / G;
  const int j = static_cast<int>(u % G);
  const int cb = chunk_cb[c];
  if (cb < 0) return;
  const int64_t row0 = (static_cast<int64_t>(chunk_grp[c]) * G + j) * R;
  gta::sddmm_walk<XT>(src_local, dst_local, u * ET, ET, R, C, row0,
                      static_cast<int64_t>(cb) * C, x_src, x_dst, out, n_sub * ET, F,
                      heads, n_src, n_dst, /*round_prod=*/true, smem + w * stage,
                      threadIdx.x & 31);
}

template <typename XT>
cudaError_t launch(const int* grp, const int* cb, const int16_t* s, const int16_t* d,
                   const void* xs, const void* xd, float* out, int NC, int G, int R,
                   int C, int ET, int F, int heads, int64_t n_src, int64_t n_dst,
                   cudaStream_t st) {
  const int stage = F / heads < 32 ? F : 0;
  const size_t smem = static_cast<size_t>(WARPS) * stage * sizeof(float);
  auto k = sddmm_grouped_kernel<XT>;
  cudaError_t err = gta::set_smem(k, smem);
  if (err != cudaSuccess) return err;
  const int64_t n_sub = static_cast<int64_t>(NC) * G;
  const int64_t blocks = (n_sub + WARPS - 1) / WARPS;
  k<<<static_cast<unsigned>(blocks), WARPS * 32, smem, st>>>(
      grp, cb, s, d, static_cast<const XT*>(xs), static_cast<const XT*>(xd), out, n_sub,
      G, R, C, ET, F, heads, n_src, n_dst, stage);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gta_sddmm_grouped(const void* chunk_grp, const void* chunk_cb,
                                 const void* src_local, const void* dst_local,
                                 const void* x_src, const void* x_dst, int x_dtype,
                                 void* out, int NC, int G, int R, int C, int ET, int F,
                                 int heads, int64_t n_src, int64_t n_dst, void* stream) {
  auto grp = static_cast<const int*>(chunk_grp);
  auto cb = static_cast<const int*>(chunk_cb);
  auto s = static_cast<const int16_t*>(src_local);
  auto d = static_cast<const int16_t*>(dst_local);
  auto o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      x_dtype == gta::BF16
          ? launch<__nv_bfloat16>(grp, cb, s, d, x_src, x_dst, o, NC, G, R, C, ET, F,
                                  heads, n_src, n_dst, st)
          : launch<float>(grp, cb, s, d, x_src, x_dst, o, NC, G, R, C, ET, F, heads,
                          n_src, n_dst, st);
  return static_cast<int>(err);
}
