// K10 gat_grouped: raw GAT partials [num | den] over a stripe-group chunked
// tiling (GroupedTiledGraph), derive mode, under the global shift bound.
//
// Replaces the TPU kernel ops/gat.py:_gat_grouped_kernel_t of the JAX
// package.  For each edge src -> r of a chunk's sub-tile j (src = cb*C +
// src_local, r = (grp*G + j)*R + dst_local):
//   a_s = h[src] . w_asrc  (h's dtype operands, f32 sum);  a_d = a_dst[r]
//   p   = w * exp(min(leaky(a_s + a_d) - leaky(msrc + a_d), 60))
//   num[r, f] += round_dt(p[f / D] * h[src, f]);  den[r, h] += round_dt(p[h])
// with w the slot weight (the merged copy count of a multi-edge) unless
// the tiling's real edges all weigh 1.  The output is head-major: the TPU
// kernel's head-interleaved feature layout (gat.py:450-463) exists for its
// sublane repeat and is not carried over.  a_d is read in f32, as the JAX
// kernel computes it on the CPU; the TPU body multiplies the f32 a_dst panel
// by a bf16 one-hot at DEFAULT precision (gat.py:386-388), which rounds a_d
// to bf16 on the chip.
//
// Bound on the card: memory and latency, as K3.  Each live edge gathers one
// h row (HD elements), derives a_s with HD*H multiply-adds and adds HD + H
// values; the format pads each chunk to the deepest level of its G row
// blocks, so most sub-tiles hold few or no edges.
//
// Design: one edge at a time, a_s derived per edge (gta::gat_walk,
// tile_walk.cuh), with one warp per (chunk, sub-tile), G*NC warps in blocks
// of 8, each block staging w_asrc and msrc in shared memory once.  The walk
// stops at the first 32 slots without an edge: an empty sub-tile costs one
// read of its first 32 index pairs and pad slots are never addressed.  [num | den] adds into a zeroed f32 buffer, one
// global atomic per run of slots with one receiver (run-to-run f32
// rounding only); rows without edges read 0.
#include "tile_walk.cuh"

namespace {

using gta::to_f;

constexpr int WARPS = 8;

template <typename HT>
__global__ void __launch_bounds__(WARPS * 32)
gat_grouped_kernel(const int* __restrict__ chunk_grp, const int* __restrict__ chunk_cb,
                   const int16_t* __restrict__ src_local,
                   const int16_t* __restrict__ dst_local,
                   const float* __restrict__ weight, const HT* __restrict__ h,
                   const HT* __restrict__ w_asrc, const float* __restrict__ a_dst,
                   const float* __restrict__ msrc, float* __restrict__ acc,
                   int64_t n_sub, int G, int R, int C, int ET, int HD, int H,
                   int64_t n_h, int64_t n_a, int64_t n_out, float slope) {
  extern __shared__ float smem[];
  float* w_s = smem;            // [HD, H]
  float* m_s = w_s + HD * H;    // [H]
  for (int i = threadIdx.x; i < HD * H; i += blockDim.x) w_s[i] = to_f(w_asrc[i]);
  for (int i = threadIdx.x; i < H; i += blockDim.x) m_s[i] = msrc[i];
  __syncthreads();

  const int64_t u = static_cast<int64_t>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (u >= n_sub) return;
  const int64_t c = u / G;
  const int j = static_cast<int>(u % G);
  const int64_t row0 = (static_cast<int64_t>(chunk_grp[c]) * G + j) * R;
  gta::gat_walk<HT>(src_local, dst_local, weight, u * ET, ET, R, C, row0,
                    static_cast<int64_t>(chunk_cb[c]) * C, h, w_s, a_dst, m_s, acc, HD,
                    H, n_h, n_a, n_out, slope, threadIdx.x & 31);
}

template <typename HT>
cudaError_t launch(const int* grp, const int* cb, const int16_t* s, const int16_t* d,
                   const float* w, const void* h, const void* w_asrc, const float* ad,
                   const float* ms, float* acc, int NC, int G, int R, int C, int ET,
                   int HD, int H, int64_t n_h, int64_t n_a, int64_t n_out, float slope,
                   cudaStream_t st) {
  const size_t smem = (static_cast<size_t>(HD) * H + H) * sizeof(float);
  auto k = gat_grouped_kernel<HT>;
  cudaError_t err = gta::set_smem(k, smem);
  if (err != cudaSuccess) return err;
  const int64_t n_sub = static_cast<int64_t>(NC) * G;
  const int64_t blocks = (n_sub + WARPS - 1) / WARPS;
  k<<<static_cast<unsigned>(blocks), WARPS * 32, smem, st>>>(
      grp, cb, s, d, w, static_cast<const HT*>(h), static_cast<const HT*>(w_asrc), ad,
      ms, acc, n_sub, G, R, C, ET, HD, H, n_h, n_a, n_out, slope);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gta_gat_grouped(const void* chunk_grp, const void* chunk_cb,
                               const void* src_local, const void* dst_local,
                               const void* weight, const void* h, int h_dtype,
                               const void* w_asrc, const void* a_dst, const void* msrc,
                               void* acc, int NC, int G, int R, int C, int ET, int HD,
                               int H, int64_t n_h, int64_t n_a, int64_t n_out,
                               float slope, void* stream) {
  auto grp = static_cast<const int*>(chunk_grp);
  auto cb = static_cast<const int*>(chunk_cb);
  auto s = static_cast<const int16_t*>(src_local);
  auto d = static_cast<const int16_t*>(dst_local);
  auto w = static_cast<const float*>(weight);
  auto ad = static_cast<const float*>(a_dst);
  auto ms = static_cast<const float*>(msrc);
  auto a = static_cast<float*>(acc);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      h_dtype == gta::BF16
          ? launch<__nv_bfloat16>(grp, cb, s, d, w, h, w_asrc, ad, ms, a, NC, G, R, C,
                                  ET, HD, H, n_h, n_a, n_out, slope, st)
          : launch<float>(grp, cb, s, d, w, h, w_asrc, ad, ms, a, NC, G, R, C, ET, HD,
                          H, n_h, n_a, n_out, slope, st);
  return static_cast<int>(err);
}
