// K3 gat_tiles: edge-tile GAT softmax-aggregate under the global shift bound.
//
// Replaces the TPU kernels ops/gat.py:_gat_kernel_t (transposed dataflow)
// and its wide twin _gat_kernel of the JAX package: one kernel here, since
// the twins differ only in TPU lane layout.  For each edge s -> r of a tile:
//   hs  = h[s];  a_s = hs . w_asrc (derive mode) or a_src[s];  a_d = a_dst[r]
//   p   = mult * exp(min(leaky(a_s + a_d) - leaky(msrc + a_d), 60))
//   num[r, f] += p[f / D] * hs[f]   (head-major features)
//   den[r, h] += p[h]
// and the kernel emits raw [num | den] or, when normalizing, num / max(den,
// 1e-20) per head.  p*hs and p round to the input dtype before the f32 sum,
// as on the TPU.  The shift bound is global per head, so a row whose
// sources all sit ~85 below it collapses to zero attention: reproduced, not
// corrected, so this kernel and the dense-block kernel add exactly.
//
// Bound on the card: memory and latency.  Each edge gathers one h row (HD
// elements), derives a_s with O(HD*H) flops and adds HD + H values; the
// tail tiles are TPU-shaped (512 slots, ~10% full) and, after the
// hubs+labels reorder, a few row blocks own most of them.
//
// Design: one warp per tile, so the work spreads evenly over the card
// whatever the row-block skew (the [rows, HD+H] accumulator of a whole
// row block, 270 KB at R = 512, HD+H = 132, would not fit a block's 227 KB
// anyway).  The warp walks the tile by gta::gat_walk (tile_walk.cuh): the
// live slots of each 32-slot group by ballot (pad slots and dead tiles add
// nothing and are never addressed); per live edge each lane gathers HD/32
// features, a_s is a warp reduction per head (derive mode) with w_asrc
// staged in shared memory, lane h computes head h's p, and the lanes fetch
// their head's p by shuffle.  Each run of slots with one receiver is
// summed in registers and added into a zeroed f32 [num | den] buffer with
// global atomics, whose order varies from run to run (f32 rounding only).
// When normalizing, a second launch of this library divides num by
// max(den, 1e-20) per head; rows without edges read 0 either way.
#include "tile_walk.cuh"

namespace {

using gta::to_f;

constexpr int WARPS = 8;

template <typename HT, typename MT>
__global__ void __launch_bounds__(WARPS * 32)
gat_tiles_kernel(const int* __restrict__ tile_rb, const int* __restrict__ tile_cb,
                 const int16_t* __restrict__ src_local,
                 const int16_t* __restrict__ dst_local, const MT* __restrict__ mult,
                 const HT* __restrict__ h, const HT* __restrict__ w_asrc,
                 const HT* __restrict__ a_src, const float* __restrict__ a_dst,
                 const float* __restrict__ msrc, float* __restrict__ acc, int T,
                 int R, int C, int ET, int HD, int H, int64_t n_h, int64_t n_a,
                 int64_t n_out, float slope) {
  extern __shared__ float smem[];
  float* w_s = smem;            // [HD, H] (derive mode)
  float* m_s = w_s + HD * H;    // [H]
  const bool derive = w_asrc != nullptr;
  if (derive)
    for (int i = threadIdx.x; i < HD * H; i += blockDim.x) w_s[i] = to_f(w_asrc[i]);
  for (int i = threadIdx.x; i < H; i += blockDim.x) m_s[i] = msrc[i];
  __syncthreads();

  const int t = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (t >= T) return;
  const int cb = tile_cb[t];
  if (cb < 0) return;  // dead tile
  gta::gat_walk<HT, MT>(src_local, dst_local, mult, static_cast<int64_t>(t) * ET, ET,
                        R, C, static_cast<int64_t>(tile_rb[t]) * R,
                        static_cast<int64_t>(cb) * C, h, w_s, derive, a_src, a_dst,
                        m_s, acc, HD, H, n_h, n_a, n_out, slope, /*prefix=*/false,
                        threadIdx.x & 31);
}

// out[r, f] = num[r, f] / max(den[r, f / D], 1e-20): the TPU kernel's
// normalize epilogue
__global__ void gat_normalize_kernel(const float* __restrict__ acc,
                                     float* __restrict__ out, int64_t n_out, int HD,
                                     int H) {
  const int W = HD + H, D = HD / H;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_out * HD) return;
  const int64_t r = i / HD;
  const int f = static_cast<int>(i % HD);
  const float* arow = acc + r * W;
  out[i] = arow[f] / fmaxf(arow[HD + f / D], 1e-20f);
}

template <typename HT, typename MT>
cudaError_t launch(const int* rb, const int* cb, const int16_t* s, const int16_t* d,
                   const void* mult, const void* h, const void* w, const void* as,
                   const float* ad, const float* ms, float* acc, float* out, int T,
                   int R, int C, int ET, int HD, int H, int64_t n_h, int64_t n_a,
                   int64_t n_out, float slope, cudaStream_t st) {
  const size_t smem = (static_cast<size_t>(HD) * H + H) * sizeof(float);
  auto k = gat_tiles_kernel<HT, MT>;
  cudaError_t err = gta::set_smem(k, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (T + WARPS - 1) / WARPS;
  k<<<blocks, WARPS * 32, smem, st>>>(
      rb, cb, s, d, static_cast<const MT*>(mult), static_cast<const HT*>(h),
      static_cast<const HT*>(w), static_cast<const HT*>(as), ad, ms, acc, T, R, C,
      ET, HD, H, n_h, n_a, n_out, slope);
  err = cudaGetLastError();
  if (err != cudaSuccess || out == nullptr) return err;
  const int64_t n = n_out * HD;
  if (n == 0) return cudaSuccess;
  const int threads = 256;
  gat_normalize_kernel<<<static_cast<unsigned>((n + threads - 1) / threads), threads, 0,
                         st>>>(acc, out, n_out, HD, H);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gta_gat_tiles(const void* tile_rb, const void* tile_cb,
                             const void* src_local, const void* dst_local,
                             const void* mult, int m_dtype, const void* h,
                             int h_dtype, const void* w_asrc, const void* a_src,
                             const void* a_dst, const void* msrc, void* acc, void* out,
                             int T, int R, int C, int ET, int HD, int H, int64_t n_h,
                             int64_t n_a, int64_t n_out, float slope, void* stream) {
  auto rb = static_cast<const int*>(tile_rb);
  auto cb = static_cast<const int*>(tile_cb);
  auto s = static_cast<const int16_t*>(src_local);
  auto d = static_cast<const int16_t*>(dst_local);
  auto ad = static_cast<const float*>(a_dst);
  auto ms = static_cast<const float*>(msrc);
  auto a = static_cast<float*>(acc);
  auto o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const bool hb = h_dtype == gta::BF16, mb = m_dtype == gta::BF16;
  cudaError_t err;
  if (hb && mb)
    err = launch<__nv_bfloat16, __nv_bfloat16>(rb, cb, s, d, mult, h, w_asrc, a_src, ad, ms, a, o, T, R, C, ET, HD, H, n_h, n_a, n_out, slope, st);
  else if (hb)
    err = launch<__nv_bfloat16, float>(rb, cb, s, d, mult, h, w_asrc, a_src, ad, ms, a, o, T, R, C, ET, HD, H, n_h, n_a, n_out, slope, st);
  else if (mb)
    err = launch<float, __nv_bfloat16>(rb, cb, s, d, mult, h, w_asrc, a_src, ad, ms, a, o, T, R, C, ET, HD, H, n_h, n_a, n_out, slope, st);
  else
    err = launch<float, float>(rb, cb, s, d, mult, h, w_asrc, a_src, ad, ms, a, o, T, R, C, ET, HD, H, n_h, n_a, n_out, slope, st);
  return static_cast<int>(err);
}
