// K3 gat_tiles: edge-tile GAT softmax-aggregate under the global shift bound.
//
// Replaces the TPU kernels ops/gat.py:_gat_kernel_t (transposed dataflow)
// and its wide twin _gat_kernel of the JAX package: one kernel here, since
// the twins differ only in TPU lane layout.  For each edge s -> r of a tile:
//   hs  = h[s];  a_s = a_s[s] (per node);  a_d = a_dst[r]
//   p   = mult * exp(min(leaky(a_s + a_d) - leaky(msrc + a_d), 60))
//   num[r, f] += p[f / D] * hs[f]   (head-major features)
//   den[r, h] += p[h]
// and the kernel emits raw [num | den] or, when normalizing, num / max(den,
// 1e-20) per head.  p*hs and p round to the input dtype before the f32 sum,
// as on the TPU.  The shift bound is global per head, so a row whose
// sources all sit ~85 below it collapses to zero attention: reproduced, not
// corrected, so this kernel and the dense-block kernel add exactly.
//
// a_s comes in one of two forms: float32 per node (the hybrid path's array,
// which msrc, K4 and the backward read too; the values mode's a_src, in h's
// dtype, is widened to float32 by the wrapper, exactly); or derive mode,
// w_asrc [HD, H] in h's dtype, from which a first launch forms a_s = h .
// w_asrc per node into the wrapper's float32 scratch (gat_as.cuh: one
// warp a node, bf16 x bf16 products and float32 sums, the arithmetic the
// TPU kernel does in its body, which the old per-edge derivation repeated
// for every edge).
//
// Bound on the card: memory and latency.  Each edge gathers one h row (HD
// elements) and H a_s values and adds HD + H values; the tail tiles are
// TPU-shaped (512 slots, ~10% full) and, after the hubs+labels reorder, a
// few row blocks own most of them.
//
// Design: one warp per tile, so the work spreads evenly over the card
// whatever the row-block skew, walking by gta::gat_prefix_walk
// (tile_walk.cuh), K1's walk: it stops at the first 32 slots without an
// edge (the builders put a tile's edges in a prefix of its slots, sorted by
// receiver), keeps SPMM_PF row gathers in flight per lane group (bf16 rows
// with HD and D multiples of 4 by half-warps, two edges a load, 8-byte
// loads; float32 rows by the whole warp, 16-byte loads; else one feature a
// lane, by half-warps up to 48 features, as the 41 logits of a last layer;
// where HD + H is not a multiple of 4, [num | den] rows are not 16-byte
// aligned and a run flushes by float atomics instead of float4 ones),
// and each lane forms p for the heads of its own features from the
// per-node a_s, so an edge costs no warp reduction and no shuffle per
// feature.  Each run of slots with one receiver is summed in registers and
// added into a zeroed f32 [num | den] buffer with global atomics, whose
// order varies from run to run (f32 rounding only).  When normalizing, a
// second launch of this library divides num by max(den, 1e-20) per head;
// rows without edges read 0 either way.
#include "gat_as.cuh"
#include "tile_walk.cuh"

namespace {

constexpr int WARPS = 8;

template <typename HT, typename MT, int VEC, int NV, int E>
__global__ void __launch_bounds__(WARPS * 32)
gat_tiles_kernel(const int* __restrict__ tile_rb, const int* __restrict__ tile_cb,
                 const int16_t* __restrict__ src_local,
                 const int16_t* __restrict__ dst_local, const MT* __restrict__ mult,
                 const HT* __restrict__ h, const float* __restrict__ a_src,
                 const float* __restrict__ a_dst, const float* __restrict__ msrc,
                 float* __restrict__ acc, int T, int R, int C, int ET, int HD, int H,
                 int64_t n_h, int64_t n_a, int64_t n_out, float slope) {
  const int t = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (t >= T) return;
  const int cb = tile_cb[t];
  if (cb < 0) return;  // dead tile
  gta::gat_prefix_walk<HT, MT, gta::ShiftBound, VEC, NV, E>(
      src_local, dst_local, mult, static_cast<int64_t>(t) * ET, ET, R, C,
      static_cast<int64_t>(tile_rb[t]) * R, static_cast<int64_t>(cb) * C, h, a_src, a_dst,
      msrc, acc, HD, H, n_h, n_a, n_out, slope, threadIdx.x & 31);
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

struct Args {
  const int *rb, *cb;
  const int16_t *s, *d;
  const void *mult, *h;
  const float *a_s, *ad, *ms;
  float *acc, *out;
  int T, R, C, ET, HD, H;
  int64_t n_h, n_a, n_out;
  float slope;
  cudaStream_t st;
};

template <typename HT, typename MT>
struct Launch {
  const Args& a;
  template <int VEC, int NV, int E>
  cudaError_t run() const {
    gat_tiles_kernel<HT, MT, VEC, NV, E>
        <<<(a.T + WARPS - 1) / WARPS, WARPS * 32, 0, a.st>>>(
            a.rb, a.cb, a.s, a.d, static_cast<const MT*>(a.mult),
            static_cast<const HT*>(a.h), a.a_s, a.ad, a.ms, a.acc,
            a.T, a.R, a.C, a.ET, a.HD, a.H, a.n_h, a.n_a, a.n_out, a.slope);
    return cudaGetLastError();
  }
};

template <typename HT, typename MT>
cudaError_t launch(const Args& a) {
  return gta::gat_walk_config<HT>(a.h, a.HD, a.H, Launch<HT, MT>{a});
}

template <typename HT, typename MT>
cudaError_t launch_h(const Args& a, const void* w, float* a_scr) {
  if (w != nullptr) {  // derive mode: a_s per node first, into the scratch
    const cudaError_t err = gta::launch_a_s<HT>(a.h, w, a_scr, a.n_h, a.HD, a.H, a.st);
    if (err != cudaSuccess) return err;
    Args b = a;
    b.a_s = a_scr;
    return launch<HT, MT>(b);
  }
  return launch<HT, MT>(a);
}

}  // namespace

// K3.  Exactly one of: w_asrc [HD, H] in h's dtype (derive mode; a_s_scratch
// [n_h, H] float32 receives a_s), or a_src [n_h, H] float32.  out null: raw
// [num | den] in acc only.
extern "C" int gta_gat_tiles(const void* tile_rb, const void* tile_cb,
                             const void* src_local, const void* dst_local,
                             const void* mult, int m_dtype, const void* h,
                             int h_dtype, const void* w_asrc, const void* a_src,
                             void* a_s_scratch, const void* a_dst,
                             const void* msrc, void* acc, void* out, int T, int R, int C,
                             int ET, int HD, int H, int64_t n_h, int64_t n_a,
                             int64_t n_out, float slope, void* stream) {
  if ((w_asrc == nullptr) == (a_src == nullptr) ||
      (w_asrc != nullptr && a_s_scratch == nullptr) || H <= 0 ||
      HD % H != 0 || HD > 32 * gta::GAT_MAXF)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const int*>(tile_rb), static_cast<const int*>(tile_cb),
               static_cast<const int16_t*>(src_local), static_cast<const int16_t*>(dst_local),
               mult, h, static_cast<const float*>(a_src), static_cast<const float*>(a_dst),
               static_cast<const float*>(msrc), static_cast<float*>(acc),
               static_cast<float*>(out), T, R, C, ET, HD, H, n_h, n_a, n_out, slope,
               static_cast<cudaStream_t>(stream)};
  const bool hb = h_dtype == gta::BF16, mb = m_dtype == gta::BF16;
  auto scr = static_cast<float*>(a_s_scratch);
  cudaError_t err;
  if (hb && mb)
    err = launch_h<__nv_bfloat16, __nv_bfloat16>(a, w_asrc, scr);
  else if (hb)
    err = launch_h<__nv_bfloat16, float>(a, w_asrc, scr);
  else if (mb)
    err = launch_h<float, __nv_bfloat16>(a, w_asrc, scr);
  else
    err = launch_h<float, float>(a, w_asrc, scr);
  if (err != cudaSuccess || out == nullptr) return static_cast<int>(err);
  const int64_t n = n_out * HD;
  if (n == 0) return 0;
  const int threads = 256;
  gat_normalize_kernel<<<static_cast<unsigned>((n + threads - 1) / threads), threads, 0,
                         a.st>>>(a.acc, a.out, n_out, HD, H);
  return static_cast<int>(cudaGetLastError());
}
