// K6 gat_bwd_tiles_src: the GAT attention backward's [das | dh] over the
// TRANSPOSED tail tiling, whose rows are the original senders s and whose
// columns are the original receivers d:
//   das[s, h]        += dz(s -> d, h)
//   dh[s, hD + j]    += alpha(s -> d, h) * gbar[d, hD + j]
// (gat_bwd.cuh has the chain).  Output [n, H + HD] float32.
//
// Replaces the TPU kernels ops/gat.py:_gat_bwd_dsrc_kernel_tt (transposed
// dataflow, head-interleaved feature panels) and its wide twin
// _gat_bwd_dsrc_kernel of the JAX package: one kernel here, in the natural
// head-major feature order.  Rounding points are the TPU transposed
// kernel's: inputs in (or rounded to) the compute dtype, the chain in
// float32, and dz and alpha * gbar round to the compute dtype before the
// float32 sum.
//
// Bound on the card: memory and latency.  Each live edge gathers one row
// (gbar[d]) and the receiver's side terms per head, each run of slots the
// walked row (h[s], a_s[s]), and adds H + HD values into its run's sums;
// the tail tiles are TPU-shaped (512 slots, a few dozen edges each).
//
// Design: one warp per tile (a row block's 512 x (H + HD) float32 stripe,
// 270 KB at H + HD = 132, would not fit a block's 227 KB of shared memory),
// walking by gta::gat_bwd_prefix_walk (gat_bwd.cuh), K3's walk: it stops at
// the first 32 slots without an edge and keeps all of an edge's gathers in
// flight per lane group, at 32 warps an SM (bf16 rows with D a multiple of
// 4 by half-warps, two edges a load, 8-byte loads; float32 rows by the
// whole warp, 16-byte loads; else one feature a lane, by half-warps up to
// 48 features, as the 41 logits of a last layer).  It reads the side terms
// repacked per node and head (one 16-byte load a head; pack_side_kernel, a
// pass over the side panel first), loads the walked row's h[s] and a_s[s]
// once a run of slots, reduces te within the lanes of a group that hold
// the head, and runs the chain on every lane that holds the head (no
// shuffle of alpha); each run's sums go into the zeroed output with one
// global atomic per value (float4 where the dh columns are 16-byte
// aligned).
#include "gat_bwd.cuh"

namespace {

// K6's accumulate step for gat_bwd_prefix_walk: rows are the original
// senders; each row sums [das | dh]
struct SrcWalk {
  static constexpr bool SRC = true;

  __host__ __device__ static int width(int H, int HD) { return H + HD; }
};

constexpr int WARPS = gta::TILE_WARPS;

// blocks an SM the walk's registers are held to: four (64 registers a
// thread) where a lane holds at most three loads, the GAT-2l layers'
// walks: they wait on gathers, so warps in flight count most (at five
// blocks an SM they spilled and took more time on the card); two where a
// lane holds more (HD past 128 in bf16, one feature a lane past 48)
template <int NV>
constexpr int walk_blocks() {
  return NV <= 3 ? 4 : 2;
}

template <typename HT, typename MT, int VEC, int NV, int E>
__global__ void __launch_bounds__(WARPS * 32, walk_blocks<NV>())
gat_bwd_src_walk_kernel(const int* __restrict__ tile_rb, const int* __restrict__ tile_cb,
                        const int16_t* __restrict__ src_local,
                        const int16_t* __restrict__ dst_local, const MT* __restrict__ mult,
                        const HT* __restrict__ h, const HT* __restrict__ gbar,
                        const float* __restrict__ sidep, const float* __restrict__ msrc,
                        float* __restrict__ out, int T, int R, int C, int ET, int HD, int H,
                        int L, int64_t n, float slope) {
  const int t = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (t >= T) return;
  const int cb = tile_cb[t];
  if (cb < 0) return;  // dead tile
  gta::gat_bwd_prefix_walk<SrcWalk, HT, MT, VEC, NV, E>(
      src_local, dst_local, mult, static_cast<int64_t>(t) * ET, ET, R, C,
      static_cast<int64_t>(tile_rb[t]) * R, static_cast<int64_t>(cb) * C, h, gbar, sidep, msrc,
      out, HD, H, L, n, slope, threadIdx.x & 31);
}

// side [n, 4H] = [a_s | a_d | 1/den | s2] repacked per node and head:
// packed[node, hh] = [a_s, a_d, 1/den, s2] of head hh (the walk's layout)
__global__ void pack_side_kernel(const float* __restrict__ side, float4* __restrict__ packed,
                                 int64_t n, int H) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n * H) return;
  const float* s = side + (i / H) * 4 * H + i % H;
  packed[i] = make_float4(s[0], s[H], s[2 * H], s[3 * H]);
}

struct Args {
  const int *rb, *cb;
  const int16_t *s, *d;
  const void *mult, *h, *g;
  const float *side, *ms;  // side: packed per node and head
  float* out;
  int T, R, C, ET, HD, H;
  int64_t n;
  float slope;
  cudaStream_t st;
};

template <typename HT, typename MT, int VEC, int NV, int E>
cudaError_t run(const Args& a) {
  const int L = gta::lanes_per_head(a.HD / a.H, VEC, 32 / E);
  gat_bwd_src_walk_kernel<HT, MT, VEC, NV, E>
      <<<(a.T + WARPS - 1) / WARPS, WARPS * 32, 0, a.st>>>(
          a.rb, a.cb, a.s, a.d, static_cast<const MT*>(a.mult), static_cast<const HT*>(a.h),
          static_cast<const HT*>(a.g), a.side, a.ms, a.out, a.T, a.R, a.C, a.ET, a.HD, a.H, L,
          a.n, a.slope);
  return cudaGetLastError();
}

// the walk's configuration: one pass covers HD (te needs a head's every
// feature in the pass).  Vector loads where D % 4 == 0 and both rows are
// aligned for them (bf16 by half-warps, 64 features a load step; float32 by
// the whole warp, 128); else one feature a lane, by half-warps up to 48
// features, else by the whole warp
template <typename HT, typename MT>
cudaError_t launch(const Args& a) {
  constexpr uintptr_t AL = 4 * sizeof(HT);
  const bool vec = (a.HD / a.H) % 4 == 0 && reinterpret_cast<uintptr_t>(a.h) % AL == 0 &&
                   reinterpret_cast<uintptr_t>(a.g) % AL == 0;
  if (vec) {
    if constexpr (sizeof(HT) == 2)
      return a.HD <= 128 ? run<HT, MT, 4, 2, 2>(a) : run<HT, MT, 4, 4, 2>(a);
    else
      return a.HD <= 128 ? run<HT, MT, 4, 1, 1>(a) : run<HT, MT, 4, 2, 1>(a);
  }
  return a.HD <= 48 ? run<HT, MT, 1, 3, 2>(a) : run<HT, MT, 1, 8, 1>(a);
}

}  // namespace

// K6.  `scratch` [n, 4H] float32 (the wrapper's, 16-byte aligned) receives
// side repacked per node and head; with one head, side [n, 4] is that
// layout already and is read in place where it is 16-byte aligned.
extern "C" int gta_gat_bwd_tiles_src(const void* tile_rb, const void* tile_cb,
                                     const void* src_local, const void* dst_local,
                                     const void* mult, int m_dtype, const void* h,
                                     const void* gbar, int h_dtype, const void* side,
                                     const void* msrc, void* out, int T, int R, int C,
                                     int ET, int HD, int H, int64_t n, float slope,
                                     void* scratch, void* stream) {
  if (!gta::bwd_shape_ok(HD, H) || (reinterpret_cast<uintptr_t>(scratch) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const float* sidep = static_cast<const float*>(side);
  if (H > 1 || (reinterpret_cast<uintptr_t>(side) & 15) != 0) {
    const int64_t m = n * H;
    if (m > 0) {
      pack_side_kernel<<<static_cast<unsigned>((m + 255) / 256), 256, 0, st>>>(
          sidep, static_cast<float4*>(scratch), n, H);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    sidep = static_cast<const float*>(scratch);
  }
  const Args a{static_cast<const int*>(tile_rb), static_cast<const int*>(tile_cb),
               static_cast<const int16_t*>(src_local), static_cast<const int16_t*>(dst_local),
               mult, h, gbar, sidep, static_cast<const float*>(msrc),
               static_cast<float*>(out), T, R, C, ET, HD, H, n, slope, st};
  const bool hb = h_dtype == gta::BF16, mb = m_dtype == gta::BF16;
  cudaError_t err;
  if (hb && mb)
    err = launch<__nv_bfloat16, __nv_bfloat16>(a);
  else if (hb)
    err = launch<__nv_bfloat16, float>(a);
  else if (mb)
    err = launch<float, __nv_bfloat16>(a);
  else
    err = launch<float, float>(a);
  return static_cast<int>(err);
}
