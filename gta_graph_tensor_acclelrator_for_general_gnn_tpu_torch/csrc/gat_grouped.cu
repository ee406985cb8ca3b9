// K10 gat_grouped: raw GAT partials [num | den] over a stripe-group chunked
// tiling (GroupedTiledGraph), under the global shift bound.
//
// Replaces the TPU kernel ops/gat.py:_gat_grouped_kernel_t of the JAX
// package.  For each edge src -> r of a chunk's sub-tile j (src = cb*C +
// src_local, r = (grp*G + j)*R + dst_local):
//   a_s = a_s[src] (per node);  a_d = a_dst[r]
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
// a_s comes in one of two forms, as K3's: the float32 per-node array the
// grouped hybrid path hands it (the one its msrc and the dense partial K4
// read), or derive mode, w_asrc [HD, H] in h's dtype, from which a first
// launch forms a_s = h . w_asrc per node into the wrapper's float32 scratch
// (gat_as.cuh, K3's pass).  The TPU body derives a_s per edge, having no
// per-node array; here that would cost HD H multiply-adds and H warp sums
// an edge.
//
// Bound on the card: memory and latency, as K3.  Each live edge gathers one
// h row (HD elements) and H a_s values and adds HD + H values; the format
// pads each chunk to the deepest level of its G row blocks, so most
// sub-tiles hold few or no edges.
//
// Design: K9's work list (GroupedTiledGraph.live_sub, the flat indices
// c*G + j of the sub-tiles that hold an edge), one warp per listed
// sub-tile, so no warp is spent on an empty one; the warp walks its
// sub-tile by K3's walk (gta::gat_prefix_walk under gta::ShiftBound,
// tile_walk.cuh): 32 slots at a time up to the first 32 without an edge,
// SPMM_PF rows in flight per lane group, each lane forming p for the heads
// of its own features, each receiver's run of slots summed in registers
// and added into a zeroed f32 [num | den] buffer with one global atomic
// per value (the sub-tiles of one stripe group share rows, so run sums
// reorder from run to run: f32 rounding only); rows without edges read 0.
#include "gat_as.cuh"
#include "tile_walk.cuh"

namespace {

constexpr int WARPS = 8;

template <typename HT, int VEC, int NV, int E>
__global__ void __launch_bounds__(WARPS * 32)
gat_grouped_kernel(const int* __restrict__ live_sub, const int* __restrict__ chunk_grp,
                   const int* __restrict__ chunk_cb, const int16_t* __restrict__ src_local,
                   const int16_t* __restrict__ dst_local,
                   const float* __restrict__ weight, const HT* __restrict__ h,
                   const float* __restrict__ a_src, const float* __restrict__ a_dst,
                   const float* __restrict__ msrc, float* __restrict__ acc, int n_live,
                   int G, int R, int C, int ET, int HD, int H, int64_t n_h, int64_t n_a,
                   int64_t n_out, float slope) {
  const int i = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (i >= n_live) return;
  const int64_t u = live_sub[i];
  const int64_t c = u / G;
  const int j = static_cast<int>(u % G);
  gta::gat_prefix_walk<HT, float, gta::ShiftBound, VEC, NV, E>(
      src_local, dst_local, weight, u * ET, ET, R, C,
      (static_cast<int64_t>(chunk_grp[c]) * G + j) * R, static_cast<int64_t>(chunk_cb[c]) * C,
      h, a_src, a_dst, msrc, acc, HD, H, n_h, n_a, n_out, slope, threadIdx.x & 31);
}

struct Args {
  const int *live, *grp, *cb;
  const int16_t *s, *d;
  const float* w;
  const void* h;
  const float *a_s, *ad, *ms;
  float* acc;
  int n_live, G, R, C, ET, HD, H;
  int64_t n_h, n_a, n_out;
  float slope;
  cudaStream_t st;
};

template <typename HT>
struct Launch {
  const Args& a;
  template <int VEC, int NV, int E>
  cudaError_t run() const {
    gat_grouped_kernel<HT, VEC, NV, E><<<(a.n_live + WARPS - 1) / WARPS, WARPS * 32, 0, a.st>>>(
        a.live, a.grp, a.cb, a.s, a.d, a.w, static_cast<const HT*>(a.h), a.a_s, a.ad, a.ms,
        a.acc, a.n_live, a.G, a.R, a.C, a.ET, a.HD, a.H, a.n_h, a.n_a, a.n_out, a.slope);
    return cudaGetLastError();
  }
};

template <typename HT>
cudaError_t launch(const Args& a, const void* w_asrc, float* a_scr) {
  Args b = a;
  if (w_asrc != nullptr) {  // derive mode: a_s per node first, into the scratch
    const cudaError_t err = gta::launch_a_s<HT>(a.h, w_asrc, a_scr, a.n_h, a.HD, a.H, a.st);
    if (err != cudaSuccess) return err;
    b.a_s = a_scr;
  }
  if (b.n_live == 0) return cudaSuccess;
  return gta::gat_walk_config<HT>(b.h, b.HD, b.H, Launch<HT>{b});
}

}  // namespace

// K10.  live_sub: int32[n_live] flat indices (chunk * G + sub-tile) of the
// sub-tiles that hold an edge (GroupedTiledGraph.live_sub).  Exactly one
// of: w_asrc [HD, H] in h's dtype (derive mode; a_s_scratch [n_h, H]
// float32 receives a_s), or a_src [n_h, H] float32.  weight null: every
// real slot weighs 1.
extern "C" int gta_gat_grouped(const void* live_sub, const void* chunk_grp,
                               const void* chunk_cb, const void* src_local,
                               const void* dst_local, const void* weight, const void* h,
                               int h_dtype, const void* w_asrc, const void* a_src,
                               void* a_s_scratch, const void* a_dst, const void* msrc,
                               void* acc, int n_live, int G, int R, int C, int ET, int HD,
                               int H, int64_t n_h, int64_t n_a, int64_t n_out, float slope,
                               void* stream) {
  if ((w_asrc == nullptr) == (a_src == nullptr) ||
      (w_asrc != nullptr && a_s_scratch == nullptr) || H <= 0 || HD % H != 0 ||
      HD > 32 * gta::GAT_MAXF)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const int*>(live_sub), static_cast<const int*>(chunk_grp),
               static_cast<const int*>(chunk_cb), static_cast<const int16_t*>(src_local),
               static_cast<const int16_t*>(dst_local), static_cast<const float*>(weight), h,
               static_cast<const float*>(a_src), static_cast<const float*>(a_dst),
               static_cast<const float*>(msrc), static_cast<float*>(acc), n_live, G, R, C, ET,
               HD, H, n_h, n_a, n_out, slope, static_cast<cudaStream_t>(stream)};
  auto scr = static_cast<float*>(a_s_scratch);
  const cudaError_t err = h_dtype == gta::BF16
                              ? launch<__nv_bfloat16>(a, w_asrc, scr)
                              : launch<float>(a, w_asrc, scr);
  return static_cast<int>(err);
}
