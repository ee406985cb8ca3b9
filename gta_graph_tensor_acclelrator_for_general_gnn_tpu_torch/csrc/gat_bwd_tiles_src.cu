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
// Bound on the card: memory and atomics.  Each live edge gathers two rows
// and adds H + HD values, K3's own atomic pattern.
//
// Design: the tail walk of gat_bwd.cuh (a warp per tile: a row block's
// 512 x (H + HD) float32 stripe, 270 KB at H + HD = 132, would not fit a
// block's 227 KB of shared memory); lane h adds head h's dz, and every lane
// fetches its features' head's alpha by shuffle and adds alpha * gbar, all
// with global atomics into the zeroed output.
#include "gat_bwd.cuh"

namespace {

struct SrcAcc {
  static constexpr bool SRC = true;

  template <typename HT>
  __device__ static void add(float* out, int64_t src, int64_t, float alpha, float dz,
                             const float* gv, const int* hk, int lane, int H, int HD) {
    float* orow = out + src * (H + HD);
    if (lane < H) atomicAdd(orow + lane, gta::round_to<HT>(dz));
#pragma unroll
    for (int k = 0; k < gta::BWD_MAXF; ++k) {
      const float a = __shfl_sync(0xffffffffu, alpha, hk[k] >= 0 ? hk[k] : 0);
      if (hk[k] >= 0) atomicAdd(orow + H + lane + 32 * k, gta::round_to<HT>(a * gv[k]));
    }
  }
};

}  // namespace

extern "C" int gta_gat_bwd_tiles_src(const void* tile_rb, const void* tile_cb,
                                     const void* src_local, const void* dst_local,
                                     const void* mult, int m_dtype, const void* h,
                                     const void* gbar, int h_dtype, const void* side,
                                     const void* msrc, void* out, int T, int R, int C,
                                     int ET, int HD, int H, int64_t n, float slope,
                                     void* stream) {
  return gta::tiles_entry<SrcAcc>(tile_rb, tile_cb, src_local, dst_local, mult, m_dtype,
                                  h, gbar, h_dtype, side, msrc, out, T, R, C, ET, HD, H,
                                  n, slope, stream);
}
