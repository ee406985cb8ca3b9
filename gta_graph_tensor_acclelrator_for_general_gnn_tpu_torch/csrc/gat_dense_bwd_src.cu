// K8 gat_dense_bwd_src: the GAT attention backward's [das | dh] over the
// 'cr' dense count blocks of the TRANSPOSED graph's split, whose rows are
// the original senders c and whose columns are the original receivers r:
//   das[c, h]        += sum_r dz(c -> r, h)
//   dh[c, hD + j]    += sum_r bf(alpha(c -> r, h)) * gbar[r, hD + j]
// (gat_bwd.cuh has the chain; bf() rounds to the compute dtype).  Output
// [n, H + HD] float32.
//
// Replaces the TPU kernel ops/dense.py:_gat_dense_bwd_src_kernel of the JAX
// package.  Rounding points are the TPU kernel's: h and gbar in the compute
// dtype, the side values and dz in float32, alpha rounded to the compute
// dtype before the dh product, whose sums are float32.
//
// Bound on the card: the nonzero cells, as K7 (two row gathers, HD
// multiply-adds for te, H exps and HD multiply-adds for dh per cell).
//
// Design: the dense walk of gat_bwd.cuh, staging h[c] per row and gathering
// gbar[r] per nonzero cell; the row's accumulator is [H + HD] float32 in
// shared memory (33 KB per 64-row sub-tile at H + HD = 132): lane h adds
// head h's dz, and every lane adds its features' bf(alpha) * gbar.
#include "gat_bwd.cuh"

namespace {

struct SrcAcc {
  static constexpr bool SRC = true;

  __host__ __device__ static int width(int H, int HD) { return H + HD; }

  template <typename HT>
  __device__ static void add(float* arow, float alpha, float dz, const float* gv,
                             const int* hk, int lane, int H) {
    if (lane < H) arow[lane] += dz;
#pragma unroll
    for (int q = 0; q < gta::BWD_MAXF; ++q) {
      const float a = __shfl_sync(0xffffffffu, alpha, hk[q] >= 0 ? hk[q] : 0);
      if (hk[q] >= 0) arow[H + lane + 32 * q] += gta::round_to<HT>(a) * gv[q];
    }
  }
};

}  // namespace

extern "C" int gta_gat_dense_bwd_src(const void* segments, const void* row_blocks,
                                     const void* blk_cb, const void* values, int v_dtype,
                                     const void* h, const void* gbar, int h_dtype,
                                     const void* side, const void* msrc, void* out,
                                     int n_seg, int R, int C, int HD, int H, int64_t n,
                                     float slope, void* stream) {
  return gta::dense_entry<SrcAcc>(segments, row_blocks, blk_cb, values, v_dtype, h, gbar,
                                  h_dtype, side, msrc, out, n_seg, R, C, HD, H, n, slope,
                                  stream);
}
