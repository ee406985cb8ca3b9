// K7 gat_dense_bwd_dad: the GAT attention backward's dad over the rb-major
// 'cr' dense count blocks of the density split (rows = receivers r,
// columns = senders c):
//   dad[r, h] += sum_c dz(c -> r, h)    (gat_bwd.cuh has the chain; the
//                                        cell's count is its multiplicity)
//
// Replaces the TPU kernel ops/dense.py:_gat_dense_bwd_dad_kernel of the JAX
// package.  Rounding points are the TPU kernel's: h and gbar in the compute
// dtype, the side values (a_s, a_d, 1/den, s2) and dz in float32.
//
// Bound on the card: the nonzero cells (two row gathers, HD multiply-adds
// and H exps each).
//
// Design: the dense walk of gat_bwd.cuh, staging gbar[r] per row and
// gathering h[c] per nonzero cell; lane h adds head h's dz into the row's
// [H] accumulator in shared memory.
#include "gat_bwd.cuh"

namespace {

struct DadAcc {
  static constexpr bool SRC = false;

  __host__ __device__ static int width(int H, int) { return H; }

  template <typename HT>
  __device__ static void add(float* arow, float, float dz, const float*, const int*,
                             int lane, int H) {
    if (lane < H) arow[lane] += dz;
  }
};

}  // namespace

extern "C" int gta_gat_dense_bwd_dad(const void* segments, const void* row_blocks,
                                     const void* blk_cb, const void* values, int v_dtype,
                                     const void* h, const void* gbar, int h_dtype,
                                     const void* side, const void* msrc, void* out,
                                     int n_seg, int R, int C, int HD, int H, int64_t n,
                                     float slope, void* stream) {
  return gta::dense_entry<DadAcc>(segments, row_blocks, blk_cb, values, v_dtype, h, gbar,
                                  h_dtype, side, msrc, out, n_seg, R, C, HD, H, n, slope,
                                  stream);
}
