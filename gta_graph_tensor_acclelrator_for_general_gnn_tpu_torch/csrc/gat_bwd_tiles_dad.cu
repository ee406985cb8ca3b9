// K5 gat_bwd_tiles_dad: the GAT attention backward's dad over the forward
// tail tiling (rows = receivers d, columns = senders s):
//   dad[d, h] += dz(s -> d, h)        (gat_bwd.cuh has the chain)
//
// Replaces the TPU kernels ops/gat.py:_gat_bwd_dad_kernel_tt (transposed
// dataflow) and its wide twin _gat_bwd_dad_kernel of the JAX package: one
// kernel here, since the twins differ only in TPU lane layout.  Rounding
// points are the TPU kernels': h, gbar and the side values arrive in (or
// rounded to) the compute dtype, te and the chain run in float32, and dz
// rounds to the compute dtype before the float32 sum.
//
// Bound on the card: memory and latency, as K3.  Each live edge gathers two
// rows (h[s] and gbar[d], HD elements each) and the side values, does HD
// multiply-adds and H exps, and adds H values.
//
// Design: the tail walk of gat_bwd.cuh (K3's: a warp per tile, live slots
// by ballot); lane h sums head h's rounded dz over each run of slots with
// one receiver in a register and adds the run's sum into the zeroed [N, H]
// float32 output with one global atomic.
#include "gat_bwd.cuh"

namespace {

struct DadAcc {
  static constexpr bool SRC = false;

  template <typename HT>
  __device__ static void add(gta::BwdRun& run, float, float dz, const float*, const int*,
                             int lane, int H) {
    if (lane < H) run.head += gta::round_to<HT>(dz);
  }

  __device__ static void flush(float* dad, int64_t dst, const gta::BwdRun& run, const int*,
                               int lane, int H, int) {
    if (lane < H) atomicAdd(dad + dst * H + lane, run.head);
  }
};

}  // namespace

extern "C" int gta_gat_bwd_tiles_dad(const void* tile_rb, const void* tile_cb,
                                     const void* src_local, const void* dst_local,
                                     const void* mult, int m_dtype, const void* h,
                                     const void* gbar, int h_dtype, const void* side,
                                     const void* msrc, void* out, int T, int R, int C,
                                     int ET, int HD, int H, int64_t n, float slope,
                                     void* stream) {
  return gta::tiles_entry<DadAcc>(tile_rb, tile_cb, src_local, dst_local, mult, m_dtype,
                                  h, gbar, h_dtype, side, msrc, out, T, R, C, ET, HD, H,
                                  n, slope, stream);
}
