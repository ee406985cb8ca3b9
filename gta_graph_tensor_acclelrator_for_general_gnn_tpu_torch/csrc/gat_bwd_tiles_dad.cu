// K5 gat_bwd_tiles_dad: the GAT attention backward's dad over the forward
// tail tiling (rows = receivers d, columns = senders s):
//   dad[d, h] += dz(s -> d, h)        (gat_bwd.cuh has the chain)
// Output [n, H] float32.
//
// Replaces the TPU kernels ops/gat.py:_gat_bwd_dad_kernel_tt (transposed
// dataflow) and its wide twin _gat_bwd_dad_kernel of the JAX package: one
// kernel here, since the twins differ only in TPU lane layout.  Rounding
// points are the TPU kernels': h, gbar and the side values arrive in (or
// rounded to) the compute dtype, te and the chain run in float32, and dz
// rounds to the compute dtype before the float32 sum.
//
// Bound on the card: memory and latency.  Each live edge gathers one row
// (h[s]) and the sender's a_s per head, each run of slots the walked row
// (gbar[d] and d's side terms), and adds H values into its run's sums;
// the tail tiles are TPU-shaped (512 slots, a few dozen edges each).
//
// Design: K6's walk with the rows the receivers, gta::gat_bwd_prefix_walk
// with SRC false through gta::tail_entry (gat_bwd.cuh): one warp per tile,
// stopping at the first 32 slots without an edge, an edge's gathers in
// flight per lane group (bf16 rows with D a multiple of 4 by half-warps,
// 8-byte loads; float32 by the whole warp, 16-byte loads; else one
// feature a lane), gbar[d] and d's side terms loaded once a run, te
// reduced within the lanes of a group that hold the head, the chain on
// every lane of the head, dad summed on the lane whose load starts the
// head and added once a run with one float32 atomic a head.  The sender's
// a_s is one float of its packed side terms.
#include "gat_bwd.cuh"

namespace {

// K5's accumulate step: rows are the receivers; each row sums dad
struct DadWalk {
  static constexpr bool SRC = false;

  __host__ __device__ static int width(int H, int) { return H; }
};

}  // namespace

// K5.  ``sidep``: the side panel [a_s, a_d, 1/den, s2] float32 packed per
// node and head ([n, H, 4], 16-byte aligned; ops/gat.pack_side).
extern "C" int gta_gat_bwd_tiles_dad(const void* tile_rb, const void* tile_cb,
                                     const void* src_local, const void* dst_local,
                                     const void* mult, int m_dtype, const void* h,
                                     const void* gbar, int h_dtype, const void* sidep,
                                     const void* msrc, void* out, int T, int R, int C, int ET,
                                     int HD, int H, int64_t n, float slope, void* stream) {
  return gta::tail_entry<DadWalk>(tile_rb, tile_cb, src_local, dst_local, mult, m_dtype, h,
                                  gbar, h_dtype, sidep, msrc, out, T, R, C, ET, HD, H, n,
                                  slope, stream);
}
