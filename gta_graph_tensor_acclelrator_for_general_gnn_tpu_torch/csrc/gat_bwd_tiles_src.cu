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
// Design: one warp per tile (gta::tail_entry, gat_bwd.cuh), walking by
// gta::gat_bwd_prefix_walk, K3's walk: it stops at the first 32 slots
// without an edge and keeps all of an edge's gathers in flight per lane
// group, at 32 warps an SM (bf16 rows with D a multiple of 4 by
// half-warps, two edges a load, 8-byte loads; float32 rows by the whole
// warp, 16-byte loads; else one feature a lane, by half-warps up to 48
// features, as the 41 logits of a last layer).  It reads the side terms
// packed per node and head (one 16-byte load a head; ops/gat.pack_side,
// once per backward for K5 and K6), loads the walked row's h[s] and
// a_s[s] once a run of slots, reduces te within the lanes of a group that
// hold the head, and runs the chain on every lane that holds the head (no
// shuffle of alpha); each run's sums go into the zeroed output with one
// global atomic per value (float4 where the dh columns are 16-byte
// aligned).
#include "gat_bwd.cuh"

namespace {

// K6's accumulate step: rows are the original senders; each row sums
// [das | dh]
struct SrcWalk {
  static constexpr bool SRC = true;

  __host__ __device__ static int width(int H, int HD) { return H + HD; }
};

}  // namespace

// K6.  ``sidep``: the side panel [a_s, a_d, 1/den, s2] float32 packed per
// node and head ([n, H, 4], 16-byte aligned; ops/gat.pack_side).
extern "C" int gta_gat_bwd_tiles_src(const void* tile_rb, const void* tile_cb,
                                     const void* src_local, const void* dst_local,
                                     const void* mult, int m_dtype, const void* h,
                                     const void* gbar, int h_dtype, const void* sidep,
                                     const void* msrc, void* out, int T, int R, int C, int ET,
                                     int HD, int H, int64_t n, float slope, void* stream) {
  return gta::tail_entry<SrcWalk>(tile_rb, tile_cb, src_local, dst_local, mult, m_dtype, h,
                                  gbar, h_dtype, sidep, msrc, out, T, R, C, ET, HD, H, n,
                                  slope, stream);
}
