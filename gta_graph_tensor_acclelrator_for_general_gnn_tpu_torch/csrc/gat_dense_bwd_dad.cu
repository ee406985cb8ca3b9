// K7 gat_dense_bwd_dad: the GAT attention backward's dad over the rb-major
// 'cr' dense count blocks of the density split (rows = receivers r,
// columns = senders c):
//   dad[r, h] += sum_c dz(c -> r, h)    (gat_bwd.cuh has the chain; the
//                                        cell's count is its multiplicity)
// Output [n, H] float32.
//
// Replaces the TPU kernel ops/dense.py:_gat_dense_bwd_dad_kernel of the JAX
// package.  Rounding points are the TPU kernel's: h and gbar in the compute
// dtype, te in float32, the side values (a_s, a_d, 1/den, s2) and dz in
// float32.
//
// Bound on the card: the per-cell chain.  Like the TPU kernel, the bf16 path
// evaluates every cell of a dense block (the blocks are a few percent full),
// per cell and head one exp and about ten float32 operations
// (roofline.dense_bwd_cell_floor_ms, K8's floor: K7 skips K8's alpha
// packing); the te product per head is [64 rows x 64 columns x D] tensor
// work, far below the card's bf16 rate.
//
// Design for bf16 h (the path GAT trains on; gat_dense_bwd_dad_wgmma_kernel):
// K8's tensor-core stage (gat_bwd.cuh) with rows and columns swapped and
// without the second product.  One CUDA block of two warpgroups owns 128
// receiver rows of a row block over a run of at most DENSE_WIDE_SEGMENT
// dense blocks (DenseBlockGraph.wide_segments).  The entry point first
// writes two panels into the wrapper's scratch: h transposed (head_panel.cuh:
// each head's D features on KT = D padded to 16 rows, every column present)
// and the columns' a_s transposed ([H, ld] float32), K7's only column term.
// Per 64-column k-chunk, the chunk's count tile, its h panel rows and its
// a_s stream through the stage's 3-deep cp.async ring (tc_load_stage).
// Each thread holds, for the whole run, its two rows' gbar k16 fragments
// (te's A operand: with no second product they stay in registers) and
// their a_d, leaky(msrc + a_d), 1/den and s2 per head.  Per chunk it reads
// its 32 cells' counts once (the counts do not depend on the head) and,
// with one head, marks the 16 x 8 cell steps where the warp holds a count;
// per head:
//   te = gbar_rows . h_colsᵀ   wgmma m64n64k16, B = the panel rows MN-major;
//   the chain on te in registers (gat_bwd.cuh dense_bwd_chain_dad), dz
//   summed per row and head in registers (a step without a count adds
//   only zeros, and is skipped).
// te of the next head is issued before this head's chain (two te register
// sets), so the tensor cores work while the chain runs.  One epilogue per
// run sums a row's dz over its four lanes by shuffle and adds it into the
// zeroed output with one float32 atomic per row and head (a row block's
// runs meet there, in an order that varies by run: float32 rounding only).
// Stripes no block visits read 0.  exp runs as ex2 of the clamped exponent
// times log2(e); leaky' reads the unscaled logit, as the plain version does.
//
// float32 h, and heads not in 1, 2, 4, 8 or with H N > 128 (as K4 and K8),
// keep the dense walk of gat_bwd.cuh: one CUDA block per (segment of at most
// DENSE_SEGMENT blocks, 64-row sub-tile), staging gbar[r] per row and
// gathering h[c] per nonzero cell; lane h adds head h's dz into the row's
// [H] accumulator in shared memory.
#include "gat_bwd.cuh"
#include "head_panel.cuh"

namespace {

using gta::TC_KC;
using gta::TC_STAGES;
using gta::TC_THREADS;

struct DadAcc {
  static constexpr bool SRC = false;

  __host__ __device__ static int width(int H, int) { return H; }

  template <typename HT>
  __device__ static void add(float* arow, float, float dz, const float*, const int*,
                             int lane, int H) {
    if (lane < H) arow[lane] += dz;
  }
};

// ---- bf16 h: te on wgmma, the chain in registers ---------------------------

// the ring (gat_bwd.cuh TcStage: H KT h panel rows, the count tile, the
// H a_s rows) and 1 KB for aligning it (compiler/schedule._dense_bwd_smem
// mirrors it)
template <typename VT, int H, int KT>
__host__ __device__ constexpr int wgmma_smem() {
  return TC_STAGES * gta::TcStage<VT, H * KT, H>::BYTES + 1024;
}

template <typename VT, int H, int N>
__global__ void __launch_bounds__(TC_THREADS, 1)
gat_dense_bwd_dad_wgmma_kernel(const int* __restrict__ segments,
                               const int* __restrict__ row_blocks,
                               const int* __restrict__ blk_cb, const VT* __restrict__ values,
                               const __nv_bfloat16* __restrict__ gbar,
                               const __nv_bfloat16* __restrict__ hT,
                               const float* __restrict__ ast, int64_t ld,
                               const float* __restrict__ side, const float* __restrict__ msrc,
                               float* __restrict__ out, int R, int C, int HD, int64_t n,
                               float slope) {
  constexpr int KT = (N + 15) / 16 * 16;
  using St = gta::TcStage<VT, H * KT, H>;
  constexpr int SB = St::BYTES, SZ = St::CT::SZ;
  extern __shared__ __align__(1024) char smem_raw[];
  __shared__ int s_b[gta::TC_MAX_SEG];         // the run's block ids
  __shared__ int64_t s_col0[gta::TC_MAX_SEG];  // and their first columns
  // the ring starts on a 1 KB boundary (the launch adds 1 KB for this)
  const char* smem = smem_raw + gta::tc_ring_pad(smem_raw);
  const uint32_t smem0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const gta::TcRun run = gta::tc_run(segments, row_blocks, blk_cb, R, C, s_b, s_col0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2;                     // warpgroup: rows 64 wg ..
  const bool active = wg * 64 < run.rows_here;  // uniform per warpgroup
  const int D = HD / H, S = 4 * H;
  auto load_stage = [&](int it, int stage) {
    gta::tc_load_stage<VT, H * KT, H>(smem0 + stage * SB, it, run, s_b, s_col0, values, hT,
                                      ast, ld, R, C);
  };

  const int g = lane >> 2, t = lane & 3;
  const int ra = wg * 64 + (warp & 3) * 16 + g;  // this thread's rows ra, ra + 8
  const int64_t row_a = run.row_base + ra, row_b = row_a + 8;
  const bool ok_a = ra < run.rows_here && row_a < n;
  const bool ok_b = ra + 8 < run.rows_here && row_b < n;
  // te's A (the rows' gbar per head) and the rows' terms, for the whole run
  uint32_t frag[H][KT / 16][4];
  float ad[H][2], bnd[H][2], rden[H][2], s2[H][2], dad[H][2];
#pragma unroll
  for (int hh = 0; hh < H; ++hh) {
    gta::dense_bwd_row_frags<KT>(gbar, row_a, ok_a, row_b, ok_b, HD, D, hh, t, frag[hh]);
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const bool ok = v ? ok_b : ok_a;
      const float* sr = side + (v ? row_b : row_a) * S;
      ad[hh][v] = ok ? sr[H + hh] : 0.f;
      bnd[hh][v] = ok ? gta::leaky(msrc[hh] + ad[hh][v], slope) : 0.f;
      rden[hh][v] = ok ? sr[2 * H + hh] : 0.f;
      s2[hh][v] = ok ? sr[3 * H + hh] : 0.f;
      dad[hh][v] = 0.f;
    }
  }

#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < run.iters) load_stage(s, s);
    gta::cp_async_commit();
  }
  for (int it = 0; it < run.iters; ++it) {
    gta::cp_async_wait<TC_STAGES - 2>();
    gta::fence_proxy_async();
    __syncthreads();  // chunk `it` landed for all; stage (it - 1) is free
    if (it + TC_STAGES - 1 < run.iters)
      load_stage(it + TC_STAGES - 1, (it + TC_STAGES - 1) % TC_STAGES);
    gta::cp_async_commit();
    if (!active) continue;
    const int st = it % TC_STAGES;
    const char* tile = smem + st * SB + St::P_BYTES;
    const float* as = reinterpret_cast<const float*>(tile + St::CT::BYTES);
    const uint32_t sp = smem0 + st * SB;
    // te of head 0 runs on the tensor cores while the counts are read
    float te[2][32];
    gta::dense_bwd_te<KT>(te[0], frag[0], sp);
    // the thread's cells' counts: kc[4j + 2v + u] of row ra + 8v, column
    // 8j + 2t + u (te's index), and with one head the steps j where the
    // warp holds one (at more heads a branch per step and head cost more
    // time on the card than the steps it skipped saved)
    float kc[32];
    unsigned live = H > 1 ? 0xffu : 0u;
#pragma unroll
    for (int j = 0; j < TC_KC / 8; ++j) {
      bool any = false;
#pragma unroll
      for (int v = 0; v < 2; ++v)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float k = gta::count_f(tile + (8 * j + 2 * t + u) * St::CT::STRIDE +
                                           (ra + 8 * v) * SZ, VT());
          kc[4 * j + 2 * v + u] = k;
          any |= k != 0.f;
        }
      if (H == 1) live |= (__any_sync(0xffffffffu, any) ? 1u : 0u) << j;
    }
#pragma unroll
    for (int hh = 0; hh < H; ++hh) {
      gta::wgmma_wait<0>();  // te of hh
#pragma unroll
      for (int i = 0; i < 32; ++i) gta::fence_reg(te[hh & 1][i]);
      if (hh + 1 < H) gta::dense_bwd_te<KT>(te[(hh + 1) & 1], frag[hh + 1], sp + (hh + 1) * KT * 128);
      gta::dense_bwd_chain_dad(te[hh & 1], kc, live, t, as + hh * TC_KC, ad[hh], bnd[hh],
                               rden[hh], s2[hh], slope, dad[hh]);
    }
  }
  gta::cp_async_wait<0>();
  if (!active) return;
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    const int64_t row = v ? row_b : row_a;
    const bool ok = v ? ok_b : ok_a;
#pragma unroll
    for (int hh = 0; hh < H; ++hh) {
      float dsum = dad[hh][v];
      dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
      dsum += __shfl_xor_sync(0xffffffffu, dsum, 2);
      if (ok && t == 0) atomicAdd(out + row * H + hh, dsum);
    }
  }
}

// The columns' a_s, transposed: ast[hh, c] = a_s[c, hh] (side [n, 4H] =
// [a_s | a_d | 1/den | s2]) for column c < n, 0 past n up to ld.
__global__ void as_terms_kernel(const float* __restrict__ side, float* __restrict__ ast,
                                int64_t n, int H, int64_t ld) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c >= ld) return;
  for (int hh = 0; hh < H; ++hh) ast[hh * ld + c] = c < n ? side[c * 4 * H + hh] : 0.f;
}

struct Args {
  const int *sg, *rbk, *cb;
  const void* v;
  const __nv_bfloat16 *h, *g;
  const float *side, *ms;
  float* out;
  __nv_bfloat16* panel;
  float* ast;
  int64_t ld, n;
  int n_seg, seg_cap, R, C, HD, H;
  size_t smem;
  float slope;
  cudaStream_t st;
};

template <typename VT, int H, int N>
cudaError_t launch_wgmma_hn(const Args& a) {
  constexpr int KT = (N + 15) / 16 * 16;
  constexpr size_t smem = wgmma_smem<VT, H, KT>();
  if (a.smem != smem) return cudaErrorInvalidValue;  // the wrapper's size is the ring's
  auto k = gat_dense_bwd_dad_wgmma_kernel<VT, H, N>;
  cudaError_t err = gta::set_smem(k, smem);
  if (err != cudaSuccess) return err;
  err = gta::write_head_panel(a.h, a.panel, a.n, a.HD, H, KT, a.ld, a.st);
  if (err != cudaSuccess) return err;
  as_terms_kernel<<<static_cast<unsigned>((a.ld + 255) / 256), 256, 0, a.st>>>(a.side, a.ast,
                                                                               a.n, H, a.ld);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid(a.n_seg, (a.R + gta::TC_ROWS - 1) / gta::TC_ROWS);
  k<<<grid, TC_THREADS, smem, a.st>>>(a.sg, a.rbk, a.cb, static_cast<const VT*>(a.v), a.g,
                                      a.panel, a.ast, a.ld, a.side, a.ms, a.out, a.R, a.C,
                                      a.HD, a.n, a.slope);
  return cudaGetLastError();
}

template <typename VT>
cudaError_t launch_wgmma(const Args& a, int N) {
  // 16-byte copies of count columns (R a multiple of 16), of panel and
  // a_s rows (C and ld multiples of 8)
  if (a.R % 16 != 0 || a.C % 16 != 0 || a.ld % 8 != 0 || a.panel == nullptr ||
      a.ast == nullptr || (reinterpret_cast<uintptr_t>(a.panel) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(a.ast) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(a.v) & 15) != 0)
    return cudaErrorInvalidValue;
  if (a.seg_cap > gta::TC_MAX_SEG) return cudaErrorInvalidValue;  // runs' ids in shared memory
  switch (a.H * 1000 + N) {
    case 1008: return launch_wgmma_hn<VT, 1, 8>(a);
    case 1032: return launch_wgmma_hn<VT, 1, 32>(a);
    case 1048: return launch_wgmma_hn<VT, 1, 48>(a);
    case 1064: return launch_wgmma_hn<VT, 1, 64>(a);
    case 1128: return launch_wgmma_hn<VT, 1, 128>(a);
    case 2008: return launch_wgmma_hn<VT, 2, 8>(a);
    case 2032: return launch_wgmma_hn<VT, 2, 32>(a);
    case 2048: return launch_wgmma_hn<VT, 2, 48>(a);
    case 2064: return launch_wgmma_hn<VT, 2, 64>(a);
    case 4008: return launch_wgmma_hn<VT, 4, 8>(a);
    case 4032: return launch_wgmma_hn<VT, 4, 32>(a);
    case 8008: return launch_wgmma_hn<VT, 8, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// K7.  bf16 h with compiler/schedule._gat_wgmma_width(H, HD / H) > 0 runs
// the wgmma path: `panel` [H KT, ld] bf16 and `ast` [H, ld] float32 are the
// wrapper's scratch (ld a multiple of 8 covering every column block), which
// the entry point fills first, and segments are the wide ones (at most
// seg_cap = DENSE_WIDE_SEGMENT blocks); otherwise the scratch is unused and
// the segments hold at most DENSE_SEGMENT.  smem: compiler/schedule
// ._dense_bwd_smem, checked against the chosen path's layout.
extern "C" int gta_gat_dense_bwd_dad(const void* segments, const void* row_blocks,
                                     const void* blk_cb, const void* values, int v_dtype,
                                     const void* h, const void* gbar, int h_dtype,
                                     const void* side, const void* msrc, void* out,
                                     int n_seg, int seg_cap, int R, int C, int HD, int H,
                                     int64_t n, void* panel, void* ast, int64_t ld,
                                     int64_t smem, float slope, void* stream) {
  if (v_dtype != gta::I8 && v_dtype != h_dtype) return static_cast<int>(cudaErrorInvalidValue);
  if (!gta::bwd_shape_ok(HD, H)) return static_cast<int>(cudaErrorInvalidValue);
  const int N = h_dtype == gta::BF16 ? gta::wgmma_width(H, HD / H) : 0;
  if (N == 0) {
    if (static_cast<size_t>(smem) != gta::dense_smem_bytes<DadAcc>(HD, H))
      return static_cast<int>(cudaErrorInvalidValue);
    return gta::dense_entry<DadAcc>(segments, row_blocks, blk_cb, values, v_dtype, h, gbar,
                                    h_dtype, side, msrc, out, n_seg, R, C, HD, H, n, slope,
                                    stream);
  }
  if (n_seg == 0) return 0;
  const Args a{static_cast<const int*>(segments), static_cast<const int*>(row_blocks),
               static_cast<const int*>(blk_cb), values,
               static_cast<const __nv_bfloat16*>(h), static_cast<const __nv_bfloat16*>(gbar),
               static_cast<const float*>(side), static_cast<const float*>(msrc),
               static_cast<float*>(out), static_cast<__nv_bfloat16*>(panel),
               static_cast<float*>(ast), ld, n, n_seg, seg_cap, R, C, HD, H,
               static_cast<size_t>(smem), slope, static_cast<cudaStream_t>(stream)};
  const cudaError_t err = v_dtype == gta::I8 ? launch_wgmma<int8_t>(a, N)
                                             : launch_wgmma<__nv_bfloat16>(a, N);
  return static_cast<int>(err);
}
