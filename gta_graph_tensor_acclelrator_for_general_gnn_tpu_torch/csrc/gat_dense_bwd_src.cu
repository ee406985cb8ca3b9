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
// dtype, te and the dh sums in float32, the side values and dz in float32,
// alpha rounded to the compute dtype before the dh product.
//
// Bound on the card: the per-cell chain.  Like the TPU kernel, the bf16 path
// evaluates every cell of a dense block (the blocks are a few percent full),
// per cell and head one exp and twelve float32 operations
// (roofline.dense_bwd_cell_floor_ms); the two products per head are
// [64 rows x 64 columns x D] tensor work, far below the card's bf16 rate.
//
// Design for bf16 h (the path GAT trains on; gat_dense_bwd_wgmma_kernel):
// the TPU kernel's structure, two tensor-core products per head with the
// chain between them in registers.  One CUDA block of two warpgroups owns
// 128 rows of a row block over a run of at most DENSE_WIDE_SEGMENT dense
// blocks (DenseBlockGraph.wide_segments, as K2 and K4).  The entry point
// first writes two panels into the wrapper's scratch: gbar transposed
// (head_panel.cuh: each head's D features on KT = D padded to 16 rows, every
// column present) and the columns' terms [a_d | leaky(msrc + a_d) | 1/den |
// s2] transposed ([4H, ld] float32).  Per 64-column k-chunk, the chunk's
// count tile ('cr' [64 columns][128 rows], 16-byte copies), its panel rows
// (H KT rows of 128 bytes, 128-byte swizzle) and its column terms stream
// through the ring of gat_bwd.cuh's tensor-core stage (tc_load_stage, which
// K7 shares) by cp.async.  Per head:
//   te = h_rows . gbar_colsᵀ   wgmma m64n64k16, A = the rows' h fragments
//                              (formed once per CUDA block and stashed in
//                              shared memory, each thread reading back only
//                              its own), B = the panel rows MN-major;
//   the chain on te in registers (gat_bwd.cuh dense_bwd_chain_src): dz
//   summed per row and head in registers, bf(alpha) packed into A
//   fragments;
//   dh += bf(alpha) . gbar     wgmma m64nNk16 in RS form, B = the same
//                              panel rows K-major (N = D padded to 8, 32,
//                              48, 64 or 128).
// te of the next head is issued before this head's chain (two te register
// sets), so the tensor cores work while the chain runs.  alpha and dz never
// touch shared memory, and gbar is staged once per chunk for both
// products.  The dh accumulators (H N / 2 floats a thread) and das
// (2 H) stay in registers across the run; one epilogue per run adds them
// into the zeroed output with float32 atomics (float2 where aligned; das
// summed over a row's four lanes first; a row block's runs meet there, in
// an order that varies by run: float32 rounding only).  Stripes no block
// visits read 0.  exp runs as ex2 of the clamped exponent times log2(e);
// leaky' reads the unscaled logit, as the plain version does.
//
// float32 h, and heads not in 1, 2, 4, 8 or with H N > 128 (as K4: 16 heads
// of 1; 4 of 64; 1 of 129-256), keep the dense walk of gat_bwd.cuh: one CUDA
// block per (segment of at most DENSE_SEGMENT blocks, 64-row sub-tile),
// staging h[c] per row and gathering gbar[r] per nonzero cell; the row's
// accumulator is [H + HD] float32 in shared memory: lane h adds head h's dz,
// and every lane adds its features' bf(alpha) * gbar.
#include "gat_bwd.cuh"
#include "head_panel.cuh"

namespace {

using gta::TC_KC;

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

// ---- bf16 h: te and dh on wgmma, the chain in registers --------------------

using gta::TC_STAGES;
using gta::TC_THREADS;

// after the ring (gat_bwd.cuh TcStage: H KT gbar panel rows, the count
// tile, the 4H column terms), each thread's te A fragments of its rows (one
// 16-byte word per head and k-step, in the thread's own slots), then 1 KB
// for aligning the ring (compiler/schedule._dense_bwd_smem mirrors it)
template <int H, int KT>
__host__ __device__ constexpr int frag_bytes() {
  return H * (KT / 16) * TC_THREADS * 16;
}
template <typename VT, int H, int KT>
__host__ __device__ constexpr int wgmma_smem() {
  return TC_STAGES * gta::TcStage<VT, H * KT, 4 * H>::BYTES + frag_bytes<H, KT>() + 1024;
}

template <typename VT, int H, int N>
__global__ void __launch_bounds__(TC_THREADS, 1)
gat_dense_bwd_wgmma_kernel(const int* __restrict__ segments,
                           const int* __restrict__ row_blocks, const int* __restrict__ blk_cb,
                           const VT* __restrict__ values, const __nv_bfloat16* __restrict__ h,
                           const __nv_bfloat16* __restrict__ gT,
                           const float* __restrict__ ct, int64_t ld,
                           const float* __restrict__ side, float* __restrict__ out, int R,
                           int C, int HD, int64_t n, float slope) {
  constexpr int KT = (N + 15) / 16 * 16;
  using St = gta::TcStage<VT, H * KT, 4 * H>;
  constexpr int SB = St::BYTES;
  extern __shared__ __align__(1024) char smem_raw[];
  __shared__ int s_b[gta::TC_MAX_SEG];             // the run's block ids
  __shared__ int64_t s_col0[gta::TC_MAX_SEG];      // and their first columns
  // the ring starts on a 1 KB boundary (the launch adds 1 KB for this)
  const uint32_t pad = gta::tc_ring_pad(smem_raw);
  const char* smem = smem_raw + pad;
  const uint32_t smem0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const gta::TcRun run = gta::tc_run(segments, row_blocks, blk_cb, R, C, s_b, s_col0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2;                        // warpgroup: rows 64 wg ..
  const bool active = wg * 64 < run.rows_here;     // uniform per warpgroup
  const int D = HD / H, W = H + HD, S = 4 * H;
  auto load_stage = [&](int it, int stage) {
    gta::tc_load_stage<VT, H * KT, 4 * H>(smem0 + stage * SB, it, run, s_b, s_col0, values,
                                          gT, ct, ld, R, C);
  };

  const int g = lane >> 2, t = lane & 3;
  const int ra = wg * 64 + (warp & 3) * 16 + g;    // this thread's rows ra, ra + 8
  const int64_t row_a = run.row_base + ra, row_b = row_a + 8;
  const bool ok_a = ra < run.rows_here && row_a < n;
  const bool ok_b = ra + 8 < run.rows_here && row_b < n;
  // te's A: the rows' h per head, stashed once in the thread's own slots
  uint4* frags = reinterpret_cast<uint4*>(smem_raw + pad + TC_STAGES * SB);
  auto frag = [&](int hh, int s) -> uint4& { return frags[(hh * (KT / 16) + s) * TC_THREADS + tid]; };
  float as_a[H], as_b[H];      // the rows' a_s
#pragma unroll
  for (int hh = 0; hh < H; ++hh) {
    uint32_t a[KT / 16][4];
    gta::dense_bwd_row_frags<KT>(h, row_a, ok_a, row_b, ok_b, HD, D, hh, t, a);
#pragma unroll
    for (int s = 0; s < KT / 16; ++s) frag(hh, s) = make_uint4(a[s][0], a[s][1], a[s][2], a[s][3]);
    as_a[hh] = ok_a ? side[row_a * S + hh] : 0.f;
    as_b[hh] = ok_b ? side[row_b * S + hh] : 0.f;
  }
  // issues te of head hh over the chunk at panel `sp` into `te`
  auto issue_te = [&](int hh, float* te, uint32_t sp) {
    uint32_t a[KT / 16][4];
#pragma unroll
    for (int s = 0; s < KT / 16; ++s) {
      const uint4 w = frag(hh, s);
      a[s][0] = w.x, a[s][1] = w.y, a[s][2] = w.z, a[s][3] = w.w;
    }
    gta::dense_bwd_te<KT>(te, a, sp + hh * KT * 128);
  };
  float acc[H][N / 2];
  float das_a[H], das_b[H];
#pragma unroll
  for (int hh = 0; hh < H; ++hh) {
    das_a[hh] = das_b[hh] = 0.f;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[hh][i] = 0.f;
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
    const float* cts = reinterpret_cast<const float*>(tile + St::CT::BYTES);
    const uint32_t sp = smem0 + st * SB;
    // te of head hh + 1 runs on the tensor cores during head hh's chain
    float te[2][32];
    issue_te(0, te[0], sp);
#pragma unroll
    for (int hh = 0; hh < H; ++hh) {
      gta::wgmma_wait<0>();  // te of hh, and dh of hh - 1 (its A fragments)
#pragma unroll
      for (int i = 0; i < 32; ++i) gta::fence_reg(te[hh & 1][i]);
      if (hh + 1 < H) issue_te(hh + 1, te[(hh + 1) & 1], sp);
      uint32_t af[TC_KC / 16][4];
      const float* cth = cts + hh * TC_KC;
      gta::dense_bwd_chain_src<VT>(te[hh & 1], tile, St::CT::STRIDE, ra, t, cth,
                                   cth + H * TC_KC, cth + 2 * H * TC_KC,
                                   cth + 3 * H * TC_KC, as_a[hh], as_b[hh], slope,
                                   das_a[hh], das_b[hh], af);
      gta::wgmma_fence();
#pragma unroll
      for (int s = 0; s < TC_KC / 16; ++s)
        gta::wgmma_rs<N, 0>(acc[hh], af[s],
                            gta::smem_desc(sp + hh * KT * 128 + 32 * s, 16, 1024));
      gta::wgmma_commit();
    }
    gta::wgmma_wait<0>();  // before the stage is refilled
#pragma unroll
    for (int hh = 0; hh < H; ++hh)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) gta::fence_reg(acc[hh][i]);
  }
  gta::cp_async_wait<0>();
  if (!active) return;
  // acc[hh][4j + 2v + u] = dh[ra + 8v][hh D + 8j + 2t + u]
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    const int64_t row = v ? row_b : row_a;
    const bool ok = v ? ok_b : ok_a;
    float* orow = out + row * W;
#pragma unroll
    for (int hh = 0; hh < H; ++hh) {
      float dsum = v ? das_b[hh] : das_a[hh];
      dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
      dsum += __shfl_xor_sync(0xffffffffu, dsum, 2);
      if (!ok) continue;
      if (t == 0) atomicAdd(orow + hh, dsum);
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int col = 8 * j + 2 * t;
        const float v0 = acc[hh][4 * j + 2 * v], v1 = acc[hh][4 * j + 2 * v + 1];
        const int64_t at = row * W + H + hh * D + col;
        if (col + 1 < D && (at & 1) == 0) {
          atomicAdd(reinterpret_cast<float2*>(out + at), make_float2(v0, v1));
        } else {
          if (col < D) atomicAdd(out + at, v0);
          if (col + 1 < D) atomicAdd(out + at + 1, v1);
        }
      }
    }
  }
}

// The column terms of the wgmma path, transposed: ct[k H + hh, c] for
// column c < n: k = 0 a_d, 1 leaky(msrc + a_d), 2 1/den, 3 s2 of head hh
// (from side [n, 4H] = [a_s | a_d | 1/den | s2]); 0 past n, up to ld.
__global__ void col_terms_kernel(const float* __restrict__ side,
                                 const float* __restrict__ msrc, float* __restrict__ ct,
                                 int64_t n, int H, int64_t ld, float slope) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c >= ld) return;
  const float* s = side + c * 4 * H;
  for (int hh = 0; hh < H; ++hh) {
    const bool ok = c < n;
    const float ad = ok ? s[H + hh] : 0.f;
    ct[hh * ld + c] = ad;
    ct[(H + hh) * ld + c] = ok ? gta::leaky(msrc[hh] + ad, slope) : 0.f;
    ct[(2 * H + hh) * ld + c] = ok ? s[2 * H + hh] : 0.f;
    ct[(3 * H + hh) * ld + c] = ok ? s[3 * H + hh] : 0.f;
  }
}

struct Args {
  const int *sg, *rbk, *cb;
  const void *v;
  const __nv_bfloat16 *h, *g;
  const float *side, *ms;
  float* out;
  __nv_bfloat16* panel;
  float* ct;
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
  auto k = gat_dense_bwd_wgmma_kernel<VT, H, N>;
  cudaError_t err = gta::set_smem(k, smem);
  if (err != cudaSuccess) return err;
  err = gta::write_head_panel(a.g, a.panel, a.n, a.HD, H, KT, a.ld, a.st);
  if (err != cudaSuccess) return err;
  col_terms_kernel<<<static_cast<unsigned>((a.ld + 255) / 256), 256, 0, a.st>>>(
      a.side, a.ms, a.ct, a.n, H, a.ld, a.slope);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid(a.n_seg, (a.R + gta::TC_ROWS - 1) / gta::TC_ROWS);
  k<<<grid, TC_THREADS, smem, a.st>>>(a.sg, a.rbk, a.cb, static_cast<const VT*>(a.v), a.h,
                                      a.panel, a.ct, a.ld, a.side, a.out, a.R, a.C, a.HD,
                                      a.n, a.slope);
  return cudaGetLastError();
}

template <typename VT>
cudaError_t launch_wgmma(const Args& a, int N) {
  // 16-byte copies of count columns (R a multiple of 16), of panel and
  // column-term rows (C and ld multiples of 8)
  if (a.R % 16 != 0 || a.C % 16 != 0 || a.ld % 8 != 0 || a.panel == nullptr ||
      a.ct == nullptr || (reinterpret_cast<uintptr_t>(a.panel) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(a.ct) & 15) != 0 ||
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

// K8.  bf16 h with compiler/schedule._gat_wgmma_width(H, HD / H) > 0 runs
// the wgmma path: `panel` [H KT, ld] bf16 and `ct` [4H, ld] float32 are the
// wrapper's scratch (ld a multiple of 8 covering every column block), which
// the entry point fills first, and segments are the wide ones (at most
// seg_cap = DENSE_WIDE_SEGMENT blocks); otherwise the scratch is unused and
// the segments hold at most DENSE_SEGMENT.  smem: compiler/schedule
// ._dense_bwd_smem, checked against the chosen path's layout.
extern "C" int gta_gat_dense_bwd_src(const void* segments, const void* row_blocks,
                                     const void* blk_cb, const void* values, int v_dtype,
                                     const void* h, const void* gbar, int h_dtype,
                                     const void* side, const void* msrc, void* out,
                                     int n_seg, int seg_cap, int R, int C, int HD, int H,
                                     int64_t n, void* panel, void* ct, int64_t ld,
                                     int64_t smem, float slope, void* stream) {
  if (v_dtype != gta::I8 && v_dtype != h_dtype) return static_cast<int>(cudaErrorInvalidValue);
  if (!gta::bwd_shape_ok(HD, H)) return static_cast<int>(cudaErrorInvalidValue);
  const int N = h_dtype == gta::BF16 ? gta::wgmma_width(H, HD / H) : 0;
  if (N == 0) {
    if (static_cast<size_t>(smem) != gta::dense_smem_bytes<SrcAcc>(HD, H))
      return static_cast<int>(cudaErrorInvalidValue);
    return gta::dense_entry<SrcAcc>(segments, row_blocks, blk_cb, values, v_dtype, h, gbar,
                                    h_dtype, side, msrc, out, n_seg, R, C, HD, H, n, slope,
                                    stream);
  }
  if (n_seg == 0) return 0;
  const Args a{static_cast<const int*>(segments), static_cast<const int*>(row_blocks),
               static_cast<const int*>(blk_cb), values,
               static_cast<const __nv_bfloat16*>(h), static_cast<const __nv_bfloat16*>(gbar),
               static_cast<const float*>(side), static_cast<const float*>(msrc),
               static_cast<float*>(out), static_cast<__nv_bfloat16*>(panel),
               static_cast<float*>(ct), ld, n, n_seg, seg_cap, R, C, HD, H,
               static_cast<size_t>(smem), slope, static_cast<cudaStream_t>(stream)};
  const cudaError_t err = v_dtype == gta::I8 ? launch_wgmma<int8_t>(a, N)
                                             : launch_wgmma<__nv_bfloat16>(a, N);
  return static_cast<int>(err);
}
