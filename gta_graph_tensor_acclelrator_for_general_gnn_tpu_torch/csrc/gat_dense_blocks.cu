// K4 gat_dense_blocks: [num | den] attention partials over the dense blocks
// of the density split, under the same global shift bound as K3; and K15
// gat_dense_panel, the same walk with per-node exp panels.
//
// Replaces the TPU kernels ops/dense.py:_gat_dense_kernel_t ('cr' blocks,
// transposed dataflow) and _gat_dense_kernel ('rc' blocks) of the JAX
// package: one kernel here, the block layout is an argument.  Per block and
// head, for every cell (r, c):
//   p[r,c] = count[r,c] * exp(min(leaky(a_s[c] + a_d[r]) - leaky(msrc + a_d[r]), 60))
//   num[r, hD:(h+1)D] += sum_c p * h[c, hD:(h+1)D]    (p rounded to h's dtype)
//   den[r, h]         += sum_c p                        (f32, unrounded)
// which are the TPU kernel's rounding points.
//
// Bound on the card: the per-cell chain.  p is formed for every cell of a
// dense block, zero or not (the blocks are a few percent full, but a
// thread's cells are rarely all zero): per cell and head one exp and about
// ten float32 operations, 1.05G cell-heads a GAT-2l step on the smoke's
// graph (~0.5 ms at the card's issue rate), against 0.24 ms to stream the
// counts and ~0.08 ms of tensor work (D padded to N).
//
// Design for bf16 h (the path GAT runs; gat_dense_wgmma_kernel): one CUDA
// block of four warpgroups owns a row block's 256 rows over a run of at
// most DENSE_WIDE_SEGMENT dense blocks (DenseBlockGraph.wide_segments, ids
// read once into shared memory), so each h panel is read once per dense
// block and each output stripe takes one epilogue per run.  The count tile,
// the h panel and the a_s chunk of each 64-column k-chunk stream through a
// ring of STAGES shared-memory stages filled by cp.async (16-byte copies of
// counts and h, zero-filled past the block's edges; the next chunks' copies
// are issued before this chunk's work).  The counts are staged in their
// own layout ('cr' [64 cols][256 rows], 'rc' [256 rows][64 cols]) and
// each thread reads its fragment's cells from shared memory by byte (or
// bf16) loads.  p never touches shared memory: per head, each thread forms
// p for the cells of its wgmma A fragment (rows g, g + 8 of its warp's 16,
// columns 2t, 2t + 1, 2t + 8, 2t + 9 of each 16-column step) in registers,
// adds the unrounded p into its rows' den partials, rounds p to bf16 into
// the fragment and issues wgmma m64nNk16 in RS form, B from that head's N
// rows of the h panel.  The panel is h transposed, each head's D features
// padded to N (a multiple of 8) and every column block's columns present
// ([H N, ld] bf16, written by head_panel_kernel into the wrapper's
// scratch before the main kernel), so its stage copy is K-major in the
// 128-byte swizzle layout, written by 16-byte copies, and each head's B
// starts on a 1 KB atom.  The num accumulators (H N / 2 floats a thread)
// stay in registers across the run; A fragments rotate through two
// register sets, so head hh's next product runs while the following
// fragment is formed (wgmma.wait_group 1).  exp runs as ex2 on a_s, a_d
// and the bound scaled by log2(e) (leaky commutes with a positive scale).
// The epilogue adds num (float2 atomics where aligned) and den (summed
// over the four lanes of a row first) into the zeroed output once per run.
// Shapes the wgmma path does not take (H not in 1, 2, 4, 8, or H N > 128
// with N the next of 8, 32, 48, 64, 128 at or above D) and float32 h run
// on gat_dense_kernel below.
//
// gat_dense_kernel (float32 h and those shapes): one CUDA block per
// (segment, 64-row sub-tile), where a segment is a run of at most 8 dense
// blocks of one row block (DenseBlockGraph.segments).  Per block and
// column chunk of CC columns, the counts, the h panel and a_s of the chunk
// are staged in shared memory; p is formed once per (head, row, column)
// and den sums it unrounded by warp shuffles in the same pass.  For bf16 h
// the num product P_h[64 x CC] . H[CC x D] of each head runs on mma.sync
// m16n8k16 (p rounded to bf16; exact products; f32 sums); for float32 h
// (or more than 8 heads) it runs in f32 on the CUDA cores, so float32 stays
// float32.  The 64 x (HD + H) f32 accumulator lives in shared memory; at
// the end the block adds it into the zeroed output with f32 atomics (a row
// block's segments meet there; the order varies by run, f32 rounding
// only).  Stripes no dense block visits read 0.
//
// K15 (PANEL, entry point gta_gat_dense_panel) replaces the TPU kernel
// ops/dense.py:_gat_dense_kernel_t2, the exp-panel factorisation of K4 (the
// JAX package runs it when DENSE_EXP_PANEL is set).  On each branch of the
// leaky relu, exp(e - bound) factors into a column term and a row term, so
// with per-node panels built in PyTorch (pan_s [n_cols, 2H] = [E1s | E2s],
// pan_d [n_rows, 3H] = [E1d | E2d | raw a_d], pad entries 0)
//   p[r,c] = count[r,c] * (a_s[c] + a_d[r] >= 0 ? E1s[c] E1d[r] : E2s[c] E2d[r])
// with no per-cell exponential; num and den as K4.  K15 runs on K4's
// kernels in their panel mode and takes the same split: bf16 h at the
// wgmma head shapes on gat_dense_wgmma_kernel<..., PANEL = true>, whose
// ring stages the chunk's a_s, E1s and E2s as three arrays [KC][H] (three
// shared loads a cell column: utils/layer_variants.py measured one packed
// 16-byte entry a column and head 5% slower) and whose rows keep E1d, E2d
// and the raw a_d in shared memory in place of K4's log2(e)-scaled a_d and bound (each thread
// forms p from them for its A-fragment cells: a compare, a select and two
// multiplies, no exponential); float32 h and the other shapes on
// gat_dense_kernel<..., PANEL = true>.
#include <type_traits>

#include "head_panel.cuh"
#include "wgmma.cuh"

namespace {

using gta::count_f;
using gta::ex2;
using gta::leaky;
using gta::LOG2E;
using gta::round_to;
using gta::to_f;

constexpr int BM = 64, THREADS = 256, PAD = 8;

// shared-memory floats of one CUDA block (bf16 arrays count as half floats);
// the panel mode adds the column chunk's [E1s | E2s] and the rows' E2d
inline size_t smem_bytes(int HD, int H, int CC, bool mma, bool panel) {
  size_t f = static_cast<size_t>(BM) * (HD + H) + static_cast<size_t>(CC) * H +
             2 * BM * H + static_cast<size_t>(BM) * CC +
             (panel ? static_cast<size_t>(CC) * 2 * H + BM * H : 0);
  if (mma)  // HsT [HD][CC+PAD] and Pb [H][BM][CC+PAD], bf16
    return f * 4 + (static_cast<size_t>(HD) + static_cast<size_t>(H) * BM) * (CC + PAD) * 2;
  return (f + static_cast<size_t>(CC) * HD + static_cast<size_t>(H) * BM * CC) * 4;
}

// PANEL: a_dst and msrc are not read; pan_s [n_ps, 2H] and pan_d [n_pd, 3H]
// are (K4 passes null panels)
template <typename VT, typename HT, bool MMA, bool PANEL>
__global__ void __launch_bounds__(THREADS)
gat_dense_kernel(const int* __restrict__ segments, const int* __restrict__ row_blocks,
                 const int* __restrict__ blk_cb, const VT* __restrict__ values,
                 int layout_cr, const HT* __restrict__ h,
                 const float* __restrict__ a_src, const float* __restrict__ a_dst,
                 const float* __restrict__ msrc, const float* __restrict__ pan_s,
                 const float* __restrict__ pan_d, float* __restrict__ out, int R, int C,
                 int HD, int H, int CC, int64_t n_h, int64_t n_a, int64_t n_ps,
                 int64_t n_pd, int64_t n_out, float slope) {
  extern __shared__ __align__(16) float smem[];
  const int W = HD + H, D = HD / H, CP = CC + PAD;
  float* acc = smem;              // [BM, W]
  float* as = acc + BM * W;       // [CC, H]
  float* ad = as + CC * H;        // [BM, H]
  float* bnd = ad + BM * H;       // [BM, H]; PANEL: E1d of the rows
  float* es = bnd + BM * H;       // PANEL: [CC, 2H] E1s | E2s of the chunk
  float* e2d = es + (PANEL ? CC * 2 * H : 0);   // PANEL: [BM, H]
  float* mk = e2d + (PANEL ? BM * H : 0);       // [BM, CC] counts
  float* hs = mk + BM * CC;       // FMA: [CC, HD]
  float* p = hs + CC * HD;        // FMA: [H, BM, CC]
  __nv_bfloat16* hsT = reinterpret_cast<__nv_bfloat16*>(mk + BM * CC);  // MMA: [HD, CP]
  __nv_bfloat16* pb = hsT + HD * CP;                                    // MMA: [H, BM, CP]
  const int* seg = segments + 3 * blockIdx.x;
  const int rb = seg[0], k_begin = seg[1], k_end = seg[2];
  const int r0 = blockIdx.y * BM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t row0 = static_cast<int64_t>(rb) * R + r0;

  for (int i = tid; i < BM * W; i += THREADS) acc[i] = 0.f;
  for (int i = tid; i < BM * H; i += THREADS) {
    const int r = i / H, hh = i % H;
    const int64_t row = row0 + r;
    if constexpr (PANEL) {
      const bool ok = r0 + r < R && row < n_pd;
      const float* pr = pan_d + row * 3 * H;
      ad[i] = ok ? pr[2 * H + hh] : 0.f;
      bnd[i] = ok ? pr[hh] : 0.f;
      e2d[i] = ok ? pr[H + hh] : 0.f;
    } else {
      const float a = (r0 + r < R && row < n_a) ? a_dst[row * H + hh] : 0.f;
      ad[i] = a;
      bnd[i] = leaky(msrc[hh] + a, slope);
    }
  }
  __syncthreads();

  for (int k = k_begin; k < k_end; ++k) {
    const int b = row_blocks[k];
    const int64_t col0 = static_cast<int64_t>(blk_cb[b]) * C;
    const VT* A = values + static_cast<int64_t>(b) * R * C;
    for (int c0 = 0; c0 < C; c0 += CC) {
      for (int i = tid; i < CC * HD; i += THREADS) {
        const int c = i / HD, f = i % HD;
        const int64_t col = col0 + c0 + c;
        const bool ok = c0 + c < C && col < n_h;
        if constexpr (MMA)
          hsT[f * CP + c] = ok ? h[col * HD + f] : __float2bfloat16_rn(0.f);
        else
          hs[i] = ok ? to_f(h[col * HD + f]) : 0.f;
      }
      for (int i = tid; i < CC * H; i += THREADS) {
        const int c = i / H, hh = i % H;
        const int64_t col = col0 + c0 + c;
        as[i] = (c0 + c < C && col < n_a) ? a_src[col * H + hh] : 0.f;
        if constexpr (PANEL) {
          const bool ok = c0 + c < C && col < n_ps;
          es[c * 2 * H + hh] = ok ? pan_s[col * 2 * H + hh] : 0.f;
          es[c * 2 * H + H + hh] = ok ? pan_s[col * 2 * H + H + hh] : 0.f;
        }
      }
      // counts: walk the layout's contiguous axis fastest
      for (int i = tid; i < BM * CC; i += THREADS) {
        int r, c;
        if (layout_cr) { c = i / BM; r = i % BM; } else { r = i / CC; c = i % CC; }
        const int rr = r0 + r, cc = c0 + c;
        float v = 0.f;
        if (rr < R && cc < C)
          v = to_f(layout_cr ? A[static_cast<int64_t>(cc) * R + rr]
                             : A[static_cast<int64_t>(rr) * C + cc]);
        mk[r * CC + c] = v;
      }
      __syncthreads();
      // p per (head, row, column); den: the CC lanes of one (head, row)
      // are consecutive (CC divides 32), so a segmented warp sum adds them
      for (int i = tid; i < H * BM * CC; i += THREADS) {
        const int hh = i / (BM * CC), r = (i / CC) % BM, c = i % CC;
        const float cnt = mk[r * CC + c];
        float v = 0.f;
        if (cnt != 0.f) {
          if constexpr (PANEL) {
            const bool pos = as[c * H + hh] + ad[r * H + hh] >= 0.f;
            v = cnt * (pos ? es[c * 2 * H + hh] * bnd[r * H + hh]
                           : es[c * 2 * H + H + hh] * e2d[r * H + hh]);
          } else {
            const float z = leaky(as[c * H + hh] + ad[r * H + hh], slope) - bnd[r * H + hh];
            v = cnt * expf(fminf(z, 60.f));
          }
        }
        if constexpr (MMA)
          pb[(hh * BM + r) * CP + c] = __float2bfloat16_rn(v);
        else
          p[i] = v;
        float sum = v;
        for (int o = CC / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (c == 0) acc[r * W + HD + hh] += sum;
      }
      __syncthreads();
      if constexpr (MMA) {
        // items: 4 m-tiles (16 rows) x per-head n-tiles (8 columns of one
        // head); each item owns its accumulator cells
        const int g = lane >> 2, tq = lane & 3;
        const int ntph = (D + 7) / 8;
        for (int item = warp; item < 4 * H * ntph; item += THREADS / 32) {
          const int mt = item % 4, nt = item / 4;
          const int hh = nt / ntph, n = (nt % ntph) * 8 + g;  // head-local column
          const __nv_bfloat16* pr = pb + (hh * BM + mt * 16 + g) * CP;
          const __nv_bfloat16* hc = hsT + (hh * D + n) * CP;
          float c4[4] = {0.f, 0.f, 0.f, 0.f};
          for (int kk = 0; kk < CC; kk += 16) {
            const uint32_t b0 = n < D ? gta::ld32(hc + kk + 2 * tq) : 0u;
            const uint32_t b1 = n < D ? gta::ld32(hc + kk + 2 * tq + 8) : 0u;
            gta::mma_bf16(c4, gta::ld32(pr + kk + 2 * tq), gta::ld32(pr + 8 * CP + kk + 2 * tq),
                          gta::ld32(pr + kk + 2 * tq + 8), gta::ld32(pr + 8 * CP + kk + 2 * tq + 8),
                          b0, b1);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = mt * 16 + g + (i >= 2 ? 8 : 0);
            const int col = (nt % ntph) * 8 + 2 * tq + (i & 1);
            if (col < D) acc[r * W + hh * D + col] += c4[i];
          }
        }
      } else {
        for (int i = tid; i < BM * HD; i += THREADS) {
          const int r = i / HD, f = i % HD;
          const float* pr = p + ((f / D) * BM + r) * CC;
          const float* hc = hs + f;
          float s = acc[r * W + f];
          for (int c = 0; c < CC; ++c) s = fmaf(round_to<HT>(pr[c]), hc[c * HD], s);
          acc[r * W + f] = s;
        }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < BM * W; i += THREADS) {
    const int r = i / W;
    const int64_t row = row0 + r;
    if (r0 + r < R && row < n_out) atomicAdd(out + row * W + i % W, acc[i]);
  }
}

// ---- bf16 h: wgmma with p formed in registers ------------------------------

constexpr int WG_ROWS = 256;     // rows of a row block per CUDA block
constexpr int WG_THREADS = 512;  // four warpgroups, 64 rows each
constexpr int STAGES = 3;        // ring depth: two chunks in flight
constexpr int KC = 64;           // columns per k-chunk: one 128-byte h row
constexpr int MAX_SEG = 16;      // graph.DENSE_WIDE_SEGMENT: ids kept in shared memory

// a stage's count tile (bytes): 'cr' [KC cols][256 rows], 'rc' [256 rows][KC
// cols], the row strides padded by 16 bytes so a fragment's loads hit
// distinct banks; the tile takes the larger layout
template <typename VT> struct CountTile {
  static constexpr int SZ = static_cast<int>(sizeof(VT));
  static constexpr int CR_STRIDE = WG_ROWS * SZ + 16;
  static constexpr int RC_STRIDE = KC * SZ + 16;
  static constexpr int BYTES =
      KC * CR_STRIDE > WG_ROWS * RC_STRIDE ? KC * CR_STRIDE : WG_ROWS * RC_STRIDE;
};

// a stage: the h panel (H N rows of 128 bytes, K-major, 128-byte swizzle),
// the count tile, then K4: a_s of the chunk [KC][H] f32; K15: a_s, E1s and
// E2s of the chunk [3][KC][H] f32; a multiple of 1 KB so every stage's panel starts
// on a swizzle atom.  After the ring, per row of the 256, [H] f32 each: K4
// a_d and the bound (log2(e)-scaled); K15 the raw a_d, E1d and E2d.  The
// launch adds 1 KB for aligning the ring (compiler/schedule.
// _dense_attention_smem mirrors this).
template <typename VT, int H, int N, bool PANEL>
__host__ __device__ constexpr int stage_bytes() {
  return (H * N * 128 + CountTile<VT>::BYTES + KC * 4 * (PANEL ? 3 : 1) * H + 1023) /
         1024 * 1024;
}
template <typename VT, int H, int N, bool PANEL>
__host__ __device__ constexpr int wgmma_smem() {
  return STAGES * stage_bytes<VT, H, N, PANEL>() + 1024 + (PANEL ? 3 : 2) * WG_ROWS * H * 4;
}

// PANEL (K15): a_dst, msrc and slope are not read; pan_s [n_ps, 2H] and
// pan_d [n_pd, 3H] are (K4 passes null panels)
template <typename VT, int H, int N, bool PANEL>
__global__ void __launch_bounds__(WG_THREADS, 1)
gat_dense_wgmma_kernel(const int* __restrict__ segments, const int* __restrict__ row_blocks,
                       const int* __restrict__ blk_cb, const VT* __restrict__ values,
                       int layout_cr, const __nv_bfloat16* __restrict__ hT, int64_t ld_h,
                       const float* __restrict__ a_src, const float* __restrict__ a_dst,
                       const float* __restrict__ msrc, const float* __restrict__ pan_s,
                       const float* __restrict__ pan_d, float* __restrict__ out, int R, int C,
                       int HD, int64_t n_a, int64_t n_ps, int64_t n_pd, int64_t n_out,
                       float slope) {
  using CT = CountTile<VT>;
  constexpr int SZ = CT::SZ, B_BYTES = H * N * 128, SB = stage_bytes<VT, H, N, PANEL>();
  extern __shared__ __align__(1024) char smem_raw[];
  __shared__ int s_b[MAX_SEG];                     // the run's block ids
  __shared__ int64_t s_col0[MAX_SEG];              // and their first columns
  // the ring starts on a 1 KB boundary (the launch adds 1 KB for this)
  const uint32_t raw0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t pad = (1024u - (raw0 & 1023u)) & 1023u;
  const uint32_t smem0 = raw0 + pad;
  char* smem = smem_raw + pad;
  // the rows' terms [256][H] each: K4 a_d, bound; K15 a_d, E1d, E2d
  float* s_ad = reinterpret_cast<float*>(smem + STAGES * SB);
  float* s_bnd = s_ad + WG_ROWS * H;
  float* s_e2d = s_bnd + WG_ROWS * H;              // PANEL only
  const int* seg = segments + 3 * blockIdx.x;
  const int rb = seg[0], k_begin = seg[1], k_end = seg[2];
  const int r_base = blockIdx.y * WG_ROWS;
  const int rows_here = min(WG_ROWS, R - r_base);
  const int64_t row_base = static_cast<int64_t>(rb) * R + r_base;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2;                        // warpgroup: rows 64 wg ..
  const bool active = wg * 64 < rows_here;         // uniform per warpgroup
  const int cpb = (C + KC - 1) / KC;               // k-chunks per dense block
  const int iters = (k_end - k_begin) * cpb;
  const int D = HD / H, W = HD + H;
  if (tid < k_end - k_begin) {  // at most MAX_SEG (the launch checks)
    const int b = row_blocks[k_begin + tid];
    s_b[tid] = b;
    s_col0[tid] = static_cast<int64_t>(blk_cb[b]) * C;
  }
  for (int i = tid; i < WG_ROWS * H; i += WG_THREADS) {
    const int r = i / H, hh = i % H;
    const int64_t row = row_base + r;
    if constexpr (PANEL) {
      const bool ok = r < rows_here && row < n_pd;
      const float* pr = pan_d + row * 3 * H;
      s_ad[i] = ok ? pr[2 * H + hh] : 0.f;
      s_bnd[i] = ok ? pr[hh] : 0.f;
      s_e2d[i] = ok ? pr[H + hh] : 0.f;
    } else {
      const float a = (r < rows_here && row < n_a) ? a_dst[row * H + hh] : 0.f;
      s_ad[i] = a * LOG2E;
      s_bnd[i] = leaky(msrc[hh] + a, slope) * LOG2E;
    }
  }
  __syncthreads();

  auto load_stage = [&](int it, int stage) {
    const int kk = it / cpb, c0 = (it % cpb) * KC;
    const int64_t col0 = s_col0[kk];
    const VT* A = values + static_cast<int64_t>(s_b[kk]) * R * C;
    const uint32_t sp = smem0 + stage * SB;          // h panel
    const uint32_t sa = sp + B_BYTES;                // counts
    const uint32_t ss = sa + CT::BYTES;              // a_s, or the column terms
    for (int c = tid; c < H * N * 8; c += WG_THREADS) {
      const int n = c >> 3, j = c & 7;
      const bool ok = c0 + 8 * j < C;
      const __nv_bfloat16* src = ok ? hT + n * ld_h + col0 + c0 + 8 * j : hT;
      gta::cp_async16(sp + gta::panel_offset(n, j), src, ok ? 16 : 0);
    }
    constexpr int EPC = 16 / SZ;                     // values per copy
    if (layout_cr) {  // [C][R]: KC count rows of 256 values
      constexpr int UPR = WG_ROWS / EPC;
      for (int c = tid; c < KC * UPR; c += WG_THREADS) {
        const int cc = c / UPR, r = (c % UPR) * EPC;
        const bool ok = c0 + cc < C && r < rows_here;
        const VT* src = ok ? A + static_cast<int64_t>(c0 + cc) * R + r_base + r : values;
        gta::cp_async16(sa + cc * CT::CR_STRIDE + r * SZ, src, ok ? 16 : 0);
      }
    } else {          // [R][C]: 256 rows of KC values
      constexpr int UPR = KC / EPC;
      for (int c = tid; c < WG_ROWS * UPR; c += WG_THREADS) {
        const int r = c / UPR, cc = (c % UPR) * EPC;
        const bool ok = r < rows_here && c0 + cc < C;
        const VT* src = ok ? A + static_cast<int64_t>(r_base + r) * C + c0 + cc : values;
        gta::cp_async16(sa + r * CT::RC_STRIDE + cc * SZ, src, ok ? 16 : 0);
      }
    }
    if constexpr (PANEL) {  // a_s, E1s and E2s of each column and head
      for (int c = tid; c < KC * H * 3; c += WG_THREADS) {
        const int cc = c / (3 * H), hh = (c / 3) % H, w = c % 3;
        const int64_t col = col0 + c0 + cc;
        const bool ok = c0 + cc < C && col < (w == 0 ? n_a : n_ps);
        const float* src =
            w == 0 ? a_src + col * H + hh : pan_s + col * 2 * H + (w - 1) * H + hh;
        gta::cp_async4(ss + 4 * (w * KC * H + cc * H + hh), ok ? src : a_src,
                       ok ? 4 : 0);
      }
    } else {
      for (int c = tid; c < KC * H; c += WG_THREADS) {
        const int64_t col = col0 + c0 + c / H;
        const bool ok = c0 + c / H < C && col < n_a;
        gta::cp_async4(ss + 4 * c, ok ? a_src + col * H + c % H : a_src, ok ? 4 : 0);
      }
    }
  };

  const int g = lane >> 2, t = lane & 3;
  const int ra = wg * 64 + (warp & 3) * 16 + g;    // this thread's rows ra, ra + 8
  // byte offsets of this thread's fragment cells in the count tile: rows
  // ra + 8v, columns 2t + {0, 1, 8, 9} of each 16-column step
  const int sr = layout_cr ? SZ : CT::RC_STRIDE, sc = layout_cr ? CT::CR_STRIDE : SZ;
  int off[2][4];
#pragma unroll
  for (int v = 0; v < 2; ++v)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      off[v][q] = (ra + 8 * v) * sr + (2 * t + (q & 1) + 8 * (q >> 1)) * sc;
  const float clamp = 60.f * LOG2E;

  float acc[H][N / 2];
  float den[2][H];
#pragma unroll
  for (int hh = 0; hh < H; ++hh) {
    den[0][hh] = den[1][hh] = 0.f;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[hh][i] = 0.f;
  }
  uint32_t frag[2][4];  // two A fragments in rotation

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < iters) load_stage(s, s);
    gta::cp_async_commit();
  }
  for (int it = 0; it < iters; ++it) {
    gta::cp_async_wait<STAGES - 2>();
    gta::fence_proxy_async();
    __syncthreads();  // chunk `it` landed for all; stage (it - 1) is free
    if (it + STAGES - 1 < iters) load_stage(it + STAGES - 1, (it + STAGES - 1) % STAGES);
    gta::cp_async_commit();
    if (!active) continue;
    const int st = it % STAGES;
    const char* tile = smem + st * SB + B_BYTES;
    const float* as = reinterpret_cast<const float*>(tile + CT::BYTES);
    const uint32_t sp = smem0 + st * SB;
#pragma unroll
    for (int hh = 0; hh < H; ++hh) {
      // K4: a_d and bound; K15: a_d, E1d and E2d of rows ra, ra + 8
      const float ad[2] = {s_ad[ra * H + hh], s_ad[(ra + 8) * H + hh]};
      const float bd[2] = {s_bnd[ra * H + hh], s_bnd[(ra + 8) * H + hh]};
      float e2d[2] = {0.f, 0.f};
      if constexpr (PANEL) {
        e2d[0] = s_e2d[ra * H + hh];
        e2d[1] = s_e2d[(ra + 8) * H + hh];
      }
#pragma unroll
      for (int s = 0; s < KC / 16; ++s) {
        const char* ts = tile + 16 * s * sc;
        float p[2][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int col = 16 * s + 2 * t + (q & 1) + 8 * (q >> 1);
          float4 ct;  // K4: a_s; K15: {a_s, E1s, E2s}
          ct.x = as[col * H + hh];
          if constexpr (PANEL) {
            ct.y = as[KC * H + col * H + hh];
            ct.z = as[2 * KC * H + col * H + hh];
          }
          const float a_s = ct.x;
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            if constexpr (PANEL) {
              // the branch test in float32 on the raw logits, as the plain
              // version; then count * (column term * row term)
              const bool pos = a_s + ad[v] >= 0.f;
              const float e = pos ? ct.y * bd[v] : ct.z * e2d[v];
              p[v][q] = count_f(ts + off[v][q], VT()) * e;
            } else {
              const float z = leaky(fmaf(a_s, LOG2E, ad[v]), slope) - bd[v];
              p[v][q] = count_f(ts + off[v][q], VT()) * ex2(fminf(z, clamp));
            }
            den[v][hh] += p[v][q];
          }
        }
        uint32_t* a = frag[(hh * (KC / 16) + s) & 1];
        gta::wgmma_wait<1>();  // the product that read this set is done
        a[0] = gta::pack_bf16(p[0][0], p[0][1]);
        a[1] = gta::pack_bf16(p[1][0], p[1][1]);
        a[2] = gta::pack_bf16(p[0][2], p[0][3]);
        a[3] = gta::pack_bf16(p[1][2], p[1][3]);
        gta::wgmma_fence();
        gta::wgmma_rs<N, 0>(acc[hh], a,
                            gta::smem_desc(sp + hh * N * 128 + 32 * s, 16, 1024));
        gta::wgmma_commit();
      }
    }
    gta::wgmma_wait<0>();  // before the stage is refilled
#pragma unroll
    for (int hh = 0; hh < H; ++hh)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) gta::fence_reg(acc[hh][i]);
  }
  gta::cp_async_wait<0>();
  if (!active) return;
  // acc[hh][4j + 2v + u] = num[ra + 8v][hh D + 8j + 2t + u]
  const bool pair = W % 2 == 0 && (D % 2 == 0 || H == 1);
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    const int r = ra + 8 * v;
    const int64_t row = row_base + r;
    const bool ok = r < rows_here && row < n_out;
    float* orow = out + row * W;
#pragma unroll
    for (int hh = 0; hh < H; ++hh) {
      float dsum = den[v][hh];
      dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
      dsum += __shfl_xor_sync(0xffffffffu, dsum, 2);
      if (!ok) continue;
      if (t == 0) atomicAdd(orow + HD + hh, dsum);
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int col = 8 * j + 2 * t;
        const float v0 = acc[hh][4 * j + 2 * v], v1 = acc[hh][4 * j + 2 * v + 1];
        float* o = orow + hh * D + col;
        if (pair && col + 1 < D) {
          atomicAdd(reinterpret_cast<float2*>(o), make_float2(v0, v1));
        } else {
          if (col < D) atomicAdd(o, v0);
          if (col + 1 < D) atomicAdd(o + 1, v1);
        }
      }
    }
  }
}

// the arguments of one launch, K4's or K15's.  The bf16 paths on wgmma read
// h as the transposed panel hT [H N, ld_h] (see the design note) and
// segments as runs of at most seg_cap <= MAX_SEG blocks; smem is the size
// the wrapper computed (compiler/schedule._dense_attention_smem), which the
// launch checks against the chosen path's layout.
struct Args {
  const int *sg, *rbk, *cb;
  const void *v, *h;
  void* panel;
  int layout_cr;
  const float *as, *ad, *ms, *ps, *pd;
  float* out;
  int n_seg, seg_cap, R, C, HD, H;
  int64_t ld_h, n_h, n_a, n_ps, n_pd, n_out;
  size_t smem;
  float slope;
  cudaStream_t st;
};

template <typename VT, typename HT, bool MMA, bool PANEL>
cudaError_t launch(const Args& a, int CC) {
  const size_t smem = smem_bytes(a.HD, a.H, CC, MMA, PANEL);
  if (a.smem != smem) return cudaErrorInvalidValue;
  auto k = gat_dense_kernel<VT, HT, MMA, PANEL>;
  cudaError_t err = gta::set_smem(k, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.n_seg, (a.R + BM - 1) / BM);
  k<<<grid, THREADS, smem, a.st>>>(a.sg, a.rbk, a.cb, static_cast<const VT*>(a.v),
                                   a.layout_cr, static_cast<const HT*>(a.h), a.as, a.ad,
                                   a.ms, a.ps, a.pd, a.out, a.R, a.C, a.HD, a.H, CC, a.n_h,
                                   a.n_a, a.n_ps, a.n_pd, a.n_out, a.slope);
  return cudaGetLastError();
}

template <typename VT, int H, int N, bool PANEL>
cudaError_t launch_wgmma_hn(const Args& a) {
  constexpr size_t smem = wgmma_smem<VT, H, N, PANEL>();
  if (a.smem != smem) return cudaErrorInvalidValue;  // the wrapper's size is the ring's
  auto k = gat_dense_wgmma_kernel<VT, H, N, PANEL>;
  cudaError_t err = gta::set_smem(k, smem);
  if (err != cudaSuccess) return err;
  auto pan = static_cast<__nv_bfloat16*>(a.panel);
  err = gta::write_head_panel(static_cast<const __nv_bfloat16*>(a.h), pan, a.n_h, a.HD, H,
                              N, a.ld_h, a.st);
  if (err != cudaSuccess) return err;
  dim3 grid(a.n_seg, (a.R + WG_ROWS - 1) / WG_ROWS);
  k<<<grid, WG_THREADS, smem, a.st>>>(
      a.sg, a.rbk, a.cb, static_cast<const VT*>(a.v), a.layout_cr, pan, a.ld_h, a.as, a.ad,
      a.ms, a.ps, a.pd, a.out, a.R, a.C, a.HD, a.n_a, a.n_ps, a.n_pd, a.n_out, a.slope);
  return cudaGetLastError();
}

template <typename VT, bool PANEL>
cudaError_t launch_wgmma(const Args& a, int N) {
  // 16-byte copies of count rows (R or C a multiple of 16) and hT rows
  if (a.R % 16 != 0 || a.C % 16 != 0 || a.ld_h % 8 != 0 || a.panel == nullptr ||
      (reinterpret_cast<uintptr_t>(a.panel) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(a.v) & 15) != 0)
    return cudaErrorInvalidValue;
  if (a.seg_cap > MAX_SEG) return cudaErrorInvalidValue;  // runs' ids in shared memory
  switch (a.H * 1000 + N) {
    case 1008: return launch_wgmma_hn<VT, 1, 8, PANEL>(a);
    case 1032: return launch_wgmma_hn<VT, 1, 32, PANEL>(a);
    case 1048: return launch_wgmma_hn<VT, 1, 48, PANEL>(a);
    case 1064: return launch_wgmma_hn<VT, 1, 64, PANEL>(a);
    case 1128: return launch_wgmma_hn<VT, 1, 128, PANEL>(a);
    case 2008: return launch_wgmma_hn<VT, 2, 8, PANEL>(a);
    case 2032: return launch_wgmma_hn<VT, 2, 32, PANEL>(a);
    case 2048: return launch_wgmma_hn<VT, 2, 48, PANEL>(a);
    case 2064: return launch_wgmma_hn<VT, 2, 64, PANEL>(a);
    case 4008: return launch_wgmma_hn<VT, 4, 8, PANEL>(a);
    case 4032: return launch_wgmma_hn<VT, 4, 32, PANEL>(a);
    case 8008: return launch_wgmma_hn<VT, 8, 8, PANEL>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename VT, typename HT, bool PANEL>
cudaError_t launch_h(const Args& a) {
  if (a.n_seg == 0) return cudaSuccess;
  if constexpr (std::is_same_v<HT, __nv_bfloat16>) {
    const int N = gta::wgmma_width(a.H, a.HD / a.H);
    if (N > 0) return launch_wgmma<VT, PANEL>(a, N);
  }
  // column chunk: the p panel [H, 64, CC] at or under 32 KB of f32
  int CC = 32;
  while (CC > 4 && static_cast<size_t>(a.H) * BM * CC * 4 > 32 * 1024) CC /= 2;
  if constexpr (std::is_same_v<HT, __nv_bfloat16>) {
    if (CC % 16 == 0) return launch<VT, HT, true, PANEL>(a, CC);
  }
  return launch<VT, HT, false, PANEL>(a, CC);
}

// values are int8 counts or of h's dtype (the wrappers check)
template <bool PANEL>
int dispatch(const Args& a, int v_dtype, int h_dtype) {
  if (a.smem == 0 || (v_dtype != gta::I8 && v_dtype != h_dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool hb = h_dtype == gta::BF16;
  cudaError_t err;
  if (v_dtype == gta::I8 && hb)
    err = launch_h<int8_t, __nv_bfloat16, PANEL>(a);
  else if (v_dtype == gta::I8)
    err = launch_h<int8_t, float, PANEL>(a);
  else if (hb)
    err = launch_h<__nv_bfloat16, __nv_bfloat16, PANEL>(a);
  else
    err = launch_h<float, float, PANEL>(a);
  return static_cast<int>(err);
}

}  // namespace

// K4 and K15 take the same split.  h [n_h, HD].  bf16 h on the wgmma path
// (compiler/schedule._gat_wgmma_width > 0): `panel` is the wrapper's bf16
// scratch [H N, ld_p] (ld_p a multiple of 8 covering every column block)
// that head_panel_kernel fills first, and segments are the wide ones (at
// most seg_cap = DENSE_WIDE_SEGMENT blocks); otherwise panel is unused and
// the segments hold at most DENSE_SEGMENT.  smem: compiler/schedule
// ._dense_attention_smem, checked against the chosen path's layout.
extern "C" int gta_gat_dense_blocks(const void* segments, const void* row_blocks,
                                    const void* blk_cb, const void* values,
                                    int v_dtype, int layout_cr, const void* h,
                                    int h_dtype, void* panel, int64_t ld_p,
                                    const void* a_src,
                                    const void* a_dst, const void* msrc, void* out,
                                    int n_seg, int seg_cap, int R, int C, int HD, int H,
                                    int64_t n_h, int64_t n_a, int64_t n_out, int64_t smem,
                                    float slope, void* stream) {
  const Args a{static_cast<const int*>(segments), static_cast<const int*>(row_blocks),
               static_cast<const int*>(blk_cb), values, h, panel, layout_cr,
               static_cast<const float*>(a_src), static_cast<const float*>(a_dst),
               static_cast<const float*>(msrc), nullptr, nullptr, static_cast<float*>(out),
               n_seg, seg_cap, R, C, HD, H, ld_p, n_h, n_a, 0, 0, n_out,
               static_cast<size_t>(smem), slope, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, v_dtype, h_dtype);
}

// K15: as K4 with the exp panels pan_s [n_ps, 2H], pan_d [n_pd, 3H] in place
// of a_dst and msrc
extern "C" int gta_gat_dense_panel(const void* segments, const void* row_blocks,
                                   const void* blk_cb, const void* values, int v_dtype,
                                   int layout_cr, const void* h, int h_dtype, void* panel,
                                   int64_t ld_p, const void* a_src, const void* pan_s,
                                   const void* pan_d, void* out, int n_seg, int seg_cap,
                                   int R, int C, int HD, int H, int64_t n_h, int64_t n_a,
                                   int64_t n_ps, int64_t n_pd, int64_t n_out, int64_t smem,
                                   void* stream) {
  const Args a{static_cast<const int*>(segments), static_cast<const int*>(row_blocks),
               static_cast<const int*>(blk_cb), values, h, panel, layout_cr,
               static_cast<const float*>(a_src), nullptr, nullptr,
               static_cast<const float*>(pan_s), static_cast<const float*>(pan_d),
               static_cast<float*>(out), n_seg, seg_cap, R, C, HD, H, ld_p, n_h, n_a, n_ps,
               n_pd, n_out, static_cast<size_t>(smem), 0.f, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, v_dtype, h_dtype);
}
