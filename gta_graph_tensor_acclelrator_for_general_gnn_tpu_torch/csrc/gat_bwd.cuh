// The GAT attention backward kernels K5-K8: the per-edge chain and the two
// edge walks they share.  Each kernel's .cu holds only its accumulate step
// (an ``Acc`` type) and its C entry point.
//
// Every one of them walks edges s -> d (tail slots or nonzero dense
// cells) with one warp per edge at a time and, per head, recomputes the
// forward's weight from the saved combined denominator and forms the
// softmax-and-leaky_relu chain:
//   te    = <gbar[d], h[s]>                   (per head, over its D features)
//   p     = exp(min(leaky(a_s[s] + a_d[d]) - leaky(msrc + a_d[d]), 60))
//   alpha = p * mult / den[d]
//   dz    = alpha * (te - s2[d]) * leaky'(a_s[s] + a_d[d])
// in the order of operations of the TPU kernels.  A warp holds a node's
// HD features lane-strided: lane l holds features l, l + 32, ... (HD <= 256).
// The side panel [N, 4H] float32 packs [a_s | a_d | 1/den | s2] per node.
//
// ``Acc::SRC`` says which end of an edge the walked rows are: false for
// the forward split (rows = receivers d; K5, K7 sum dad there), true for
// the transposed split (rows = original senders s; K6, K8 sum [das | dh]).
#pragma once
#include "wgmma.cuh"

namespace gta {

constexpr int BWD_MAXF = 8;  // features per lane: HD <= 256

// head of each of this lane's features (-1 past HD)
__device__ __forceinline__ void lane_heads(int HD, int D, int lane, int* hk) {
#pragma unroll
  for (int k = 0; k < BWD_MAXF; ++k) {
    const int f = lane + 32 * k;
    hk[k] = f < HD ? f / D : -1;
  }
}

// a node's features, lane-strided, as float32
template <typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ p, int HD, int lane,
                                         float* v) {
#pragma unroll
  for (int k = 0; k < BWD_MAXF; ++k) {
    const int f = lane + 32 * k;
    v[k] = f < HD ? to_f(p[f]) : 0.f;
  }
}

// per-head dot product of two lane-strided rows: lane hh < H returns head
// hh's sum (float32, warp-reduced); every lane must call it
__device__ __forceinline__ float head_dot(const float* a, const float* b, const int* hk,
                                          int H, int lane) {
  float mine = 0.f;
  for (int hh = 0; hh < H; ++hh) {
    float part = 0.f;
#pragma unroll
    for (int k = 0; k < BWD_MAXF; ++k)
      if (hk[k] == hh) part = fmaf(a[k], b[k], part);
    part = warp_sum(part);
    if (lane == hh) mine = part;
  }
  return mine;
}

// alpha and dz of one edge and head
__device__ __forceinline__ void edge_grad(float as, float ad, float rden, float s2,
                                          float ms, float mult, float te, float slope,
                                          float& alpha, float& dz) {
  const float lraw = as + ad;
  const float p = expf(fminf(leaky(lraw, slope) - leaky(ms + ad, slope), 60.f));
  alpha = p * mult * rden;
  dz = alpha * (te - s2) * (lraw >= 0.f ? 1.f : slope);
}

inline bool bwd_shape_ok(int HD, int H) {
  return HD <= 32 * BWD_MAXF && H > 0 && H <= 32 && HD % H == 0;
}

// ---------------------------------------------------------------------------
// The tail walk (K5, K6): K3's design.  One warp per tile, so the work
// spreads evenly whatever the row-block skew; the warp keeps the live slots
// of each 32-slot group by ballot (pad slots and dead tiles, cb < 0, add
// nothing and are never addressed); per live edge the lanes gather h[s] and
// gbar[d] lane-strided, te is a warp reduction per head, lane h runs head
// h's chain, and every lane calls
//   Acc::add<HT>(run, alpha, dz, gbar[d] lane-strided, hk, lane, H)
// (alpha and dz are those of the lane's head for lanes < H, else 0), which
// adds the edge's rounded terms into the register sums of the current run
// of slots with one walked row (the builders sort a tile's slots by
// receiver, the walked row of either split).  When the walked row changes,
// and after the walk,
//   Acc::flush(out, row, run, hk, lane, H, HD)
// adds the run's sums into the zeroed float32 output with one global
// atomic per value (order varies by run: float32 rounding only).  A hub
// row of 2e5 slots thus takes a few hundred atomics of run sums, and a row
// that repeats one edge drifts only over a run, as in gta::gat_walk.
// ---------------------------------------------------------------------------

// The register sums of one run: lane h < H holds head h's, and for the
// source kernel every lane its features' (lane-strided, as the rows).
struct BwdRun {
  float head;
  float feat[BWD_MAXF];
  __device__ __forceinline__ void zero() {
    head = 0.f;
#pragma unroll
    for (int k = 0; k < BWD_MAXF; ++k) feat[k] = 0.f;
  }
};

constexpr int TILE_WARPS = 8;

template <typename Acc, typename HT, typename MT>
__global__ void __launch_bounds__(TILE_WARPS * 32)
gat_bwd_tiles_kernel(const int* __restrict__ tile_rb, const int* __restrict__ tile_cb,
                     const int16_t* __restrict__ src_local,
                     const int16_t* __restrict__ dst_local, const MT* __restrict__ mult,
                     const HT* __restrict__ h, const HT* __restrict__ gbar,
                     const float* __restrict__ side, const float* __restrict__ msrc,
                     float* __restrict__ out, int T, int R, int C, int ET, int HD, int H,
                     int64_t n, float slope) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * TILE_WARPS + (threadIdx.x >> 5);
  if (t >= T) return;
  const int cb = tile_cb[t];
  if (cb < 0) return;  // dead tile
  int hk[BWD_MAXF];
  lane_heads(HD, HD / H, lane, hk);
  const float ms = lane < H ? msrc[lane] : 0.f;
  const int64_t row0 = static_cast<int64_t>(tile_rb[t]) * R;
  const int64_t col0 = static_cast<int64_t>(cb) * C;
  const int64_t base = static_cast<int64_t>(t) * ET;
  const int S = 4 * H;
  BwdRun run;
  run.zero();
  int64_t cur = -1;  // the current run's walked row (the same in every lane)
  for (int e0 = 0; e0 < ET; e0 += 32) {
    const int e = e0 + lane;
    int c = C, r = R;
    float m = 0.f;
    if (e < ET) {
      c = src_local[base + e];
      r = dst_local[base + e];
      m = to_f(mult[base + e]);
    }
    const bool live = c >= 0 && c < C && r >= 0 && r < R && col0 + c < n && row0 + r < n;
    unsigned todo = __ballot_sync(0xffffffffu, live);
    while (todo) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      const int64_t row = row0 + __shfl_sync(0xffffffffu, r, j);
      const int64_t col = col0 + __shfl_sync(0xffffffffu, c, j);
      const int64_t src = Acc::SRC ? row : col;
      const int64_t dst = Acc::SRC ? col : row;
      const float mj = __shfl_sync(0xffffffffu, m, j);
      if (row != cur) {
        if (cur >= 0) Acc::flush(out, cur, run, hk, lane, H, HD);
        cur = row;
        run.zero();
      }
      float hv[BWD_MAXF], gv[BWD_MAXF];
      load_row(h + src * HD, HD, lane, hv);
      load_row(gbar + dst * HD, HD, lane, gv);
      const float te = head_dot(hv, gv, hk, H, lane);
      float alpha = 0.f, dz = 0.f;
      if (lane < H) {
        const float* sd = side + dst * S;
        edge_grad(side[src * S + lane], sd[H + lane], sd[2 * H + lane], sd[3 * H + lane],
                  ms, mj, te, slope, alpha, dz);
      }
      Acc::template add<HT>(run, alpha, dz, gv, hk, lane, H);
    }
  }
  if (cur >= 0) Acc::flush(out, cur, run, hk, lane, H, HD);
}

template <typename Acc, typename HT, typename MT>
cudaError_t launch_tiles(const void* rb, const void* cb, const void* s, const void* d,
                         const void* mult, const void* h, const void* g, const void* side,
                         const void* ms, void* out, int T, int R, int C, int ET, int HD,
                         int H, int64_t n, float slope, void* stream) {
  const int blocks = (T + TILE_WARPS - 1) / TILE_WARPS;
  gat_bwd_tiles_kernel<Acc, HT, MT>
      <<<blocks, TILE_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int*>(rb), static_cast<const int*>(cb),
          static_cast<const int16_t*>(s), static_cast<const int16_t*>(d),
          static_cast<const MT*>(mult), static_cast<const HT*>(h),
          static_cast<const HT*>(g), static_cast<const float*>(side),
          static_cast<const float*>(ms), static_cast<float*>(out), T, R, C, ET, HD, H, n,
          slope);
  return cudaGetLastError();
}

// the body of a tail kernel's C entry point: h in float32 or bf16, the
// slot multiplicities (``mult``) likewise
template <typename Acc>
int tiles_entry(const void* rb, const void* cb, const void* s, const void* d,
                const void* mult, int m_dtype, const void* h, const void* g, int h_dtype,
                const void* side, const void* ms, void* out, int T, int R, int C, int ET,
                int HD, int H, int64_t n, float slope, void* st) {
  if (!bwd_shape_ok(HD, H)) return static_cast<int>(cudaErrorInvalidValue);
  const bool hb = h_dtype == BF16, mb = m_dtype == BF16;
  cudaError_t err;
  if (hb && mb)
    err = launch_tiles<Acc, __nv_bfloat16, __nv_bfloat16>(rb, cb, s, d, mult, h, g, side, ms, out, T, R, C, ET, HD, H, n, slope, st);
  else if (hb)
    err = launch_tiles<Acc, __nv_bfloat16, float>(rb, cb, s, d, mult, h, g, side, ms, out, T, R, C, ET, HD, H, n, slope, st);
  else if (mb)
    err = launch_tiles<Acc, float, __nv_bfloat16>(rb, cb, s, d, mult, h, g, side, ms, out, T, R, C, ET, HD, H, n, slope, st);
  else
    err = launch_tiles<Acc, float, float>(rb, cb, s, d, mult, h, g, side, ms, out, T, R, C, ET, HD, H, n, slope, st);
  return static_cast<int>(err);
}

// ---------------------------------------------------------------------------
// The dense walk (K7, K8), over rb-major 'cr' count blocks (rows r,
// columns c; A[c * R + r]).  The TPU kernels evaluate every cell of a
// 256 x 256 block (an exp per head and a [C, D] x [D, R] product per head)
// because the matrix unit wants dense operands; the blocks hold a few
// percent nonzero cells, so here the work is per nonzero cell: two row
// gathers, HD multiply-adds and H exps.
//
// One CUDA block per (segment, 64-row sub-tile), where a segment is a run
// of at most 8 dense blocks of one row block (DenseBlockGraph.segments, as
// K2 and K4), so hub row blocks spread over the card.  The sub-tile's row
// vectors (gbar[d] for K7, h[s] for K8) and side values are staged in
// shared memory once; per dense block and 64-column chunk the counts are
// staged transposed ([r][c], read coalesced along r from the 'cr' layout);
// each warp owns 8 rows and, per row, keeps the nonzero columns of each
// 32-column group by ballot, gathers the column's vector (h[s] for K7,
// gbar[d] for K8) lane-strided, reduces te per head across the warp, and
// every lane calls
//   Acc::add<HT>(row's accumulator, alpha, dz, column's vector, hk, lane, H)
// on the row's float32 accumulator of Acc::width(H, HD) values in shared
// memory (owned by that warp: no atomics there, a fixed order).  At the end
// the block adds its rows into the zeroed output with float32 atomics (a
// row block's segments meet there; stripes no block visits read 0).  The
// cell's count is its multiplicity.
// ---------------------------------------------------------------------------

constexpr int DENSE_BM = 64, DENSE_CW = 64, DENSE_THREADS = 256;

template <typename Acc>
inline size_t dense_smem_bytes(int HD, int H) {
  return sizeof(float) * (static_cast<size_t>(DENSE_BM) * HD + DENSE_BM * 4 * H +
                          DENSE_BM * (DENSE_CW + 1) +
                          static_cast<size_t>(DENSE_BM) * Acc::width(H, HD));
}

template <typename Acc, typename VT, typename HT>
__global__ void __launch_bounds__(DENSE_THREADS)
gat_dense_bwd_kernel(const int* __restrict__ segments, const int* __restrict__ row_blocks,
                     const int* __restrict__ blk_cb, const VT* __restrict__ values,
                     const HT* __restrict__ h, const HT* __restrict__ gbar,
                     const float* __restrict__ side, const float* __restrict__ msrc,
                     float* __restrict__ out, int R, int C, int HD, int H, int64_t n,
                     float slope) {
  constexpr int BM = DENSE_BM, CW = DENSE_CW, WARPS = DENSE_THREADS / 32;
  extern __shared__ __align__(16) float smem[];
  const int S = 4 * H, W = Acc::width(H, HD);
  const HT* rowvec = Acc::SRC ? h : gbar;  // staged per row
  const HT* colvec = Acc::SRC ? gbar : h;  // gathered per nonzero cell
  float* xr = smem;                  // [BM, HD]  the rows' vectors
  float* rs = xr + BM * HD;          // [BM, 4H]  side values of the rows
  float* cnt = rs + BM * S;          // [BM, CW + 1] counts of the chunk
  float* acc = cnt + BM * (CW + 1);  // [BM, W]
  const int* seg = segments + 3 * blockIdx.x;
  const int rb = seg[0], k_begin = seg[1], k_end = seg[2];
  const int r0 = blockIdx.y * BM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t row0 = static_cast<int64_t>(rb) * R + r0;

  for (int i = tid; i < BM * HD; i += DENSE_THREADS) {
    const int r = i / HD;
    const int64_t row = row0 + r;
    xr[i] = (r0 + r < R && row < n) ? to_f(rowvec[row * HD + i % HD]) : 0.f;
  }
  for (int i = tid; i < BM * S; i += DENSE_THREADS) {
    const int r = i / S;
    const int64_t row = row0 + r;
    rs[i] = (r0 + r < R && row < n) ? side[row * S + i % S] : 0.f;
  }
  for (int i = tid; i < BM * W; i += DENSE_THREADS) acc[i] = 0.f;
  int hk[BWD_MAXF];
  lane_heads(HD, HD / H, lane, hk);
  const float ms = lane < H ? msrc[lane] : 0.f;
  __syncthreads();

  for (int k = k_begin; k < k_end; ++k) {
    const int b = row_blocks[k];
    const int64_t col0 = static_cast<int64_t>(blk_cb[b]) * C;
    const VT* A = values + static_cast<int64_t>(b) * R * C;  // 'cr': A[c * R + r]
    for (int c0 = 0; c0 < C; c0 += CW) {
      for (int i = tid; i < BM * CW; i += DENSE_THREADS) {
        const int c = i / BM, r = i % BM;
        cnt[r * (CW + 1) + c] = (r0 + r < R && c0 + c < C)
            ? to_f(A[static_cast<int64_t>(c0 + c) * R + r0 + r]) : 0.f;
      }
      __syncthreads();
      for (int r = warp; r < BM; r += WARPS) {
        if (r0 + r >= R || row0 + r >= n) continue;
        const float* xrow = xr + r * HD;
        const float* rside = rs + r * S;
        float* arow = acc + r * W;
        for (int cc = 0; cc < CW; cc += 32) {
          const int c = cc + lane;
          const int64_t col = col0 + c0 + c;
          const float v = cnt[r * (CW + 1) + c];
          unsigned todo = __ballot_sync(0xffffffffu, v != 0.f && col < n);
          while (todo) {
            const int j = __ffs(todo) - 1;
            todo &= todo - 1;
            const int64_t cj = col0 + c0 + cc + j;
            const float vj = __shfl_sync(0xffffffffu, v, j);
            float xv[BWD_MAXF], yv[BWD_MAXF];
            load_row(xrow, HD, lane, xv);
            load_row(colvec + cj * HD, HD, lane, yv);
            const float te = head_dot(xv, yv, hk, H, lane);
            float alpha = 0.f, dz = 0.f;
            if (lane < H) {
              const float* cside = side + cj * S;
              const float* sside = Acc::SRC ? rside : cside;  // the sender's
              const float* dside = Acc::SRC ? cside : rside;  // the receiver's
              edge_grad(sside[lane], dside[H + lane], dside[2 * H + lane],
                        dside[3 * H + lane], ms, vj, te, slope, alpha, dz);
            }
            Acc::template add<HT>(arow, alpha, dz, yv, hk, lane, H);
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < BM * W; i += DENSE_THREADS) {
    const int r = i / W;
    const int64_t row = row0 + r;
    if (r0 + r < R && row < n) atomicAdd(out + row * W + i % W, acc[i]);
  }
}

template <typename Acc, typename VT, typename HT>
cudaError_t launch_dense(const void* sg, const void* rbk, const void* cb, const void* v,
                         const void* h, const void* g, const void* side, const void* ms,
                         void* out, int n_seg, int R, int C, int HD, int H, int64_t n,
                         float slope, void* stream) {
  const size_t smem = dense_smem_bytes<Acc>(HD, H);
  auto k = gat_dense_bwd_kernel<Acc, VT, HT>;
  cudaError_t err = set_smem(k, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n_seg, (R + DENSE_BM - 1) / DENSE_BM);
  k<<<grid, DENSE_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(sg), static_cast<const int*>(rbk),
      static_cast<const int*>(cb), static_cast<const VT*>(v), static_cast<const HT*>(h),
      static_cast<const HT*>(g), static_cast<const float*>(side),
      static_cast<const float*>(ms), static_cast<float*>(out), R, C, HD, H, n, slope);
  return cudaGetLastError();
}

// the body of a dense kernel's C entry point: values int8 counts or of
// h's dtype (the wrapper checks), h float32 or bf16
template <typename Acc>
int dense_entry(const void* sg, const void* rbk, const void* cb, const void* v,
                int v_dtype, const void* h, const void* g, int h_dtype, const void* side,
                const void* ms, void* out, int n_seg, int R, int C, int HD, int H,
                int64_t n, float slope, void* st) {
  if (v_dtype != I8 && v_dtype != h_dtype) return static_cast<int>(cudaErrorInvalidValue);
  if (!bwd_shape_ok(HD, H)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_seg == 0) return 0;
  const bool hb = h_dtype == BF16;
  cudaError_t err;
  if (v_dtype == I8 && hb)
    err = launch_dense<Acc, int8_t, __nv_bfloat16>(sg, rbk, cb, v, h, g, side, ms, out, n_seg, R, C, HD, H, n, slope, st);
  else if (v_dtype == I8)
    err = launch_dense<Acc, int8_t, float>(sg, rbk, cb, v, h, g, side, ms, out, n_seg, R, C, HD, H, n, slope, st);
  else if (hb)
    err = launch_dense<Acc, __nv_bfloat16, __nv_bfloat16>(sg, rbk, cb, v, h, g, side, ms, out, n_seg, R, C, HD, H, n, slope, st);
  else
    err = launch_dense<Acc, float, float>(sg, rbk, cb, v, h, g, side, ms, out, n_seg, R, C, HD, H, n, slope, st);
  return static_cast<int>(err);
}

// ---------------------------------------------------------------------------
// The dense tensor-core stage: K8's bf16 path (gat_dense_bwd_src.cu), written
// for K7 to share.  A warpgroup owns 64 rows of a stripe.  Per 64-column
// k-chunk of a dense block and per head, on wgmma m64n64k16 (bf16 operands,
// float32 sums, the TPU kernel's precision):
//   te[row, col] = <rowvec[row], colvec[col]>   over the head's D features,
// A = the rows' k16 fragments, held in registers for a whole run
// (dense_bwd_row_frags), B = the chunk's columns from the transposed head
// panel of the column vectors (head_panel.cuh, KT rows a head: D padded to
// a multiple of 16), MN-major: 64 columns are one 128-byte swizzle row, and
// each k-step of 16 panel rows is two 1 KB atoms.  The accumulator
// te[4j + 2v + u] holds te[16 w + g + 8v][8j + 2t + u] (warp w of the
// warpgroup, g = lane / 4, t = lane % 4): rows ra, ra + 8 of the thread and
// columns 8j + 2t + u, which are the cells of the thread's k16 A fragments
// of a product over the chunk's columns (rows g, g + 8; columns 2t, 2t + 1,
// 2t + 8, 2t + 9 of each 16-column step).  So the chain runs on te in
// registers, and its alpha, rounded to bf16, is packed straight into the A
// fragments of the next product (as FlashAttention-3 turns S into P):
// alpha and dz never touch shared memory.
// ---------------------------------------------------------------------------

constexpr int TC_KC = 64;  // columns a k-chunk: one 128-byte panel row
// the k16 A fragments of head hh of this thread's two rows (row_a = ra,
// row_b = ra + 8; a row that is not ok reads zeros, as do features past D):
// frag[s] covers the head's features 16 s .. 16 s + 15
template <int KT>
__device__ __forceinline__ void dense_bwd_row_frags(const __nv_bfloat16* __restrict__ x,
                                                    int64_t row_a, bool ok_a, int64_t row_b,
                                                    bool ok_b, int HD, int D, int hh, int t,
                                                    uint32_t (*frag)[4]) {
  auto at = [&](int64_t row, bool ok, int d) {
    return ok && d < D ? __bfloat162float(x[row * HD + hh * D + d]) : 0.f;
  };
#pragma unroll
  for (int s = 0; s < KT / 16; ++s) {
    const int d0 = 16 * s + 2 * t;
    frag[s][0] = pack_bf16(at(row_a, ok_a, d0), at(row_a, ok_a, d0 + 1));
    frag[s][1] = pack_bf16(at(row_b, ok_b, d0), at(row_b, ok_b, d0 + 1));
    frag[s][2] = pack_bf16(at(row_a, ok_a, d0 + 8), at(row_a, ok_a, d0 + 9));
    frag[s][3] = pack_bf16(at(row_b, ok_b, d0 + 8), at(row_b, ok_b, d0 + 9));
  }
}

// issues te of one head over one k-chunk (te zeroed, then KT / 16 k-steps
// from the head's KT panel rows at shared address `panel`) and commits it;
// the caller waits (wgmma_wait) before reading te
template <int KT>
__device__ __forceinline__ void dense_bwd_te(float* te, const uint32_t (*frag)[4],
                                             uint32_t panel) {
#pragma unroll
  for (int i = 0; i < 32; ++i) te[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < KT / 16; ++s)
    wgmma_rs<64, 1>(te, frag[s], smem_desc(panel + 2048 * s, 1024, 1024));
  wgmma_commit();
}

// alpha and dz of one cell and head: edge_grad's chain with the receiver's
// bound leaky(msrc + a_d) precomputed and exp as ex2 of the clamped
// exponent scaled by log2(e); leaky' is read from the unscaled sum, so its
// side of the kink is the plain version's
__device__ __forceinline__ void dense_bwd_cell(float as, float ad, float bnd, float rden,
                                               float s2, float cnt, float te, float slope,
                                               float& alpha, float& dz) {
  const float lraw = as + ad;
  const float p = cnt * ex2(fminf(leaky(lraw, slope) - bnd, 60.f) * LOG2E);
  alpha = p * rden;
  dz = alpha * (te - s2) * (lraw >= 0.f ? 1.f : slope);
}

// The chain on one head's te of a k-chunk with the rows the senders (K8):
// per cell the row's a_s (as_a, as_b for rows ra, ra + 8), the column's
// a_d, bound, 1/den and s2 (float32 [64] each for the chunk's columns) and
// the cell's count (`cnt`: the chunk's 'cr' count tile, `cs` bytes per
// column); adds dz into das_a / das_b and packs bf(alpha) into the four k16
// A fragments `af` of the dh product.  Cells with count 0 give alpha = dz =
// 0 exactly, so the dense form equals the per-cell one.
template <typename VT>
__device__ __forceinline__ void dense_bwd_chain_src(
    const float* te, const char* cnt, int cs, int ra, int t, const float* ad,
    const float* bnd, const float* rden, const float* s2, float as_a, float as_b,
    float slope, float& das_a, float& das_b, uint32_t (*af)[4]) {
  constexpr int SZ = static_cast<int>(sizeof(VT));
#pragma unroll
  for (int j = 0; j < TC_KC / 8; ++j) {
    const int c = 8 * j + 2 * t;
    const float2 ad2 = *reinterpret_cast<const float2*>(ad + c);
    const float2 bd2 = *reinterpret_cast<const float2*>(bnd + c);
    const float2 rd2 = *reinterpret_cast<const float2*>(rden + c);
    const float2 s22 = *reinterpret_cast<const float2*>(s2 + c);
    float al[2][2];
#pragma unroll
    for (int v = 0; v < 2; ++v)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float k = count_f(cnt + (c + u) * cs + (ra + 8 * v) * SZ, VT());
        float alpha, dz;
        dense_bwd_cell(v ? as_b : as_a, u ? ad2.y : ad2.x, u ? bd2.y : bd2.x,
                       u ? rd2.y : rd2.x, u ? s22.y : s22.x, k, te[4 * j + 2 * v + u],
                       slope, alpha, dz);
        (v ? das_b : das_a) += dz;
        al[v][u] = alpha;
      }
    // j = 2s: a0 (row g), a1 (row g + 8); j = 2s + 1: a2, a3
    af[j >> 1][(j & 1) * 2] = pack_bf16(al[0][0], al[0][1]);
    af[j >> 1][(j & 1) * 2 + 1] = pack_bf16(al[1][0], al[1][1]);
  }
}

}  // namespace gta
