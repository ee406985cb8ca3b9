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
#include "common.cuh"

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
//   Acc::add<HT>(out, s, d, alpha, dz, gbar[d] lane-strided, hk, lane, H, HD)
// (alpha and dz are those of the lane's head for lanes < H, else 0).  The
// output is zeroed float32 and takes global atomics (order varies by run:
// float32 rounding only).
// ---------------------------------------------------------------------------

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
      Acc::template add<HT>(out, src, dst, alpha, dz, gv, hk, lane, H, HD);
    }
  }
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

}  // namespace gta
