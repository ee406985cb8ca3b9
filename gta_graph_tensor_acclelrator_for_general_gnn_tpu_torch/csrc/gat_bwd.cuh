// The GAT attention backward kernels K5-K8: the per-edge chain and the
// walks they share.  Each kernel's .cu holds only its accumulate step (an
// ``Acc`` type) and its C entry point.
//
// Every one of them walks edges s -> d (tail slots or dense cells) and,
// per head, recomputes the forward's weight from the saved combined
// denominator and forms the softmax-and-leaky_relu chain:
//   te    = <gbar[d], h[s]>                   (per head, over its D features)
//   p     = exp(min(leaky(a_s[s] + a_d[d]) - leaky(msrc + a_d[d]), 60))
//   alpha = p * mult / den[d]
//   dz    = alpha * (te - s2[d]) * leaky'(a_s[s] + a_d[d])
// in the order of operations of the TPU kernels.  The side panel [N, 4H]
// float32 packs [a_s | a_d | 1/den | s2] per node; the tail walks also read
// it repacked per node and head, [N, H, 4] (ops/gat.pack_side, once per
// backward for K5 and K6 together).
//
// ``Acc::SRC`` says which end of an edge the walked rows are: false for
// the forward split (rows = receivers d; K5, K7 sum dad there), true for
// the transposed split (rows = original senders s; K6, K8 sum [das | dh]).
#pragma once
#include "tile_walk.cuh"
#include "wgmma.cuh"

namespace gta {

// The dense walk holds a node's HD features lane-strided, lane l taking
// features l, l + 32, ...
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
// The tail prefix walk of K5 (SRC false) and K6 (SRC true): K3's walk
// (tile_walk.cuh gat_prefix_walk) for the backward chain.  The
// warp reads a tile's slots 32 at a time, keeps the live ones by ballot
// and stops at the first 32 without an edge (the builders put a tile's
// edges in a prefix of its slots, sorted by the walked row).  E lane
// groups of LG = 32 / E lanes take their halves of a window's live slots,
// each BWD_PF at a time with all their gathers issued before the first is
// used (every gather of an edge in flight together); lane k of a group
// holds features (k + LG i) VEC + [0, VEC), i <
// NV, of the one pass that covers HD (VEC = 4 only where D % 4 == 0, so
// one load's features share a head).  The side terms come packed per node
// and head, [a_s, a_d, 1/den, s2] float32 (``sidep`` [N, H, 4]: one
// 16-byte load a head).  Per edge a group gathers the column's vector
// (gbar[d] for SRC, h[s] otherwise) and the column's side terms of its
// lanes' heads: for SRC the receiver's four, else the sender's a_s alone
// (one float of its packed terms: on the card that beat reading a node's H
// a_s contiguous from the unpacked [N, 4H] panel, a second panel beside
// the packed one); the walked row's vector and side terms are loaded once,
// with the batch in which its run of slots starts.  te of a head is each
// lane's partial over its features, summed by xor shuffles across the
// lanes of the group that hold that head (group_head_dots); every lane
// that holds a head runs its chain (edge_grad), so alpha is never
// shuffled.  Register sums over the group's current run: das or dad
// (round_to<HT>(dz)) on the lane whose
// load starts the head, and for SRC dh (round_to<HT>(alpha * gbar), the
// product never contracted into an FMA) on every lane.  A run is added
// into the zeroed float32 output of Acc::width(H, HD) columns per row
// ([das | dh] or dad) when the walked row changes and after the walk, one
// float32 atomic per value (float4 atomics where VEC = 4 and the dh
// columns are 16-byte aligned: H and the row width multiples of 4).
// ---------------------------------------------------------------------------

// edges a lane group gathers at a time.  Each edge already keeps several
// gathers of a lane in flight (its column vector's NV loads, its side
// terms and, where a run starts, the walked row's); one edge a group at
// four blocks an SM took less time on the card than two (K5, K6; K6 also
// at three blocks) or four at one (K6), since each more edge costs some
// twenty registers a lane
constexpr int BWD_PF = 1;

// lanes of one load that hold a head, where they form an aligned power of
// two within a group of LG lanes (D % VEC == 0 and D / VEC a power of two
// <= LG); else 0
inline int lanes_per_head(int D, int VEC, int LG) {
  if (D % VEC != 0) return 0;
  const int l = D / VEC;
  return l <= LG && (l & (l - 1)) == 0 ? l : 0;
}

// te of each of this lane's loads: its partial summed over the lanes of its
// group (and the lane's loads) that hold the same head.  L > 0: a head is L
// aligned lanes of one load (log2 L xor steps a load); L == 0: any layout,
// one whole-group xor sum per head.  Every lane of the warp calls it.
template <int NV, int LG>
__device__ __forceinline__ void group_head_dots(const float* part, const int* hk, int L,
                                                int H, float* te) {
  if (L > 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float v = part[i];
      for (int o = 1; o < L; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      te[i] = v;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < NV; ++i) te[i] = 0.f;
  for (int hh = 0; hh < H; ++hh) {
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (hk[i] == hh) v += part[i];
#pragma unroll
    for (int o = 1; o < LG; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (hk[i] == hh) te[i] = v;
  }
}

template <typename Acc, typename HT, typename MT, int VEC, int NV, int E>
__device__ __forceinline__ void gat_bwd_prefix_walk(
    const int16_t* __restrict__ src_local, const int16_t* __restrict__ dst_local,
    const MT* __restrict__ mult, int64_t base, int ET, int R, int C, int64_t row0,
    int64_t col0, const HT* __restrict__ h, const HT* __restrict__ gbar,
    const float* __restrict__ sidep, const float* __restrict__ msrc, float* __restrict__ out,
    int HD, int H, int L, int64_t n, float slope, int lane) {
  static_assert(E == 1 || E == 2, "one or two lane groups");
  using V = typename VecLoad<HT, VEC>::type;
  constexpr bool SRC = Acc::SRC;
  constexpr int LG = 32 / E;  // lanes a group
  const int grp = lane / LG, k = lane % LG;
  const int D = HD / H, W = Acc::width(H, HD);
  const bool wide4 = VEC == 4 && H % 4 == 0 && W % 4 == 0;
  const HT* rowvec = SRC ? h : gbar;  // the walked row's, once a run
  const HT* colvec = SRC ? gbar : h;  // the column's, per edge
  int hk[NV];     // the head of each of this lane's loads (-1 past HD)
  bool own[NV];   // the load starts its head: this lane sums its das / dad
  bool same[NV];  // the load's head is the previous load's
  float ms[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int f = (k + LG * i) * VEC;
    hk[i] = f < HD ? f / D : -1;
    own[i] = f < HD && f % D == 0;
    same[i] = i > 0 && hk[i] == hk[i > 0 ? i - 1 : 0];
    ms[i] = hk[i] >= 0 ? msrc[hk[i]] : 0.f;
  }
  // a node's side terms for load i's head: [a_s, a_d, 1/den, s2]; the
  // sender's a_s and the receiver's others enter the chain (the row's
  // come with its run, the column's per edge)
  auto terms = [&](int64_t node, int i, float* t) {
    const float4 v = *reinterpret_cast<const float4*>(sidep + (node * H + hk[i]) * 4);
    t[0] = v.x;
    t[1] = v.y;
    t[2] = v.z;
    t[3] = v.w;
  };
  float hs[NV] = {}, fs[NV][VEC] = {};  // the current run's sums
  V rv[NV];                             // its walked row's vector
  float rt[NV][4] = {};                 // and side terms
#pragma unroll
  for (int i = 0; i < NV; ++i) rv[i] = zero_of<V>();
  int64_t cur = -1;  // the group's current run's walked row
  auto flush = [&]() {
    float* orow = out + cur * W;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (hk[i] < 0) continue;
      if (own[i]) atomicAdd(orow + hk[i], hs[i]);
      if (SRC) {
        float* p = orow + H + (k + LG * i) * VEC;
        if (VEC == 1 || wide4) {
          add_vec<VEC>(p, fs[i]);
        } else {  // rows not 16-byte aligned: one float at a time
#pragma unroll
          for (int v = 0; v < VEC; ++v) atomicAdd(p + v, fs[i][v]);
        }
      }
    }
  };
  for (int e0 = 0; e0 < ET; e0 += 32) {
    const int e = e0 + lane;
    int c = C, r = R;
    if (e < ET) {
      c = src_local[base + e];
      r = dst_local[base + e];
    }
    const bool real = c >= 0 && c < C && r >= 0 && r < R;
    if (__ballot_sync(0xffffffffu, real) == 0u) break;  // past the edges
    const bool live = real && col0 + c < n && row0 + r < n;
    const float m = live ? to_f(mult[base + e]) : 0.f;
    const unsigned all = __ballot_sync(0xffffffffu, live);
    // group g takes the g-th half of the live slots, in slot order
    unsigned todo = all;
    if (E > 1) {
      const int cnt = __popc(all), rank = __popc(all & ((1u << lane) - 1u));
      const unsigned first = __ballot_sync(0xffffffffu, live && rank < (cnt + 1) / 2);
      todo = grp == 0 ? first : all & ~first;
    }
    while (__any_sync(0xffffffffu, todo != 0u)) {
      int64_t rq[BWD_PF];  // each edge's walked row, -1 past the group's last
      bool fresh[BWD_PF];  // its run starts here
      float mq[BWD_PF], cq[BWD_PF][NV][4], rtq[BWD_PF][NV][4];
      V gq[BWD_PF][NV], rvq[BWD_PF][NV];
      int64_t prev = cur;
#pragma unroll
      for (int q = 0; q < BWD_PF; ++q) {
        const int j = todo ? __ffs(todo) - 1 : -1;
        todo &= todo - 1;
        const int src = j >= 0 ? j : 0;
        // every lane shuffles: the groups' j differ, and one may be done
        const int cj = __shfl_sync(0xffffffffu, c, src);
        const int rj = __shfl_sync(0xffffffffu, r, src);
        mq[q] = __shfl_sync(0xffffffffu, m, src);
        const int64_t row = row0 + rj, col = col0 + cj;
        rq[q] = j >= 0 ? row : -1;
        fresh[q] = j >= 0 && row != prev;
        if (j >= 0) prev = row;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const bool on = j >= 0 && hk[i] >= 0;
          const int f = (k + LG * i) * VEC;
          gq[q][i] = on ? *reinterpret_cast<const V*>(colvec + col * HD + f) : zero_of<V>();
          rvq[q][i] = on && fresh[q] ? *reinterpret_cast<const V*>(rowvec + row * HD + f)
                                     : zero_of<V>();
          if (on && !same[i]) {
            if (SRC)
              terms(col, i, cq[q][i]);
            else  // the sender's a_s alone
              cq[q][i][0] = sidep[(col * H + hk[i]) * 4];
          }
          if (on && fresh[q] && !same[i]) terms(row, i, rtq[q][i]);
          if (i > 0 && same[i]) {
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              cq[q][i][u] = cq[q][i - 1][u];
              rtq[q][i][u] = rtq[q][i - 1][u];
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < BWD_PF; ++q) {
        if (!__any_sync(0xffffffffu, rq[q] >= 0)) break;  // both groups done
        const bool on = rq[q] >= 0;
        if (fresh[q]) {
          if (cur >= 0) flush();
          cur = rq[q];
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            hs[i] = 0.f;
            rv[i] = rvq[q][i];
#pragma unroll
            for (int v = 0; v < VEC; ++v) fs[i][v] = 0.f;
#pragma unroll
            for (int u = 0; u < 4; ++u) rt[i][u] = rtq[q][i][u];
          }
        }
        float part[NV], te[NV];
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          part[i] = 0.f;
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            part[i] = fmaf(unpack(rv[i], v), unpack(gq[q][i], v), part[i]);
        }
        group_head_dots<NV, LG>(part, hk, L, H, te);
        if (!on) continue;
        float alpha = 0.f, dz = 0.f;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          if (hk[i] < 0) continue;
          const float* sn = SRC ? rt[i] : cq[q][i];  // the sender's terms
          const float* rc = SRC ? cq[q][i] : rt[i];  // the receiver's
          if (!same[i])
            edge_grad(sn[0], rc[1], rc[2], rc[3], ms[i], mq[q], te[i], slope, alpha, dz);
          if (own[i]) hs[i] += round_to<HT>(dz);
          if (SRC) {
#pragma unroll
            for (int v = 0; v < VEC; ++v)
              fs[i][v] += round_to<HT>(__fmul_rn(alpha, unpack(gq[q][i], v)));
          }
        }
      }
    }
  }
  if (cur >= 0) flush();
}

// The tail kernels K5 and K6: one warp per tile (a row block's 512-row
// stripe of [das | dh], 270 KB at H + HD = 132, would not fit a block's
// 227 KB of shared memory), walking by gat_bwd_prefix_walk; each .cu
// holds its Acc and a C entry that calls tail_entry<Acc>.
constexpr int TAIL_WARPS = 8;

// blocks an SM the walk's registers are held to: four (64 registers a
// thread) where a lane holds at most three loads, the GAT-2l layers'
// walks: they wait on gathers, so warps in flight count most (on the card
// both took more time at five blocks an SM, K6 spilling there, K5 at
// three and K6 at two); two where a lane holds more (HD past 128 in bf16,
// one feature a lane past 48)
template <int NV>
constexpr int walk_blocks() {
  return NV <= 3 ? 4 : 2;
}

template <typename Acc, typename HT, typename MT, int VEC, int NV, int E>
__global__ void __launch_bounds__(TAIL_WARPS * 32, walk_blocks<NV>())
gat_bwd_tail_kernel(const int* __restrict__ tile_rb, const int* __restrict__ tile_cb,
                    const int16_t* __restrict__ src_local,
                    const int16_t* __restrict__ dst_local, const MT* __restrict__ mult,
                    const HT* __restrict__ h, const HT* __restrict__ gbar,
                    const float* __restrict__ sidep, const float* __restrict__ msrc,
                    float* __restrict__ out, int T, int R, int C, int ET, int HD, int H, int L,
                    int64_t n, float slope) {
  const int t = blockIdx.x * TAIL_WARPS + (threadIdx.x >> 5);
  if (t >= T) return;
  const int cb = tile_cb[t];
  if (cb < 0) return;  // dead tile
  gat_bwd_prefix_walk<Acc, HT, MT, VEC, NV, E>(
      src_local, dst_local, mult, static_cast<int64_t>(t) * ET, ET, R, C,
      static_cast<int64_t>(tile_rb[t]) * R, static_cast<int64_t>(cb) * C, h, gbar, sidep,
      msrc, out, HD, H, L, n, slope, threadIdx.x & 31);
}

struct TailArgs {
  const int *rb, *cb;
  const int16_t *s, *d;
  const void *mult, *h, *g;
  const float *sidep, *ms;  // sidep: the side panel packed [n, H, 4]
  float* out;
  int T, R, C, ET, HD, H;
  int64_t n;
  float slope;
  cudaStream_t st;
};

template <typename Acc, typename HT, typename MT, int VEC, int NV, int E>
cudaError_t tail_run(const TailArgs& a) {
  const int L = lanes_per_head(a.HD / a.H, VEC, 32 / E);
  gat_bwd_tail_kernel<Acc, HT, MT, VEC, NV, E>
      <<<(a.T + TAIL_WARPS - 1) / TAIL_WARPS, TAIL_WARPS * 32, 0, a.st>>>(
          a.rb, a.cb, a.s, a.d, static_cast<const MT*>(a.mult), static_cast<const HT*>(a.h),
          static_cast<const HT*>(a.g), a.sidep, a.ms, a.out, a.T, a.R, a.C, a.ET, a.HD, a.H, L,
          a.n, a.slope);
  return cudaGetLastError();
}

// the walk's configuration: one pass covers HD (te needs a head's every
// feature in the pass).  Vector loads where D % 4 == 0 and both rows are
// aligned for them (bf16 by half-warps, 64 features a load step; float32 by
// the whole warp, 128); else one feature a lane, by half-warps up to 48
// features, else by the whole warp
template <typename Acc, typename HT, typename MT>
cudaError_t tail_launch(const TailArgs& a) {
  constexpr uintptr_t AL = 4 * sizeof(HT);
  const bool vec = (a.HD / a.H) % 4 == 0 && reinterpret_cast<uintptr_t>(a.h) % AL == 0 &&
                   reinterpret_cast<uintptr_t>(a.g) % AL == 0;
  if (vec) {
    if constexpr (sizeof(HT) == 2)
      return a.HD <= 128 ? tail_run<Acc, HT, MT, 4, 2, 2>(a) : tail_run<Acc, HT, MT, 4, 4, 2>(a);
    else
      return a.HD <= 128 ? tail_run<Acc, HT, MT, 4, 1, 1>(a) : tail_run<Acc, HT, MT, 4, 2, 1>(a);
  }
  return a.HD <= 48 ? tail_run<Acc, HT, MT, 1, 3, 2>(a) : tail_run<Acc, HT, MT, 1, 8, 1>(a);
}

// the body of a tail kernel's C entry point: h float32 or bf16, the slot
// multiplicities (``mult``) likewise; ``sidep`` (the side panel packed per
// node and head) 16-byte aligned
template <typename Acc>
int tail_entry(const void* rb, const void* cb, const void* s, const void* d, const void* mult,
               int m_dtype, const void* h, const void* g, int h_dtype, const void* sidep,
               const void* ms, void* out, int T, int R, int C, int ET, int HD, int H, int64_t n,
               float slope, void* stream) {
  if (!bwd_shape_ok(HD, H) || (reinterpret_cast<uintptr_t>(sidep) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const TailArgs a{static_cast<const int*>(rb), static_cast<const int*>(cb),
                   static_cast<const int16_t*>(s), static_cast<const int16_t*>(d), mult, h, g,
                   static_cast<const float*>(sidep), static_cast<const float*>(ms),
                   static_cast<float*>(out), T, R, C, ET, HD, H, n, slope,
                   static_cast<cudaStream_t>(stream)};
  const bool hb = h_dtype == BF16, mb = m_dtype == BF16;
  cudaError_t err;
  if (hb && mb)
    err = tail_launch<Acc, __nv_bfloat16, __nv_bfloat16>(a);
  else if (hb)
    err = tail_launch<Acc, __nv_bfloat16, float>(a);
  else if (mb)
    err = tail_launch<Acc, float, __nv_bfloat16>(a);
  else
    err = tail_launch<Acc, float, float>(a);
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
// The dense tensor-core stage of K7's and K8's bf16 paths
// (gat_dense_bwd_dad.cu, gat_dense_bwd_src.cu).  One CUDA block of two
// warpgroups owns TC_ROWS rows of a row block over a run of at most
// TC_MAX_SEG dense blocks (DenseBlockGraph.wide_segments); a warpgroup owns
// 64 of the rows.  Per 64-column k-chunk of a dense block and per head, on
// wgmma m64n64k16 (bf16 operands, float32 sums, the TPU kernel's precision):
//   te[row, col] = <rowvec[row], colvec[col]>   over the head's D features,
// A = the rows' k16 fragments (dense_bwd_row_frags), B = the chunk's
// columns from the transposed head panel of the column vectors
// (head_panel.cuh, KT rows a head: D padded to a multiple of 16), MN-major:
// 64 columns are one 128-byte swizzle row, and each k-step of 16 panel rows
// is two 1 KB atoms.  The accumulator te[4j + 2v + u] holds
// te[16 w + g + 8v][8j + 2t + u] (warp w of the warpgroup, g = lane / 4,
// t = lane % 4): rows ra, ra + 8 of the thread and columns 8j + 2t + u,
// which are the cells of the thread's k16 A fragments of a product over
// the chunk's columns (rows g, g + 8; columns 2t, 2t + 1, 2t + 8, 2t + 9 of
// each 16-column step).  So the chain runs on te in registers: K8 packs
// its alpha, rounded to bf16, straight into the A fragments of its second
// product (as FlashAttention-3 turns S into P), K7 sums its dz per row;
// alpha and dz never touch shared memory.
//
// The chunks stream through a ring of TC_STAGES shared-memory stages by
// cp.async (tc_load_stage): per stage the chunk's PR panel rows (128 bytes
// each, 128-byte swizzle), its 'cr' count tile (CountTile) and NT rows of
// column terms (TC_KC float32 each, from a transposed [NT, ld] scratch).
// ---------------------------------------------------------------------------

constexpr int TC_KC = 64;        // columns a k-chunk: one 128-byte panel row
constexpr int TC_ROWS = 128;     // rows of a row block per CUDA block
constexpr int TC_THREADS = 256;  // two warpgroups, 64 rows each
constexpr int TC_STAGES = 3;     // ring depth: two chunks in flight
constexpr int TC_MAX_SEG = 16;   // graph.DENSE_WIDE_SEGMENT: ids kept in shared memory

// a stage's count tile: 'cr' [TC_KC cols][TC_ROWS rows], each column's
// bytes padded by 16 so a fragment's loads hit distinct banks
template <typename VT> struct CountTile {
  static constexpr int SZ = static_cast<int>(sizeof(VT));
  static constexpr int STRIDE = TC_ROWS * SZ + 16;
  static constexpr int BYTES = TC_KC * STRIDE;
};

// a stage: PR panel rows, the count tile, NT column-term rows; a multiple
// of 1 KB so every stage's panel starts on a swizzle atom.  The launches
// add 1 KB for aligning the ring (compiler/schedule._dense_bwd_smem mirrors
// the layouts).
template <typename VT, int PR, int NT> struct TcStage {
  using CT = CountTile<VT>;
  static constexpr int P_BYTES = PR * 128;
  static constexpr int BYTES = (P_BYTES + CT::BYTES + NT * TC_KC * 4 + 1023) / 1024 * 1024;
};

// A block's run of dense blocks: its rows and, in shared memory, its
// blocks' ids and first columns (every thread calls it; it syncs)
struct TcRun {
  int r_base, rows_here, cpb, iters;
  int64_t row_base;
};
__device__ __forceinline__ TcRun tc_run(const int* __restrict__ segments,
                                        const int* __restrict__ row_blocks,
                                        const int* __restrict__ blk_cb, int R, int C,
                                        int* s_b, int64_t* s_col0) {
  const int* seg = segments + 3 * blockIdx.x;
  const int rb = seg[0], k_begin = seg[1], k_end = seg[2];
  TcRun run;
  run.r_base = blockIdx.y * TC_ROWS;
  run.rows_here = min(TC_ROWS, R - run.r_base);
  run.row_base = static_cast<int64_t>(rb) * R + run.r_base;
  run.cpb = (C + TC_KC - 1) / TC_KC;  // k-chunks per dense block
  run.iters = (k_end - k_begin) * run.cpb;
  const int tid = threadIdx.x;
  if (tid < k_end - k_begin) {  // at most TC_MAX_SEG (the launches check)
    const int b = row_blocks[k_begin + tid];
    s_b[tid] = b;
    s_col0[tid] = static_cast<int64_t>(blk_cb[b]) * C;
  }
  __syncthreads();
  return run;
}

// the bytes from `raw` (dynamic shared memory) to the first 1 KB boundary,
// where the ring starts
__device__ __forceinline__ uint32_t tc_ring_pad(const char* raw) {
  const uint32_t raw0 = static_cast<uint32_t>(__cvta_generic_to_shared(raw));
  return (1024u - (raw0 & 1023u)) & 1023u;
}

// the copies of chunk `it` of the run into the stage at shared address sp:
// the chunk's columns of the PR panel rows, its count tile (16-byte pieces
// of count columns), and its columns of the NT term rows
template <typename VT, int PR, int NT>
__device__ __forceinline__ void tc_load_stage(uint32_t sp, int it, const TcRun& run,
                                              const int* s_b, const int64_t* s_col0,
                                              const VT* __restrict__ values,
                                              const __nv_bfloat16* __restrict__ panel,
                                              const float* __restrict__ terms, int64_t ld,
                                              int R, int C) {
  using St = TcStage<VT, PR, NT>;
  using CT = typename St::CT;
  const int tid = threadIdx.x;
  const int kk = it / run.cpb, c0 = (it % run.cpb) * TC_KC;
  const int64_t col0 = s_col0[kk];
  const VT* A = values + static_cast<int64_t>(s_b[kk]) * R * C;
  const uint32_t sa = sp + St::P_BYTES;  // counts
  const uint32_t sc = sa + CT::BYTES;    // column terms
  for (int c = tid; c < PR * 8; c += TC_THREADS) {
    const int nr = c >> 3, j = c & 7;
    const bool ok = c0 + 8 * j < C;
    const __nv_bfloat16* src = ok ? panel + nr * ld + col0 + c0 + 8 * j : panel;
    cp_async16(sp + panel_offset(nr, j), src, ok ? 16 : 0);
  }
  constexpr int EPC = 16 / CT::SZ, UPR = TC_ROWS / EPC;  // values per copy, copies per column
  for (int c = tid; c < TC_KC * UPR; c += TC_THREADS) {
    const int cc = c / UPR, r = (c % UPR) * EPC;
    const bool ok = c0 + cc < C && r < run.rows_here;
    const VT* src = ok ? A + static_cast<int64_t>(c0 + cc) * R + run.r_base + r : values;
    cp_async16(sa + cc * CT::STRIDE + r * CT::SZ, src, ok ? 16 : 0);
  }
  for (int c = tid; c < NT * (TC_KC / 4); c += TC_THREADS) {
    const int row = c / (TC_KC / 4), u = c % (TC_KC / 4);
    const bool ok = c0 + 4 * u < C;
    const float* src = ok ? terms + row * ld + col0 + c0 + 4 * u : terms;
    cp_async16(sc + row * (TC_KC * 4) + 16 * u, src, ok ? 16 : 0);
  }
}

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

// The chain on one head's te of a k-chunk with the rows the receivers
// (K7): per cell the column's a_s (float32 [64] for the chunk's columns),
// the rows' a_d, bound, 1/den and s2 (index v: row ra + 8v) and the cell's
// count (kc[4j + 2v + u], te's index); adds dz into dad[v].  A j-step
// whose 16 x 8 cells hold no count in the whole warp is skipped (bit j of
// `live` clear): its dz are all 0 exactly, so the sums do not change.
__device__ __forceinline__ void dense_bwd_chain_dad(const float* te, const float* kc,
                                                    unsigned live, int t, const float* as,
                                                    const float* ad, const float* bnd,
                                                    const float* rden, const float* s2,
                                                    float slope, float* dad) {
#pragma unroll
  for (int j = 0; j < TC_KC / 8; ++j) {
    if (!(live >> j & 1u)) continue;
    const float2 as2 = *reinterpret_cast<const float2*>(as + 8 * j + 2 * t);
#pragma unroll
    for (int v = 0; v < 2; ++v)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float alpha, dz;
        dense_bwd_cell(u ? as2.y : as2.x, ad[v], bnd[v], rden[v], s2[v], kc[4 * j + 2 * v + u],
                       te[4 * j + 2 * v + u], slope, alpha, dz);
        dad[v] += dz;
      }
  }
}

}  // namespace gta
