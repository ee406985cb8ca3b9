// K13 pair_agg: the DGN / PNA pair-sum aggregation in one pass over a
// TiledGraph.  For each slot of a tile (rb, cb) whose receiver is real
// (dst_local < R), with U = u[max(cb, 0)*C + src_local] (0 for a pad
// sender) and V = v[rb*R + dst_local], both in u's dtype:
//   z = sf(U + V) in float32 (sf: none, or leaky_relu with `slope`)
//   sum[r] += round_dt(z);  max[r] = max(max[r], round_dt(z));  count[r] += 1
// and, in the instantiation PNA's four aggregators take (MINSQ),
//   min[r] = min(min[r], round_dt(z));  sq[r] += round_dt(z)^2
// in the same pass.  Rows without a slot report 0 in every output.
//
// Replaces the TPU kernel ops/pairagg.py:_pair_agg_kernel of the JAX
// package, which gathers U and V and scatters the sum and count through
// one-hot matmuls and takes each row's tile maximum with a segmented
// cumulative max (there is no max-matmul on the MXU).  Hopper gathers rows
// directly, so this kernel keeps z in registers.  Numerics as the TPU
// kernel: the sum adds z rounded to u's dtype in float32, the max is of z
// rounded to u's dtype (the rounding is monotone, so it is the rounded
// maximum), and a dead tile (cb < 0) reads column block 0, as the TPU
// kernel's BlockSpec max(cb[t], 0) does.
//
// Bound on the card: memory and latency.  Each counted slot gathers one
// D-wide row of u; v is read, and the [N, D] sum and max written, once per
// row.  On TPU-shaped tiles (1024² blocks, 512 slots, ~170 edges a tile) a
// receiver has about one slot a tile, so a walk over the tiles would
// flush about one slot per receiver run: 2D + 1 atomics an edge.
//
// Design: the kernel walks the tiling's receiver-ordered work list
// (ops/pairagg.pair_work: the counted slots' senders sorted by receiver,
// tile order kept within a row, cut into chunks of at most PAIR_CHUNK
// slots of one receiver, every row at least one chunk).  One lane group
// per chunk: it loads v[r] once, reads its chunk's senders LG at a time
// (one coalesced load, then shuffles within the group), gathers u rows
// PF at a time with all PF loads issued before the first is used (K1's
// vector rules: bf16 rows with D % 4 == 0 by half-warps, 8-byte loads,
// 64 features a load step; float32 by the whole warp, 16-byte loads;
// else one feature a lane, by half-warps up to 48 features), and sums and
// maxes z in registers in slot order.  A row of one chunk (every row up
// to PAIR_CHUNK slots, empty rows included) is written with plain stores:
// no atomic, its max needs no sign trick and its sum's order is fixed.  A
// row cut into several chunks (the hubs) adds each chunk's sum and count
// with float32 atomics (order varies by run: f32 rounding only) and its
// max by the integer order of IEEE-754 bits (signed atomicMax for values
// >= 0, unsigned atomicMin for negative ones; -0.0 flushed as +0.0, which
// the signed order would put below -inf), into rows the wrapper set to 0
// and -inf.  The min mirrors the max (signed atomicMin for values >= 0,
// unsigned atomicMax for negative ones, into rows set to +inf) and the sum
// of squares adds like the sum.  Four accumulators a feature instead of
// two hold more registers, so MINSQ runs at BLOCKS_MINSQ blocks an SM.
//
// The outputs are rows of stride ld, so that they may be column slices of
// one [N, ld] tensor.  With `finish` (MINSQ only) K13 writes PNA's
// aggregates in their final layout: a row of one chunk stores, in place of
// its sum and sum of squares, its mean and its std
//   c = max(count, 1),  mean = sum / c,
//   std = sqrt(relu(sq / c - mean * mean) + eps)
// (ops/primitives.std_from_moments), each operation rounded on its own
// (__fdiv_rn and the like: nothing contracts into an FMA), so the row
// equals those formulas applied in PyTorch to the stored moments bit for
// bit.  A cut row gathers its moments there by atomics, and
// pair_agg_finish_kernel turns them into its mean and std afterwards by
// the same operations.
#include "tile_walk.cuh"

namespace {

constexpr int WARPS = 8;
// u rows in flight per lane group, and blocks an SM the registers are held
// to (64 a thread): the walk waits on gathers, so warps in flight count
// most.  On the card two or eight rows in flight, chunks of 64 or 256
// slots, and the sum-and-max instantiations left at their 79 registers
// all took more time
constexpr int PF = 4;
constexpr int BLOCKS = 4;
constexpr int BLOCKS_MINSQ = 3;

__device__ __forceinline__ void atomic_max_f32(float* addr, float v) {
  v = v == 0.f ? 0.f : v;
  if (v >= 0.f)
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
}

__device__ __forceinline__ void atomic_min_f32(float* addr, float v) {
  v = v == 0.f ? 0.f : v;
  if (v >= 0.f)
    atomicMin(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMax(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if (VEC == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *p = v[0];
}

// A row's mean and std from its count c, sum s and sum of squares q, in
// the operations and order of PyTorch's mean = s / c and
// std_from_moments(mean, q / c), each rounded on its own
__device__ __forceinline__ void mean_std(float c, float s, float q, float eps, float& mean,
                                         float& sd) {
  c = fmaxf(c, 1.f);
  mean = __fdiv_rn(s, c);
  float var = __fsub_rn(__fdiv_rn(q, c), __fmul_rn(mean, mean));
  var = var < 0.f ? 0.f : var;  // relu; NaN stays NaN, as torch.relu
  sd = __fsqrt_rn(__fadd_rn(var, eps));
}

template <typename T, int VEC, int NV, int E, bool WANT_MAX, bool MINSQ>
__global__ void __launch_bounds__(WARPS * 32, MINSQ ? BLOCKS_MINSQ : BLOCKS)
pair_agg_kernel(const int* __restrict__ chunk_ptr, const int* __restrict__ chunk_row,
                const int* __restrict__ slot_src, const T* __restrict__ u,
                const T* __restrict__ v, float* __restrict__ sum, float* __restrict__ mx,
                float* __restrict__ mn, float* __restrict__ sq, float* __restrict__ cnt,
                int n_chunks, int D, int64_t ld, bool use_leaky, float slope, bool finish,
                float eps) {
  using V = typename gta::VecLoad<T, VEC>::type;
  constexpr int LG = 32 / E;        // lanes a group
  constexpr int W = LG * VEC * NV;  // features a pass
  const int lane = threadIdx.x & 31, k = lane % LG;
  const int c = (blockIdx.x * WARPS + (threadIdx.x >> 5)) * E + lane / LG;
  if (c >= n_chunks) return;  // the whole group: its shuffles use its own mask
  const unsigned gmask = (0xffffffffu >> (32 - LG)) << (lane - k);
  const int b = chunk_ptr[c], end = chunk_ptr[c + 1];
  const int rc = chunk_row[c];
  const bool split = rc < 0;
  const int64_t r = split ? ~rc : rc;
  if (k == 0) {
    const float m = static_cast<float>(end - b);
    if (split)
      atomicAdd(cnt + r, m);
    else
      cnt[r] = m;
  }
  const float neg_inf = __uint_as_float(0xff800000u);
  const float pos_inf = __uint_as_float(0x7f800000u);
  for (int f0 = 0; f0 < D; f0 += W) {
    bool on[NV];
    float vv[NV][VEC], s[NV][VEC], m[NV][VEC];
    float lo[NV][VEC], s2[NV][VEC];  // MINSQ only
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int f = f0 + (k + LG * i) * VEC;
      on[i] = f < D;
      const V x = on[i] ? *reinterpret_cast<const V*>(v + r * D + f) : gta::zero_of<V>();
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        vv[i][e] = gta::unpack(x, e);
        s[i][e] = 0.f;
        m[i][e] = neg_inf;
        if constexpr (MINSQ) {
          lo[i][e] = pos_inf;
          s2[i][e] = 0.f;
        }
      }
    }
    for (int p0 = b; p0 < end; p0 += LG) {
      const int here = min(LG, end - p0);
      const int mine = k < here ? slot_src[p0 + k] : -1;
      for (int q0 = 0; q0 < here; q0 += PF) {
        V uq[PF][NV];
#pragma unroll
        for (int q = 0; q < PF; ++q) {
          const int j = q0 + q;
          const int sj = __shfl_sync(gmask, mine, j < here ? j : 0, LG);
          const bool ok = j < here && sj >= 0;  // a pad sender reads 0
          const T* ur = u + static_cast<int64_t>(ok ? sj : 0) * D;
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            const int f = f0 + (k + LG * i) * VEC;
            uq[q][i] = ok && on[i] ? *reinterpret_cast<const V*>(ur + f) : gta::zero_of<V>();
          }
        }
#pragma unroll
        for (int q = 0; q < PF; ++q) {
          if (q0 + q >= here) break;
#pragma unroll
          for (int i = 0; i < NV; ++i)
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              float z = gta::unpack(uq[q][i], e) + vv[i][e];
              if (use_leaky) z = gta::leaky(z, slope);
              s[i][e] += gta::round_to<T>(z);
              if (WANT_MAX) m[i][e] = fmaxf(m[i][e], z);
              if constexpr (MINSQ) {
                const float zr = gta::round_to<T>(z);
                lo[i][e] = fminf(lo[i][e], z);
                s2[i][e] = __fmaf_rn(zr, zr, s2[i][e]);
              }
            }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (!on[i]) continue;
      const int64_t o = r * ld + f0 + (k + LG * i) * VEC;
      float mr[VEC], lr[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        mr[e] = end > b ? gta::round_to<T>(m[i][e]) : 0.f;
        if constexpr (MINSQ) lr[e] = end > b ? gta::round_to<T>(lo[i][e]) : 0.f;
      }
      if (!split) {
        if (WANT_MAX) store_vec<VEC>(mx + o, mr);
        if constexpr (MINSQ) {
          store_vec<VEC>(mn + o, lr);
          if (finish) {
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              mean_std(static_cast<float>(end - b), s[i][e], s2[i][e], eps, s[i][e], s2[i][e]);
          }
          store_vec<VEC>(sum + o, s[i]);
          store_vec<VEC>(sq + o, s2[i]);
        } else {
          store_vec<VEC>(sum + o, s[i]);
        }
      } else {
        gta::add_vec<VEC>(sum + o, s[i]);
        if (WANT_MAX) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) atomic_max_f32(mx + o + e, mr[e]);
        }
        if constexpr (MINSQ) {
          gta::add_vec<VEC>(sq + o, s2[i]);
#pragma unroll
          for (int e = 0; e < VEC; ++e) atomic_min_f32(mn + o + e, lr[e]);
        }
      }
    }
  }
}

// A cut row's mean and std from the moments K13 gathered there by atomics,
// in place: a thread per (row, feature) of `rows`
__global__ void pair_agg_finish_kernel(const int64_t* __restrict__ rows, int64_t n_cells,
                                       const float* __restrict__ cnt, float* __restrict__ mean,
                                       float* __restrict__ sd, int64_t ld, int D, float eps) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n_cells;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t r = rows[i / D];
    const int64_t o = r * ld + i % D;
    mean_std(cnt[r], mean[o], sd[o], eps, mean[o], sd[o]);
  }
}

struct Args {
  const int *ptr, *row, *src;
  const void *u, *v;
  float *sum, *mx, *mn, *sq, *cnt;
  int n_chunks, D;
  int64_t ld;
  bool leaky;
  float slope;
  bool finish;
  float eps;
  cudaStream_t st;
};

template <typename T, int VEC, int NV, int E>
cudaError_t run(const Args& a) {
  const int groups = WARPS * E;
  const unsigned blocks = static_cast<unsigned>((a.n_chunks + groups - 1) / groups);
  const T* u = static_cast<const T*>(a.u);
  const T* v = static_cast<const T*>(a.v);
  if (a.mn != nullptr)
    pair_agg_kernel<T, VEC, NV, E, true, true><<<blocks, WARPS * 32, 0, a.st>>>(
        a.ptr, a.row, a.src, u, v, a.sum, a.mx, a.mn, a.sq, a.cnt, a.n_chunks, a.D, a.ld,
        a.leaky, a.slope, a.finish, a.eps);
  else if (a.mx != nullptr)
    pair_agg_kernel<T, VEC, NV, E, true, false><<<blocks, WARPS * 32, 0, a.st>>>(
        a.ptr, a.row, a.src, u, v, a.sum, a.mx, nullptr, nullptr, a.cnt, a.n_chunks, a.D,
        a.ld, a.leaky, a.slope, false, 0.f);
  else
    pair_agg_kernel<T, VEC, NV, E, false, false><<<blocks, WARPS * 32, 0, a.st>>>(
        a.ptr, a.row, a.src, u, v, a.sum, a.mx, nullptr, nullptr, a.cnt, a.n_chunks, a.D,
        a.ld, a.leaky, a.slope, false, 0.f);
  return cudaGetLastError();
}

// K1's vector rules (tile_walk.cuh spmm_walk_config), with one feature a
// lane by half-warps up to 48 features (the 41 logits of a last layer)
template <typename T>
cudaError_t launch(const Args& a) {
  constexpr uintptr_t AL = 4 * sizeof(T);
  if (a.D % 4 == 0 && reinterpret_cast<uintptr_t>(a.u) % AL == 0 &&
      reinterpret_cast<uintptr_t>(a.v) % AL == 0) {
    if constexpr (sizeof(T) == 2)
      return run<T, 4, 2, 2>(a);
    else
      return run<T, 4, 1, 1>(a);
  }
  return a.D <= 48 ? run<T, 1, 3, 2>(a) : run<T, 1, 2, 1>(a);
}

}  // namespace

// K13 over a work list (ops/pairagg.PairWork): ``sum``, ``mx`` (null: no
// max), ``mn`` and ``sq`` (null: no min and no sum of squares; non-null
// needs ``mx``) float32 rows of stride ``ld`` (16-byte aligned where D is
// a multiple of 4), ``cnt`` float32 [N]; the rows of split chunks
// (chunk_row < 0) set to 0, -inf, +inf, 0 and 0 by the caller.  With
// ``finish`` (needs ``mn``) the rows of one chunk store their mean in
// ``sum`` and their std in ``sq``; the caller then finishes the cut rows
// with gta_pair_agg_finish.
extern "C" int gta_pair_agg(const void* chunk_ptr, const void* chunk_row, const void* slot_src,
                            const void* u, const void* v, int dtype, void* sum, void* mx,
                            void* mn, void* sq, void* cnt, int n_chunks, int D, int64_t ld,
                            int leaky, float slope, int finish, float eps, void* stream) {
  const Args a{static_cast<const int*>(chunk_ptr), static_cast<const int*>(chunk_row),
               static_cast<const int*>(slot_src), u, v, static_cast<float*>(sum),
               static_cast<float*>(mx), static_cast<float*>(mn), static_cast<float*>(sq),
               static_cast<float*>(cnt), n_chunks, D, ld, leaky != 0, slope,
               finish != 0 && mn != nullptr, eps, static_cast<cudaStream_t>(stream)};
  const cudaError_t err = dtype == gta::BF16 ? launch<__nv_bfloat16>(a) : launch<float>(a);
  return static_cast<int>(err);
}

// The cut rows ``rows`` (int64, n_rows of them) of K13's final layout:
// their moments in ``mean`` and ``sd`` (rows of stride ``ld``, D wide)
// become the mean and the std, in place, by K13's own operations
extern "C" int gta_pair_agg_finish(const void* rows, int64_t n_rows, const void* cnt,
                                   void* mean, void* sd, int64_t ld, int D, float eps,
                                   void* stream) {
  const int64_t cells = n_rows * D;
  if (cells == 0) return 0;
  constexpr int T = 256;
  const int64_t need = (cells + T - 1) / T;
  const unsigned blocks = static_cast<unsigned>(need < 4096 ? need : 4096);
  pair_agg_finish_kernel<<<blocks, T, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(rows), cells, static_cast<const float*>(cnt),
      static_cast<float*>(mean), static_cast<float*>(sd), ld, D, eps);
  return static_cast<int>(cudaGetLastError());
}
