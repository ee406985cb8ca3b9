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

template <typename T, int VEC, int NV, int E, bool WANT_MAX, bool MINSQ>
__global__ void __launch_bounds__(WARPS * 32, MINSQ ? BLOCKS_MINSQ : BLOCKS)
pair_agg_kernel(const int* __restrict__ chunk_ptr, const int* __restrict__ chunk_row,
                const int* __restrict__ slot_src, const T* __restrict__ u,
                const T* __restrict__ v, float* __restrict__ sum, float* __restrict__ mx,
                float* __restrict__ mn, float* __restrict__ sq, float* __restrict__ cnt,
                int n_chunks, int D, bool use_leaky, float slope) {
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
      const int64_t o = r * D + f0 + (k + LG * i) * VEC;
      float mr[VEC], lr[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        mr[e] = end > b ? gta::round_to<T>(m[i][e]) : 0.f;
        if constexpr (MINSQ) lr[e] = end > b ? gta::round_to<T>(lo[i][e]) : 0.f;
      }
      if (!split) {
        store_vec<VEC>(sum + o, s[i]);
        if (WANT_MAX) store_vec<VEC>(mx + o, mr);
        if constexpr (MINSQ) {
          store_vec<VEC>(mn + o, lr);
          store_vec<VEC>(sq + o, s2[i]);
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

struct Args {
  const int *ptr, *row, *src;
  const void *u, *v;
  float *sum, *mx, *mn, *sq, *cnt;
  int n_chunks, D;
  bool leaky;
  float slope;
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
        a.ptr, a.row, a.src, u, v, a.sum, a.mx, a.mn, a.sq, a.cnt, a.n_chunks, a.D, a.leaky,
        a.slope);
  else if (a.mx != nullptr)
    pair_agg_kernel<T, VEC, NV, E, true, false><<<blocks, WARPS * 32, 0, a.st>>>(
        a.ptr, a.row, a.src, u, v, a.sum, a.mx, nullptr, nullptr, a.cnt, a.n_chunks, a.D,
        a.leaky, a.slope);
  else
    pair_agg_kernel<T, VEC, NV, E, false, false><<<blocks, WARPS * 32, 0, a.st>>>(
        a.ptr, a.row, a.src, u, v, a.sum, a.mx, nullptr, nullptr, a.cnt, a.n_chunks, a.D,
        a.leaky, a.slope);
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
// needs ``mx``) and ``cnt`` float32, 16-byte aligned; the rows of split
// chunks (chunk_row < 0) set to 0, -inf, +inf, 0 and 0 by the caller.
extern "C" int gta_pair_agg(const void* chunk_ptr, const void* chunk_row, const void* slot_src,
                            const void* u, const void* v, int dtype, void* sum, void* mx,
                            void* mn, void* sq, void* cnt, int n_chunks, int D, int leaky,
                            float slope, void* stream) {
  const Args a{static_cast<const int*>(chunk_ptr), static_cast<const int*>(chunk_row),
               static_cast<const int*>(slot_src), u, v, static_cast<float*>(sum),
               static_cast<float*>(mx), static_cast<float*>(mn), static_cast<float*>(sq),
               static_cast<float*>(cnt), n_chunks, D, leaky != 0, slope,
               static_cast<cudaStream_t>(stream)};
  const cudaError_t err = dtype == gta::BF16 ? launch<__nv_bfloat16>(a) : launch<float>(a);
  return static_cast<int>(err);
}
