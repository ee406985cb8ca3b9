// K13 pair_agg: the DGN / PNA pair-sum aggregation in one pass over a
// TiledGraph.  For each slot of a tile (rb, cb) whose receiver is real
// (dst_local < R), with U = u[max(cb, 0)*C + src_local] (0 for a pad
// sender) and V = v[rb*R + dst_local], both in u's dtype:
//   z = sf(U + V) in float32 (sf: none, or leaky_relu with `slope`)
//   sum[r] += round_dt(z);  max[r] = max(max[r], round_dt(z));  count[r] += 1
// Rows without a slot report sum 0, max 0 and count 0.
//
// Replaces the TPU kernel ops/pairagg.py:_pair_agg_kernel of the JAX
// package, which gathers U and V and scatters the sum and count through
// one-hot matmuls and takes each row's tile maximum with a segmented
// cumulative max (there is no max-matmul on the MXU).  Hopper gathers rows
// directly and has an atomic max, so this kernel reads the same tile arrays
// and keeps z in registers.  Numerics as the TPU kernel: the sum adds z
// rounded to u's dtype in float32, the max is of z rounded to u's dtype
// (the rounding is monotone, so it is the rounded maximum), and a dead tile
// (cb < 0) reads column block 0, as the TPU kernel's BlockSpec
// max(cb[t], 0) does.
//
// Bound on the card: memory.  Each live slot reads its two index words and
// two D-wide rows and adds into 2D + 1 floats; u and v are read, and the
// [N, D] sum and max written, once when the L2 cache holds the rows.
//
// Design: one warp per tile, lanes over features (256 features a pass; a
// wider D takes more passes over the tile).  The warp walks the live slots
// in order, found by ballot.  tile_graph sorts each tile's slots by
// receiver (a stable sort by block over receiver-sorted edges), so a
// receiver's slots form one run: the warp accumulates the run's sum and max
// in registers and flushes them with one float32 atomic add and one atomic
// max per (row, feature), and one count add per row, when the receiver
// changes.  The float max uses the integer order of IEEE-754 bits: signed
// atomicMax for values >= 0 and unsigned atomicMin for negative ones, over
// a buffer the wrapper fills with -inf; -0.0 is flushed as +0.0, which the
// signed order would put below -inf.  The maximum is exact in any order;
// the sum of a row spread over several tiles (the hubs) adds in an order
// that varies from run to run (f32 rounding only).  The wrapper sets the
// max of rows without a slot to 0.
#include "common.cuh"

namespace {

using gta::to_f;

constexpr int WARPS = 8;
constexpr int MAXF = 8;  // features per lane and pass

__device__ __forceinline__ void atomic_max_f32(float* addr, float v) {
  v = v == 0.f ? 0.f : v;
  if (v >= 0.f)
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
}

// Add one receiver's run (its slots in this tile, features f0 + lane +
// 32k) into the outputs.
template <typename T>
__device__ __forceinline__ void flush_run(const float* s_acc, const float* m_acc,
                                          int64_t r, int run, int f0, int lane, int D,
                                          float* sum, float* mx, float* cnt) {
#pragma unroll
  for (int k = 0; k < MAXF; ++k) {
    const int f = f0 + lane + 32 * k;
    if (f < D) {
      atomicAdd(sum + r * D + f, s_acc[k]);
      if (mx != nullptr) atomic_max_f32(mx + r * D + f, gta::round_to<T>(m_acc[k]));
    }
  }
  if (f0 == 0 && lane == 0) atomicAdd(cnt + r, static_cast<float>(run));
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
pair_agg_kernel(const int* __restrict__ tile_rb, const int* __restrict__ tile_cb,
                const int16_t* __restrict__ src_local,
                const int16_t* __restrict__ dst_local, const T* __restrict__ u,
                const T* __restrict__ v, float* __restrict__ sum, float* __restrict__ mx,
                float* __restrict__ cnt, int n_tiles, int R, int C, int ET, int D,
                int64_t n, bool use_leaky, float slope) {
  const int t = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (t >= n_tiles) return;
  const int lane = threadIdx.x & 31;
  const int64_t base = static_cast<int64_t>(t) * ET;
  const int64_t row0 = static_cast<int64_t>(tile_rb[t]) * R;
  const int cb = tile_cb[t];
  const int64_t col0 = static_cast<int64_t>(cb > 0 ? cb : 0) * C;
  const float neg_inf = __uint_as_float(0xff800000u);
  for (int f0 = 0; f0 < D; f0 += 32 * MAXF) {
    float s_acc[MAXF], m_acc[MAXF];
    int64_t cur = -1;
    int run = 0;
    for (int e0 = 0; e0 < ET; e0 += 32) {
      const int e = e0 + lane;
      int s = C, d = R;
      if (e < ET) {
        s = src_local[base + e];
        d = dst_local[base + e];
      }
      const bool live = d >= 0 && d < R && row0 + d < n;
      unsigned todo = __ballot_sync(0xffffffffu, live);
      while (todo) {
        const int j = __ffs(todo) - 1;
        todo &= todo - 1;
        const int sj = __shfl_sync(0xffffffffu, s, j);
        const int64_t r = row0 + __shfl_sync(0xffffffffu, d, j);
        if (r != cur) {
          if (cur >= 0) flush_run<T>(s_acc, m_acc, cur, run, f0, lane, D, sum, mx, cnt);
          cur = r;
          run = 0;
#pragma unroll
          for (int k = 0; k < MAXF; ++k) {
            s_acc[k] = 0.f;
            m_acc[k] = neg_inf;
          }
        }
        ++run;
        const bool has_u = sj >= 0 && sj < C && col0 + sj < n;
        const T* ur = u + (col0 + (has_u ? sj : 0)) * D;
        const T* vr = v + r * D;
#pragma unroll
        for (int k = 0; k < MAXF; ++k) {
          const int f = f0 + lane + 32 * k;
          if (f < D) {
            float z = (has_u ? to_f(ur[f]) : 0.f) + to_f(vr[f]);
            if (use_leaky) z = gta::leaky(z, slope);
            s_acc[k] += gta::round_to<T>(z);
            m_acc[k] = fmaxf(m_acc[k], z);
          }
        }
      }
    }
    if (cur >= 0) flush_run<T>(s_acc, m_acc, cur, run, f0, lane, D, sum, mx, cnt);
  }
}

template <typename T>
cudaError_t launch(const int* rb, const int* cb, const int16_t* s, const int16_t* d,
                   const void* u, const void* v, float* sum, float* mx, float* cnt, int T_,
                   int R, int C, int ET, int D, int64_t n, bool use_leaky, float slope,
                   cudaStream_t st) {
  const int blocks = (T_ + WARPS - 1) / WARPS;
  pair_agg_kernel<T><<<blocks, WARPS * 32, 0, st>>>(
      rb, cb, s, d, static_cast<const T*>(u), static_cast<const T*>(v), sum, mx, cnt, T_,
      R, C, ET, D, n, use_leaky, slope);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gta_pair_agg(const void* tile_rb, const void* tile_cb,
                            const void* src_local, const void* dst_local, const void* u,
                            const void* v, int dtype, void* sum, void* mx, void* cnt,
                            int T, int R, int C, int ET, int D, int64_t n, int leaky,
                            float slope, void* stream) {
  auto rb = static_cast<const int*>(tile_rb);
  auto cb = static_cast<const int*>(tile_cb);
  auto s = static_cast<const int16_t*>(src_local);
  auto d = static_cast<const int16_t*>(dst_local);
  auto ys = static_cast<float*>(sum);
  auto ym = static_cast<float*>(mx);
  auto yc = static_cast<float*>(cnt);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == gta::BF16
          ? launch<__nv_bfloat16>(rb, cb, s, d, u, v, ys, ym, yc, T, R, C, ET, D, n,
                                  leaky != 0, slope, st)
          : launch<float>(rb, cb, s, d, u, v, ys, ym, yc, T, R, C, ET, D, n, leaky != 0,
                          slope, st);
  return static_cast<int>(err);
}
