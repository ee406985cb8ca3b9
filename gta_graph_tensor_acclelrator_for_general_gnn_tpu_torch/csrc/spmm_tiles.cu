// K1 spmm_tiles: edge-tile SpMM, y[r] += w_e * x[s] over the tiles of each
// row block.
//
// Replaces the TPU kernel ops/spmm.py:_spmm_kernel of the JAX package,
// which gathers and scatters through one-hot matmuls because the TPU has no
// fast dynamic gather.  Hopper gathers rows directly, so this kernel reads
// the same host-built tile arrays and indexes x by the sender instead.
//
// Bound on the card: the row gathers and the chain of dependent loads per
// tile (tile words, slot words, rows).  Each live edge reads one x row (F
// elements, a few hundred bytes at most) and its index and weight words,
// and each run of slots with one receiver adds F float32 values into y;
// the tiles are TPU-shaped (512 slots, ~10% full on the sparse tail), so a
// warp that reads every slot and waits on one row at a time leaves the
// card idle.  The atomics are not what bounds it: a row-owned variant (a
// CUDA block summing 64 or 128 rows of a row block in shared memory and
// storing them once, no global atomics) and variants with streaming
// stores or an L2 evict-last hint on x ran no faster on the smoke's GCN
// tail.
//
// Design: one warp per tile, so the work spreads evenly over the card
// whatever the row-block skew; dead tiles (cb < 0) are skipped whole.  The
// warp reads the tile's slots 32 at a time, keeps the live ones by ballot
// (pad slots are never addressed), and stops at the first 32 without an
// edge: the builders fill a prefix of each tile's slots, so a tile ~10%
// full costs one read past its edges instead of its ~90% padding.  It takes
// the live slots PF at a time: their senders, receivers and weights by
// shuffle, then the loads of all PF rows are issued before the first is
// used, so each warp keeps PF rows in flight instead of one.  Where F is a
// multiple of 4, bf16 rows go to half-warps, two edges a load (the first
// half of a window's live slots to one half-warp, the rest to the other):
// lane k of a half holds features 4k.. and 64 + 4k.. of a 128-feature
// pass, so each 8-byte load and each float4 atomic of a half-warp covers
// 64 contiguous features, and a warp keeps 2 PF rows in flight (16-byte
// loads of 8 features a lane spread each atomic over half-filled sectors
// and ran slower); float32 rows go to the whole warp, 4 features a
// lane (16-byte loads).  Otherwise lane l holds features l and l + 32.
// Each lane group sums its terms in slot order into register sums of its
// current receiver's run of slots (the builders sort a tile's slots by
// receiver), and a run's sums go into y, zeroed by the wrapper, with one float32
// atomic per value (float4 atomics where VEC = 4) when the receiver
// changes and after the walk.  A row that repeats one edge hundreds of
// times thus drifts only over a run, and y takes run sums, never single
// slots.  As on the TPU, w*x rounds to the input dtype before the f32 sum
// (__fmul_rn: never contracted into an FMA).  The atomics make the f32
// summation order of the run sums vary from run to run: results differ
// from the exact sum by f32 rounding only.
#include "common.cuh"

namespace {

using gta::round_to;
using gta::to_f;

constexpr int WARPS = 8;   // warps (tiles) per CUDA block
constexpr int PF = 4;      // row gathers in flight per warp

// VEC values of x in one aligned load, kept packed until they are summed
// (value i of a packed bf16 load is half i % 2 of its word i / 2; an
// unpacking through memory would put the loads in local memory)
template <typename T, int VEC> struct VecLoad;
template <> struct VecLoad<__nv_bfloat16, 4> { using type = uint2; };
template <> struct VecLoad<float, 4> { using type = float4; };
template <typename T> struct VecLoad<T, 1> { using type = T; };

__device__ __forceinline__ float bf16_half(uint32_t w, int h) {
  return __uint_as_float(h ? w & 0xffff0000u : w << 16);
}
__device__ __forceinline__ float unpack(const uint2& v, int i) {
  return bf16_half(i >> 1 ? v.y : v.x, i & 1);
}
__device__ __forceinline__ float unpack(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ float unpack(float v, int) { return v; }
__device__ __forceinline__ float unpack(__nv_bfloat16 v, int) { return __bfloat162float(v); }

template <typename V> __device__ __forceinline__ V zero_of() { return V{}; }
template <> __device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0);
}

template <int VEC>
__device__ __forceinline__ void add_vec(float* p, const float* v) {
  if (VEC == 4)
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  else
    atomicAdd(p, v[0]);
}

// E edges per load (1 or 2): the warp splits into E groups of LG = 32 / E
// lanes, each taking its own live slots; lane k of a group holds features
// f0 + (k + LG i) VEC + [0, VEC), i < NV, of a pass
template <typename XT, typename WT, int VEC, int NV, int E>
__global__ void __launch_bounds__(WARPS * 32)
spmm_tiles_kernel(const int* __restrict__ tile_rb, const int* __restrict__ tile_cb,
                  const int16_t* __restrict__ src_local,
                  const int16_t* __restrict__ dst_local, const WT* __restrict__ weight,
                  const XT* __restrict__ x, float* __restrict__ y, int T, int R, int C,
                  int ET, int F, int64_t n_x, int64_t n_out) {
  static_assert(E == 1 || E == 2, "one or two lane groups");
  using V = typename VecLoad<XT, VEC>::type;
  constexpr int LG = 32 / E;          // lanes a group
  constexpr int W = LG * VEC * NV;    // features a pass
  const int lane = threadIdx.x & 31, grp = lane / LG, k = lane % LG;
  const int t = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (t >= T) return;
  const int cb = tile_cb[t];
  if (cb < 0) return;  // dead tile
  const int64_t row0 = static_cast<int64_t>(tile_rb[t]) * R;
  const int64_t col0 = static_cast<int64_t>(cb) * C, base = static_cast<int64_t>(t) * ET;
  for (int f0 = 0; f0 < F; f0 += W) {
    float sum[NV][VEC] = {};
    int64_t cur = -1;  // the group's current run's receiver
    auto flush = [&]() {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int f = f0 + (k + LG * i) * VEC;
        if (f < F) add_vec<VEC>(y + cur * F + f, sum[i]);
      }
    };
    for (int e0 = 0; e0 < ET; e0 += 32) {
      const int e = e0 + lane;
      int s = C, d = R;
      if (e < ET) {
        s = src_local[base + e];
        d = dst_local[base + e];
      }
      const bool real = s >= 0 && s < C && d >= 0 && d < R;
      if (__ballot_sync(0xffffffffu, real) == 0u) break;  // past the edges
      const bool live = real && col0 + s < n_x && row0 + d < n_out;
      const float w = live ? to_f(weight[base + e]) : 0.f;
      const unsigned all = __ballot_sync(0xffffffffu, live);
      // group g takes the g-th half of the live slots, in slot order
      unsigned todo = all;
      if (E > 1) {
        const int n = __popc(all), rank = __popc(all & ((1u << lane) - 1u));
        const unsigned first = __ballot_sync(0xffffffffu, live && rank < (n + 1) / 2);
        todo = grp == 0 ? first : all & ~first;
      }
      while (__any_sync(0xffffffffu, todo != 0u)) {
        int dq[PF];
        float wq[PF];
        V xv[PF][NV];
#pragma unroll
        for (int q = 0; q < PF; ++q) {
          const int j = todo ? __ffs(todo) - 1 : -1;  // -1: past the group's last
          todo &= todo - 1;
          const int src = j >= 0 ? j : 0;
          // every lane shuffles: the groups' j differ, and one may be done
          const int sj = __shfl_sync(0xffffffffu, s, src);
          const int dj = __shfl_sync(0xffffffffu, d, src);
          dq[q] = j >= 0 ? dj : -1;
          wq[q] = __shfl_sync(0xffffffffu, w, src);
          const XT* xr = x + (col0 + sj) * F;
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            const int f = f0 + (k + LG * i) * VEC;
            xv[q][i] = j >= 0 && f < F ? *reinterpret_cast<const V*>(xr + f) : zero_of<V>();
          }
        }
#pragma unroll
        for (int q = 0; q < PF; ++q) {
          if (dq[q] < 0) break;
          if (row0 + dq[q] != cur) {
            if (cur >= 0) flush();
            cur = row0 + dq[q];
#pragma unroll
            for (int i = 0; i < NV; ++i)
#pragma unroll
              for (int v = 0; v < VEC; ++v) sum[i][v] = 0.f;
          }
#pragma unroll
          for (int i = 0; i < NV; ++i)
#pragma unroll
            for (int v = 0; v < VEC; ++v)
              sum[i][v] += round_to<XT>(__fmul_rn(wq[q], unpack(xv[q][i], v)));
        }
      }
    }
    if (cur >= 0) flush();
  }
}

template <typename XT, typename WT, int VEC, int NV, int E>
cudaError_t launch_cfg(const int* rb, const int* cb, const int16_t* s,
                       const int16_t* d, const void* w, const void* x, float* y, int T, int R,
                       int C, int ET, int F, int64_t n_x, int64_t n_out, cudaStream_t st) {
  spmm_tiles_kernel<XT, WT, VEC, NV, E><<<(T + WARPS - 1) / WARPS, WARPS * 32, 0, st>>>(
      rb, cb, s, d, static_cast<const WT*>(w), static_cast<const XT*>(x), y, T, R, C,
      ET, F, n_x, n_out);
  return cudaGetLastError();
}

// Where x's rows allow aligned 4-feature loads: bf16 rows by half-warps,
// two edges a load, each lane 4 + 4 features 64 apart (8-byte loads; a
// half-warp's load and float4 atomic cover 64 contiguous features, one
// pass per 128), float32 rows by the whole warp, 4 features a lane (16-byte
// loads, one pass per 128); else 1 feature a lane, two a lane a pass
template <typename XT, typename WT>
cudaError_t launch(const int* rb, const int* cb, const int16_t* s,
                   const int16_t* d, const void* w, const void* x, float* y, int T, int R,
                   int C, int ET, int F, int64_t n_x, int64_t n_out, cudaStream_t st) {
  if (F % 4 == 0 && reinterpret_cast<uintptr_t>(x) % (4 * sizeof(XT)) == 0) {
    if constexpr (sizeof(XT) == 2)
      return launch_cfg<XT, WT, 4, 2, 2>(rb, cb, s, d, w, x, y, T, R, C, ET, F, n_x, n_out, st);
    else
      return launch_cfg<XT, WT, 4, 1, 1>(rb, cb, s, d, w, x, y, T, R, C, ET, F, n_x, n_out, st);
  }
  return launch_cfg<XT, WT, 1, 2, 1>(rb, cb, s, d, w, x, y, T, R, C, ET, F, n_x, n_out, st);
}

}  // namespace

extern "C" const char* gta_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int gta_spmm_tiles(const void* tile_rb, const void* tile_cb,
                              const void* src_local, const void* dst_local,
                              const void* weight, int w_dtype, const void* x, int x_dtype,
                              void* y, int T, int R, int C, int ET, int F, int64_t n_x,
                              int64_t n_out, void* stream) {
  auto rb = static_cast<const int*>(tile_rb);
  auto cb = static_cast<const int*>(tile_cb);
  auto s = static_cast<const int16_t*>(src_local);
  auto d = static_cast<const int16_t*>(dst_local);
  auto yy = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  if (T == 0 || F == 0) return 0;
  const bool xb = x_dtype == gta::BF16, wb = w_dtype == gta::BF16;
  cudaError_t err;
  if (xb && wb)
    err = launch<__nv_bfloat16, __nv_bfloat16>(rb, cb, s, d, weight, x, yy, T, R, C, ET, F, n_x, n_out, st);
  else if (xb)
    err = launch<__nv_bfloat16, float>(rb, cb, s, d, weight, x, yy, T, R, C, ET, F, n_x, n_out, st);
  else if (wb)
    err = launch<float, __nv_bfloat16>(rb, cb, s, d, weight, x, yy, T, R, C, ET, F, n_x, n_out, st);
  else
    err = launch<float, float>(rb, cb, s, d, weight, x, yy, T, R, C, ET, F, n_x, n_out, st);
  return static_cast<int>(err);
}
