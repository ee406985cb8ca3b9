// K14 gat_layer: one whole GAT layer (projection, attention logits under a
// static shift, softmax, aggregation, final activation).
//
// Replaces the TPU kernel ops/gat.py:_gat_layer_kernel of the JAX package,
// which does all of it per edge tile in one call and recomputes X[cb] W and
// X[rb] W on every tile: the TPU layer was bound by its op count.  On this
// card that recompute would cost 2 (R + C) F HD flops per tile, over 20
// PFLOP per layer on a Reddit-sized tail, so the same function runs as
// three launches of this library (entry point gta_gat_layer, `stages` bits
// 1, 2, 4), each a pass the next one needs finished:
//
//  1. projection, every row once: h32 = x W with float32 sums; hq = h32
//     rounded to the compute dtype; a_s = hq . wa_s and a_d = hq . wa_d,
//     each summed in float32 and rounded to the compute dtype (the TPU
//     kernel's h_cb.astype(dt) and its one-hot gather of asrc_cb.astype(dt)),
//     written widened to float32 (exact) for the walk.
//  2. walk, with the static shift:
//       e = min(leaky(a_s[s] + a_d[d]), SHIFT + 60),  p = exp(e - SHIFT)
//       den[d] += round(p),  num[d, f] += round(p[f / D] hq[s, f])
//     (SHIFT = 12; round to the compute dtype before the float32 sums, as
//     the TPU kernel's scatter_rows casts both before its sum).  Tile
//     weights are not read: the layer's tilings are unit-weight, as in JAX.
//  3. epilogue: out[r, f] = sf(num[r, f] / max(den[r, f / D], 1e-30)) for
//     every row, so a row that no live slot reaches reads sf(0).  A pass
//     of its own: folding it into the walk's last flush of each row (a
//     per-row count of live slots, counted down by one atomic after a
//     fence a run) measured much slower, since a run is one or two edges.
//
// Bound on the card: bytes for the walk (one hq row gathered per live slot,
// HD + H float32 atomics per receiver run) and for the projection (x read
// once: 280 MB at Reddit's n and F = 602 in bf16, against 36 GFLOP of x W).
//
// Design.  Projection in bf16 (gat_layer_project_wgmma): one CUDA block of
// two warpgroups owns 128 rows, two blocks an SM; x and W stream through a
// ring of 3 shared-memory stages of 64-wide k-chunks filled by cp.async,
// both K-major in the 128-byte swizzle layout (wgmma.cuh panel_offset): the
// x tile's 128 rows of 128 bytes, and W transposed, HD padded to the wgmma
// width N of K4's rule (8, 32, 48, 64, 128), from a panel [N, ld_w] that
// the entry point's first launch writes into the wrapper's scratch
// (head_panel.cuh, one head).  Each warpgroup runs wgmma m64nNk16 in RS
// form: its A fragments read from the x tile by 32-bit shared loads (the
// swizzle puts a fragment's 32 words in distinct banks), B by descriptor.
// x rows are staged by 16-byte copies when they are 16-byte aligned (F a
// multiple of 8), by 4-byte copies when F is even (Reddit's F = 602), else
// element by element; copies past F read zeros.  The epilogue rounds h to
// bf16 into a float32 tile in shared memory (the ring's space), writes hq
// from it and forms a_s | a_d per row.  float32 (and bf16 wider than 128,
// which the wgmma rule does not take) run gat_layer_project_fma on the
// CUDA cores, never TF32.
//
// Walk: gta::gat_prefix_walk (tile_walk.cuh, K3's walk) under the
// StaticShift logit: a warp per tile, up to its first 32 slots without an
// edge (the builders put a tile's edges in a prefix of its slots, sorted by
// receiver), SPMM_PF row gathers in flight per lane group, run sums in
// registers and one float32 atomic per value and run.
#include <type_traits>

#include "head_panel.cuh"
#include "tile_walk.cuh"

namespace {

using gta::round_to;
using gta::to_f;

template <typename XT>
__device__ __forceinline__ XT from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// a_s | a_d of `rows` rows of the hq tile hs [rows][S] (values of XT's
// precision, f32): a dot over HD per (row, term) against wv [HD][2H] f32,
// summed in feature order, rounded to XT, stored as float32
template <typename XT>
__device__ __forceinline__ void attention_terms(const float* hs, int S, const float* wv,
                                                float* __restrict__ a_s,
                                                float* __restrict__ a_d, int64_t row0,
                                                int rows, int64_t n, int HD, int H,
                                                int tid, int threads) {
  const int H2 = 2 * H;
  for (int i = tid; i < rows * H2; i += threads) {
    const int r = i / H2, j = i % H2;
    const int64_t row = row0 + r;
    if (row >= n) continue;
    const float* hr = hs + r * S;
    float s = 0.f;
    for (int f = 0; f < HD; ++f) s = fmaf(hr[f], wv[f * H2 + j], s);
    const float v = round_to<XT>(s);
    if (j < H)
      a_s[row * H + j] = v;
    else
      a_d[row * H + j - H] = v;
  }
}

// ---- stage 1, bf16: wgmma ---------------------------------------------------

constexpr int P_ROWS = 128, P_THREADS = 256;  // two warpgroups, 64 rows each
constexpr int P_KC = 64, P_STAGES = 3;        // k-chunk (128 bytes of bf16), ring depth
constexpr int X_TILE = P_ROWS * 128;          // bytes of a stage's x tile

template <int N>
__host__ __device__ constexpr int proj_stage_bytes() {
  return X_TILE + N * 128;
}
// the ring, or after it the epilogue's f32 hq tile [128][N + 1] in the same
// space, then wv [HD][2H] f32; 1 KB for aligning the ring
// (compiler/schedule._gat_layer_smem mirrors this)
template <int N>
size_t proj_wgmma_smem(int HD, int H) {
  const size_t ring = static_cast<size_t>(P_STAGES) * proj_stage_bytes<N>();
  const size_t epi = static_cast<size_t>(P_ROWS) * (N + 1) * 4;
  return (ring > epi ? ring : epi) + 1024 + static_cast<size_t>(HD) * 2 * H * 4;
}

// XV: bytes per copy of x (16, 4, or 2: element by element, not async)
template <int N, int XV>
__global__ void __launch_bounds__(P_THREADS, 2)
gat_layer_project_wgmma(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ wT, int64_t ld_w,
                        const __nv_bfloat16* __restrict__ was,
                        const __nv_bfloat16* __restrict__ wad, __nv_bfloat16* __restrict__ hq,
                        float* __restrict__ a_s, float* __restrict__ a_d, int64_t n, int F,
                        int HD, int H) {
  constexpr int SB = proj_stage_bytes<N>(), S = N + 1;
  constexpr int RING = P_STAGES * SB, EPI = P_ROWS * S * 4;
  extern __shared__ __align__(1024) char smem_raw[];
  const uint32_t raw0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t pad = (1024u - (raw0 & 1023u)) & 1023u;
  const uint32_t smem0 = raw0 + pad;
  char* smem = smem_raw + pad;
  float* wv = reinterpret_cast<float*>(smem + (RING > EPI ? RING : EPI));  // [HD][2H]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * P_ROWS;
  const int iters = (F + P_KC - 1) / P_KC;
  for (int i = tid; i < HD * H; i += P_THREADS) {
    const int f = i / H, hh = i % H;
    wv[f * 2 * H + hh] = to_f(was[i]);
    wv[f * 2 * H + H + hh] = to_f(wad[i]);
  }

  auto load_stage = [&](int it, int stage) {
    const int k0 = it * P_KC;
    const uint32_t sx = smem0 + stage * SB, sw = sx + X_TILE;
    if constexpr (XV == 16) {
      for (int c = tid; c < P_ROWS * 8; c += P_THREADS) {
        const int r = c >> 3, j = c & 7, k = k0 + 8 * j;
        const int64_t row = row0 + r;
        const int bytes = row < n && k < F ? min(16, 2 * (F - k)) : 0;
        gta::cp_async16(sx + gta::panel_offset(r, j), bytes ? x + row * F + k : x, bytes);
      }
    } else if constexpr (XV == 4) {  // F even: a pair never straddles F
      for (int c = tid; c < P_ROWS * 32; c += P_THREADS) {
        const int r = c >> 5, u = c & 31, k = k0 + 2 * u;
        const int64_t row = row0 + r;
        const bool ok = row < n && k < F;
        gta::cp_async4(sx + gta::panel_offset(r, u >> 2) + 4 * (u & 3),
                       ok ? x + row * F + k : x, ok ? 4 : 0);
      }
    } else {
      char* tile = smem + stage * SB;
      for (int c = tid; c < P_ROWS * P_KC; c += P_THREADS) {
        const int r = c >> 6, kk = c & 63, k = k0 + kk;
        const int64_t row = row0 + r;
        *reinterpret_cast<__nv_bfloat16*>(tile + gta::panel_offset(r, kk >> 3) + 2 * (kk & 7)) =
            row < n && k < F ? x[row * F + k] : __float2bfloat16_rn(0.f);
      }
    }
    for (int c = tid; c < N * 8; c += P_THREADS) {  // the W panel holds zeros past F
      const int nn = c >> 3, j = c & 7, k = k0 + 8 * j;
      const bool ok = k < ld_w;
      gta::cp_async16(sw + gta::panel_offset(nn, j), ok ? wT + nn * ld_w + k : wT, ok ? 16 : 0);
    }
  };

  const int g = lane >> 2, t = lane & 3;
  const int ra = (warp >> 2) * 64 + (warp & 3) * 16 + g;  // this thread's rows ra, ra + 8
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  uint32_t frag[2][4];  // two A fragments in rotation

#pragma unroll
  for (int s = 0; s < P_STAGES - 1; ++s) {
    if (s < iters) load_stage(s, s);
    gta::cp_async_commit();
  }
  for (int it = 0; it < iters; ++it) {
    gta::cp_async_wait<P_STAGES - 2>();
    gta::fence_proxy_async();
    __syncthreads();  // chunk `it` landed for all; stage (it - 1) is free
    if (it + P_STAGES - 1 < iters) load_stage(it + P_STAGES - 1, (it + P_STAGES - 1) % P_STAGES);
    gta::cp_async_commit();
    const int st = it % P_STAGES;
    const char* xt = smem + st * SB;
    const uint32_t sw = smem0 + st * SB + X_TILE;
#pragma unroll
    for (int s = 0; s < P_KC / 16; ++s) {
      // rows ra, ra + 8; k = 16 s + 2t (unit 2s) and 16 s + 8 + 2t (unit 2s + 1)
      uint32_t* a = frag[s & 1];
      gta::wgmma_wait<1>();  // the product that read this set is done
      a[0] = *reinterpret_cast<const uint32_t*>(xt + gta::panel_offset(ra, 2 * s) + 4 * t);
      a[1] = *reinterpret_cast<const uint32_t*>(xt + gta::panel_offset(ra + 8, 2 * s) + 4 * t);
      a[2] = *reinterpret_cast<const uint32_t*>(xt + gta::panel_offset(ra, 2 * s + 1) + 4 * t);
      a[3] =
          *reinterpret_cast<const uint32_t*>(xt + gta::panel_offset(ra + 8, 2 * s + 1) + 4 * t);
      gta::wgmma_fence();
      gta::wgmma_rs<N, 0>(acc, a, gta::smem_desc(sw + 32 * s, 16, 1024));
      gta::wgmma_commit();
    }
    gta::wgmma_wait<0>();  // before the stage is refilled
#pragma unroll
    for (int i = 0; i < N / 2; ++i) gta::fence_reg(acc[i]);
  }
  gta::cp_async_wait<0>();
  __syncthreads();  // every warpgroup is done with the ring: its space takes the hq tile

  // acc[4j + 2v + u] = h[ra + 8v][8j + 2t + u], rounded to bf16 into hs
  float* hs = reinterpret_cast<float*>(smem);  // [128][S]
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int v = 0; v < 2; ++v)
#pragma unroll
      for (int u = 0; u < 2; ++u)
        hs[(ra + 8 * v) * S + 8 * j + 2 * t + u] = round_to<__nv_bfloat16>(acc[4 * j + 2 * v + u]);
  __syncthreads();
  for (int i = tid; i < P_ROWS * HD; i += P_THREADS) {
    const int r = i / HD, c = i % HD;
    const int64_t row = row0 + r;
    if (row < n) hq[row * HD + c] = __float2bfloat16_rn(hs[r * S + c]);
  }
  attention_terms<__nv_bfloat16>(hs, S, wv, a_s, a_d, row0, P_ROWS, n, HD, H, tid, P_THREADS);
}

// ---- stage 1, float32 (and bf16 wider than 128): FMA on the CUDA cores ----

constexpr int PBM = 64, PTHREADS = 256;  // rows and threads per block
constexpr int KC = 32;                   // k chunk of x W
constexpr int MAXJ = 16;                 // columns per thread: HD <= 256

__host__ __device__ inline int padded(int HD) { return (HD + 15) / 16 * 16; }

// the f32 hq tile and wv, then the k-chunk staging of x and W
// (compiler/schedule._gat_layer_smem mirrors this)
inline size_t proj_fma_smem(int HD, int H) {
  const size_t HP = padded(HD);
  return (PBM * HP + 2 * static_cast<size_t>(HD) * H + PBM * KC + KC * HP) * 4;
}

template <typename XT>
__global__ void __launch_bounds__(PTHREADS)
gat_layer_project_fma(const XT* __restrict__ x, const XT* __restrict__ w,
                      const XT* __restrict__ was, const XT* __restrict__ wad,
                      XT* __restrict__ hq, float* __restrict__ a_s, float* __restrict__ a_d,
                      int64_t n, int F, int HD, int H) {
  extern __shared__ __align__(16) float smem[];
  const int HP = padded(HD), H2 = 2 * H;
  float* hs = smem;                 // [PBM, HP] hq of the block's rows, f32
  float* wv = hs + PBM * HP;        // [HD, 2H]  wa_s | wa_d
  float* xs = wv + HD * H2;         // [PBM, KC]
  float* ws = xs + PBM * KC;        // [KC, HP]
  const int tid = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * PBM;
  for (int i = tid; i < HD * H; i += PTHREADS) {
    const int f = i / H, hh = i % H;
    wv[f * H2 + hh] = to_f(was[i]);
    wv[f * H2 + H + hh] = to_f(wad[i]);
  }
  const int ty = tid >> 4, tx = tid & 15, nj = HP / 16;
  float acc[4][MAXJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < F; k0 += KC) {
    __syncthreads();
    for (int i = tid; i < PBM * KC; i += PTHREADS) {
      const int r = i / KC, k = i % KC;
      const int64_t row = row0 + r;
      xs[i] = (row < n && k0 + k < F) ? to_f(x[row * F + k0 + k]) : 0.f;
    }
    for (int i = tid; i < KC * HP; i += PTHREADS) {
      const int k = i / HP, c = i % HP;
      ws[i] = (c < HD && k0 + k < F) ? to_f(w[static_cast<int64_t>(k0 + k) * HD + c]) : 0.f;
    }
    __syncthreads();
    for (int k = 0; k < KC; ++k) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float xv = xs[(ty + 16 * i) * KC + k];
#pragma unroll
        for (int j = 0; j < MAXJ; ++j)
          if (j < nj) acc[i][j] = fmaf(xv, ws[k * HP + tx + 16 * j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < MAXJ; ++j)
      if (j < nj) hs[(ty + 16 * i) * HP + tx + 16 * j] = round_to<XT>(acc[i][j]);
  __syncthreads();
  for (int i = tid; i < PBM * HD; i += PTHREADS) {
    const int r = i / HD, c = i % HD;
    const int64_t row = row0 + r;
    if (row < n) hq[row * HD + c] = from_f<XT>(hs[r * HP + c]);
  }
  attention_terms<XT>(hs, HP, wv, a_s, a_d, row0, PBM, n, HD, H, tid, PTHREADS);
}

// ---- stage 2: the walk ------------------------------------------------------

constexpr int WARPS = 8;  // tiles per block

// 3 blocks an SM (at most 85 registers a thread): measured faster than 2
// (no cap) and 4 (spills)
template <typename XT, int VEC, int NV, int E>
__global__ void __launch_bounds__(WARPS * 32, 3)
gat_layer_walk(const int* __restrict__ tile_rb, const int* __restrict__ tile_cb,
               const int16_t* __restrict__ src_local, const int16_t* __restrict__ dst_local,
               const XT* __restrict__ hq, const float* __restrict__ a_s,
               const float* __restrict__ a_d, float* __restrict__ acc, int T, int R, int C,
               int ET, int HD, int H, int64_t n, float slope) {
  const int t = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (t >= T) return;
  const int cb = tile_cb[t];
  if (cb < 0) return;  // dead tile
  gta::gat_prefix_walk<XT, float, gta::StaticShift, VEC, NV, E>(
      src_local, dst_local, nullptr, static_cast<int64_t>(t) * ET, ET, R, C,
      static_cast<int64_t>(tile_rb[t]) * R, static_cast<int64_t>(cb) * C, hq, a_s, a_d,
      nullptr, acc, HD, H, n, n, n, slope, threadIdx.x & 31);
}

// ---- stage 3: the epilogue --------------------------------------------------

// final activations, codes shared with ops/gat.py SF_CODE; ELU is
// exp(min(v, 0)) - 1 as in the JAX package (no expm1)
__device__ __forceinline__ float sf_apply(float v, int sf, float slope) {
  switch (sf) {
    case 1: return fmaxf(v, 0.f);
    case 2: return v > 0.f ? v : expf(fminf(v, 0.f)) - 1.f;
    case 3: return v >= 0.f ? v : slope * v;
    default: return v;
  }
}

__global__ void gat_layer_finish(const float* __restrict__ acc, float* __restrict__ out,
                                 int64_t n, int HD, int H, int sf, float slope) {
  const int W = HD + H, D = HD / H;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n * HD) return;
  const int64_t r = i / HD;
  const int f = static_cast<int>(i % HD);
  const float* arow = acc + r * W;
  out[i] = sf_apply(arow[f] / fmaxf(arow[HD + f / D], 1e-30f), sf, slope);
}

struct Args {
  const int *rb, *cb;
  const int16_t *s, *d;
  const void *x, *w, *was, *wad;
  void *w_panel, *hq;
  float *a_s, *a_d, *acc, *out;
  int64_t ld_w;
  int T, R, C, ET;
  int64_t n;
  int F, HD, H, sf;
  float slope;
  int stages;
  size_t smem;
  cudaStream_t st;
};

template <typename XT>
struct WalkLaunch {
  const Args& a;
  template <int VEC, int NV, int E>
  cudaError_t run() const {
    gat_layer_walk<XT, VEC, NV, E><<<(a.T + WARPS - 1) / WARPS, WARPS * 32, 0, a.st>>>(
        a.rb, a.cb, a.s, a.d, static_cast<const XT*>(a.hq), a.a_s, a.a_d, a.acc, a.T, a.R,
        a.C, a.ET, a.HD, a.H, a.n, a.slope);
    return cudaGetLastError();
  }
};

template <int N, int XV>
cudaError_t project_wgmma(const Args& a) {
  const size_t smem = proj_wgmma_smem<N>(a.HD, a.H);
  if (a.smem != smem) return cudaErrorInvalidValue;
  auto k = gat_layer_project_wgmma<N, XV>;
  cudaError_t err = gta::set_smem(k, smem);
  if (err != cudaSuccess) return err;
  using B = __nv_bfloat16;
  auto wp = static_cast<B*>(a.w_panel);
  err = gta::write_head_panel(static_cast<const B*>(a.w), wp, a.F, a.HD, 1, N, a.ld_w, a.st);
  if (err != cudaSuccess) return err;
  k<<<static_cast<unsigned>((a.n + P_ROWS - 1) / P_ROWS), P_THREADS, smem, a.st>>>(
      static_cast<const B*>(a.x), wp, a.ld_w, static_cast<const B*>(a.was),
      static_cast<const B*>(a.wad), static_cast<B*>(a.hq), a.a_s, a.a_d, a.n, a.F, a.HD, a.H);
  return cudaGetLastError();
}

// x's staging by its rows' alignment (see the design note)
template <int N>
cudaError_t project_wgmma_n(const Args& a) {
  const uintptr_t xp = reinterpret_cast<uintptr_t>(a.x);
  if (a.F % 8 == 0 && xp % 16 == 0) return project_wgmma<N, 16>(a);
  if (a.F % 2 == 0 && xp % 4 == 0) return project_wgmma<N, 4>(a);
  return project_wgmma<N, 2>(a);
}

template <typename XT>
cudaError_t project(const Args& a) {
  if constexpr (std::is_same_v<XT, __nv_bfloat16>) {
    const int N = gta::wgmma_width(1, a.HD);
    if (N > 0) {
      if (a.w_panel == nullptr || a.ld_w < a.F || a.ld_w % 8 != 0 ||
          reinterpret_cast<uintptr_t>(a.w_panel) % 16 != 0)
        return cudaErrorInvalidValue;
      switch (N) {
        case 8: return project_wgmma_n<8>(a);
        case 32: return project_wgmma_n<32>(a);
        case 48: return project_wgmma_n<48>(a);
        case 64: return project_wgmma_n<64>(a);
        default: return project_wgmma_n<128>(a);
      }
    }
  }
  const size_t smem = proj_fma_smem(a.HD, a.H);
  if (a.smem != smem) return cudaErrorInvalidValue;
  auto k = gat_layer_project_fma<XT>;
  cudaError_t err = gta::set_smem(k, smem);
  if (err != cudaSuccess) return err;
  k<<<static_cast<unsigned>((a.n + PBM - 1) / PBM), PTHREADS, smem, a.st>>>(
      static_cast<const XT*>(a.x), static_cast<const XT*>(a.w),
      static_cast<const XT*>(a.was), static_cast<const XT*>(a.wad), static_cast<XT*>(a.hq),
      a.a_s, a.a_d, a.n, a.F, a.HD, a.H);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t run(const Args& a) {
  cudaError_t err = cudaSuccess;
  if ((a.stages & 1) && a.n > 0) {
    err = project<XT>(a);
    if (err != cudaSuccess) return err;
  }
  if ((a.stages & 2) && a.T > 0) {
    err = gta::gat_walk_config<XT>(a.hq, a.HD, a.H, WalkLaunch<XT>{a});
    if (err != cudaSuccess) return err;
  }
  if ((a.stages & 4) && a.n > 0) {
    const int threads = 256;
    gat_layer_finish<<<static_cast<unsigned>((a.n * a.HD + threads - 1) / threads), threads,
                       0, a.st>>>(a.acc, a.out, a.n, a.HD, a.H, a.sf, a.slope);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

// K14.  x [n, F] contiguous; w [F, HD], wa_src and
// wa_dst [HD, H], all of x's dtype.  bf16 at HD <= 128: w_panel is the
// wrapper's bf16 scratch [N, ld_w] (N = compiler/schedule._gat_wgmma_width
// (1, HD), ld_w >= F a multiple of 8) that the projection's first launch
// fills.  hq [n, HD] of x's dtype; a_s, a_d [n, H] float32 (values of x's
// dtype); acc [n, HD + H] float32 zeroed; out [n, HD] float32.  smem:
// compiler/schedule._gat_layer_smem, the projection's, checked.
extern "C" int gta_gat_layer(const void* tile_rb, const void* tile_cb,
                             const void* src_local, const void* dst_local, const void* x,
                             const void* w, const void* wa_src,
                             const void* wa_dst, int dtype, void* w_panel, int64_t ld_w,
                             void* hq, void* a_s, void* a_d, void* acc, void* out, int T, int R,
                             int C, int ET, int64_t n, int F, int HD, int H, int sf,
                             float slope, int stages, int64_t smem, void* stream) {
  if (HD <= 0 || H <= 0 || H > 32 || HD > 256 || HD % H != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const int*>(tile_rb), static_cast<const int*>(tile_cb),
               static_cast<const int16_t*>(src_local), static_cast<const int16_t*>(dst_local),
               x, w, wa_src, wa_dst, w_panel, hq, static_cast<float*>(a_s),
               static_cast<float*>(a_d), static_cast<float*>(acc), static_cast<float*>(out),
               ld_w, T, R, C, ET, n, F, HD, H, sf, slope, stages,
               static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (dtype == gta::BF16)
    err = run<__nv_bfloat16>(a);
  else
    err = run<float>(a);
  return static_cast<int>(err);
}
