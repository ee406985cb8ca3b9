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
//     kernel's h_cb.astype(dt) and its one-hot gather of asrc_cb.astype(dt)).
//     One CUDA block per 64 rows: bf16 on the tensor cores (mma.sync
//     m16n8k16, exact products, f32 sums), float32 by FMA on the CUDA cores
//     (never TF32).  The block keeps its 64 x HD tile of hq in shared memory
//     and derives a_s and a_d from it.
//  2. walk: one warp per tile over its live slots (found by ballot, as in
//     tile_walk.cuh; dead tiles and pad slots add nothing), with the static
//     shift:
//       e = min(leaky(a_s[s] + a_d[d]), SHIFT + 60),  p = exp(e - SHIFT)
//       den[d] += round(p),  num[d, f] += round(p[f / D] hq[s, f])
//     (SHIFT = 12; round to the compute dtype before the float32 sums, as
//     the TPU kernel's scatter_rows casts both before its sum).  A tile's
//     slots are sorted by receiver (tile_graph), so, as K13 does, the warp
//     sums a receiver's run in registers and adds it to the row with one
//     float32 atomic per (row, column): a hub row of 2e5 edges takes a few
//     hundred atomic adds of run sums, not 2e5 of single terms, which keeps
//     its float32 sum-order error near that of a blocked sum.  Tile
//     weights are not read: the layer's tilings are unit-weight, as in JAX.
//  3. epilogue: out[r, f] = sf(num[r, f] / max(den[r, f / D], 1e-30)) for
//     every row, so a row that no live slot reaches reads sf(0).
//
// Bound on the card: bytes for the walk (one hq row gathered per live slot,
// HD + H float32 atomics per receiver run), operations for the projection
// at wide F (2 n F HD: 36 GFLOP at Reddit's F = 602, HD = 128).  The design
// is simple and right first: the projection stages x and W through shared
// memory with plain loads.
#include <type_traits>

#include "common.cuh"

namespace {

using gta::round_to;
using gta::to_f;

constexpr int PBM = 64, PTHREADS = 256;  // projection: rows and threads per block
constexpr int KC = 32, KPAD = 8;         // k chunk of x W, bf16 row padding
constexpr int MAXN = 16;                 // mma n-tiles per warp: HD <= 256
constexpr int MAXJ = 16;                 // FMA columns per thread: HD <= 256
constexpr int WARPS = 8;                 // walk: tiles per block
constexpr int MAXF = 8;                  // walk: features per lane, HD <= 256
constexpr float SHIFT = 12.f;            // the static softmax shift

__host__ __device__ inline int padded(int HD) { return (HD + 15) / 16 * 16; }

// dynamic shared memory of the projection, bytes: the f32 hq tile and the
// attention vectors (the epilogue), then the k-chunk staging of x and W
inline size_t proj_smem_bytes(int HD, int H, bool mma) {
  const size_t HP = padded(HD);
  const size_t epi = (PBM * HP + 2 * static_cast<size_t>(HD) * H) * 4;
  const size_t stage = mma ? (PBM + HP) * (KC + KPAD) * 2 : (PBM * KC + KC * HP) * 4;
  return epi + stage;
}

template <typename XT>
__device__ __forceinline__ XT from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename XT, bool MMA>
__global__ void __launch_bounds__(PTHREADS)
gat_layer_project(const XT* __restrict__ x, const XT* __restrict__ w,
                  const XT* __restrict__ was, const XT* __restrict__ wad,
                  XT* __restrict__ hq, XT* __restrict__ a_s, float* __restrict__ a_d,
                  int64_t n, int F, int HD, int H) {
  extern __shared__ __align__(16) float smem[];
  const int HP = padded(HD), H2 = 2 * H;
  float* hs = smem;                 // [PBM, HP] hq of the block's rows, f32
  float* wv = hs + PBM * HP;        // [HD, 2H]  wa_s | wa_d
  float* stage = wv + HD * H2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * PBM;
  for (int i = tid; i < HD * H; i += PTHREADS) {
    const int f = i / H, hh = i % H;
    wv[f * H2 + hh] = to_f(was[i]);
    wv[f * H2 + H + hh] = to_f(wad[i]);
  }

  if constexpr (MMA) {
    constexpr int KP = KC + KPAD;
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(stage);  // [PBM, KP]
    __nv_bfloat16* wt = xs + PBM * KP;                            // [HP, KP] W^T
    const int g = lane >> 2, tq = lane & 3;
    const int mt = warp & 3, ng = warp >> 2;  // 16-row m-tile; n-tiles ng, ng + 2, ...
    float acc[MAXN][4];
#pragma unroll
    for (int i = 0; i < MAXN; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    for (int k0 = 0; k0 < F; k0 += KC) {
      __syncthreads();
      for (int i = tid; i < PBM * KC; i += PTHREADS) {
        const int r = i / KC, k = i % KC;
        const int64_t row = row0 + r;
        xs[r * KP + k] = (row < n && k0 + k < F) ? x[row * F + k0 + k]
                                                 : __float2bfloat16_rn(0.f);
      }
      for (int i = tid; i < KC * HP; i += PTHREADS) {
        const int k = i / HP, c = i % HP;
        wt[c * KP + k] = (c < HD && k0 + k < F) ? w[static_cast<int64_t>(k0 + k) * HD + c]
                                                : __float2bfloat16_rn(0.f);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        const __nv_bfloat16* ar = xs + (mt * 16 + g) * KP + kk + 2 * tq;
        const uint32_t a0 = gta::ld32(ar), a1 = gta::ld32(ar + 8 * KP);
        const uint32_t a2 = gta::ld32(ar + 8), a3 = gta::ld32(ar + 8 * KP + 8);
#pragma unroll
        for (int i = 0; i < MAXN; ++i) {
          const int nt = ng + 2 * i;
          if (nt * 8 < HP) {
            const __nv_bfloat16* br = wt + (nt * 8 + g) * KP + kk + 2 * tq;
            gta::mma_bf16(acc[i], a0, a1, a2, a3, gta::ld32(br), gta::ld32(br + 8));
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MAXN; ++i) {
      const int nt = ng + 2 * i;
      if (nt * 8 < HP) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = mt * 16 + g + (j >= 2 ? 8 : 0);
          const int c = nt * 8 + 2 * tq + (j & 1);
          hs[r * HP + c] = round_to<XT>(acc[i][j]);
        }
      }
    }
  } else {
    float* xs = stage;          // [PBM, KC]
    float* ws = xs + PBM * KC;  // [KC, HP]
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
  }
  __syncthreads();

  for (int i = tid; i < PBM * HD; i += PTHREADS) {
    const int r = i / HD, c = i % HD;
    const int64_t row = row0 + r;
    if (row < n) hq[row * HD + c] = from_f<XT>(hs[r * HP + c]);
  }
  // a_s | a_d of each row: a dot over the row's HD values, f32, rounded
  for (int i = tid; i < PBM * H2; i += PTHREADS) {
    const int r = i / H2, j = i % H2;
    const int64_t row = row0 + r;
    if (row >= n) continue;
    const float* hr = hs + r * HP;
    float s = 0.f;
    for (int f = 0; f < HD; ++f) s = fmaf(hr[f], wv[f * H2 + j], s);
    const float v = round_to<XT>(s);
    if (j < H)
      a_s[row * H + j] = from_f<XT>(v);
    else
      a_d[row * H + j - H] = v;
  }
}

// add one receiver's run (num in the lanes' features, den of head `lane`)
// into row r of [num | den]
__device__ __forceinline__ void flush_run(float* __restrict__ acc, int64_t r, int W,
                                          int HD, int H, const float* num, float den,
                                          int lane) {
  float* arow = acc + r * W;
#pragma unroll
  for (int k = 0; k < MAXF; ++k) {
    const int f = lane + 32 * k;
    if (f < HD) atomicAdd(arow + f, num[k]);
  }
  if (lane < H) atomicAdd(arow + HD + lane, den);
}

template <typename XT>
__global__ void __launch_bounds__(WARPS * 32)
gat_layer_walk(const int* __restrict__ tile_rb, const int* __restrict__ tile_cb,
               const int16_t* __restrict__ src_local, const int16_t* __restrict__ dst_local,
               const XT* __restrict__ hq, const XT* __restrict__ a_s,
               const float* __restrict__ a_d, float* __restrict__ acc, int T, int R, int C,
               int ET, int HD, int H, int64_t n, float slope) {
  const int t = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (t >= T) return;
  const int cb = tile_cb[t];
  if (cb < 0) return;  // dead tile
  const int lane = threadIdx.x & 31, W = HD + H, D = HD / H;
  const int64_t base = static_cast<int64_t>(t) * ET;
  const int64_t row0 = static_cast<int64_t>(tile_rb[t]) * R;
  const int64_t col0 = static_cast<int64_t>(cb) * C;
  float num[MAXF], den = 0.f;  // the run's sums; lane hh < H holds head hh's den
  int64_t cur = -1;            // the run's receiver (the same in every lane)
  for (int e0 = 0; e0 < ET; e0 += 32) {
    const int e = e0 + lane;
    int s = C, d = R;
    if (e < ET) {
      s = src_local[base + e];
      d = dst_local[base + e];
    }
    const bool live = s >= 0 && s < C && d >= 0 && d < R && col0 + s < n && row0 + d < n;
    unsigned todo = __ballot_sync(0xffffffffu, live);
    while (todo) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      const int64_t src = col0 + __shfl_sync(0xffffffffu, s, j);
      const int64_t r = row0 + __shfl_sync(0xffffffffu, d, j);
      if (r != cur) {
        if (cur >= 0) flush_run(acc, cur, W, HD, H, num, den, lane);
        cur = r;
        den = 0.f;
#pragma unroll
        for (int k = 0; k < MAXF; ++k) num[k] = 0.f;
      }
      float p = 0.f;
      if (lane < H) {
        const float e = fminf(gta::leaky(to_f(a_s[src * H + lane]) + a_d[r * H + lane], slope),
                              SHIFT + 60.f);
        p = expf(e - SHIFT);
        den += round_to<XT>(p);
      }
#pragma unroll
      for (int k = 0; k < MAXF; ++k) {
        const int f = lane + 32 * k;
        const float pf = __shfl_sync(0xffffffffu, p, f < HD ? f / D : 0);
        if (f < HD) num[k] += round_to<XT>(pf * to_f(hq[src * HD + f]));
      }
    }
  }
  if (cur >= 0) flush_run(acc, cur, W, HD, H, num, den, lane);
}

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

template <typename XT>
cudaError_t run(const int* rb, const int* cb, const int16_t* s, const int16_t* d,
                const void* x, const void* w, const void* was, const void* wad, void* hq,
                void* a_s, float* a_d, float* acc, float* out, int T, int R, int C, int ET,
                int64_t n, int F, int HD, int H, int sf, float slope, int stages,
                cudaStream_t st) {
  constexpr bool MMA = std::is_same_v<XT, __nv_bfloat16>;
  cudaError_t err = cudaSuccess;
  if ((stages & 1) && n > 0) {
    const size_t smem = proj_smem_bytes(HD, H, MMA);
    auto k = gat_layer_project<XT, MMA>;
    err = gta::set_smem(k, smem);
    if (err != cudaSuccess) return err;
    k<<<static_cast<unsigned>((n + PBM - 1) / PBM), PTHREADS, smem, st>>>(
        static_cast<const XT*>(x), static_cast<const XT*>(w), static_cast<const XT*>(was),
        static_cast<const XT*>(wad), static_cast<XT*>(hq), static_cast<XT*>(a_s), a_d, n,
        F, HD, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if ((stages & 2) && T > 0) {
    gat_layer_walk<XT><<<(T + WARPS - 1) / WARPS, WARPS * 32, 0, st>>>(
        rb, cb, s, d, static_cast<const XT*>(hq), static_cast<const XT*>(a_s), a_d, acc, T,
        R, C, ET, HD, H, n, slope);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if ((stages & 4) && n > 0) {
    const int threads = 256;
    gat_layer_finish<<<static_cast<unsigned>((n * HD + threads - 1) / threads), threads, 0,
                       st>>>(acc, out, n, HD, H, sf, slope);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

extern "C" int gta_gat_layer(const void* tile_rb, const void* tile_cb,
                             const void* src_local, const void* dst_local, const void* x,
                             const void* w, const void* wa_src, const void* wa_dst,
                             int dtype, void* hq, void* a_s, void* a_d, void* acc, void* out,
                             int T, int R, int C, int ET, int64_t n, int F, int HD, int H,
                             int sf, float slope, int stages, void* stream) {
  if (HD <= 0 || H <= 0 || H > 32 || HD > 256 || HD % H != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto rb = static_cast<const int*>(tile_rb);
  auto cb = static_cast<const int*>(tile_cb);
  auto s = static_cast<const int16_t*>(src_local);
  auto d = static_cast<const int16_t*>(dst_local);
  auto ad = static_cast<float*>(a_d);
  auto ac = static_cast<float*>(acc);
  auto o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == gta::BF16)
    err = run<__nv_bfloat16>(rb, cb, s, d, x, w, wa_src, wa_dst, hq, a_s, ad, ac, o, T, R, C,
                             ET, n, F, HD, H, sf, slope, stages, st);
  else
    err = run<float>(rb, cb, s, d, x, w, wa_src, wa_dst, hq, a_s, ad, ac, o, T, R, C, ET, n,
                     F, HD, H, sf, slope, stages, st);
  return static_cast<int>(err);
}
