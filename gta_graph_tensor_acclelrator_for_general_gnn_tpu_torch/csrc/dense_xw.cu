// K16 dense_xw: y = round_bf16(x) @ round_bf16(w) with float32 sums and a
// float32 result; with xhat, also xhat = float32(round_bf16(x)), the tensor
// autograd keeps for dW.
//
// Replaces no TPU kernel.  The JAX package leaves x W to XLA, a dot of bf16
// operands with preferred_element_type=float32.  On this card that product
// from PyTorch calls writes a bf16 copy of x (and a float32 one for a
// float32 product) before it multiplies: this kernel reads x once.  Its
// products are the same (exact in float32), summed in float32 in another
// order.
//
// Bound on the card: bytes.  x is read once and y written once: Reddit's
// 232,965 x 602 float32 features into 128 columns are 561 MB + 119 MB, 0.20
// ms at 3.35 TB/s (0.37 ms with xhat's 561 MB more), against 0.036 ms for the
// 35.9 GFLOP at 989 TFLOP/s.
//
// Design.  A persistent grid, as many blocks of WGS warpgroups as fit the
// SMs.  Each block rounds W (this launch's k-segment and column tile) to bf16
// once into shared memory, K-major in the 128-byte swizzle layout (wgmma.cuh
// panel_offset): 64 k a chunk, N padded to the wgmma width NP (8, 32, 48, 64,
// 128) with zero columns, k past K as zero rows.  Each warpgroup then streams
// 64-row tiles of x.  A thread loads just the values of x that its A
// fragments of wgmma m64nNPk16 hold (rows g and g + 8 of its warp's 16; k =
// 2t, 2t + 1, 2t + 8, 2t + 9 of each k-step) from device memory straight into
// registers, by 8-byte loads (a float32 row of 602 features is 8-byte aligned
// and not 16: no TMA, no 16-byte copies; bf16 rows by 4-byte loads), rounds
// them to bf16 there (cvt.rn.bf16x2) and runs a chunk's four k-steps as wgmma
// with A from registers and float32 accumulators.  PF chunks of loads stay in
// flight per thread over the warpgroup's (tile, chunk) sequence, so the next
// tile's first loads are out before a tile's epilogue, which stores the
// accumulators by masked float2 (or scalar) stores.  Rows of odd length or
// unaligned rows take loads of one value.  No copy of x is written unless
// xhat is asked for; then each warp lays its rounded chunk (16 rows of 64)
// into a shared-memory tile of its own and stores it row by row, consecutive
// lanes on consecutive addresses (its fragments' own 32-byte pieces of
// misaligned rows wrote at 0.6 of that rate).  Staging x through shared
// memory by cp.async instead measured slower on the card.
//
// The wrapper (ops/primitives._xw_kernel) cuts N into column tiles of at most
// 128 and K into segments whose W fits shared memory; a later segment adds
// its partial sums into y.
#include "wgmma.cuh"

namespace {

constexpr int WGS = 2;              // warpgroups a block
constexpr int THREADS = 128 * WGS;
constexpr int ROWS = 64;            // rows of a tile: one warpgroup's wgmma M
constexpr int KC = 64;              // k of a chunk: one 128-byte swizzle row of W
constexpr int STEPS = KC / 16;      // wgmma k-steps a chunk
constexpr int PF = 2;               // chunks of x loaded ahead, per thread
constexpr int HAT_BYTES = 16 * KC * 4;  // a warp's xhat tile: 16 rows of a chunk
constexpr size_t SMEM_MAX = 232448;

// shared memory of a launch over K columns of x into an NP-wide tile: W's
// chunks, the warps' xhat tiles and 1 KB for aligning them
// (ops/primitives._xw_smem mirrors this)
inline size_t xw_smem(int K, int NP) {
  return static_cast<size_t>((K + KC - 1) / KC) * NP * 128 +
         static_cast<size_t>(WGS) * 4 * HAT_BYTES + 1024;
}

// a pair of x's values along k: float32 as loaded, bf16 packed as a fragment
template <typename XT> struct Pair;
template <> struct Pair<float> { using T = float2; };
template <> struct Pair<__nv_bfloat16> { using T = uint32_t; };

// x[col], x[col + 1] of row p, zeros past K or off the rows; VEC 2: one load
// (K even, the row aligned to the pair)
template <int VEC>
__device__ __forceinline__ float2 load_pair(const float* p, int col, bool ok, int K) {
  float2 v = make_float2(0.f, 0.f);
  if constexpr (VEC == 2) {
    if (ok && col < K) v = __ldg(reinterpret_cast<const float2*>(p + col));
  } else {
    if (ok && col < K) v.x = __ldg(p + col);
    if (ok && col + 1 < K) v.y = __ldg(p + col + 1);
  }
  return v;
}
template <int VEC>
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p, int col, bool ok, int K) {
  uint32_t v = 0;
  if constexpr (VEC == 2) {
    if (ok && col < K) v = __ldg(reinterpret_cast<const unsigned int*>(p + col));
  } else {
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
    if (ok && col < K) v = __ldg(q + col);
    if (ok && col + 1 < K) v |= static_cast<uint32_t>(__ldg(q + col + 1)) << 16;
  }
  return v;
}

__device__ __forceinline__ uint32_t to_frag(float2 v) { return gta::pack_bf16(v.x, v.y); }
__device__ __forceinline__ uint32_t to_frag(uint32_t v) { return v; }

__device__ __forceinline__ float bf16_lo(uint32_t f) { return __uint_as_float(f << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t f) { return __uint_as_float(f & 0xffff0000u); }

// float2 unit u (k = 2u, 2u + 1) of row r of a warp's xhat tile, swizzled so
// that a fragment-layout write and a row-wise read both hit 32 distinct banks
__device__ __forceinline__ int hat_at(int r, int u) { return r * KC * 4 + 8 * (u ^ ((r & 3) << 2)); }

__device__ __forceinline__ float w_at(const void* w, int w_bf16, int64_t ldw, int k, int n, int K,
                                      int N) {
  if (k >= K || n >= N) return 0.f;
  const int64_t i = k * ldw + n;
  return w_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(w)[i])
                : static_cast<const float*>(w)[i];
}

template <typename XT, int VEC, int NP>
__global__ void __launch_bounds__(THREADS, 1)
dense_xw_kernel(const XT* __restrict__ x, int64_t ldx, const void* __restrict__ w, int64_t ldw,
                int w_bf16, float* __restrict__ y, int64_t ldy, int y_vec,
                float* __restrict__ xhat, int64_t ldxh, int64_t M, int K, int N,
                int accumulate) {
  using P = typename Pair<XT>::T;
  extern __shared__ __align__(1024) char smem_raw[];
  const uint32_t raw0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t pad = (1024u - (raw0 & 1023u)) & 1023u;
  const uint32_t wsm = raw0 + pad;
  char* ws = smem_raw + pad;
  const int nch = (K + KC - 1) / KC;
  const int tid = threadIdx.x, lane = tid & 31;
  char* hat = ws + nch * NP * 128 + (tid >> 5) * HAT_BYTES;  // this warp's xhat tile
  const int g = lane >> 2, t = lane & 3;
  const int rw = ((tid >> 5) & 3) * 16 + g;  // this thread's rows of a tile: rw, rw + 8
  const int64_t tiles = (M + ROWS - 1) / ROWS;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * WGS;
  // load and compute cursors over this warpgroup's (tile, chunk) sequence
  int64_t lt = static_cast<int64_t>(blockIdx.x) * WGS + (tid >> 7), ct = lt;
  int lc = 0, cc = 0;

  P buf[PF][STEPS][4];  // [chunk in flight][k-step][A fragment register]
  auto load = [&](P (&b)[STEPS][4]) {
    const int64_t r0 = lt * ROWS + rw, r1 = r0 + 8;
    const bool ok0 = r0 < M, ok1 = r1 < M;
    const XT* p0 = x + (ok0 ? r0 : 0) * ldx;
    const XT* p1 = x + (ok1 ? r1 : 0) * ldx;
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      const int col = lc * KC + 16 * s + 2 * t;
      b[s][0] = load_pair<VEC>(p0, col, ok0, K);
      b[s][1] = load_pair<VEC>(p1, col, ok1, K);
      b[s][2] = load_pair<VEC>(p0, col + 8, ok0, K);
      b[s][3] = load_pair<VEC>(p1, col + 8, ok1, K);
    }
  };

  // x's first chunks go out before W is staged
#pragma unroll
  for (int p = 0; p < PF; ++p) {
    if (lt < tiles) load(buf[p]);
    if (++lc == nch) lc = 0, lt += stride;
  }
  // W rounded into the panel: unit (c, n, j) holds k = 64 c + 8 j .. + 7 of
  // column n.  Every block reads all of W from L2 at once, so each starts
  // at its own place in it.
  const int units = nch * NP * 8, first = static_cast<int>(blockIdx.x * 64 % units);
#pragma unroll 4
  for (int i = tid; i < units; i += THREADS) {
    const int u = (i + first) % units;
    const int n = u % NP, j = (u / NP) % 8, c = u / (NP * 8);
    const int k = c * KC + 8 * j;
    uint4 q;
    q.x = gta::pack_bf16(w_at(w, w_bf16, ldw, k, n, K, N), w_at(w, w_bf16, ldw, k + 1, n, K, N));
    q.y = gta::pack_bf16(w_at(w, w_bf16, ldw, k + 2, n, K, N), w_at(w, w_bf16, ldw, k + 3, n, K, N));
    q.z = gta::pack_bf16(w_at(w, w_bf16, ldw, k + 4, n, K, N), w_at(w, w_bf16, ldw, k + 5, n, K, N));
    q.w = gta::pack_bf16(w_at(w, w_bf16, ldw, k + 6, n, K, N), w_at(w, w_bf16, ldw, k + 7, n, K, N));
    *reinterpret_cast<uint4*>(ws + c * NP * 128 + gta::panel_offset(n, j)) = q;
  }
  gta::fence_proxy_async();  // the panel's stores, visible to the tensor cores
  __syncthreads();

  float acc[NP / 2];
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) acc[i] = 0.f;
  while (ct < tiles) {
#pragma unroll
    for (int p = 0; p < PF; ++p) {
      if (ct >= tiles) break;
      const int64_t r0 = ct * ROWS + rw, r1 = r0 + 8;
      uint32_t a[STEPS][4];
      gta::wgmma_wait<0>();  // the last chunk's products have read their fragments
#pragma unroll
      for (int s = 0; s < STEPS; ++s)
#pragma unroll
        for (int i = 0; i < 4; ++i) a[s][i] = to_frag(buf[p][s][i]);
      if (xhat != nullptr) {
        // the warp's 16 rows of the chunk, rounded, through its tile
        __syncwarp();
#pragma unroll
        for (int s = 0; s < STEPS; ++s)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t f = a[s][i];
            *reinterpret_cast<float2*>(hat + hat_at(g + 8 * (i & 1), 8 * s + 4 * (i >> 1) + t)) =
                make_float2(bf16_lo(f), bf16_hi(f));
          }
        __syncwarp();
        const int col = cc * KC + 2 * lane;
        const int64_t row0 = ct * ROWS + (rw - g);
#pragma unroll 4
        for (int r = 0; r < 16; ++r) {
          const float2 v = *reinterpret_cast<const float2*>(hat + hat_at(r, lane));
          if (row0 + r >= M) break;
          float* q = xhat + (row0 + r) * ldxh + col;
          if constexpr (VEC == 2) {
            if (col < K) *reinterpret_cast<float2*>(q) = v;
          } else {
            if (col < K) q[0] = v.x;
            if (col + 1 < K) q[1] = v.y;
          }
        }
      }
      if (lt < tiles) load(buf[p]);
      if (++lc == nch) lc = 0, lt += stride;
      gta::wgmma_fence();
#pragma unroll
      for (int s = 0; s < STEPS; ++s)
        if (cc * KC + 16 * s < K)
          gta::wgmma_rs<NP, 0>(acc, a[s], gta::smem_desc(wsm + cc * NP * 128 + 32 * s, 16, 1024));
      gta::wgmma_commit();
      if (++cc < nch) continue;
      // the tile's last chunk: acc[4j + 2v + u] = y[rw + 8v][8j + 2t + u]
      gta::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < NP / 2; ++i) gta::fence_reg(acc[i]);
#pragma unroll
      for (int j = 0; j < NP / 8; ++j) {
        const int col = 8 * j + 2 * t;
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int64_t r = v ? r1 : r0;
          float lo = acc[4 * j + 2 * v], hi = acc[4 * j + 2 * v + 1];
          if (r >= M || col >= N) continue;
          float* q = y + r * ldy + col;
          if (y_vec) {  // N even: a pair never straddles N
            if (accumulate) {
              const float2 o = *reinterpret_cast<const float2*>(q);
              lo += o.x, hi += o.y;
            }
            *reinterpret_cast<float2*>(q) = make_float2(lo, hi);
          } else {
            q[0] = accumulate ? q[0] + lo : lo;
            if (col + 1 < N) q[1] = accumulate ? q[1] + hi : hi;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < NP / 2; ++i) acc[i] = 0.f;
      cc = 0, ct += stride;
    }
  }
}

struct Args {
  const void* x;
  int64_t ldx;
  const void* w;
  int64_t ldw;
  int w_bf16;
  float* y;
  int64_t ldy;
  int y_vec;
  float* xhat;
  int64_t ldxh, M;
  int K, N, accumulate;
  size_t smem;
  cudaStream_t st;
};

template <typename XT, int VEC, int NP>
cudaError_t launch(const Args& a) {
  auto k = dense_xw_kernel<XT, VEC, NP>;
  cudaError_t err = gta::set_smem(k, a.smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, THREADS, a.smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t tiles = (a.M + ROWS - 1) / ROWS;
  const int64_t room = static_cast<int64_t>(sms) * per_sm, want = (tiles + WGS - 1) / WGS;
  const int64_t blocks = want < room ? want : room;
  k<<<static_cast<unsigned>(blocks), THREADS, a.smem, a.st>>>(
      static_cast<const XT*>(a.x), a.ldx, a.w, a.ldw, a.w_bf16, a.y, a.ldy, a.y_vec, a.xhat,
      a.ldxh, a.M, a.K, a.N, a.accumulate);
  return cudaGetLastError();
}

template <typename XT, int VEC>
cudaError_t launch_np(const Args& a, int NP) {
  switch (NP) {
    case 8: return launch<XT, VEC, 8>(a);
    case 32: return launch<XT, VEC, 32>(a);
    case 48: return launch<XT, VEC, 48>(a);
    case 64: return launch<XT, VEC, 64>(a);
    default: return launch<XT, VEC, 128>(a);
  }
}

}  // namespace

// K16.  x [M, K] of x_dtype (float32 or bf16), rows ldx elements apart,
// unit stride along k; w [K, N] of w_dtype, rows ldw apart, 1 <= N <= 128;
// y [M, N] float32, rows ldy apart: written, or with `accumulate` added to;
// xhat [M, K] float32, rows ldxh apart, or null.  smem:
// ops/primitives._xw_smem(K, NP), checked.
extern "C" int gta_dense_xw(const void* x, int64_t ldx, int x_dtype, const void* w, int64_t ldw,
                            int w_dtype, void* y, int64_t ldy, void* xhat, int64_t ldxh,
                            int64_t M, int K, int N, int accumulate, int64_t smem,
                            void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || N > 128 || (x_dtype != gta::F32 && x_dtype != gta::BF16) ||
      (w_dtype != gta::F32 && w_dtype != gta::BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const int NP = gta::wgmma_width(1, N);
  if (static_cast<size_t>(smem) != xw_smem(K, NP) || static_cast<size_t>(smem) > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool bf16 = x_dtype == gta::BF16;
  const uintptr_t pair = bf16 ? 4 : 8;
  const bool vec = K % 2 == 0 && ldx % 2 == 0 && reinterpret_cast<uintptr_t>(x) % pair == 0 &&
                   (xhat == nullptr ||
                    (ldxh % 2 == 0 && reinterpret_cast<uintptr_t>(xhat) % 8 == 0));
  const int y_vec = N % 2 == 0 && ldy % 2 == 0 && reinterpret_cast<uintptr_t>(y) % 8 == 0;
  const Args a{x, ldx, w, ldw, w_dtype == gta::BF16, static_cast<float*>(y), ldy, y_vec,
               static_cast<float*>(xhat), ldxh, M, K, N, accumulate, static_cast<size_t>(smem),
               static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (bf16)
    err = vec ? launch_np<__nv_bfloat16, 2>(a, NP) : launch_np<__nv_bfloat16, 1>(a, NP);
  else
    err = vec ? launch_np<float, 2>(a, NP) : launch_np<float, 1>(a, NP);
  return static_cast<int>(err);
}
