// K2 spmm_dense_blocks: dense-block SpMM, Y_rb += A_b @ X_cb over the dense
// adjacency blocks of the density split.
//
// Replaces the TPU kernels ops/dense.py:_spmm_dense_kernel (rb-major blocks)
// and _spmm_dense_super_kernel (supergroup order, G row blocks resident) of
// the JAX package: on Hopper both are this one kernel, which walks
// per-row-block lists of block ids and so accepts either block order.
//
// Bound on the card: the count stream.  A 256 x 256 int8 block (64 KB)
// times a 256 x 128 bf16 panel is 16.8 MFLOP, 256 FLOP per count byte,
// near the card's balance point (295 for bf16), so a kernel that keeps the
// tensor cores fed runs at the rate it streams counts (3.35 TB/s).
//
// Design (bf16 x, the path GCN runs): one CUDA block of four warpgroups
// owns all 256 rows of a row block for one feature tile (N = 128, or 64
// for F <= 64, as for the 41 logits of a last layer), over a run of at
// most DENSE_WIDE_SEGMENT dense blocks of that row block
// (DenseBlockGraph.wide_segments, their ids read once into shared
// memory), so each x panel is read once per dense block and each output
// stripe takes one epilogue per run.  The count and x tiles of successive
// 128-byte k-chunks (128 int8 columns, 64 bf16) stream through a ring of
// STAGES shared-memory stages filled by cp.async (16-byte copies,
// zero-filled past the block's edges); the copies of the next two chunks
// are issued right after this chunk's products, so they overlap the
// tensor cores' work.  Each warpgroup runs wgmma m64nNk16 with float32
// accumulators in registers across the whole run: A (the counts) from
// registers, widened from int8 to bf16 in the warp (exact: counts up to
// 127), B (x) from shared memory, MN-major in the 128-byte swizzle layout
// (x_offset), which the 16-byte copies write directly.  The k order
// inside each 16-column step is permuted (column 4t + q of the chunk is k
// index 2t + q, or 2t + 6 + q for q >= 2) so that a thread's four A values
// of a row are one 32-bit word of counts; the x rows are stored in the
// same permuted order, which leaves the product unchanged.  The epilogue
// adds each accumulator into the zeroed output once, with float2 atomics
// where F is even (a row block's runs meet there; the order varies by
// run, f32 rounding only); stripes no dense block visits read 0.  x rows
// must be 16-byte aligned: the wrapper pads a copy of x to a multiple of
// 8 features where F is not one.  Products are exact and accumulate in
// f32, as the TPU's bf16 matmul.
//
// float32 x stays on the CUDA cores (f32 FMAs over 64 x 64 tiles, 8 dense
// blocks per CUDA block), so float32 stays float32.  The separable
// row/column scales stay outside, in plain torch, as on the TPU.
#include "wgmma.cuh"

namespace {

using gta::cp_async16;
using gta::cp_async_commit;
using gta::cp_async_wait;
using gta::fence_reg;
using gta::pack_bf16;
using gta::smem_desc;
using gta::to_f;

constexpr int BM = 64, BN = 64, BK = 32, THREADS = 256;

// ---- float32 path: CUDA-core FMAs --------------------------------------

template <typename VT, typename XT>
__global__ void __launch_bounds__(THREADS)
spmm_dense_fma_kernel(const int* __restrict__ segments,
                      const int* __restrict__ row_blocks,
                      const int* __restrict__ blk_cb, const VT* __restrict__ values,
                      const XT* __restrict__ x, float* __restrict__ y, int R, int C,
                      int F, int64_t n_x, int64_t n_out) {
  __shared__ float As[BM][BK + 1];
  __shared__ float Xs[BK][BN];
  const int* seg = segments + 3 * blockIdx.x;
  const int rb = seg[0], k_begin = seg[1], k_end = seg[2];
  const int r0 = blockIdx.y * BM, f0 = blockIdx.z * BN;
  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;  // rows tr*4+i, cols tc+16*j
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k = k_begin; k < k_end; ++k) {
    const int b = row_blocks[k];
    const int64_t col0 = static_cast<int64_t>(blk_cb[b]) * C;
    const VT* A = values + static_cast<int64_t>(b) * R * C;
    for (int c0 = 0; c0 < C; c0 += BK) {
      for (int idx = tid; idx < BM * BK; idx += THREADS) {
        const int r = idx / BK, c = idx % BK;
        const int rr = r0 + r, cc = c0 + c;
        As[r][c] = (rr < R && cc < C) ? to_f(A[static_cast<int64_t>(rr) * C + cc]) : 0.f;
      }
      for (int idx = tid; idx < BK * BN; idx += THREADS) {
        const int c = idx / BN, f = idx % BN;
        const int64_t xr = col0 + c0 + c;
        Xs[c][f] = (c0 + c < C && xr < n_x && f0 + f < F) ? to_f(x[xr * F + f0 + f]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        float a[4], v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[tr * 4 + i][kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = Xs[kk][tc + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], v[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + tr * 4 + i;
    const int64_t row = static_cast<int64_t>(rb) * R + r;
    if (r >= R || row >= n_out) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = f0 + tc + 16 * j;
      if (f < F) atomicAdd(y + row * F + f, acc[i][j]);
    }
  }
}

// ---- bf16 path: wgmma over a cp.async ring --------------------------------

constexpr int WG_ROWS = 256;     // rows of a row block per CUDA block
constexpr int WG_THREADS = 512;  // four warpgroups, 64 rows each
constexpr int STAGES = 3;        // ring depth: two chunks in flight
constexpr int CHUNK_BYTES = 128; // bytes of a count row per k-chunk
constexpr int MAX_SEG = 16;      // graph.DENSE_WIDE_SEGMENT: ids kept in shared memory

// k-chunk depth and shared-memory row stride (bytes) of the count tile:
// 144 (int8) and 160 (bf16) make the fragment loads conflict-free
template <typename VT> struct ATile {
  static constexpr int KC = CHUNK_BYTES / static_cast<int>(sizeof(VT));
  static constexpr int STRIDE = CHUNK_BYTES + (sizeof(VT) == 1 ? 16 : 32);
};

// a stage: the count tile, then the x tile (both multiples of 1 KB, so
// every x tile starts on a 1 KB swizzle atom)
template <typename VT, int N>
__host__ __device__ constexpr int stage_bytes() {
  return WG_ROWS * ATile<VT>::STRIDE + ATile<VT>::KC * N * 2;
}

// byte offset of the 16-byte piece (logical k row L, feature unit j of 8)
// in an x tile of N features: 1 KB atoms of 8 k rows x 64 features, atom
// (L / 8, j / 8) at ((L / 8) (N / 64) + j / 8) KB, row L % 8 at 128 B,
// its 16-byte units XOR-permuted by the row (the B128 swizzle), so the
// tensor cores read 8 rows of one unit column from 8 different banks
template <int N>
__device__ __forceinline__ int x_offset(int L, int j) {
  const int kr = L & 7;
  return ((L >> 3) * (N / 64) + (j >> 3)) * 1024 + 128 * kr + 16 * ((j & 7) ^ kr);
}

__device__ __forceinline__ float byte_f(uint32_t w, int i) {
  return static_cast<float>(static_cast<int8_t>((w >> (8 * i)) & 0xffu));
}

// A fragment of one 16-column step from the count tile (rows ra, ra + 8 of
// the warp's 16): a0 = row ra, k 2t..2t+1; a1 = row ra + 8; a2 = row ra,
// k 2t+8..2t+9; a3 = row ra + 8 -- under the permuted k order these are
// the thread's 4 consecutive columns 4t..4t+3 of each row
__device__ __forceinline__ void a_frag(uint32_t* a, const char* r0, const char* r1,
                                       int8_t) {
  const uint32_t w0 = *reinterpret_cast<const uint32_t*>(r0);
  const uint32_t w1 = *reinterpret_cast<const uint32_t*>(r1);
  a[0] = pack_bf16(byte_f(w0, 0), byte_f(w0, 1));
  a[1] = pack_bf16(byte_f(w1, 0), byte_f(w1, 1));
  a[2] = pack_bf16(byte_f(w0, 2), byte_f(w0, 3));
  a[3] = pack_bf16(byte_f(w1, 2), byte_f(w1, 3));
}
__device__ __forceinline__ void a_frag(uint32_t* a, const char* r0, const char* r1,
                                       __nv_bfloat16) {
  const uint2 v0 = *reinterpret_cast<const uint2*>(r0);
  const uint2 v1 = *reinterpret_cast<const uint2*>(r1);
  a[0] = v0.x;
  a[1] = v1.x;
  a[2] = v0.y;
  a[3] = v1.y;
}

// chunk column of the x row stored at logical k row L (the permuted order)
__device__ __forceinline__ int phys_col(int L) {
  const int l = L & 15;
  return (L & ~15) + 4 * ((l & 7) >> 1) + (l & 1) + (l >= 8 ? 2 : 0);
}

template <typename VT, int N>
__global__ void __launch_bounds__(WG_THREADS, 1)
spmm_dense_wgmma_kernel(const int* __restrict__ segments, const int* __restrict__ row_blocks,
                        const int* __restrict__ blk_cb, const VT* __restrict__ values,
                        const __nv_bfloat16* __restrict__ x, float* __restrict__ y, int R,
                        int C, int F, int ld, int64_t n_x, int64_t n_out) {
  using AT = ATile<VT>;
  constexpr int KC = AT::KC, STRIDE = AT::STRIDE, KSTEPS = KC / 16, NG = N / 8;
  constexpr int A_BYTES = WG_ROWS * STRIDE, SB = stage_bytes<VT, N>();
  constexpr int CPR = CHUNK_BYTES / 16;            // 16-byte copies per count row
  constexpr int EPC = 16 / static_cast<int>(sizeof(VT));  // values per copy
  extern __shared__ __align__(1024) char smem_raw[];
  __shared__ int s_b[MAX_SEG];                     // the run's block ids
  __shared__ int64_t s_col0[MAX_SEG];              // and their first x rows
  // the ring starts on a 1 KB boundary (the launch adds 1 KB for this)
  const uint32_t raw0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t pad = (1024u - (raw0 & 1023u)) & 1023u;
  const uint32_t smem0 = raw0 + pad;
  const char* smem = smem_raw + pad;
  const int* seg = segments + 3 * blockIdx.x;
  const int rb = seg[0], k_begin = seg[1], k_end = seg[2];
  const int r_base = blockIdx.y * WG_ROWS, f0 = blockIdx.z * N;
  const int rows_here = min(WG_ROWS, R - r_base);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2;                        // warpgroup: rows 64 wg ..
  const bool active = wg * 64 < rows_here;         // uniform per warpgroup
  const int cpb = (C + KC - 1) / KC;               // k-chunks per dense block
  const int iters = (k_end - k_begin) * cpb;
  if (tid < k_end - k_begin) {  // at most MAX_SEG (the launch checks)
    const int b = row_blocks[k_begin + tid];
    s_b[tid] = b;
    s_col0[tid] = static_cast<int64_t>(blk_cb[b]) * C;
  }
  __syncthreads();

  auto load_stage = [&](int it, int stage) {
    const int kk = it / cpb, c0 = (it % cpb) * KC;
    const int b = s_b[kk];
    const int64_t col0 = s_col0[kk];
    const VT* A = values + static_cast<int64_t>(b) * R * C;
    const uint32_t sa = smem0 + stage * SB;
    const uint32_t sx = sa + A_BYTES;
    for (int c = tid; c < WG_ROWS * CPR; c += WG_THREADS) {
      const int r = c / CPR, q = c % CPR, col = c0 + q * EPC;
      const bool ok = r < rows_here && col < C;
      const VT* src = ok ? A + static_cast<int64_t>(r_base + r) * C + col : values;
      cp_async16(sa + r * STRIDE + q * 16, src, ok ? 16 : 0);
    }
    for (int c = tid; c < KC * NG; c += WG_THREADS) {
      // a warp copies whole 128-byte rows of x: features f0 + 8j.. of the
      // x row for chunk column phys_col(L), into k row L of the tile
      const int j = c % NG, L = c / NG;
      const int p = phys_col(L);
      const int64_t xr = col0 + c0 + p;
      const int f = f0 + j * 8;
      const bool ok = c0 + p < C && xr < n_x && f < ld;
      const __nv_bfloat16* src = ok ? x + xr * ld + f : x;
      cp_async16(sx + x_offset<N>(L, j), src, ok ? 16 : 0);
    }
  };

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  const int g = lane >> 2, t = lane & 3;
  const int ra = wg * 64 + (warp & 3) * 16 + g;    // this thread's rows ra, ra + 8
  constexpr uint32_t LBO = 1024, SBO = (N / 64) * 1024;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < iters) load_stage(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < iters; ++it) {
    cp_async_wait<STAGES - 2>();
    gta::fence_proxy_async();
    __syncthreads();  // chunk `it` landed for all; stage (it - 1) is free
    if (active) {     // issue this chunk's products, then the next copies
      const char* sa = smem + (it % STAGES) * SB;
      const uint32_t sx = smem0 + (it % STAGES) * SB + A_BYTES;
      uint32_t a[KSTEPS][4];
#pragma unroll
      for (int s = 0; s < KSTEPS; ++s) {
        const int cb = (16 * s + 4 * t) * static_cast<int>(sizeof(VT));
        a_frag(a[s], sa + ra * STRIDE + cb, sa + (ra + 8) * STRIDE + cb, VT());
      }
#pragma unroll
      for (int i = 0; i < N / 2; ++i) fence_reg(acc[i]);
      gta::wgmma_fence();
#pragma unroll
      for (int s = 0; s < KSTEPS; ++s)
        gta::wgmma_rs<N, 1>(acc, a[s], smem_desc(sx + 2 * s * SBO, LBO, SBO));
      gta::wgmma_commit();
    }
    if (it + STAGES - 1 < iters) load_stage(it + STAGES - 1, (it + STAGES - 1) % STAGES);
    cp_async_commit();
    if (active) {
      gta::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < N / 2; ++i) fence_reg(acc[i]);
    }
  }
  cp_async_wait<0>();
  if (!active) return;
  // d[4j + 2v + u] = D[ra + 8v][8j + 2t + u]
  const bool pair = (F & 1) == 0;
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    const int r = ra + 8 * v;
    const int64_t row = static_cast<int64_t>(rb) * R + r_base + r;
    if (r >= rows_here || row >= n_out) continue;
    float* yr = y + row * F;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int f = f0 + 8 * j + 2 * t;
      const float v0 = acc[4 * j + 2 * v], v1 = acc[4 * j + 2 * v + 1];
      if (pair) {
        if (f < F) atomicAdd(reinterpret_cast<float2*>(yr + f), make_float2(v0, v1));
      } else {
        if (f < F) atomicAdd(yr + f, v0);
        if (f + 1 < F) atomicAdd(yr + f + 1, v1);
      }
    }
  }
}

template <typename VT, int N>
cudaError_t launch_wgmma_n(const int* sg, const int* rbk, const int* cb, const void* v,
                           const void* x, float* y, int n_seg, int R, int C, int F, int ld,
                           int64_t n_x, int64_t n_out, size_t smem, cudaStream_t st) {
  if (smem != static_cast<size_t>(STAGES) * stage_bytes<VT, N>() + 1024)
    return cudaErrorInvalidValue;  // the wrapper's size is the ring's
  auto k = spmm_dense_wgmma_kernel<VT, N>;
  cudaError_t err = gta::set_smem(k, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n_seg, (R + WG_ROWS - 1) / WG_ROWS, (F + N - 1) / N);
  k<<<grid, WG_THREADS, smem, st>>>(sg, rbk, cb, static_cast<const VT*>(v),
                                    static_cast<const __nv_bfloat16*>(x), y, R, C, F, ld,
                                    n_x, n_out);
  return cudaGetLastError();
}

// the feature tile: 64 for narrow F, else 128 (whole swizzle atoms)
template <typename VT>
cudaError_t launch_wgmma(const int* sg, const int* rbk, const int* cb, const void* v,
                         const void* x, float* y, int n_seg, int seg_cap, int R, int C,
                         int F, int ld, int64_t n_x, int64_t n_out, size_t smem,
                         cudaStream_t st) {
  if (C % (16 / static_cast<int>(sizeof(VT))) != 0 || ld % 8 != 0 ||
      (reinterpret_cast<uintptr_t>(x) & 15) != 0)
    return cudaErrorInvalidValue;  // the 16-byte copies need aligned rows
  if (seg_cap > MAX_SEG) return cudaErrorInvalidValue;  // runs' ids in shared memory
  if (F <= 64)
    return launch_wgmma_n<VT, 64>(sg, rbk, cb, v, x, y, n_seg, R, C, F, ld, n_x, n_out, smem, st);
  return launch_wgmma_n<VT, 128>(sg, rbk, cb, v, x, y, n_seg, R, C, F, ld, n_x, n_out, smem, st);
}

template <typename VT, typename XT>
cudaError_t launch_fma(const int* sg, const int* rbk, const int* cb, const void* v,
                       const void* x, float* y, int n_seg, int R, int C, int F,
                       int64_t n_x, int64_t n_out, cudaStream_t st) {
  dim3 grid(n_seg, (R + BM - 1) / BM, (F + BN - 1) / BN);
  spmm_dense_fma_kernel<VT, XT><<<grid, THREADS, 0, st>>>(
      sg, rbk, cb, static_cast<const VT*>(v), static_cast<const XT*>(x), y, R, C,
      F, n_x, n_out);
  return cudaGetLastError();
}

}  // namespace

// segments: DenseBlockGraph.segments for float32 x, .wide_segments for bf16
// x, runs of at most seg_cap dense blocks (graph.DENSE_SEGMENT,
// DENSE_WIDE_SEGMENT); ld: x's row stride (F, or F padded to a multiple of
// 8 for bf16); smem: the bf16 path's ring (compiler/schedule.py
// _spmm_dense_smem), checked against the layout here
extern "C" int gta_spmm_dense_blocks(const void* segments, const void* row_blocks,
                                     const void* blk_cb, const void* values,
                                     int v_dtype, const void* x, int x_dtype,
                                     void* y, int n_seg, int seg_cap, int R, int C, int F,
                                     int ld, int64_t n_x, int64_t n_out, int64_t smem,
                                     void* stream) {
  auto sg = static_cast<const int*>(segments);
  auto rbk = static_cast<const int*>(row_blocks);
  auto cb = static_cast<const int*>(blk_cb);
  auto yy = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  if (n_seg == 0) return 0;
  // values are int8 counts or of x's dtype (the wrapper checks)
  if (v_dtype != gta::I8 && v_dtype != x_dtype) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (x_dtype == gta::BF16 && v_dtype == gta::I8)
    err = launch_wgmma<int8_t>(sg, rbk, cb, values, x, yy, n_seg, seg_cap, R, C, F, ld, n_x,
                               n_out, static_cast<size_t>(smem), st);
  else if (x_dtype == gta::BF16)
    err = launch_wgmma<__nv_bfloat16>(sg, rbk, cb, values, x, yy, n_seg, seg_cap, R, C, F, ld,
                                      n_x, n_out, static_cast<size_t>(smem), st);
  else if (ld != F)
    err = cudaErrorInvalidValue;
  else if (v_dtype == gta::I8)
    err = launch_fma<int8_t, float>(sg, rbk, cb, values, x, yy, n_seg, R, C, F, n_x, n_out, st);
  else
    err = launch_fma<float, float>(sg, rbk, cb, values, x, yy, n_seg, R, C, F, n_x, n_out, st);
  return static_cast<int>(err);
}
