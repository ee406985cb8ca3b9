// K2 spmm_dense_blocks: dense-block SpMM, Y_rb += A_b @ X_cb over the dense
// adjacency blocks of the density split.
//
// Replaces the TPU kernels ops/dense.py:_spmm_dense_kernel (rb-major blocks)
// and _spmm_dense_super_kernel (supergroup order, G row blocks resident) of
// the JAX package: on Hopper both are this one kernel, which walks
// per-row-block lists of block ids and so accepts either block order.
//
// Bound on the card: compute.  A 256 x 256 block times a 256 x 128 panel is
// 16.8 MFLOP per 64 KB of int8 counts, far above the card's balance point.
// After the hubs+labels reorder the work is skewed: a hub row block owns
// hundreds of dense blocks, a community row block a handful.
//
// Design: one CUDA block per (segment, 64-row sub-tile, feature tile),
// where a segment is a run of at most 8 dense blocks of one row block
// (DenseBlockGraph.segments), so hub row blocks spread over the card.  Per
// block and 32-column chunk, the count sub-tile (int8 widened in the
// kernel, 4 at a time) and the x panel (16-byte loads) are staged in
// shared memory.  bf16 x takes the tensor cores over feature tiles of 128
// (64 when F <= 64, as for the 41 logits of a last layer, so the padding
// does not double the work), so each count converts once per row of x:
// mma.sync m16n8k16 bf16 (B fragments by ldmatrix.trans) with f32
// accumulation, exact
// products (counts up to 127 are exact in bf16), as the TPU's bf16 matmul
// with f32 accumulation; float32 x takes f32 FMAs on the CUDA cores (a
// 4 x 4 register micro-tile per thread), so float32 stays float32.  Each
// CUDA block adds its partial stripe into the zeroed output with f32
// atomics (a row block's segments meet there; the order varies by run,
// f32 rounding only); stripes no dense block visits read 0.  The
// separable row/column scales stay outside, in plain torch, as on the TPU.
#include "common.cuh"

namespace {

using gta::ld32;
using gta::mma_bf16;
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

// ---- bf16 path: tensor cores (mma.sync m16n8k16, f32 accumulation) -----

constexpr int PAD = 8;  // bf16 row padding: conflict-free fragment loads

// 4 consecutive values of the count block as bf16 (exact for counts)
__device__ __forceinline__ uint2 four_bf16(const int8_t* p) {
  const char4 v = *reinterpret_cast<const char4*>(p);
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  return make_uint2(*reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
}
__device__ __forceinline__ uint2 four_bf16(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint2*>(p);
}

// B fragments (b0, b1) of an m16n8k16 product from a row-major [k][n] tile
// in shared memory: lanes 0-15 address rows k0..k0+15 at column n0
__device__ __forceinline__ void ldmatrix_b(uint32_t& b0, uint32_t& b1,
                                           const __nv_bfloat16* row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(addr));
}

// BN_MMA: features per CUDA block; each of the 8 warps owns a 16-row m-tile
// and half of the features
template <typename VT, int BN_MMA>
__global__ void __launch_bounds__(THREADS)
spmm_dense_mma_kernel(const int* __restrict__ segments,
                      const int* __restrict__ row_blocks,
                      const int* __restrict__ blk_cb, const VT* __restrict__ values,
                      const __nv_bfloat16* __restrict__ x, float* __restrict__ y,
                      int R, int C, int F, int64_t n_x, int64_t n_out) {
  __shared__ __align__(16) __nv_bfloat16 As[BM][BK + PAD];      // [row][k]
  __shared__ __align__(16) __nv_bfloat16 Xs[BK][BN_MMA + PAD];  // [k][feature]
  const int* seg = segments + 3 * blockIdx.x;
  const int rb = seg[0], k_begin = seg[1], k_end = seg[2];
  const int r0 = blockIdx.y * BM, f0 = blockIdx.z * BN_MMA;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int NT = BN_MMA / 16;          // 8-feature n-tiles per warp
  const int wm = warp % 4, wn = warp / 4;  // 16-row m-tile, feature half
  const int g = lane >> 2, tq = lane & 3;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  // vector loads need 4-value count rows and 8-value (16-byte) x rows
  const bool vec_a = C % 4 == 0;
  const bool vec_x = F % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  for (int k = k_begin; k < k_end; ++k) {
    const int b = row_blocks[k];
    const int64_t col0 = static_cast<int64_t>(blk_cb[b]) * C;
    const VT* A = values + static_cast<int64_t>(b) * R * C;
    for (int c0 = 0; c0 < C; c0 += BK) {
      if (vec_a) {
        for (int idx = tid; idx < BM * BK / 4; idx += THREADS) {
          const int r = idx / (BK / 4), c = (idx % (BK / 4)) * 4;
          const int rr = r0 + r, cc = c0 + c;
          *reinterpret_cast<uint2*>(&As[r][c]) =
              (rr < R && cc < C) ? four_bf16(A + static_cast<int64_t>(rr) * C + cc)
                                 : make_uint2(0u, 0u);
        }
      } else {
        for (int idx = tid; idx < BM * BK; idx += THREADS) {
          const int r = idx / BK, c = idx % BK;
          const int rr = r0 + r, cc = c0 + c;
          As[r][c] = (rr < R && cc < C)
                         ? __float2bfloat16_rn(to_f(A[static_cast<int64_t>(rr) * C + cc]))
                         : zero;
        }
      }
      if (vec_x) {
        for (int idx = tid; idx < BK * BN_MMA / 8; idx += THREADS) {
          const int c = idx / (BN_MMA / 8), f = (idx % (BN_MMA / 8)) * 8;
          const int64_t xr = col0 + c0 + c;
          *reinterpret_cast<uint4*>(&Xs[c][f]) =
              (c0 + c < C && xr < n_x && f0 + f < F)
                  ? *reinterpret_cast<const uint4*>(x + xr * F + f0 + f)
                  : make_uint4(0u, 0u, 0u, 0u);
        }
      } else {
        for (int idx = tid; idx < BK * BN_MMA; idx += THREADS) {
          const int c = idx / BN_MMA, f = idx % BN_MMA;
          const int64_t xr = col0 + c0 + c;
          Xs[c][f] = (c0 + c < C && xr < n_x && f0 + f < F) ? x[xr * F + f0 + f] : zero;
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        const int ar = wm * 16 + g;
        const uint32_t a0 = ld32(&As[ar][kk + 2 * tq]);
        const uint32_t a1 = ld32(&As[ar + 8][kk + 2 * tq]);
        const uint32_t a2 = ld32(&As[ar][kk + 2 * tq + 8]);
        const uint32_t a3 = ld32(&As[ar + 8][kk + 2 * tq + 8]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t b0, b1;
          ldmatrix_b(b0, b1, &Xs[kk + (lane & 15)][wn * (BN_MMA / 2) + j * 8]);
          mma_bf16(acc[j], a0, a1, a2, a3, b0, b1);
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + wm * 16 + g + (i >= 2 ? 8 : 0);
      const int f = f0 + wn * (BN_MMA / 2) + j * 8 + 2 * tq + (i & 1);
      const int64_t row = static_cast<int64_t>(rb) * R + r;
      if (r < R && row < n_out && f < F) atomicAdd(y + row * F + f, acc[j][i]);
    }
  }
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

template <typename VT, int BN_MMA>
cudaError_t launch_mma_bn(const int* sg, const int* rbk, const int* cb, const void* v,
                          const void* x, float* y, int n_seg, int R, int C, int F,
                          int64_t n_x, int64_t n_out, cudaStream_t st) {
  dim3 grid(n_seg, (R + BM - 1) / BM, (F + BN_MMA - 1) / BN_MMA);
  spmm_dense_mma_kernel<VT, BN_MMA><<<grid, THREADS, 0, st>>>(
      sg, rbk, cb, static_cast<const VT*>(v), static_cast<const __nv_bfloat16*>(x),
      y, R, C, F, n_x, n_out);
  return cudaGetLastError();
}

template <typename VT>
cudaError_t launch_mma(const int* sg, const int* rbk, const int* cb, const void* v,
                       const void* x, float* y, int n_seg, int R, int C, int F,
                       int64_t n_x, int64_t n_out, cudaStream_t st) {
  if (F <= 64)
    return launch_mma_bn<VT, 64>(sg, rbk, cb, v, x, y, n_seg, R, C, F, n_x, n_out, st);
  return launch_mma_bn<VT, 128>(sg, rbk, cb, v, x, y, n_seg, R, C, F, n_x, n_out, st);
}

}  // namespace

extern "C" int gta_spmm_dense_blocks(const void* segments, const void* row_blocks,
                                     const void* blk_cb, const void* values,
                                     int v_dtype, const void* x, int x_dtype,
                                     void* y, int n_seg, int R, int C, int F,
                                     int64_t n_x, int64_t n_out, void* stream) {
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
    err = launch_mma<int8_t>(sg, rbk, cb, values, x, yy, n_seg, R, C, F, n_x, n_out, st);
  else if (x_dtype == gta::BF16)
    err = launch_mma<__nv_bfloat16>(sg, rbk, cb, values, x, yy, n_seg, R, C, F, n_x, n_out, st);
  else if (v_dtype == gta::I8)
    err = launch_fma<int8_t, float>(sg, rbk, cb, values, x, yy, n_seg, R, C, F, n_x, n_out, st);
  else
    err = launch_fma<float, float>(sg, rbk, cb, values, x, yy, n_seg, R, C, F, n_x, n_out, st);
  return static_cast<int>(err);
}
