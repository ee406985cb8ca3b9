// The transposed head panel that K4's and K8's wgmma paths read as their B
// operand, and the layout of its shared-memory stage copies.
//
// A panel holds a row-major [n_x, HD] bf16 array x (h for K4, gbar for K8)
// transposed, each of its H heads' D features on NP rows (NP >= D, a
// multiple of 8; rows past D hold zeros), every column present up to ld:
// row hh NP + d, column c holds x[c, hh D + d] for d < D and c < n_x, else
// 0.  A stage copy keeps 64 columns of each row (128 bytes), K-major in the
// 128-byte swizzle layout (panel_offset), so each head's rows start on a 1
// KB atom when NP is a multiple of 8.
#pragma once
#include "common.cuh"

namespace gta {

// byte offset of 16-byte unit j (columns 8j..8j+7) of panel row n in the
// 128-byte swizzle layout: 1 KB atoms of 8 rows, units XOR-permuted by the
// row
__device__ __forceinline__ int panel_offset(int n, int j) {
  return (n >> 3) * 1024 + (n & 7) * 128 + ((j ^ (n & 7)) << 4);
}

// A block transposes TP_COLS nodes through shared memory (rows padded by
// one word: conflict-free column reads), reading them contiguously and
// writing 128 contiguous bytes of each panel row; pad rows and columns are
// written as zeros, so the panel needs no fill of its own.
constexpr int TP_COLS = 64, TP_THREADS = 256;

inline size_t head_panel_smem(int HD) { return TP_COLS * (HD + 2) * sizeof(__nv_bfloat16); }

namespace {

__global__ void __launch_bounds__(TP_THREADS)
head_panel_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ pan,
                  int64_t n_x, int HD, int H, int NP, int64_t ld) {
  extern __shared__ __nv_bfloat16 tile[];  // [TP_COLS][HD + 2]
  const int S = HD + 2, D = HD / H;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * TP_COLS;
  const int cols = static_cast<int>(max(min(static_cast<int64_t>(TP_COLS), n_x - c0),
                                        static_cast<int64_t>(0)));
  for (int i = threadIdx.x; i < cols * HD; i += TP_THREADS)
    tile[(i / HD) * S + i % HD] = x[c0 * HD + i];
  __syncthreads();
  for (int i = threadIdx.x; i < H * NP * TP_COLS; i += TP_THREADS) {
    const int row = i / TP_COLS, c = i % TP_COLS, d = row % NP;
    if (c0 + c >= ld) continue;
    pan[row * ld + c0 + c] = d < D && c < cols ? tile[c * S + (row / NP) * D + d]
                                               : __float2bfloat16_rn(0.f);
  }
}

}  // namespace

// writes the panel of x [n_x, HD] into pan [H NP, ld] on stream st
inline cudaError_t write_head_panel(const __nv_bfloat16* x, __nv_bfloat16* pan, int64_t n_x,
                                    int HD, int H, int NP, int64_t ld, cudaStream_t st) {
  head_panel_kernel<<<static_cast<unsigned>((ld + TP_COLS - 1) / TP_COLS), TP_THREADS,
                      head_panel_smem(HD), st>>>(x, pan, n_x, HD, H, NP, ld);
  return cudaGetLastError();
}

}  // namespace gta
