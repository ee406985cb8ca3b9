// The per-node a_s pass of K3's and K10's derive mode: a_s = h . w_asrc,
// [n_h, H] float32, from h [n_h, HD] and w_asrc [HD, H] in h's dtype.  Both
// walks then read a_s per node instead of deriving it for every edge.
#pragma once
#include "common.cuh"

namespace gta {

constexpr int GAT_MAXF = 8;   // features per lane: HD <= 256
constexpr int AS_WARPS = 8;

namespace {

// One warp a node, lane l taking features l, l + 32, ... (f32 products of
// h's values, summed by fmaf in feature order and then across the warp);
// w staged in shared memory
template <typename HT>
__global__ void __launch_bounds__(AS_WARPS * 32)
gat_as_kernel(const HT* __restrict__ h, const HT* __restrict__ w, float* __restrict__ a_s,
              int64_t n_h, int HD, int H) {
  extern __shared__ float w_s[];  // [HD, H]
  for (int i = threadIdx.x; i < HD * H; i += blockDim.x) w_s[i] = to_f(w[i]);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t node = static_cast<int64_t>(blockIdx.x) * AS_WARPS + (threadIdx.x >> 5);
  if (node >= n_h) return;
  float hv[GAT_MAXF];
#pragma unroll
  for (int k = 0; k < GAT_MAXF; ++k) {
    const int f = lane + 32 * k;
    hv[k] = f < HD ? to_f(h[node * HD + f]) : 0.f;
  }
  for (int hh = 0; hh < H; ++hh) {
    float part = 0.f;
#pragma unroll
    for (int k = 0; k < GAT_MAXF; ++k) {
      const int f = lane + 32 * k;
      if (f < HD) part = fmaf(hv[k], w_s[f * H + hh], part);
    }
    part = warp_sum(part);
    if (lane == 0) a_s[node * H + hh] = part;
  }
}

}  // namespace

// writes a_s [n_h, H] float32 on stream st (HD <= 32 GAT_MAXF)
template <typename HT>
inline cudaError_t launch_a_s(const void* h, const void* w, float* a_s, int64_t n_h, int HD,
                              int H, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(HD) * H * sizeof(float);
  cudaError_t err = set_smem(gat_as_kernel<HT>, smem);
  if (err != cudaSuccess || n_h == 0) return err;
  gat_as_kernel<HT><<<static_cast<unsigned>((n_h + AS_WARPS - 1) / AS_WARPS), AS_WARPS * 32,
                      smem, st>>>(static_cast<const HT*>(h), static_cast<const HT*>(w), a_s,
                                  n_h, HD, H);
  return cudaGetLastError();
}

}  // namespace gta
