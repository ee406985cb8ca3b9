// K4 gat_dense_blocks: [num | den] attention partials over the dense blocks
// of the density split, under the same global shift bound as K3.
//
// Replaces the TPU kernels ops/dense.py:_gat_dense_kernel_t ('cr' blocks,
// transposed dataflow) and _gat_dense_kernel ('rc' blocks) of the JAX
// package: one kernel here, the block layout is an argument.  Per block and
// head, for every cell (r, c):
//   p[r,c] = count[r,c] * exp(min(leaky(a_s[c] + a_d[r]) - leaky(msrc + a_d[r]), 60))
//   num[r, hD:(h+1)D] += sum_c p * h[c, hD:(h+1)D]    (p rounded to h's dtype)
//   den[r, h]         += sum_c p                        (f32, unrounded)
// which are the TPU kernel's rounding points.
//
// Bound on the card: compute.  Every cell costs one exp per head and HD
// multiply-adds whatever the count, so a 256 x 256 block at HD = 128 is
// 8.4 M FMA; after the hubs+labels reorder a hub row block owns hundreds of
// dense blocks, a community row block a handful.
//
// Design: one CUDA block per (segment, 64-row sub-tile), where a segment is
// a run of at most 8 dense blocks of one row block (DenseBlockGraph
// .segments), so hub row blocks spread over the card.  Per block and
// column chunk of CC columns, the counts, the h panel and a_s of the chunk
// are staged in shared memory; p is formed once per (head, row, column)
// and den sums it unrounded by warp shuffles in the same pass.  For bf16 h
// the num product P_h[64 x CC] . H[CC x D] of each head runs on the tensor
// cores (mma.sync m16n8k16: p rounded to bf16, the TPU kernel's own
// rounding point; exact products; f32 sums); for float32 h (or more than 8
// heads, where the column chunk drops below the mma depth of 16) it runs in
// f32 on the CUDA cores, so float32 stays float32.  The 64 x (HD + H) f32
// accumulator (33 KB at HD + H = 132) lives in shared memory, each cell
// owned by one thread or one mma tile; at the end the block adds it into
// the zeroed output with f32 atomics (a row block's segments meet there;
// the order varies by run, f32 rounding only).  Stripes no dense block
// visits read 0.
#include <type_traits>

#include "common.cuh"

namespace {

using gta::leaky;
using gta::round_to;
using gta::to_f;

constexpr int BM = 64, THREADS = 256, PAD = 8;

// shared-memory floats of one CUDA block (bf16 arrays count as half floats)
inline size_t smem_bytes(int HD, int H, int CC, bool mma) {
  size_t f = static_cast<size_t>(BM) * (HD + H) + static_cast<size_t>(CC) * H +
             2 * BM * H + static_cast<size_t>(BM) * CC;
  if (mma)  // HsT [HD][CC+PAD] and Pb [H][BM][CC+PAD], bf16
    return f * 4 + (static_cast<size_t>(HD) + static_cast<size_t>(H) * BM) * (CC + PAD) * 2;
  return (f + static_cast<size_t>(CC) * HD + static_cast<size_t>(H) * BM * CC) * 4;
}

template <typename VT, typename HT, bool MMA>
__global__ void __launch_bounds__(THREADS)
gat_dense_kernel(const int* __restrict__ segments, const int* __restrict__ row_blocks,
                 const int* __restrict__ blk_cb, const VT* __restrict__ values,
                 int layout_cr, const HT* __restrict__ h,
                 const float* __restrict__ a_src, const float* __restrict__ a_dst,
                 const float* __restrict__ msrc, float* __restrict__ out, int R, int C,
                 int HD, int H, int CC, int64_t n_h, int64_t n_a, int64_t n_out,
                 float slope) {
  extern __shared__ __align__(16) float smem[];
  const int W = HD + H, D = HD / H, CP = CC + PAD;
  float* acc = smem;              // [BM, W]
  float* as = acc + BM * W;       // [CC, H]
  float* ad = as + CC * H;        // [BM, H]
  float* bnd = ad + BM * H;       // [BM, H]
  float* mk = bnd + BM * H;       // [BM, CC] counts
  float* hs = mk + BM * CC;       // FMA: [CC, HD]
  float* p = hs + CC * HD;        // FMA: [H, BM, CC]
  __nv_bfloat16* hsT = reinterpret_cast<__nv_bfloat16*>(mk + BM * CC);  // MMA: [HD, CP]
  __nv_bfloat16* pb = hsT + HD * CP;                                    // MMA: [H, BM, CP]
  const int* seg = segments + 3 * blockIdx.x;
  const int rb = seg[0], k_begin = seg[1], k_end = seg[2];
  const int r0 = blockIdx.y * BM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t row0 = static_cast<int64_t>(rb) * R + r0;

  for (int i = tid; i < BM * W; i += THREADS) acc[i] = 0.f;
  for (int i = tid; i < BM * H; i += THREADS) {
    const int r = i / H, hh = i % H;
    const int64_t row = row0 + r;
    const float a = (r0 + r < R && row < n_a) ? a_dst[row * H + hh] : 0.f;
    ad[i] = a;
    bnd[i] = leaky(msrc[hh] + a, slope);
  }
  __syncthreads();

  for (int k = k_begin; k < k_end; ++k) {
    const int b = row_blocks[k];
    const int64_t col0 = static_cast<int64_t>(blk_cb[b]) * C;
    const VT* A = values + static_cast<int64_t>(b) * R * C;
    for (int c0 = 0; c0 < C; c0 += CC) {
      for (int i = tid; i < CC * HD; i += THREADS) {
        const int c = i / HD, f = i % HD;
        const int64_t col = col0 + c0 + c;
        const bool ok = c0 + c < C && col < n_h;
        if constexpr (MMA)
          hsT[f * CP + c] = ok ? h[col * HD + f] : __float2bfloat16_rn(0.f);
        else
          hs[i] = ok ? to_f(h[col * HD + f]) : 0.f;
      }
      for (int i = tid; i < CC * H; i += THREADS) {
        const int c = i / H, hh = i % H;
        const int64_t col = col0 + c0 + c;
        as[i] = (c0 + c < C && col < n_a) ? a_src[col * H + hh] : 0.f;
      }
      // counts: walk the layout's contiguous axis fastest
      for (int i = tid; i < BM * CC; i += THREADS) {
        int r, c;
        if (layout_cr) { c = i / BM; r = i % BM; } else { r = i / CC; c = i % CC; }
        const int rr = r0 + r, cc = c0 + c;
        float v = 0.f;
        if (rr < R && cc < C)
          v = to_f(layout_cr ? A[static_cast<int64_t>(cc) * R + rr]
                             : A[static_cast<int64_t>(rr) * C + cc]);
        mk[r * CC + c] = v;
      }
      __syncthreads();
      // p per (head, row, column); den: the CC lanes of one (head, row)
      // are consecutive (CC divides 32), so a segmented warp sum adds them
      for (int i = tid; i < H * BM * CC; i += THREADS) {
        const int hh = i / (BM * CC), r = (i / CC) % BM, c = i % CC;
        const float cnt = mk[r * CC + c];
        float v = 0.f;
        if (cnt != 0.f) {
          const float z = leaky(as[c * H + hh] + ad[r * H + hh], slope) - bnd[r * H + hh];
          v = cnt * expf(fminf(z, 60.f));
        }
        if constexpr (MMA)
          pb[(hh * BM + r) * CP + c] = __float2bfloat16_rn(v);
        else
          p[i] = v;
        float sum = v;
        for (int o = CC / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (c == 0) acc[r * W + HD + hh] += sum;
      }
      __syncthreads();
      if constexpr (MMA) {
        // items: 4 m-tiles (16 rows) x per-head n-tiles (8 columns of one
        // head); each item owns its accumulator cells
        const int g = lane >> 2, tq = lane & 3;
        const int ntph = (D + 7) / 8;
        for (int item = warp; item < 4 * H * ntph; item += THREADS / 32) {
          const int mt = item % 4, nt = item / 4;
          const int hh = nt / ntph, n = (nt % ntph) * 8 + g;  // head-local column
          const __nv_bfloat16* pr = pb + (hh * BM + mt * 16 + g) * CP;
          const __nv_bfloat16* hc = hsT + (hh * D + n) * CP;
          float c4[4] = {0.f, 0.f, 0.f, 0.f};
          for (int kk = 0; kk < CC; kk += 16) {
            const uint32_t b0 = n < D ? gta::ld32(hc + kk + 2 * tq) : 0u;
            const uint32_t b1 = n < D ? gta::ld32(hc + kk + 2 * tq + 8) : 0u;
            gta::mma_bf16(c4, gta::ld32(pr + kk + 2 * tq), gta::ld32(pr + 8 * CP + kk + 2 * tq),
                          gta::ld32(pr + kk + 2 * tq + 8), gta::ld32(pr + 8 * CP + kk + 2 * tq + 8),
                          b0, b1);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = mt * 16 + g + (i >= 2 ? 8 : 0);
            const int col = (nt % ntph) * 8 + 2 * tq + (i & 1);
            if (col < D) acc[r * W + hh * D + col] += c4[i];
          }
        }
      } else {
        for (int i = tid; i < BM * HD; i += THREADS) {
          const int r = i / HD, f = i % HD;
          const float* pr = p + ((f / D) * BM + r) * CC;
          const float* hc = hs + f;
          float s = acc[r * W + f];
          for (int c = 0; c < CC; ++c) s = fmaf(round_to<HT>(pr[c]), hc[c * HD], s);
          acc[r * W + f] = s;
        }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < BM * W; i += THREADS) {
    const int r = i / W;
    const int64_t row = row0 + r;
    if (r0 + r < R && row < n_out) atomicAdd(out + row * W + i % W, acc[i]);
  }
}

template <typename VT, typename HT, bool MMA>
cudaError_t launch(const int* sg, const int* rbk, const int* cb, const void* v,
                   int layout_cr, const void* h, const float* as, const float* ad,
                   const float* ms, float* out, int n_seg, int R, int C, int HD, int H,
                   int64_t n_h, int64_t n_a, int64_t n_out, float slope, int CC,
                   cudaStream_t st) {
  const size_t smem = smem_bytes(HD, H, CC, MMA);
  auto k = gat_dense_kernel<VT, HT, MMA>;
  cudaError_t err = gta::set_smem(k, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n_seg, (R + BM - 1) / BM);
  k<<<grid, THREADS, smem, st>>>(sg, rbk, cb, static_cast<const VT*>(v), layout_cr,
                                 static_cast<const HT*>(h), as, ad, ms, out, R, C,
                                 HD, H, CC, n_h, n_a, n_out, slope);
  return cudaGetLastError();
}

template <typename VT, typename HT>
cudaError_t launch_h(const int* sg, const int* rbk, const int* cb, const void* v,
                     int layout_cr, const void* h, const float* as, const float* ad,
                     const float* ms, float* out, int n_seg, int R, int C, int HD,
                     int H, int64_t n_h, int64_t n_a, int64_t n_out, float slope,
                     cudaStream_t st) {
  if (n_seg == 0) return cudaSuccess;
  // column chunk: the p panel [H, 64, CC] at or under 32 KB of f32
  int CC = 32;
  while (CC > 4 && static_cast<size_t>(H) * BM * CC * 4 > 32 * 1024) CC /= 2;
  if constexpr (std::is_same_v<HT, __nv_bfloat16>) {
    if (CC % 16 == 0)
      return launch<VT, HT, true>(sg, rbk, cb, v, layout_cr, h, as, ad, ms, out, n_seg, R, C, HD, H, n_h, n_a, n_out, slope, CC, st);
  }
  return launch<VT, HT, false>(sg, rbk, cb, v, layout_cr, h, as, ad, ms, out, n_seg, R, C, HD, H, n_h, n_a, n_out, slope, CC, st);
}

}  // namespace

extern "C" int gta_gat_dense_blocks(const void* segments, const void* row_blocks,
                                    const void* blk_cb, const void* values,
                                    int v_dtype, int layout_cr, const void* h,
                                    int h_dtype, const void* a_src, const void* a_dst,
                                    const void* msrc, void* out, int n_seg, int R,
                                    int C, int HD, int H, int64_t n_h, int64_t n_a,
                                    int64_t n_out, float slope, void* stream) {
  auto rp = static_cast<const int*>(segments);
  auto rbk = static_cast<const int*>(row_blocks);
  auto cb = static_cast<const int*>(blk_cb);
  auto as = static_cast<const float*>(a_src);
  auto ad = static_cast<const float*>(a_dst);
  auto ms = static_cast<const float*>(msrc);
  auto o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  // values are int8 counts or of h's dtype (the wrapper checks)
  if (v_dtype != gta::I8 && v_dtype != h_dtype) return static_cast<int>(cudaErrorInvalidValue);
  const bool hb = h_dtype == gta::BF16;
  cudaError_t err;
  if (v_dtype == gta::I8 && hb)
    err = launch_h<int8_t, __nv_bfloat16>(rp, rbk, cb, values, layout_cr, h, as, ad, ms, o, n_seg, R, C, HD, H, n_h, n_a, n_out, slope, st);
  else if (v_dtype == gta::I8)
    err = launch_h<int8_t, float>(rp, rbk, cb, values, layout_cr, h, as, ad, ms, o, n_seg, R, C, HD, H, n_h, n_a, n_out, slope, st);
  else if (hb)
    err = launch_h<__nv_bfloat16, __nv_bfloat16>(rp, rbk, cb, values, layout_cr, h, as, ad, ms, o, n_seg, R, C, HD, H, n_h, n_a, n_out, slope, st);
  else
    err = launch_h<float, float>(rp, rbk, cb, values, layout_cr, h, as, ad, ms, o, n_seg, R, C, HD, H, n_h, n_a, n_out, slope, st);
  return static_cast<int>(err);
}
