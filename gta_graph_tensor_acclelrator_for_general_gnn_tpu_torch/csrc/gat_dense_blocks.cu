// K4 gat_dense_blocks: [num | den] attention partials over the dense blocks
// of the density split, under the same global shift bound as K3; and K15
// gat_dense_panel, the same walk with per-node exp panels.
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
//
// K15 (PANEL, entry point gta_gat_dense_panel) replaces the TPU kernel
// ops/dense.py:_gat_dense_kernel_t2, the exp-panel factorisation of K4 (the
// JAX package runs it when DENSE_EXP_PANEL is set).  On each branch of the
// leaky relu, exp(e - bound) factors into a column term and a row term, so
// with per-node panels built in PyTorch (pan_s [n_cols, 2H] = [E1s | E2s],
// pan_d [n_rows, 3H] = [E1d | E2d | raw a_d], pad entries 0)
//   p[r,c] = count[r,c] * (a_s[c] + a_d[r] >= 0 ? E1s[c] E1d[r] : E2s[c] E2d[r])
// with no per-cell exponential; num and den as K4.  On this card the exp
// is not what bounds K4 (the per-cell work and the product are), so K15 is
// expected to run at K4's speed, not faster.
#include <type_traits>

#include "common.cuh"

namespace {

using gta::leaky;
using gta::round_to;
using gta::to_f;

constexpr int BM = 64, THREADS = 256, PAD = 8;

// shared-memory floats of one CUDA block (bf16 arrays count as half floats);
// the panel mode adds the column chunk's [E1s | E2s] and the rows' E2d
inline size_t smem_bytes(int HD, int H, int CC, bool mma, bool panel) {
  size_t f = static_cast<size_t>(BM) * (HD + H) + static_cast<size_t>(CC) * H +
             2 * BM * H + static_cast<size_t>(BM) * CC +
             (panel ? static_cast<size_t>(CC) * 2 * H + BM * H : 0);
  if (mma)  // HsT [HD][CC+PAD] and Pb [H][BM][CC+PAD], bf16
    return f * 4 + (static_cast<size_t>(HD) + static_cast<size_t>(H) * BM) * (CC + PAD) * 2;
  return (f + static_cast<size_t>(CC) * HD + static_cast<size_t>(H) * BM * CC) * 4;
}

// PANEL: a_dst and msrc are not read; pan_s [n_ps, 2H] and pan_d [n_pd, 3H]
// are (K4 passes null panels)
template <typename VT, typename HT, bool MMA, bool PANEL>
__global__ void __launch_bounds__(THREADS)
gat_dense_kernel(const int* __restrict__ segments, const int* __restrict__ row_blocks,
                 const int* __restrict__ blk_cb, const VT* __restrict__ values,
                 int layout_cr, const HT* __restrict__ h,
                 const float* __restrict__ a_src, const float* __restrict__ a_dst,
                 const float* __restrict__ msrc, const float* __restrict__ pan_s,
                 const float* __restrict__ pan_d, float* __restrict__ out, int R, int C,
                 int HD, int H, int CC, int64_t n_h, int64_t n_a, int64_t n_ps,
                 int64_t n_pd, int64_t n_out, float slope) {
  extern __shared__ __align__(16) float smem[];
  const int W = HD + H, D = HD / H, CP = CC + PAD;
  float* acc = smem;              // [BM, W]
  float* as = acc + BM * W;       // [CC, H]
  float* ad = as + CC * H;        // [BM, H]
  float* bnd = ad + BM * H;       // [BM, H]; PANEL: E1d of the rows
  float* es = bnd + BM * H;       // PANEL: [CC, 2H] E1s | E2s of the chunk
  float* e2d = es + (PANEL ? CC * 2 * H : 0);   // PANEL: [BM, H]
  float* mk = e2d + (PANEL ? BM * H : 0);       // [BM, CC] counts
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
    if constexpr (PANEL) {
      const bool ok = r0 + r < R && row < n_pd;
      const float* pr = pan_d + row * 3 * H;
      ad[i] = ok ? pr[2 * H + hh] : 0.f;
      bnd[i] = ok ? pr[hh] : 0.f;
      e2d[i] = ok ? pr[H + hh] : 0.f;
    } else {
      const float a = (r0 + r < R && row < n_a) ? a_dst[row * H + hh] : 0.f;
      ad[i] = a;
      bnd[i] = leaky(msrc[hh] + a, slope);
    }
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
        if constexpr (PANEL) {
          const bool ok = c0 + c < C && col < n_ps;
          es[c * 2 * H + hh] = ok ? pan_s[col * 2 * H + hh] : 0.f;
          es[c * 2 * H + H + hh] = ok ? pan_s[col * 2 * H + H + hh] : 0.f;
        }
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
          if constexpr (PANEL) {
            const bool pos = as[c * H + hh] + ad[r * H + hh] >= 0.f;
            v = cnt * (pos ? es[c * 2 * H + hh] * bnd[r * H + hh]
                           : es[c * 2 * H + H + hh] * e2d[r * H + hh]);
          } else {
            const float z = leaky(as[c * H + hh] + ad[r * H + hh], slope) - bnd[r * H + hh];
            v = cnt * expf(fminf(z, 60.f));
          }
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

// the arguments of one launch, K4's or K15's
struct Args {
  const int *sg, *rbk, *cb;
  const void *v, *h;
  int layout_cr;
  const float *as, *ad, *ms, *ps, *pd;
  float* out;
  int n_seg, R, C, HD, H;
  int64_t n_h, n_a, n_ps, n_pd, n_out;
  float slope;
  cudaStream_t st;
};

template <typename VT, typename HT, bool MMA, bool PANEL>
cudaError_t launch(const Args& a, int CC) {
  const size_t smem = smem_bytes(a.HD, a.H, CC, MMA, PANEL);
  auto k = gat_dense_kernel<VT, HT, MMA, PANEL>;
  cudaError_t err = gta::set_smem(k, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.n_seg, (a.R + BM - 1) / BM);
  k<<<grid, THREADS, smem, a.st>>>(a.sg, a.rbk, a.cb, static_cast<const VT*>(a.v),
                                   a.layout_cr, static_cast<const HT*>(a.h), a.as, a.ad,
                                   a.ms, a.ps, a.pd, a.out, a.R, a.C, a.HD, a.H, CC, a.n_h,
                                   a.n_a, a.n_ps, a.n_pd, a.n_out, a.slope);
  return cudaGetLastError();
}

template <typename VT, typename HT, bool PANEL>
cudaError_t launch_h(const Args& a) {
  if (a.n_seg == 0) return cudaSuccess;
  // column chunk: the p panel [H, 64, CC] at or under 32 KB of f32
  int CC = 32;
  while (CC > 4 && static_cast<size_t>(a.H) * BM * CC * 4 > 32 * 1024) CC /= 2;
  if constexpr (std::is_same_v<HT, __nv_bfloat16>) {
    if (CC % 16 == 0) return launch<VT, HT, true, PANEL>(a, CC);
  }
  return launch<VT, HT, false, PANEL>(a, CC);
}

// values are int8 counts or of h's dtype (the wrappers check)
template <bool PANEL>
int dispatch(const Args& a, int v_dtype, int h_dtype) {
  if (v_dtype != gta::I8 && v_dtype != h_dtype) return static_cast<int>(cudaErrorInvalidValue);
  const bool hb = h_dtype == gta::BF16;
  cudaError_t err;
  if (v_dtype == gta::I8 && hb)
    err = launch_h<int8_t, __nv_bfloat16, PANEL>(a);
  else if (v_dtype == gta::I8)
    err = launch_h<int8_t, float, PANEL>(a);
  else if (hb)
    err = launch_h<__nv_bfloat16, __nv_bfloat16, PANEL>(a);
  else
    err = launch_h<float, float, PANEL>(a);
  return static_cast<int>(err);
}

}  // namespace

extern "C" int gta_gat_dense_blocks(const void* segments, const void* row_blocks,
                                    const void* blk_cb, const void* values,
                                    int v_dtype, int layout_cr, const void* h,
                                    int h_dtype, const void* a_src, const void* a_dst,
                                    const void* msrc, void* out, int n_seg, int R,
                                    int C, int HD, int H, int64_t n_h, int64_t n_a,
                                    int64_t n_out, float slope, void* stream) {
  const Args a{static_cast<const int*>(segments), static_cast<const int*>(row_blocks),
               static_cast<const int*>(blk_cb), values, h, layout_cr,
               static_cast<const float*>(a_src), static_cast<const float*>(a_dst),
               static_cast<const float*>(msrc), nullptr, nullptr, static_cast<float*>(out),
               n_seg, R, C, HD, H, n_h, n_a, 0, 0, n_out, slope,
               static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, v_dtype, h_dtype);
}

extern "C" int gta_gat_dense_panel(const void* segments, const void* row_blocks,
                                   const void* blk_cb, const void* values, int v_dtype,
                                   int layout_cr, const void* h, int h_dtype,
                                   const void* a_src, const void* pan_s, const void* pan_d,
                                   void* out, int n_seg, int R, int C, int HD, int H,
                                   int64_t n_h, int64_t n_a, int64_t n_ps, int64_t n_pd,
                                   int64_t n_out, void* stream) {
  const Args a{static_cast<const int*>(segments), static_cast<const int*>(row_blocks),
               static_cast<const int*>(blk_cb), values, h, layout_cr,
               static_cast<const float*>(a_src), nullptr, nullptr,
               static_cast<const float*>(pan_s), static_cast<const float*>(pan_d),
               static_cast<float*>(out), n_seg, R, C, HD, H, n_h, n_a, n_ps, n_pd, n_out,
               0.f, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, v_dtype, h_dtype);
}
