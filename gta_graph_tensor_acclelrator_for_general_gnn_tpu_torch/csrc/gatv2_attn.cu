// K17 gatv2_attn: GATv2's attention (Brody, Alon and Yahav,
// arXiv:2105.14491) in one pass over K13's receiver-ordered work list.
// For receiver r, head h and each slot j of r's chunks (a pad sender,
// -1, is no edge and is skipped), with u, v in their dtype T and att
// float32 [H, C]:
//   z   = leaky_relu(u[j] + v[r], slope)           float32, H*C wide
//   e_h = sum_c att[h, c] z[h*C + c]               float32
//   out[r, h*C + c] = sum_j softmax_j(e_h) u[j, h*C + c]
// out is float32 [N, H*C]; a row without an edge gives 0.
//
// Replaces no TPU kernel: the JAX package has no GATv2.  GAT's kernels
// (K3, K4) build on a score that is a sum of two per-node scalars; here
// the score puts a C-wide nonlinearity between u[j] and v[r], so every
// edge costs C-wide work per head and no dense-block product can form it.
//
// Bound on the card: memory and latency.  Each edge gathers one H*C-wide
// row of u; v[r], the attention vectors and the output row move once per
// chunk.  The least time at the cell's shape (11.66M edges, H*C = 128,
// bf16) is about 0.1 ms; the gathers are random 256-byte rows.
//
// Design: one warp per chunk of the work list (ops/pairagg.pair_work: the
// counted slots' senders sorted by receiver, at most PAIR_CHUNK slots of
// one receiver a chunk, every row at least one chunk).  A lane holds VEC
// adjacent features (f = lane * VEC + e): for bf16 rows of 128 features
// one 8-byte load a lane gathers the whole row in one coalesced 256-byte
// access.  v[r] and the lane's attention entries stay in registers for
// the chunk.  The warp reads its chunk's senders 32 at a time (one load,
// then shuffles) and issues PF row gathers before it uses the first.  A
// head's features lie on G = C / VEC adjacent lanes (every lane where
// there is one head), so its score is a partial dot a lane and a
// butterfly of log2(G) shuffles, the PF gathered edges' butterflies
// interleaved; every lane of the head then holds the scores and keeps the
// head's online softmax itself: the running max m, the running sum l of
// exp(e - m) and its features' accumulator acc = sum exp(e - m) u[j],
// rescaled by exp(m_old - m_new) once a batch of PF edges.  A row of one
// chunk (every row up to PAIR_CHUNK slots) stores
// acc / l with plain stores.  A row cut into several chunks (the hubs)
// cannot add softmaxes by atomics: each chunk stores its partial (m, l,
// acc) into its partial row (ops/gatv2.Gatv2Work part_of), and
// gatv2_finish_kernel merges a cut row's partials under their largest m,
//   out = sum_p acc_p exp(m_p - M) / sum_p l_p exp(m_p - M),
// a block a cut row, so that a hub's thousands of partials spread over
// its warps.
#include "tile_walk.cuh"

namespace {

constexpr int WARPS = 8;
// u rows in flight a warp, as K13 takes them (eight, at three blocks an
// SM, took 1.66 ms at the GATv2 cell's layer 0 on an H100 against four's
// 1.29)
constexpr int PF = 4;
constexpr int BLOCKS = 4;

// VEC features of row `p` from feature f: one vector load where the row
// allows it (VL), else a feature at a time; 0 past `lim`
template <typename T, int VEC, bool VL>
__device__ __forceinline__ void load_row(const T* p, int f, int lim, float* out) {
  if constexpr (VL) {
    using V = typename gta::VecLoad<T, VEC>::type;
    const V x = f < lim ? *reinterpret_cast<const V*>(p + f) : gta::zero_of<V>();
#pragma unroll
    for (int e = 0; e < VEC; ++e) out[e] = gta::unpack(x, e);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) out[e] = f + e < lim ? gta::to_f(p[f + e]) : 0.f;
  }
}

template <typename T, int VEC, bool VL>
__global__ void __launch_bounds__(WARPS * 32, BLOCKS)
gatv2_attn_kernel(const int* __restrict__ chunk_ptr, const int* __restrict__ chunk_row,
                  const int* __restrict__ slot_src, const int* __restrict__ part_of,
                  const T* __restrict__ u, const T* __restrict__ v,
                  const float* __restrict__ att, float* __restrict__ out,
                  float* __restrict__ pmax, float* __restrict__ psum,
                  float* __restrict__ pacc, int n_chunks, int H, int C, int G,
                  float slope) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (c >= n_chunks) return;  // the whole warp: its shuffles use the full mask
  const int HC = H * C;
  const int b = chunk_ptr[c], end = chunk_ptr[c + 1];
  const int rc = chunk_row[c];
  const bool split = rc < 0;
  const int64_t r = split ? ~rc : rc;
  const int f = lane * VEC;
  float vv[VEC], aa[VEC], acc[VEC];
  load_row<T, VEC, VL>(v + r * HC, f, HC, vv);
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    aa[e] = f + e < HC ? att[f + e] : 0.f;
    acc[e] = 0.f;
  }
  const float neg_inf = __uint_as_float(0xff800000u);
  float m = neg_inf, l = 0.f;
  for (int p0 = b; p0 < end; p0 += 32) {
    const int here = min(32, end - p0);
    const int mine = lane < here ? slot_src[p0 + lane] : -1;
    for (int q0 = 0; q0 < here; q0 += PF) {
      float uq[PF][VEC];
      bool ok[PF];
#pragma unroll
      for (int q = 0; q < PF; ++q) {
        const int j = q0 + q;
        const int sj = __shfl_sync(0xffffffffu, mine, j < here ? j : 0);
        ok[q] = j < here && sj >= 0;
        load_row<T, VEC, VL>(u + static_cast<int64_t>(ok[q] ? sj : 0) * HC, f,
                             ok[q] ? HC : 0, uq[q]);
      }
      // the PF scores first, their butterflies interleaved, then one
      // rescale of the running state for the batch
      float sc[PF];
#pragma unroll
      for (int q = 0; q < PF; ++q) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) s = fmaf(aa[e], gta::leaky(uq[q][e] + vv[e], slope), s);
        sc[q] = s;
      }
      for (int o = G >> 1; o > 0; o >>= 1) {
#pragma unroll
        for (int q = 0; q < PF; ++q) sc[q] += __shfl_xor_sync(0xffffffffu, sc[q], o);
      }
      float mn = m;
#pragma unroll
      for (int q = 0; q < PF; ++q)
        if (ok[q]) mn = fmaxf(mn, sc[q]);
      if (mn == neg_inf) continue;  // no edge yet: a batch of pad senders
      const float scale = __expf(m - mn);  // 0 while m is -inf
      l *= scale;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] *= scale;
#pragma unroll
      for (int q = 0; q < PF; ++q) {
        if (!ok[q]) continue;  // the same for the whole warp
        const float pe = __expf(sc[q] - mn);
        l += pe;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = fmaf(pe, uq[q][e], acc[e]);
      }
      m = mn;
    }
  }
  if (!split) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      if (f + e < HC) out[r * HC + f + e] = acc[e] * inv;
  } else {
    const int64_t pr = part_of[c];
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      if (f + e < HC) pacc[pr * HC + f + e] = acc[e];
    // the lane holding a head's first feature writes its m and l
    if (f < HC && f % C < VEC) {
      const int h = f / C;
      pmax[pr * H + h] = m;
      psum[pr * H + h] = l;
    }
  }
}

constexpr int FIN_WARPS = 8;
constexpr int FIN_K = 4;   // features a lane: H*C up to 128
constexpr int FIN_U = 4;   // partials a warp loads before it merges them

// A cut row's output from its chunks' partials: a block per cut row, its
// warps taking the row's partials in turn, FIN_U at a time with all their
// loads issued first (a lane a feature, 32 apart), each merging them into
// its own softmax state, then the warps' states merged through shared
// memory:
//   out = sum_p acc_p exp(m_p - M) / sum_p l_p exp(m_p - M),
// M the largest m_p of the feature's head.  A hub row's partials (1,626
// at the cell's largest) spread over the block's warps and loads in
// flight; the hubs come first in node order, so their blocks start first.
__global__ void __launch_bounds__(FIN_WARPS * 32)
gatv2_finish_kernel(const int64_t* __restrict__ rows, const int* __restrict__ part_ptr,
                    const float* __restrict__ pmax, const float* __restrict__ psum,
                    const float* __restrict__ pacc, float* __restrict__ out, int H, int C) {
  __shared__ float sm[3][FIN_WARPS][32 * FIN_K];
  const int HC = H * C;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int s = blockIdx.x;
  const int p0 = part_ptr[s], p1 = part_ptr[s + 1];
  const float neg_inf = __uint_as_float(0xff800000u);
  float m[FIN_K], l[FIN_K], a[FIN_K];
#pragma unroll
  for (int k = 0; k < FIN_K; ++k) {
    m[k] = neg_inf;
    l[k] = a[k] = 0.f;
  }
  for (int pb = p0 + w; pb < p1; pb += FIN_WARPS * FIN_U) {
    float qm[FIN_U][FIN_K], ql[FIN_U][FIN_K], qa[FIN_U][FIN_K];
#pragma unroll
    for (int q = 0; q < FIN_U; ++q) {
      const int p = pb + q * FIN_WARPS;
#pragma unroll
      for (int k = 0; k < FIN_K; ++k) {
        const int f = lane + 32 * k;
        const bool on = p < p1 && f < HC;
        const int64_t ph = static_cast<int64_t>(p) * H + f / C;
        qm[q][k] = on ? pmax[ph] : neg_inf;
        ql[q][k] = on ? psum[ph] : 0.f;
        qa[q][k] = on ? pacc[static_cast<int64_t>(p) * HC + f] : 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < FIN_K; ++k) {
      float mn = m[k];
#pragma unroll
      for (int q = 0; q < FIN_U; ++q) mn = fmaxf(mn, qm[q][k]);
      if (mn == neg_inf) continue;
      const float x = __expf(m[k] - mn);
      l[k] *= x;
      a[k] *= x;
#pragma unroll
      for (int q = 0; q < FIN_U; ++q) {
        const float y = __expf(qm[q][k] - mn);  // 0 for a partial past the row
        l[k] = fmaf(ql[q][k], y, l[k]);
        a[k] = fmaf(qa[q][k], y, a[k]);
      }
      m[k] = mn;
    }
  }
#pragma unroll
  for (int k = 0; k < FIN_K; ++k) {
    sm[0][w][lane + 32 * k] = m[k];
    sm[1][w][lane + 32 * k] = l[k];
    sm[2][w][lane + 32 * k] = a[k];
  }
  __syncthreads();
  for (int f = threadIdx.x; f < HC; f += blockDim.x) {
    float mm = neg_inf;
    for (int v = 0; v < FIN_WARPS; ++v) mm = fmaxf(mm, sm[0][v][f]);
    float ll = 0.f, aa = 0.f;
    if (mm != neg_inf) {
      for (int v = 0; v < FIN_WARPS; ++v) {
        const float y = __expf(sm[0][v][f] - mm);
        ll = fmaf(sm[1][v][f], y, ll);
        aa = fmaf(sm[2][v][f], y, aa);
      }
    }
    out[rows[s] * HC + f] = ll > 0.f ? aa / ll : 0.f;
  }
}

struct Args {
  const int *ptr, *row, *src, *part;
  const void *u, *v;
  const float* att;
  float *out, *pmax, *psum, *pacc;
  int n_chunks, H, C, G;
  float slope;
  cudaStream_t st;
};

template <typename T, int VEC, bool VL>
cudaError_t run(const Args& a) {
  const unsigned blocks = static_cast<unsigned>((a.n_chunks + WARPS - 1) / WARPS);
  gatv2_attn_kernel<T, VEC, VL><<<blocks, WARPS * 32, 0, a.st>>>(
      a.ptr, a.row, a.src, a.part, static_cast<const T*>(a.u), static_cast<const T*>(a.v),
      a.att, a.out, a.pmax, a.psum, a.pacc, a.n_chunks, a.H, a.C, a.G, a.slope);
  return cudaGetLastError();
}

// VEC features a lane (ops/gatv2._kernel_vec): 1 up to 32 features, 2 up
// to 64, 4 up to 128; 4 by one vector load where the rows allow it
template <typename T>
cudaError_t launch(const Args& a) {
  const int HC = a.H * a.C;
  if (HC <= 32) return run<T, 1, false>(a);
  if (HC <= 64) return run<T, 2, false>(a);
  constexpr uintptr_t AL = 4 * sizeof(T);
  if (HC % 4 == 0 && reinterpret_cast<uintptr_t>(a.u) % AL == 0 &&
      reinterpret_cast<uintptr_t>(a.v) % AL == 0)
    return run<T, 4, true>(a);
  return run<T, 4, false>(a);
}

}  // namespace

// K17 over a work list (ops/gatv2.Gatv2Work): u, v [N, H*C] in `dtype`,
// att float32 [H, C], out float32 [N, H*C] (every row of one chunk
// written here, the cut rows by gta_gatv2_attn_finish), pmax and psum
// float32 [NP, H] and pacc float32 [NP, H*C] the cut rows' partials.
// H*C up to 128; with several heads C / VEC a power of two (VEC = 1, 2 or
// 4 as H*C is up to 32, 64 or 128).
extern "C" int gta_gatv2_attn(const void* chunk_ptr, const void* chunk_row, const void* slot_src,
                              const void* part_of, const void* u, const void* v, int dtype,
                              const void* att, void* out, void* pmax, void* psum, void* pacc,
                              int n_chunks, int H, int C, float slope, void* stream) {
  const int HC = H * C;
  if (HC > 128 || HC <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = HC <= 32 ? 1 : HC <= 64 ? 2 : 4;
  const int G = H == 1 ? 32 : C / vec;
  if (H > 1 && (C % vec != 0 || (G & (G - 1)) != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const int*>(chunk_ptr), static_cast<const int*>(chunk_row),
               static_cast<const int*>(slot_src),  static_cast<const int*>(part_of),
               u, v, static_cast<const float*>(att), static_cast<float*>(out),
               static_cast<float*>(pmax), static_cast<float*>(psum), static_cast<float*>(pacc),
               n_chunks, H, C, G, slope, static_cast<cudaStream_t>(stream)};
  const cudaError_t err = dtype == gta::BF16 ? launch<__nv_bfloat16>(a) : launch<float>(a);
  return static_cast<int>(err);
}

// The cut rows ``rows`` (int64, n_rows of them) of K17's output from the
// partials its chunks left: cut row s owns partial rows
// part_ptr[s]:part_ptr[s+1] (int32)
extern "C" int gta_gatv2_attn_finish(const void* rows, const void* part_ptr, const void* pmax,
                                     const void* psum, const void* pacc, void* out,
                                     int64_t n_rows, int H, int C, void* stream) {
  if (n_rows == 0) return 0;
  if (H * C > 32 * FIN_K || n_rows > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  gatv2_finish_kernel<<<static_cast<unsigned>(n_rows), FIN_WARPS * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(rows), static_cast<const int*>(part_ptr),
      static_cast<const float*>(pmax), static_cast<const float*>(psum),
      static_cast<const float*>(pacc), static_cast<float*>(out), H, C);
  return static_cast<int>(cudaGetLastError());
}
