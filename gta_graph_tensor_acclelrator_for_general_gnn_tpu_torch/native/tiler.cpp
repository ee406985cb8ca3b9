// Native graph preprocessing: block-sparse edge tiling and receiver sort.
//
// The reference framework is pure Python (SURVEY §2: no native code exists
// in it); its per-tile nnz preprocessing (FinalVersion For Paper/
// preprocessing.py) runs over small dense adjacency dumps.  This framework
// must tile real edge lists at Reddit scale (114M edges), where the numpy
// path (argsort + searchsorted + fancy scatter) costs minutes.  The C++
// path is two O(E) passes over the COO arrays — a counting pass per
// adjacency block and a placement pass — with no sort at all: the cursor
// scan preserves edge order within a block exactly like numpy's stable
// argsort, so both paths produce byte-identical tiles.
//
// Built with the other native sources into one shared library at first use
// and loaded via ctypes (native/__init__.py); every entry point is plain C
// ABI.

#include <cstdint>
#include <cstring>
#include <atomic>
#include <thread>
#include <vector>

extern "C" {

// Pass 1: nnz per adjacency block.  block id = (r/br)*CB + (s/bc).
// block_nnz must be zeroed, length RB*CB.
void gta_block_count(const int32_t* senders, const int32_t* receivers,
                     int64_t ne, int64_t cb_count, int32_t block_rows,
                     int32_t block_cols, int64_t* block_nnz) {
  for (int64_t e = 0; e < ne; ++e) {
    int64_t b = (int64_t)(receivers[e] / block_rows) * cb_count +
                (senders[e] / block_cols);
    block_nnz[b]++;
  }
}

// Pass 2: place each edge into (tile, slot).  block_tile_base[b] = first
// tile of block b (python computes it from the counts); block_cursor must
// be zeroed scratch of length RB*CB.  Output arrays are [T * tile_edges],
// prefilled by the caller with padding values.
void gta_tile_fill(const int32_t* senders, const int32_t* receivers,
                   const float* weight, int64_t ne, int64_t cb_count,
                   int32_t block_rows, int32_t block_cols, int32_t tile_edges,
                   const int64_t* block_tile_base, int64_t* block_cursor,
                   int32_t* src_local, int32_t* dst_local, int32_t* edge_id,
                   float* w_out) {
  for (int64_t e = 0; e < ne; ++e) {
    int32_t rblk = receivers[e] / block_rows;
    int32_t cblk = senders[e] / block_cols;
    int64_t b = (int64_t)rblk * cb_count + cblk;
    int64_t c = block_cursor[b]++;
    int64_t t = block_tile_base[b] + c / tile_edges;
    int64_t at = t * tile_edges + (c % tile_edges);
    src_local[at] = senders[e] - cblk * block_cols;
    dst_local[at] = receivers[e] - rblk * block_rows;
    edge_id[at] = (int32_t)e;
    w_out[at] = weight[e];
  }
}

// Counting sort of edges by receiver (the GraphTensor invariant).  counts
// must be zeroed, length n_node+1; order_out gets the stable permutation.
void gta_sort_by_receiver(const int32_t* receivers, int64_t ne,
                          int32_t n_node, int64_t* counts,
                          int64_t* order_out) {
  for (int64_t e = 0; e < ne; ++e) counts[receivers[e]]++;
  int64_t run = 0;
  for (int32_t v = 0; v <= n_node; ++v) {
    int64_t c = counts[v];
    counts[v] = run;
    run += c;
  }
  for (int64_t e = 0; e < ne; ++e) order_out[counts[receivers[e]]++] = e;
}

// In/out degree accumulation (for symmetric normalisation).
void gta_degrees(const int32_t* senders, const int32_t* receivers, int64_t ne,
                 double* out_deg, double* in_deg) {
  for (int64_t e = 0; e < ne; ++e) {
    out_deg[senders[e]] += 1.0;
    in_deg[receivers[e]] += 1.0;
  }
}

}  // extern "C"
