"""Sparse-input first-layer product: X @ W over the nonzeros of X.

Counterpart of the JAX package's ``ops/sinput.py``.  A bag-of-words
feature matrix (Cora's is about 1.2% dense) makes the first layer's dense
X @ W almost all zeros.  X @ W is an SpMM over the bipartite feature ->
node graph (senders: the feature of each nonzero, receivers: its node,
weights: its value), so the hybrid split and its kernels run it: the
dense feature blocks on K2 (``csrc/spmm_dense_blocks.cu``) and the rest on
K1 (``csrc/spmm_tiles.cu``).  The gradient in W, Xᵀ ḡ, runs the same
kernels over the transposed bipartite graph.

X's pattern and values are baked when the graph is built: use it where the
features are fixed (training, fixed-feature serving).  Both sides live in
one square node space of ``max(N, F_in)`` nodes; rows are padded into it
and sliced back.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..graph import (HybridGraph, build_host_graph, hybrid_graph,
                     resolve_device)
from . import dense as dense_mod

# the sparse-input product switches on below this density of X
SPARSITY_THRESHOLD = 0.5


def density(x: np.ndarray) -> float:
    """Share of X's entries that are nonzero."""
    return float(np.count_nonzero(x)) / max(x.size, 1)


@dataclasses.dataclass
class FeatureGraph:
    """Bipartite split of a sparse feature matrix X [N, F_in]: ``fwd``
    (rows = nodes, columns = features) and ``bwd`` (its transpose), both
    float32-valued hybrid splits in the square node space."""

    fwd: HybridGraph
    bwd: HybridGraph
    n_node: int
    n_feat: int
    nnz: int


def feature_graph(x: np.ndarray, *, block: int = 256, tile_edges: int = 512,
                  device=None) -> FeatureGraph:
    """Build the bipartite splits of X's nonzeros on ``device`` (default
    the CUDA card), once, on the host: ``block``-wide dense and tail
    blocks, dense where a block holds at least the SpMM balance threshold
    of nonzeros, float32 values (the JAX package's builder)."""
    device = resolve_device(device)
    x = np.asarray(x)
    docs, words = np.nonzero(x)
    vals = x[docs, words].astype(np.float32)
    n = max(x.shape[0], x.shape[1])
    thr = dense_mod.spmm_dense_threshold(block, block)

    def build(s, r):
        hg = build_host_graph(s.astype(np.int32), r.astype(np.int32), n,
                              edge_weight=vals, edge_pad_multiple=tile_edges)
        return hybrid_graph(hg, block_rows=block, block_cols=block,
                            tile_edges=tile_edges, min_nnz=thr, device=device)

    return FeatureGraph(fwd=build(words, docs), bwd=build(docs, words),
                        n_node=int(x.shape[0]), n_feat=int(x.shape[1]),
                        nnz=len(vals))


def _apply_hybrid(hyb: HybridGraph, v: torch.Tensor,
                  out_rows: int) -> torch.Tensor:
    """The split's product with ``v`` [max(N, F_in), F]: K1 over the tail
    plus K2 over the dense blocks, float32, the first ``out_rows`` rows."""
    return dense_mod._spmm_hybrid_run(hyb, v)[:out_rows]


def _padded(v: torch.Tensor, rows: int, dtype) -> torch.Tensor:
    out = torch.zeros((rows, v.shape[1]), dtype=dtype, device=v.device)
    out[: v.shape[0]] = v
    return out


class _SparseInputMM(torch.autograd.Function):
    """X @ W on the forward split; dW = Xᵀ ḡ on the transposed one."""

    @staticmethod
    def forward(ctx, w, fg, compute_dtype):
        ctx.fg, ctx.w_dtype = fg, w.dtype
        ctx.dtype = compute_dtype or w.dtype
        n, f = fg.n_node, fg.n_feat
        wp = _padded(w, max(n, f), ctx.dtype)
        return _apply_hybrid(fg.fwd, wp, n)

    @staticmethod
    def backward(ctx, gy):
        fg = ctx.fg
        n, f = fg.n_node, fg.n_feat
        gp = _padded(gy, max(n, f), ctx.dtype)
        return _apply_hybrid(fg.bwd, gp, f).to(ctx.w_dtype), None, None


def sparse_input_mm(fg: FeatureGraph, w: torch.Tensor, *,
                    compute_dtype=None) -> torch.Tensor:
    """X @ W over the baked nonzeros of X: W [F_in, F_out] -> [N, F_out]
    float32, differentiable in W.  ``compute_dtype`` rounds W (and in the
    backward ḡ) to it first.  On CPU tensors both directions take the
    kernels' plain versions; on CUDA tensors they launch K1 and K2 or
    raise."""
    return _SparseInputMM.apply(w, fg, compute_dtype)
