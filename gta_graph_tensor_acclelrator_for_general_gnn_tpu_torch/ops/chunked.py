"""Chunked (edge-streaming) aggregation: the memory-bounded full-batch path.

Counterpart of the JAX package's ``ops/chunked.py``.  At Reddit's scale
(114.6M edges) a materialised [E, F] edge tensor does not fit one card, so
these ops stream fixed-size edge chunks: each chunk gathers its senders'
rows (``index_select``), forms float32 messages and adds them into an
[N + 1, F] float32 accumulator by receiver (``index_add_``; row N is the
dump row of padding edges).  Peak memory is O(N F + chunk F).  The JAX
package scans the chunks in ``lax.scan`` outside any Pallas kernel; here
the scan is a Python loop of plain PyTorch ops, and both functions are
differentiable by autograd, as JAX differentiates its scan.

GAT attention uses the shift-bound softmax of the attention kernels:
subtract b[r] = leaky(max_s a_src + a_dst[r]) >= every logit of row r (a
per-row constant; the softmax is shift-invariant), so one den pass and one
num pass suffice, with no per-edge alpha held and no max pass.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..graph import GraphTensor
from .primitives import exp_f64


def _pad_to_chunks(chunk: int, n_node: int, *arrays: torch.Tensor):
    """Pad 1-D edge arrays to a multiple of the chunk (indices -> the dump
    row n_node, weights and masks -> 0) and view them as [n_chunks,
    chunk]; the chunk is at most the edge count."""
    e_pad = int(arrays[0].shape[0])
    chunk = max(1, min(chunk, e_pad))
    total = -(-e_pad // chunk) * chunk
    out = []
    for a in arrays:
        if total != e_pad:
            index = not a.dtype.is_floating_point and a.dtype != torch.bool
            a = torch.cat([a, a.new_full((total - e_pad,),
                                         n_node if index else 0)])
        out.append(a.view(total // chunk, chunk))
    return out


def spmm_chunked(g: GraphTensor, x: torch.Tensor, *, chunk: int = 1 << 20,
                 edge_vals: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y[r] = sum over edges (s -> r) of w_e * x[s], streaming edge chunks:
    [N, F] float32.  x may be bf16 (each message is formed and summed in
    float32).  ``edge_vals`` [e_pad] multiplies the static edge weight."""
    f = x.shape[1]
    xt = torch.cat([x, x.new_zeros((1, f))])
    w = g.edge_weight if edge_vals is None else g.edge_weight * edge_vals
    send, recv, w = _pad_to_chunks(chunk, g.n_node, g.senders, g.receivers,
                                   w)
    acc = torch.zeros((g.n_node + 1, f), dtype=torch.float32,
                      device=x.device)
    for s, r, wc in zip(send, recv, w):
        msg = xt.index_select(0, s).float() * wc[:, None]
        acc.index_add_(0, r, msg)
    return acc[: g.n_node]


def gat_chunked(g: GraphTensor, h_src: torch.Tensor, a_src: torch.Tensor,
                a_dst: torch.Tensor, *, negative_slope: float = 0.2,
                chunk: int = 1 << 20) -> torch.Tensor:
    """Full-batch GAT attention without per-edge tensors: [N, HD], [N, H],
    [N, H] -> [N, HD] float32, in two streaming passes (den, then num) with
    the shift-bound softmax; out = num / max(den, 1e-20)."""
    H = a_src.shape[1]
    HD = h_src.shape[1]
    D = HD // H
    asr = torch.cat([a_src, a_src.new_zeros((1, H))])
    ads = torch.cat([a_dst, a_dst.new_zeros((1, H))])
    hs = torch.cat([h_src, h_src.new_zeros((1, HD))])
    msrc = a_src.float().amax(dim=0)                           # [H]
    send, recv, mask = _pad_to_chunks(chunk, g.n_node, g.senders,
                                      g.receivers, g.edge_mask)

    def leaky(v):
        return torch.where(v >= 0, v, negative_slope * v)

    def p_of(s, r, m):
        a_s = asr.index_select(0, s).float()
        a_d = ads.index_select(0, r).float()
        e = leaky(a_s + a_d)
        bound = leaky(msrc[None, :] + a_d)
        return torch.where(m[:, None], exp_f64(e - bound), 0.0)  # [chunk, H]

    dev = h_src.device
    den = torch.zeros((g.n_node + 1, H), dtype=torch.float32, device=dev)
    for s, r, m in zip(send, recv, mask):
        den.index_add_(0, r, p_of(s, r, m))
    num = torch.zeros((g.n_node + 1, HD), dtype=torch.float32, device=dev)
    for s, r, m in zip(send, recv, mask):
        p = p_of(s, r, m)
        num.index_add_(0, r, p.repeat_interleave(D, dim=1)
                       * hs.index_select(0, s).float())
    out = num / den.clamp(min=1e-20).repeat_interleave(D, dim=1)
    return out[: g.n_node]
