"""Sharded execution: the IR lowered per rank of a process group.

Counterpart of the JAX package's ``parallel/dist.py``.  Where JAX traces
one ``shard_map`` program over a device mesh, each rank here runs its own
forward over its shard of a :class:`~.partition.PartitionedGraph`
(``part.shard(rank, device)``), and the exchanges are collectives of
``torch.distributed`` (``parallel/qcomm.py``):

  * edge-domain values are pairs ``(local [EL, F], remote [ER, F])``;
  * apply_node / apply_edge: local (mapped over both halves);
  * gather: two local segment reductions (edges live with their
    receiver), combined;
  * scatter(order=C): the local half reads ``x_local``; the remote half
    reads the combined ``[halo all-to-all | hub all-gather | 0]`` table;
  * scatter(order=R): local on both halves (receivers are local).

Overlap: every exchange is started (``async_op=True``) before the work
that does not need it, and waited on only where the remote half reads the
table (:class:`Exchange`): the local-edge K1 or K3 call runs while the
halo all-to-all and the hub all-gather are in flight, on NCCL's stream or
on gloo's host thread.

``use_kernels=True`` runs each rank's local edges on the port's Hopper
kernels, as JAX runs its Pallas kernels there:

  * the weighted ``scatter(C) -> MUL edge_weight -> gather(ADD)`` chain of
    GCN, SAGE and GIN on K1 (``ops/spmm.spmm``) over the rank's tiling
    (:func:`shard_tiling`), with the exact linear VJP over the local edge
    arrays as its backward;
  * GAT's attention chain on K3 (``ops/gat._gat_forward``, raw [num |
    den]) over a unit-weight tiling, under the group-wide shift bound
    ``msrc`` (an all-reduce MAX of the detached per-rank a_src maxima:
    exact, since num / den does not depend on the shift); its backward is
    autograd of the plain local partial, the msrc term included.

Remote edges and the exchange are plain PyTorch and ``torch.distributed``
(XLA in JAX).  Replicated parameters get each rank's contribution to
their gradient; :func:`make_sharded_train_step` sums them over the group
before AdamW, which is what the transpose of JAX's replicated in_spec
does.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch
import torch.distributed as tdist
import torch.nn.functional as tF

from .. import ir
from ..ops import primitives as P
from . import qcomm
from .mesh2d import Mesh2D, PartitionedGraph2D

# the default group of the sharded functions: None, torch.distributed's
# world (the JAX package names its mesh axis here)
AXIS = None


def _sq(a):
    """Drop the leading [1] of a rank's shard array."""
    return a[0]


def _take_masked(x: torch.Tensor, idx: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """x[idx] with the rows where ``mask`` is False set to 0."""
    v = x.index_select(0, idx.reshape(-1)).reshape(idx.shape + x.shape[1:])
    return torch.where(mask[..., None], v, v.new_zeros(()))


def _scatter_add_rows(gx: torch.Tensor, idx: torch.Tensor,
                      mask: torch.Tensor, g: torch.Tensor) -> None:
    """The adjoint of :func:`_take_masked`: gx[idx] += g where mask."""
    F = gx.shape[1]
    g = g.float()
    g = torch.where(mask[..., None], g, g.new_zeros(()))
    gx.index_add_(0, idx.reshape(-1), g.reshape(-1, F))


def _a2a(quantize: bool):
    return qcomm.start_q8_all_to_all if quantize else qcomm.start_all_to_all


class Exchange:
    """A started exchange of ``x_local``'s boundary rows: the collectives
    are in flight after construction; :meth:`finish` waits and returns
    the combined remote table [rows, F], differentiable in ``x_local``
    (its backward runs the adjoint collectives).

    1-D plan (``group``: a process group, None for the world):
    ``[halo (D*H) | hubs (D*Kh) | dump]``.  2-D plan (``group``: a
    :class:`~.mesh2d.Mesh2D`): ``[intra (Dc*Hin) | inter (Dc*Dh*Hout) |
    hubs (D*Kh) | dump]``; the inter-host rows take the host-axis
    all-to-all, then the card-axis all-gather (with ``quantize``, of the
    int8 payload and its scales, dequantized once)."""

    def __init__(self, x_local: torch.Tensor, sh, group=AXIS,
                 quantize: bool = False):
        self.x, self.sh, self.quantize = x_local, sh, quantize
        x = x_local.detach()
        F = x.shape[-1]
        self.two_d = isinstance(sh, PartitionedGraph2D)
        if self.two_d:
            if not isinstance(group, Mesh2D):
                raise TypeError("a PartitionedGraph2D exchanges over a "
                                f"Mesh2D (make_mesh2d), not {group!r}")
            self.mesh = group
            send_in = _take_masked(x, _sq(sh.send_in_idx),
                                   _sq(sh.send_in_mask))
            self.p_in = _a2a(quantize)(send_in, group.chip)
            send_out = _take_masked(x, _sq(sh.send_out_idx),
                                    _sq(sh.send_out_mask))
            if quantize:
                q, s = qcomm._quantize(send_out)
                self.p_out = (qcomm.start_all_to_all(q, group.host),
                              qcomm.start_all_to_all(s, group.host))
            else:
                self.p_out = qcomm.start_all_to_all(send_out, group.host)
            hub_group = group.all
        else:
            if isinstance(group, Mesh2D):
                raise TypeError("a 1-D PartitionedGraph exchanges over one "
                                "process group, not a Mesh2D")
            self.group = group
            send = _take_masked(x, _sq(sh.send_idx), _sq(sh.send_mask))
            self.p_halo = _a2a(quantize)(send, group)
            hub_group = group
        self.hub_group = hub_group
        hub_src = _take_masked(x, _sq(sh.hub_idx), _sq(sh.hub_mask))
        self.p_hub = (qcomm.start_q8_all_gather if quantize
                      else qcomm.start_all_gather)(hub_src, hub_group)
        self.F = F

    def _table(self) -> torch.Tensor:
        F, x = self.F, self.x
        if self.two_d:
            halo_in = self.p_in.wait().reshape(-1, F)
            if self.quantize:
                qo, so = (p.wait() for p in self.p_out)
                q = qcomm.start_all_gather(qo, self.mesh.chip).wait()
                s = qcomm.start_all_gather(so, self.mesh.chip).wait()
                inter = qcomm._dequantize(q, s, x.dtype)
            else:
                recv = self.p_out.wait()
                inter = qcomm.start_all_gather(recv, self.mesh.chip).wait()
            parts = [halo_in, inter.reshape(-1, F)]
        else:
            parts = [self.p_halo.wait().reshape(-1, F)]
        parts.append(self.p_hub.wait().reshape(-1, F))
        parts.append(x.new_zeros((1, F)))
        return torch.cat(parts, 0)

    def _adjoint(self, g: torch.Tensor) -> torch.Tensor:
        """d x_local of the table's cotangent ``g``."""
        sh, F = self.sh, self.F
        gx = torch.zeros((self.x.shape[0], F), dtype=torch.float32,
                         device=g.device)
        q = self.quantize
        if self.two_d:
            m = self.mesh
            Dc, Dh = m.d_chip, m.d_host
            Hin, Hout = sh.halo_in, sh.halo_out
            n_in, n_inter = Dc * Hin, Dc * Dh * Hout
            g_in = qcomm.all_to_all_adjoint(g[:n_in].reshape(Dc, Hin, F),
                                            m.chip, q)
            _scatter_add_rows(gx, _sq(sh.send_in_idx),
                              _sq(sh.send_in_mask), g_in)
            g_inter = g[n_in:n_in + n_inter].reshape(Dc, Dh, Hout, F)
            g_recv = qcomm.reduce_scatter_sum(g_inter, m.chip)
            g_out = qcomm.all_to_all_adjoint(g_recv, m.host, q)
            _scatter_add_rows(gx, _sq(sh.send_out_idx),
                              _sq(sh.send_out_mask), g_out)
            base = n_in + n_inter
        else:
            D, H = sh.n_shards, sh.halo
            g_send = qcomm.all_to_all_adjoint(g[:D * H].reshape(D, H, F),
                                              self.group, q)
            _scatter_add_rows(gx, _sq(sh.send_idx), _sq(sh.send_mask),
                              g_send)
            base = D * H
        Kh = sh.hub_cap
        g_hub = g[base:base + sh.n_shards * Kh].reshape(sh.n_shards, Kh, F)
        g_hub = qcomm.reduce_scatter_sum(g_hub, self.hub_group)
        _scatter_add_rows(gx, _sq(sh.hub_idx), _sq(sh.hub_mask), g_hub)
        return gx.to(self.x.dtype)

    def finish(self) -> torch.Tensor:
        return _Finish.apply(self.x, self)


class _Finish(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ex):
        ctx.ex = ex
        return ex._table()

    @staticmethod
    def backward(ctx, g):
        return ctx.ex._adjoint(g.contiguous()), None


def remote_table(x_local: torch.Tensor, sh, group=AXIS,
                 quantize: bool = False) -> torch.Tensor:
    """Exchange boundary rows; returns the combined remote source table
    (halo rows, hub rows, zero dump row), differentiable in ``x_local``.
    A :class:`~.mesh2d.PartitionedGraph2D` takes the hierarchical exchange
    over ``group``, a :class:`~.mesh2d.Mesh2D`.  ``quantize``: int8
    payloads and per-row scales on the wire (``parallel/qcomm.py``)."""
    return Exchange(x_local, sh, group, quantize).finish()


def _pad_row(v: torch.Tensor) -> torch.Tensor:
    return torch.cat([v, v.new_zeros((1,) + tuple(v.shape[1:]))], 0)


def _scatter_c(v_node, sh, group, quantize: bool = False):
    ex = Exchange(v_node, sh, group, quantize)
    loc = _pad_row(v_node).index_select(0, _sq(sh.el_src))
    rem = ex.finish().index_select(0, _sq(sh.er_src))
    return (loc, rem)


def _scatter_r(v_node, sh):
    table = _pad_row(v_node)
    return (table.index_select(0, _sq(sh.el_dst)),
            table.index_select(0, _sq(sh.er_dst)))


def _segment_sum(v: torch.Tensor, idx: torch.Tensor, num: int):
    return v.new_zeros((num,) + tuple(v.shape[1:])).index_add_(0, idx, v)


def _segment_max(v: torch.Tensor, idx: torch.Tensor, num: int):
    out = v.new_full((num,) + tuple(v.shape[1:]), float("-inf"))
    return out.scatter_reduce_(
        0, idx.view(-1, *([1] * (v.dim() - 1))).expand_as(v), v, "amax")


def _gather(v_edge, sh, reduce: str) -> torch.Tensor:
    vl, vr = v_edge
    dl, dr = _sq(sh.el_dst), _sq(sh.er_dst)
    num = sh.n_local + 1
    if reduce == ir.ADD:
        out = _segment_sum(vl, dl, num) + _segment_sum(vr, dr, num)
    elif reduce == ir.MAX:
        out = torch.maximum(_segment_max(vl, dl, num),
                            _segment_max(vr, dr, num))
        out = torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    elif reduce == ir.MEAN:
        s = _segment_sum(vl, dl, num) + _segment_sum(vr, dr, num)
        d = (_segment_sum(_sq(sh.el_mask).to(vl.dtype), dl, num)
             + _segment_sum(_sq(sh.er_mask).to(vr.dtype), dr, num))
        out = s / torch.clamp(d, min=1.0)[:, None]
    else:
        raise ValueError(f"bad gather reduce {reduce}")
    return out[: sh.n_local]


class _SpmmLocal(torch.autograd.Function):
    """Local-edge aggregation on K1 over the rank's tiling (tile weights
    carry the edge weights); backward: the exact linear VJP, one gather
    and segment sum over the rank's local edge arrays."""

    @staticmethod
    def forward(ctx, h, tg, el_src, el_dst, el_w, n_l):
        from ..ops import spmm as spmm_mod
        ctx.save_for_backward(el_src, el_dst, el_w)
        ctx.n_l, ctx.dtype = n_l, h.dtype
        return spmm_mod.spmm(tg, h.contiguous())[:n_l]

    @staticmethod
    def backward(ctx, gbar):
        el_src, el_dst, el_w = ctx.saved_tensors
        msg = _pad_row(gbar.float()).index_select(0, el_dst) * el_w[:, None]
        gx = _segment_sum(msg, el_src, ctx.n_l + 1)
        return gx[: ctx.n_l].to(ctx.dtype), None, None, None, None, None


def spmm_remote(table: torch.Tensor, sh) -> torch.Tensor:
    """The remote half of the weighted SpMM chain, per op: the rows of
    the exchanged ``table`` at ``er_src`` times ``er_w``, summed in
    float32 into the rank's n_local receivers."""
    vr = table.index_select(0, _sq(sh.er_src)) * _sq(sh.er_w)[:, None]
    return _segment_sum(vr.float(), _sq(sh.er_dst),
                        sh.n_local + 1)[: sh.n_local]


def _spmm_local_kernel(h, sh, tiles) -> torch.Tensor:
    return _SpmmLocal.apply(h, tiles, _sq(sh.el_src), _sq(sh.el_dst),
                            _sq(sh.el_w), sh.n_local)


def _leaky(v, slope: float):
    return torch.where(v >= 0, v, slope * v)


def _attention_partial(hv, sv, dv, ms, src, dst, mask, n_l: int,
                       slope: float, table_rows=None):
    """[n_l, HD + H] = [num | den] of the edges (src -> dst) under the
    shift bound ``leaky(ms + a_d)``, in float32: the local half reads
    ``hv`` and ``sv`` at ``src``; with ``table_rows`` (the remote half)
    the sender rows come from that [h | a_s] table instead."""
    f32 = torch.float32
    H = dv.shape[1]
    HD = hv.shape[1] if table_rows is None else table_rows.shape[1] - H
    D_ = HD // H
    if table_rows is None:
        hs = _pad_row(hv.float()).index_select(0, src)
        asr = _pad_row(sv.float()).index_select(0, src)
    else:
        hs, asr = table_rows[:, :HD].float(), table_rows[:, HD:].float()
    ads = _pad_row(dv.float()).index_select(0, dst)
    e = _leaky(asr + ads, slope)
    bound = _leaky(ms.to(f32) + dv.to(f32), slope)
    b = _pad_row(bound).index_select(0, dst)
    p = torch.where(mask[:, None], P.exp_f64(e - b), e.new_zeros(()))
    num = _segment_sum(p.repeat_interleave(D_, dim=1) * hs, dst, n_l + 1)
    den = _segment_sum(p, dst, n_l + 1)
    return torch.cat([num, den], 1)[:n_l]


class _GatLocal(torch.autograd.Function):
    """Local-edge attention partials [n_local, HD + H] on K3 (raw, under
    the group-wide ``msrc``); backward: autograd of the plain partial over
    the rank's local edge arrays, the msrc term included."""

    @staticmethod
    def forward(ctx, h, a_s, a_d, msrc, tg, el_src, el_dst, el_mask, n_l,
                slope):
        from ..ops import gat as gat_mod
        ctx.save_for_backward(h, a_s, a_d, msrc, el_src, el_dst, el_mask)
        ctx.n_l, ctx.slope = n_l, slope
        return gat_mod._gat_forward(tg, h.contiguous(), None, a_d,
                                    a_s=a_s, negative_slope=slope,
                                    normalize=False, msrc=msrc)[:n_l]

    @staticmethod
    def backward(ctx, gy):
        h, a_s, a_d, msrc, el_src, el_dst, el_mask = ctx.saved_tensors
        ins = [t.detach().requires_grad_(True) for t in (h, a_s, a_d, msrc)]
        with torch.enable_grad():
            y = _attention_partial(*ins, el_src, el_dst, el_mask, ctx.n_l,
                                   ctx.slope)
            grads = torch.autograd.grad(y, ins, gy.float())
        return (*(g.to(t.dtype) for g, t in zip(grads, ins)),
                None, None, None, None, None, None)


def _kernel_chains(graph: ir.OpGraph) -> Dict[int, int]:
    """gather(ADD) op id -> input op id of each weighted ``scatter(C) ->
    MUL edge_weight -> gather(ADD)`` chain (the tile weights carry el_w,
    so an unweighted sum cannot take them)."""
    chains = {}
    for op in graph.ops:
        if op.kind != ir.GATHER or op.compute != ir.ADD:
            continue
        src = graph.by_id.get(op.inputs[0]) if op.inputs else None
        if not (src is not None and src.kind == ir.APPLY_EDGE
                and src.compute == ir.MUL and ir.EDGE_WEIGHT in src.inputs):
            continue
        inner = [i for i in src.inputs if i != ir.EDGE_WEIGHT]
        sc = graph.by_id.get(inner[0]) if inner else None
        if (sc is not None and sc.kind == ir.SCATTER and sc.order == "C"
                and sc.compute == ir.NONE and len(sc.inputs) == 1):
            chains[op.op_id] = sc.inputs[0]
    return chains


def _gat_plan(graph: ir.OpGraph):
    """The GAT attention chain whose internal values no other op reads,
    else None."""
    from ..ops.gat import find_gat_chain
    plan = find_gat_chain(graph)
    if plan is None:
        return None
    consumers = {op.op_id: set() for op in graph.ops}
    for op in graph.ops:
        for i in op.inputs:
            if i in consumers:
                consumers[i].add(op.op_id)
    internal = plan.ops - {plan.out_op}
    if (any(consumers[o] - plan.ops for o in internal)
            or internal & set(graph.outputs)):
        return None
    return plan


def _group_of(group):
    """The flat process group of a group or a Mesh2D."""
    return group.all if isinstance(group, Mesh2D) else group


def lower_shard(
    graph: ir.OpGraph,
    compute_dtype=None,
    group=AXIS,
    use_kernels: bool = False,
    tiles=None,
    gat_tiles=None,
    quantize_halo: bool = False,
) -> Callable:
    """Lower an OpGraph to ``apply(params, sh, x_local)`` for the calling
    rank of ``group`` (a process group, None for the world, or a
    :class:`~.mesh2d.Mesh2D` for a 2-D partition): ``compiler/lower.py``
    with scatter and gather replaced by their halo-partitioned forms.
    ``sh`` is the rank's shard (``part.shard(rank, device)``).

    ``use_kernels`` with ``tiles`` (the rank's :func:`shard_tiling`): the
    weighted SpMM chain runs its local edges on K1; with ``gat_tiles`` (a
    unit-weight tiling): the GAT chain runs its local edges on K3 as raw
    partials under the group-wide shift bound, the remote partial adds,
    and the combine normalizes once."""
    order = graph.topo_order()
    outputs = list(graph.outputs)
    flat = _group_of(group)
    gat_plan = (_gat_plan(graph) if use_kernels and gat_tiles is not None
                else None)
    chains = (_kernel_chains(graph) if use_kernels and tiles is not None
              else {})

    def gat_chain(ref, sh):
        h = ref(gat_plan.h_op)
        a_s = ref(gat_plan.asrc_op)
        a_d = ref(gat_plan.adst_op)
        if compute_dtype is not None:
            h = h.to(compute_dtype)
        H = a_d.shape[1]
        HD = h.shape[1]
        slope = gat_plan.negative_slope
        # the group-wide shift bound: both partials must share it; its
        # gradient is 0 analytically (num / den is shift-invariant)
        msrc = qcomm.all_reduce_(
            a_s.detach().float().amax(0, keepdim=True).contiguous(), flat,
            tdist.ReduceOp.MAX)
        # one exchange carries [h | a_src], in flight during K3
        ex = Exchange(torch.cat([h.float(), a_s.float()], 1), sh, group,
                      quantize_halo)
        acc = _GatLocal.apply(h, a_s.float(), a_d.float(), msrc, gat_tiles,
                              _sq(sh.el_src), _sq(sh.el_dst),
                              _sq(sh.el_mask), sh.n_local, slope)
        rows = ex.finish().index_select(0, _sq(sh.er_src))
        acc = acc + _attention_partial(None, None, a_d, msrc, None,
                                       _sq(sh.er_dst), _sq(sh.er_mask),
                                       sh.n_local, slope, table_rows=rows)
        num, den = acc[:, :HD], acc[:, HD:]
        return num / torch.clamp(den, min=1e-20).repeat_interleave(
            HD // H, dim=1)

    def spmm_chain(h, sh):
        if compute_dtype is not None:
            h = h.to(compute_dtype)
        ex = Exchange(h, sh, group, quantize_halo)     # in flight during K1
        y_loc = _spmm_local_kernel(h, sh, tiles)
        return y_loc + spmm_remote(ex.finish(), sh)

    def apply(params: Dict[str, torch.Tensor], sh, x: torch.Tensor):
        vals: Dict[int, object] = {}

        def ref(i: int):
            if i == ir.X_INPUT:
                return x
            if i == ir.EDGE_WEIGHT:
                return (_sq(sh.el_w)[:, None], _sq(sh.er_w)[:, None])
            return vals[i]

        def emap(f, *ins):
            return (f(*[a[0] for a in ins]), f(*[a[1] for a in ins]))

        for oid in order:
            op = graph.by_id[oid]
            if gat_plan is not None and oid in gat_plan.ops:
                if oid == gat_plan.out_op:
                    vals[oid] = gat_chain(ref, sh)
                continue
            if oid in chains:
                vals[oid] = spmm_chain(ref(chains[oid]), sh)
                continue
            ins = [ref(i) for i in op.inputs] if op.inputs else [x]
            edge = op.out_domain == ir.EDGE
            if op.kind == ir.SCATTER:
                v = (_scatter_c(ins[0], sh, group, quantize_halo)
                     if op.order == "C" else _scatter_r(ins[0], sh))
            elif op.kind == ir.GATHER:
                v = _gather(ins[0], sh, op.compute)
            elif op.compute == ir.NONE:
                v = ins[0]
            elif op.compute == ir.MM:
                w = params[op.extra["weight"][0]]

                def mfn(a, w=w):
                    return P.dense_mm(a, w, compute_dtype)
                v = emap(mfn, ins[0]) if edge else mfn(ins[0])
            elif op.compute == ir.SF:
                def sfn(a, op=op):
                    return P.special_function(
                        a, op.extra.get("sf", "relu"),
                        op.extra.get("negative_slope", 0.2))
                v = emap(sfn, ins[0]) if edge else sfn(ins[0])
            elif op.compute in (ir.ADD, ir.MUL, ir.SUB, ir.DIV):
                def bfn(*a, op=op):
                    if len(a) == 1:
                        c = torch.full((1, 1), op.extra["const"],
                                       dtype=a[0].dtype, device=a[0].device)
                        a = (a[0], c)
                    return P.binary_op(op.compute, *a)
                v = emap(bfn, *ins) if edge else bfn(*ins)
            else:
                raise ValueError(f"op {op.op_id}: unhandled compute "
                                 f"{op.compute}")
            vals[oid] = v
        if len(outputs) == 1:
            return vals[outputs[0]]
        return {o: vals[o] for o in outputs}

    return apply


def shard_tiling(part, d: int, *, block_rows: int = 256,
                 block_cols: int = 256, tile_edges: int = 512,
                 unit_weight: bool = False, device=None):
    """Rank ``d``'s :class:`~..graph.TiledGraph` over its local edges
    (``graph.tile_graph`` of a host graph of n_local nodes).  A rank runs
    its own kernel launch, so it keeps its own tile count: no padding to
    a common count and no dead tiles (JAX pads every shard to the largest
    count because one shard_map program serves every device).
    ``unit_weight``: tile weights 1 (attention tilings)."""
    from ..graph import HostGraph, _round_up, tile_graph
    n_local = part.n_local
    m = np.asarray(part.el_mask[d])
    ne = int(m.sum())
    pad = max(_round_up(max(ne, 1), 128), 128) - ne
    hg = HostGraph(
        senders=np.concatenate([np.asarray(part.el_src[d])[m],
                                np.full(pad, n_local, np.int32)]),
        receivers=np.concatenate([np.asarray(part.el_dst[d])[m],
                                  np.full(pad, n_local, np.int32)]),
        edge_mask=np.concatenate([np.ones(ne, bool), np.zeros(pad, bool)]),
        edge_weight=np.concatenate([np.asarray(part.el_w[d])[m],
                                    np.zeros(pad, np.float32)]
                                   ).astype(np.float32),
        n_node=n_local, n_edge=ne)
    return tile_graph(hg, block_rows=block_rows, block_cols=block_cols,
                      tile_edges=tile_edges, unit_weight=unit_weight,
                      device=device)


def shard_tiles(part, *, block_rows: int = 256, block_cols: int = 256,
                tile_edges: int = 512, unit_weight: bool = False,
                device=None) -> List:
    """One :func:`shard_tiling` per shard of the host partition ``part``."""
    return [shard_tiling(part, d, block_rows=block_rows,
                         block_cols=block_cols, tile_edges=tile_edges,
                         unit_weight=unit_weight, device=device)
            for d in range(part.n_shards)]


def make_dist_apply(
    layers: List[ir.OpGraph],
    group=AXIS,
    compute_dtype=None,
    use_kernels: bool = False,
    tiles=None,
    gat_tiles=None,
    quantize_halo: bool = False,
) -> Callable:
    """The calling rank's forward ``apply(params, sh, x_local) -> logits``
    [n_local, n_out] over the layer stack: ``sh`` is the rank's shard,
    ``x_local`` its rows of the padded features (``pad_nodes``)."""
    fns = [lower_shard(g, compute_dtype, group, use_kernels, tiles,
                       gat_tiles, quantize_halo=quantize_halo)
           for g in layers]

    def apply(params, sh, x_local):
        h = x_local
        for fn in fns:
            h = fn(params, sh, h)
        return h

    return apply


def make_sharded_train_step(
    layers: List[ir.OpGraph],
    group=AXIS,
    compute_dtype=None,
    use_kernels: bool = False,
    tiles=None,
    gat_tiles=None,
    quantize_halo: bool = False,
) -> Callable:
    """``step(state, sh, x_local, y_local, mask_local) -> (state, loss)``
    on the calling rank: the sharded forward, the masked cross entropy
    over the group's masked count, the backward (its exchanges' adjoints
    cross the group), the replicated parameters' gradients summed over
    the group, and AdamW (``state.optimizer``, as
    ``models/train.make_train_step`` runs it).  Every rank's parameters
    stay equal; ``loss`` is the group's loss."""
    fwd = make_dist_apply(layers, group, compute_dtype, use_kernels, tiles,
                          gat_tiles, quantize_halo=quantize_halo)
    flat = _group_of(group)

    def step(state, sh, x, y, mask):
        state.optimizer.zero_grad(set_to_none=True)
        params = dict(state.params)
        logits = fwd(params, sh, x)
        nll = tF.cross_entropy(logits.float(), y.long(), reduction="none")
        m = mask.float()
        count = qcomm.all_reduce_(m.sum().reshape(1), flat)
        loss = ((nll * m).sum() / torch.clamp(count, min=1.0))[0]
        loss.backward()
        for p in params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            qcomm.all_reduce_(p.grad, flat)
        state.optimizer.step()
        state.step += 1
        return state, qcomm.all_reduce_(loss.detach().reshape(1).clone(),
                                        flat)[0]

    return step


def shard_part(part, rank: int, device):
    """Rank ``rank``'s view of ``part`` on ``device``: ``part.shard``
    (JAX's ``shard_part`` places every shard on its mesh device)."""
    return part.shard(rank, device)


def shard_rows(arr: np.ndarray, part, d: int) -> np.ndarray:
    """Rank ``d``'s rows of a [n_node, ...] host array in the padded node
    space (``pad_nodes(arr, part)[d * n_local:(d + 1) * n_local]``)."""
    lo = d * part.n_local
    rows = arr[lo:lo + part.n_local]
    pad = part.n_local - rows.shape[0]
    return np.pad(rows, [(0, pad)] + [(0, 0)] * (arr.ndim - 1)) if pad \
        else rows
