"""Collectives of the sharded path, and the int8-quantized exchanges.

Counterpart of the JAX package's ``parallel/qcomm.py`` over a process
group of ``torch.distributed``.  Only collectives that both NCCL and gloo
have are used: ``all_to_all_single`` with equal splits, ``all_gather``
and ``all_reduce`` (SUM, MAX).  Where JAX takes ``psum_scatter`` (the
adjoint of an all-gather), the port runs an all-to-all and a local sum.

Gloo runs its collectives on the host.  A CUDA tensor on a gloo group is
staged: copied to pinned host memory, exchanged, and copied back
(:data:`STAGED` counts the staged collectives and bytes).  The kernels
around the exchange still run on the card.

``start_*`` start a collective with ``async_op=True`` and return a
:class:`Pending`, whose ``wait()`` gives the result: the sharded path
starts its exchanges before the local-edge kernels and waits only where
the remote half needs them.

The differentiable exchanges, as ``torch.autograd.Function``:

  * :func:`all_to_all`: an equal-split all-to-all is a block permutation,
    its own adjoint, so its backward runs the same exchange;
  * :func:`all_gather`: its backward is the all-to-all-and-sum;
  * :func:`q8_all_to_all` / :func:`q8_all_gather`: per-row symmetric int8
    payloads plus one float32 scale a row (``v ~ q * scale / 127``,
    straight-through: the rounding is not differentiated).  The
    all-to-all's cotangent exchange is quantized the same way; the
    all-gather's cotangent sum stays in full precision (differently
    scaled int8 payloads cannot be summed), as in JAX.

These four are the JAX package's API.  The sharded path does not call
them: ``dist.Exchange`` starts its collectives before the local kernels
and its backward runs the same two adjoints, :func:`all_to_all_adjoint`
and :func:`reduce_scatter_sum`, block by block.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

# collectives and bytes staged through pinned host memory (gloo with
# CUDA tensors) since the last reset
STAGED = {"calls": 0, "bytes": 0}


def group_size(group=None) -> int:
    return dist.get_world_size(group)


def is_staged(group, t: torch.Tensor) -> bool:
    """True where ``group`` is a gloo group and ``t`` lies on the card:
    the collective then runs on pinned host copies."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of CUDA tensor ``t`` (waits for ``t``)."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    STAGED["calls"] += 1
    STAGED["bytes"] += t.numel() * t.element_size()
    return h


class Pending:
    """A started collective: ``wait()`` returns its result on the input's
    device."""

    def __init__(self, finish: Callable[[], torch.Tensor]):
        self._finish = finish

    def wait(self) -> torch.Tensor:
        return self._finish()


def _started(work, out: torch.Tensor, device: torch.device) -> Pending:
    def finish():
        work.wait()
        return out if out.device == device else out.to(device,
                                                       non_blocking=True)
    return Pending(finish)


def start_all_to_all(t: torch.Tensor, group=None) -> Pending:
    """Start the equal-split all-to-all of ``t`` [D, ...] along dim 0:
    block q goes to rank q, and block p of the result came from rank p."""
    src = _host(t) if is_staged(group, t) else t.contiguous()
    out = torch.empty_like(src)
    w = dist.all_to_all_single(out, src, group=group, async_op=True)
    return _started(w, out, t.device)


def start_all_gather(t: torch.Tensor, group=None) -> Pending:
    """Start the all-gather of ``t``: [D, *t.shape], block p from rank p."""
    src = _host(t) if is_staged(group, t) else t.contiguous()
    out = torch.empty((group_size(group),) + tuple(src.shape),
                      dtype=src.dtype, device=src.device)
    w = dist.all_gather(list(out.unbind(0)), src, group=group,
                        async_op=True)
    return _started(w, out, t.device)


def all_reduce_(t: torch.Tensor, group=None, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    """All-reduce ``t`` in place (SUM or MAX) and return it."""
    if is_staged(group, t):
        h = _host(t)
        dist.all_reduce(h, op=op, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def reduce_scatter_sum(g: torch.Tensor, group=None) -> torch.Tensor:
    """The adjoint of :func:`start_all_gather`: block p of ``g`` [D, ...]
    summed over every rank, for rank p (an all-to-all and a local sum)."""
    return start_all_to_all(g.contiguous(), group).wait().sum(0)


def all_to_all_adjoint(g: torch.Tensor, group=None,
                       quantize: bool = False) -> torch.Tensor:
    """The adjoint of the equal-split all-to-all (int8 on the wire with
    ``quantize``): the same exchange of the cotangent ``g`` [D, ...]."""
    start = start_q8_all_to_all if quantize else start_all_to_all
    return start(g.contiguous(), group).wait()


def _quantize(v: torch.Tensor):
    """Per-row symmetric int8: (q, scale) with v ~ q * scale / 127."""
    vf = v.float()
    s = vf.abs().amax(-1, keepdim=True)
    q = torch.round(vf / torch.clamp(s, min=1e-30) * 127.0)
    return q.to(torch.int8), s


def _dequantize(q: torch.Tensor, s: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * (s / 127.0)).to(dtype)


def start_q8_all_to_all(t: torch.Tensor, group=None) -> Pending:
    """:func:`start_all_to_all` of the int8 payload and its scales,
    dequantized once on arrival."""
    q, s = _quantize(t)
    qp, sp = start_all_to_all(q, group), start_all_to_all(s, group)
    return Pending(lambda: _dequantize(qp.wait(), sp.wait(), t.dtype))


def start_q8_all_gather(t: torch.Tensor, group=None) -> Pending:
    """:func:`start_all_gather` of the int8 payload and its scales,
    dequantized once on arrival."""
    q, s = _quantize(t)
    qp, sp = start_all_gather(q, group), start_all_gather(s, group)
    return Pending(lambda: _dequantize(qp.wait(), sp.wait(), t.dtype))


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, quantize):
        ctx.group, ctx.quantize = group, quantize
        start = start_q8_all_to_all if quantize else start_all_to_all
        return start(x, group).wait()

    @staticmethod
    def backward(ctx, g):
        return all_to_all_adjoint(g, ctx.group, ctx.quantize), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, quantize):
        ctx.group = group
        start = start_q8_all_gather if quantize else start_all_gather
        return start(x, group).wait()

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_sum(g, ctx.group), None, None


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable equal-split all-to-all of ``x`` [D, ...]."""
    return _AllToAll.apply(x, group, False)


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable all-gather: [D, *x.shape]."""
    return _AllGather.apply(x, group, False)


def q8_all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8-quantized :func:`all_to_all`, with a quantized cotangent
    exchange (straight-through)."""
    return _AllToAll.apply(x, group, True)


def q8_all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8-quantized :func:`all_gather` (forward payload only; the
    cotangent's all-to-all-and-sum stays full precision)."""
    return _AllGather.apply(x, group, True)
