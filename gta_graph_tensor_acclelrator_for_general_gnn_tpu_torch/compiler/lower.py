"""IR -> per-op PyTorch lowering (the port's oracle path).

Counterpart of the JAX package's ``compiler/lower.py``: ``lower`` turns an
:class:`~..ir.OpGraph` into ``apply(params, g, x)`` that evaluates every op
with the primitives of ``ops/primitives.py``.  ``compiler/fusion.py`` runs
matched blocks on the kernels and falls back to :func:`_eval_op` for the
rest.  Parameters keep the JAX names and the ``[in, out]`` layout.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from .. import ir
from ..graph import GraphTensor, resolve_device
from ..ops import primitives as P


def init_params(graph: ir.OpGraph, generator: torch.Generator,
                dtype=torch.float32, device=None) -> Dict[str, torch.Tensor]:
    """Glorot-uniform init for every MM weight in the op graph, drawn on
    the CPU from ``generator`` and placed on ``device`` (default the CUDA
    card)."""
    device = resolve_device(device)
    params: Dict[str, torch.Tensor] = {}
    for name, iw, ow in graph.param_specs():
        limit = (6.0 / (iw + ow)) ** 0.5
        u = torch.rand((iw, ow), generator=generator, dtype=torch.float32)
        params[name] = ((2.0 * u - 1.0) * limit).to(device=device, dtype=dtype)
    return params


def params_from_numpy(params: Mapping[str, np.ndarray], device=None,
                      dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The JAX package's parameters, read back as numpy arrays, as the
    port's: same names, same ``[in, out]`` layout, on ``device`` (default
    the CUDA card)."""
    device = resolve_device(device)
    return {k: torch.tensor(np.asarray(v, np.float32), dtype=dtype,
                            device=device) for k, v in params.items()}


def _eval_op(op: ir.Op, vals: Dict[int, torch.Tensor],
             params: Mapping[str, torch.Tensor], g: GraphTensor,
             x: torch.Tensor, compute_dtype) -> torch.Tensor:
    def ref(i: int) -> torch.Tensor:
        if i == ir.X_INPUT:
            return x
        if i == ir.EDGE_WEIGHT:
            return g.edge_weight[:, None]
        return vals[i]

    ins = [ref(i) for i in op.inputs] if op.inputs else [x]

    if op.kind == ir.SCATTER:
        return P.scatter_to_edges(ins[0], g, op.order)
    if op.kind == ir.GATHER:
        return P.gather_to_nodes(ins[0], g, op.compute, op.order)

    c = op.compute
    if c == ir.NONE:
        return ins[0]
    if c == ir.MM:
        name, _, _ = op.extra["weight"]
        return P.dense_mm(ins[0], params[name], compute_dtype)
    if c == ir.SF:
        return P.special_function(ins[0], op.extra.get("sf", "relu"),
                                  op.extra.get("negative_slope", 0.2))
    if c in (ir.ADD, ir.MUL, ir.SUB, ir.DIV):
        if len(ins) == 2:
            return P.binary_op(c, ins[0], ins[1])
        const = torch.full((1, 1), op.extra["const"], dtype=ins[0].dtype,
                           device=ins[0].device)
        return P.binary_op(c, ins[0], const)
    raise ValueError(f"op {op.op_id}: unhandled compute {c}")


def lower(graph: ir.OpGraph, compute_dtype: Optional[torch.dtype] = None
          ) -> Callable[[Mapping[str, torch.Tensor], GraphTensor,
                         torch.Tensor], torch.Tensor]:
    """Lower an OpGraph to ``apply(params, g, x) -> out`` (a dict keyed by
    op id when the graph has several outputs)."""
    order = graph.topo_order()
    outputs = list(graph.outputs)

    def apply(params, g: GraphTensor, x: torch.Tensor):
        vals: Dict[int, torch.Tensor] = {}
        for oid in order:
            vals[oid] = _eval_op(graph.by_id[oid], vals, params, g, x,
                                 compute_dtype)
        if len(outputs) == 1:
            return vals[outputs[0]]
        return {o: vals[o] for o in outputs}

    return apply
