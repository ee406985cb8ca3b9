"""Multi-layer models stacked from single-layer op graphs.

Counterpart of the JAX package's ``models/zoo.py``: :class:`Model` is an
``nn.Module`` holding the trainable parameters of its layer stack, under
the JAX names and in the ``[in, out]`` layout.  Serving runs its forward
under ``torch.inference_mode()``.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Union

import torch
from torch import nn

from .. import ir
from ..compiler import lower as L
from ..compiler.schedule import Schedule
from ..graph import GraphTensor, HostGraph, resolve_device
from ..utils.spans import span
from .builders import NETWORKS, PUBLISHED, build_op_graph


class Model(nn.Module):
    """A stack of per-layer op graphs with a shared parameter namespace."""

    def __init__(self, name: str, layers: List[ir.OpGraph], *,
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        self.name = name
        self.layers = layers
        gen = generator if generator is not None else torch.Generator()
        self.params = nn.ParameterDict()
        for g in layers:
            for k, v in L.init_params(g, gen, dtype, device).items():
                self.params[k] = nn.Parameter(v)

    def load_params(self, params: Mapping[str, torch.Tensor]) -> None:
        """Copy ``params`` (e.g. from :func:`~..compiler.lower.params_from_numpy`)
        into the model."""
        for k, v in params.items():
            with torch.no_grad():
                self.params[k].copy_(v)

    def make_apply(self, compute_dtype: Optional[torch.dtype] = None,
                   schedules: Union[None, Schedule, Sequence[Schedule]] = None,
                   host_graph: Optional[HostGraph] = None, *,
                   device=None, x_host=None, build_transpose: bool = False,
                   tile_cache: Optional[dict] = None):
        """Forward over the layer stack: ``apply(params, g, x)``.

        Without ``schedules`` every layer runs op by op (the oracle path).
        ``schedules`` (one per layer, or one for all) lower each layer
        through :func:`~..compiler.fusion.lower_schedule`, so matched blocks
        run on the Hopper kernels; that needs ``host_graph`` to build the
        tilings on ``device`` (default the CUDA card; shared across the
        stack's layers).
        ``x_host``: the dataset's features (numpy), passed to the first
        layer only (the one that reads X): below half density its MM of X
        runs on the sparse-input product over X's nonzeros, which bakes X
        (training, fixed-feature serving).
        ``build_transpose`` also splits the transposed graph so that
        gradients run on the kernels (training).  ``tile_cache``: a dict
        the tilings and splits are kept in (``lower_schedule``'s), to share
        them with another lowering on the same host graph (another dtype or
        model); default a fresh one."""
        if schedules is None:
            fns = [L.lower(g, compute_dtype) for g in self.layers]
        else:
            from ..compiler.fusion import lower_schedule
            if isinstance(schedules, Schedule):
                schedules = [schedules] * len(self.layers)
            if host_graph is None:
                raise ValueError("schedules need host_graph")
            shared_cache = tile_cache if tile_cache is not None else {}
            fns = [lower_schedule(g, s, host_graph, compute_dtype,
                                  device=device,
                                  x_host=x_host if i == 0 else None,
                                  build_transpose=build_transpose,
                                  tile_cache=shared_cache)
                   for i, (g, s) in enumerate(zip(self.layers, schedules))]

        names = [f"model.layer{i}" for i in range(len(fns))]

        def apply(params: Mapping[str, torch.Tensor], g: GraphTensor,
                  x: torch.Tensor) -> torch.Tensor:
            h = x
            with span("model.forward"):
                for name, fn in zip(names, fns):
                    with span(name):
                        h = fn(params, g, h)
            return h

        apply.layer_fns = fns
        return apply

    def forward(self, g: GraphTensor, x: torch.Tensor) -> torch.Tensor:
        """The per-op forward with the model's own parameters."""
        return self.make_apply()(dict(self.params), g, x)


def build_model(network: str, in_width: int, n_class: int, *,
                hidden: int = 128, n_layers: int = 2, heads: int = 4,
                reorder: bool = False,
                generator: Optional[torch.Generator] = None,
                dtype=torch.float32, device=None) -> Model:
    """An ``n_layers`` model of ``network`` ending in ``n_class`` logits,
    its parameters on ``device`` (default the CUDA card).
    Hidden layers use the family's activation, the last emits raw logits;
    hidden GAT and GATv2 layers use ``heads`` heads and the last one a
    single head."""
    if network not in NETWORKS + PUBLISHED:
        raise ValueError(f"unknown network {network!r}")
    layers: List[ir.OpGraph] = []
    w = in_width
    for i in range(n_layers):
        last = i == n_layers - 1
        out_w = n_class if last else hidden
        kw: Dict = dict(
            reorder=reorder,
            layer_tag=f"l{i}",
            final_sf="identity" if last else (
                "elu" if network in ("GAT", "GATv2") else "relu"),
        )
        if network in ("GAT", "GATv2"):
            kw["heads"] = 1 if last else heads
        if network in ("GIN", "PNA", "PNA-4x3"):
            kw["hidden"] = hidden
        layers.append(build_op_graph(network, w, out_w, **kw))
        w = out_w
    return Model(f"{network}-{n_layers}l", layers, generator=generator,
                 dtype=dtype, device=device)
