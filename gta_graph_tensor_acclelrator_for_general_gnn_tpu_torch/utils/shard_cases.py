"""Rank functions for a world of ranks started by ``parallel.launch``.

:func:`run_cases` runs a list of cases on the calling rank, in order (so
every rank starts the same collectives, subgroups included), and returns
``{case name: result}`` with numpy arrays: a world of ranks started once
serves every case of a test module.  A case is a dict with a ``kind``
and its inputs (host graphs, op graphs and numpy parameters pickle);
see each ``_case_*`` function for its keys.  The module imports torch and
the port only, so a spawned rank imports it by name.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch
import torch.distributed as dist

from ..compiler.lower import params_from_numpy
from ..parallel import dist as PD
from ..parallel import qcomm
from ..parallel.launch import RankContext
from ..parallel.mesh2d import make_mesh2d, partition_graph_2d
from ..parallel.partition import partition_graph


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _params(case, dev, grad: bool = False) -> Dict[str, torch.Tensor]:
    p = params_from_numpy(case["params"], device=dev)
    return {k: v.requires_grad_(grad) for k, v in p.items()}


def _sharded(ctx: RankContext, case):
    """(group, part, sh, tiles kwargs) of a case: a 1-D partition over the
    world, or with ``mesh2d`` (Dh, Dc) the 2-D one over its subgroups;
    with ``use_kernels`` the rank's tilings (``tile``: block rows, block
    cols, tile edges)."""
    hg = case["graph"]
    if case.get("mesh2d"):
        dh, dc = case["mesh2d"]
        group = make_mesh2d(dh, dc)
        part = partition_graph_2d(hg, dh, dc, **case.get("part_kw", {}))
    else:
        group = None
        part = partition_graph(hg, ctx.world, **case.get("part_kw", {}))
    sh = part.shard(ctx.rank, ctx.device)
    kw = dict(quantize_halo=case.get("quantize", False))
    if case.get("use_kernels"):
        br, bc, te = case.get("tile", (16, 16, 32))
        geo = dict(block_rows=br, block_cols=bc, tile_edges=te,
                   device=ctx.device)
        kw.update(use_kernels=True,
                  tiles=PD.shard_tiling(part, ctx.rank, **geo),
                  gat_tiles=PD.shard_tiling(part, ctx.rank,
                                            unit_weight=True, **geo))
    return group, part, sh, kw


def _case_forward(ctx: RankContext, case):
    """``layers``, ``graph`` (HostGraph), ``params``, ``x`` [n, F]; options
    ``use_kernels``, ``tile``, ``quantize``, ``mesh2d``, ``part_kw``,
    ``dtype`` ("bfloat16").  With ``grads``: the gradient of sum(out²)
    over the real rows, summed over the group.  Returns the rank's output
    rows (and the gradients)."""
    group, part, sh, kw = _sharded(ctx, case)
    dt = torch.bfloat16 if case.get("dtype") == "bfloat16" else None
    fwd = PD.make_dist_apply(case["layers"], group, dt, **kw)
    params = _params(case, ctx.device, grad=case.get("grads", False))
    x = torch.as_tensor(PD.shard_rows(case["x"], part, ctx.rank),
                        device=ctx.device)
    out = fwd(params, sh, x)
    res = {"out": _np(out)}
    if case.get("grads"):
        real = (torch.arange(part.n_local, device=ctx.device)
                + ctx.rank * part.n_local) < case["graph"].n_node
        (out[real].float() ** 2).sum().backward()
        flat = PD._group_of(group)
        res["grads"] = {k: _np(qcomm.all_reduce_(v.grad, flat))
                        for k, v in params.items()}
    return res


def _case_train_step(ctx: RankContext, case):
    """``make_sharded_train_step`` with AdamW(``lr``): ``layers``,
    ``graph``, ``params``, ``x``, ``y``, ``mask``, ``steps``.  Returns
    each step's loss and the parameters after."""
    from ..models.train import TrainState, adamw
    group, part, sh, kw = _sharded(ctx, case)
    params = _params(case, ctx.device)
    for v in params.values():
        v.requires_grad_(True)
    state = TrainState(params, adamw(params, case.get("lr", 1e-2)))
    step = PD.make_sharded_train_step(case["layers"], group, **kw)
    rows = {k: torch.as_tensor(PD.shard_rows(case[k], part, ctx.rank),
                               device=ctx.device) for k in ("x", "y", "mask")}
    losses = []
    for _ in range(case.get("steps", 1)):
        state, loss = step(state, sh, rows["x"], rows["y"], rows["mask"])
        losses.append(float(loss))
    return {"losses": losses,
            "params": {k: _np(v) for k, v in state.params.items()}}


def _case_exchange(ctx: RankContext, case):
    """The quantized collectives against the exact ones on ``x`` [D*D*H,
    F] (``op``: "a2a" or "gather", each rank its [D*H, F] or [K, F]
    block): both results, and for "a2a" the gradient of sum(out²) through
    each."""
    D = ctx.world
    x = torch.as_tensor(case["x"], device=ctx.device)
    blk = x.reshape(D, -1, *x.shape[1:])[ctx.rank]
    res = {}
    for name, quant in (("exact", False), ("quant", True)):
        v = blk.clone().requires_grad_(True)
        if case["op"] == "a2a":
            v3 = v.reshape(D, -1, *v.shape[1:])
            out = (qcomm.q8_all_to_all if quant else qcomm.all_to_all)(v3)
            (out ** 2).sum().backward()
            res[name + "_grad"] = _np(v.grad)
        else:
            out = (qcomm.q8_all_gather if quant else qcomm.all_gather)(v)
        res[name] = _np(out)
    return res


def _case_remote_table(ctx: RankContext, case):
    """``remote_table`` of ``x`` [n, F] exact and quantized on ``graph``
    (``mesh2d`` for the 2-D plan)."""
    group, part, sh, _ = _sharded(ctx, case)
    x = torch.as_tensor(PD.shard_rows(case["x"], part, ctx.rank),
                        device=ctx.device)
    return {q: _np(PD.remote_table(x, sh, group, quantize=q == "quant"))
            for q in ("exact", "quant")}


def _case_dp_step(ctx: RankContext, case):
    """``make_train_step(pmean_axis=world)`` on the rank's own batch
    (``xs``, ``ys``, ``masks`` indexed by rank) of ``graph``; returns the
    loss and parameters after ``steps`` steps."""
    from ..models.train import TrainState, adamw, make_train_step
    from ..compiler.lower import lower
    params = _params(case, ctx.device)
    for v in params.values():
        v.requires_grad_(True)
    layers = case["layers"]
    fns = [lower(g) for g in layers]

    def apply(p, g, x):
        for fn in fns:
            x = fn(p, g, x)
        return x

    state = TrainState(params, adamw(params, case.get("lr", 1e-2)))
    step = make_train_step(apply, pmean_axis=dist.group.WORLD)
    g = case["graph"].to_device(ctx.device)
    x, y, m = (torch.as_tensor(case[k][ctx.rank], device=ctx.device)
               for k in ("xs", "ys", "masks"))
    losses = []
    for _ in range(case.get("steps", 1)):
        state, loss = step(state, g, x, y, m)
        losses.append(float(loss))
    return {"losses": losses,
            "params": {k: _np(v) for k, v in state.params.items()}}


def _case_sampled_scan(ctx: RankContext, case):
    """``train_sampled_scan(mesh=world)`` on ``dataset`` with ``kw``, the
    parameters ``params`` (a GraphSAGE of ``len(fanouts)`` layers) and,
    with ``numpy_sampler``, the native sampler switched off in this
    rank."""
    from .. import native
    from ..data.datasets import load_dataset
    from ..models.train import train_sampled_scan
    from ..models.zoo import build_model
    if case.get("numpy_sampler"):
        native.HAVE_NATIVE = False
    ds = load_dataset(case["dataset"])
    kw = dict(case["kw"])
    model = build_model(kw.get("network", "GraphSAGE"), ds.x.shape[1],
                        ds.n_class, hidden=kw["hidden"],
                        n_layers=len(kw["fanouts"]), device=ctx.device)
    model.load_params(params_from_numpy(case["params"], device=ctx.device))
    state, res, bd = train_sampled_scan(ds, mesh=dist.group.WORLD,
                                        model=model, device=ctx.device,
                                        **kw)
    return {"train_loss": res.train_loss, "step": state.step,
            "steps_per_epoch": bd["steps_per_epoch"],
            "epoch_losses": bd["epoch_losses"],
            "params": {k: _np(v) for k, v in state.params.items()}}


def _case_multihost(ctx: RankContext, case):
    """``train_multihost`` on ``dataset`` with ``kw`` (2-D mesh
    ``mesh2d``); returns what it returns."""
    from ..data.datasets import load_dataset
    from ..parallel.multihost import init_multihost, train_multihost
    ds = load_dataset(case["dataset"])
    mesh = make_mesh2d(*case["mesh2d"]) if case.get("mesh2d") else None
    return {"init": init_multihost(),
            "result": train_multihost(ds, mesh=mesh, device=ctx.device,
                                      **case["kw"])}


def _case_trace(ctx: RankContext, case):
    """``parallel/overlap.overlap_report`` of a profiler trace of one
    sharded forward (the ``forward`` case's keys), written under
    ``trace_dir``."""
    import os

    from torch.profiler import ProfilerActivity, profile

    from ..parallel.overlap import overlap_report
    acts = [ProfilerActivity.CPU]
    if ctx.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        _case_forward(ctx, dict(case, grads=False))
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
    path = os.path.join(case["trace_dir"], f"trace{ctx.rank}.json")
    prof.export_chrome_trace(path)
    return overlap_report(path)


CASES: Dict[str, Callable] = {
    "forward": _case_forward,
    "train_step": _case_train_step,
    "exchange": _case_exchange,
    "remote_table": _case_remote_table,
    "dp_step": _case_dp_step,
    "sampled_scan": _case_sampled_scan,
    "multihost": _case_multihost,
    "trace": _case_trace,
}


def run_cases(ctx: RankContext, cases: List[dict]) -> Dict[str, object]:
    """Run ``cases`` in order on this rank; ``{name: result}``."""
    torch.manual_seed(0)
    return {c["name"]: CASES[c["kind"]](ctx, c) for c in cases}
