"""The sharded path on the card: the rank functions of ``chip_smoke.py``'s
phase 13, started by ``parallel.launch``.

:func:`gloo_rank` (13a and 13b, four gloo ranks on one card) checks K1
and K3 against their plain versions at the rank's shapes and times them
(the ranks take turns), serves GCN-2l and GAT-2l requests through
``make_dist_apply(use_kernels=True)`` (one bf16 and one float32 each, and
GAT-2l with ``quantize_halo``), takes one float32 and two bf16 sharded
train steps, counts K1's and K3's launches on that path, times one
layer's exchange and (a card only) one layer's aggregation without it
(K1 local plus the per-op remote half), traces one step for
``overlap_report``, then repeats a
GCN-2l request and gradient on the 2 x 2 mesh.  :func:`nccl_rank` (13c, a
world of one over NCCL) serves and steps GCN-2l through the same entry
points and trains one Flickr epoch of ``train_sampled_scan`` with the
all-reduce in the captured graph, beside ``mesh=None``.  Both return
numpy arrays and numbers; the caller compares them with the single-card
paths.  The partitions come from the caller as directories of ``.npy``
files (:func:`save_partition`), which each rank maps and slices.

On a CPU device (the small dry runs of the tests) nothing is timed.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from ..compiler.lower import params_from_numpy
from ..models import train as TT
from ..models.zoo import build_model
from ..ops import gat as A
from ..ops import spmm as SP
from ..parallel import dist as PD
from ..parallel import qcomm
from ..parallel.launch import RankContext
from ..parallel.mesh2d import PartitionedGraph2D, make_mesh2d
from ..parallel.partition import PartitionedGraph
from . import fixtures, roofline
from .benchmark import median_ms

# timing windows of a kernel (CALLS calls each) and of its plain version
REPEATS, CALLS, PLAIN_REPEATS = 5, 10, 3


def save_partition(part, path: str) -> None:
    """Write ``part``'s arrays as ``.npy`` files and its sizes as JSON
    under directory ``path``."""
    os.makedirs(path, exist_ok=True)
    meta = {"class": type(part).__name__}
    for f in dataclasses.fields(part):
        v = getattr(part, f.name)
        if isinstance(v, np.ndarray):
            np.save(os.path.join(path, f.name + ".npy"), v)
        else:
            meta[f.name] = v
    with open(os.path.join(path, "meta.json"), "w") as fh:
        json.dump(meta, fh)


def load_partition(path: str):
    """The partition :func:`save_partition` wrote, its arrays memory-mapped
    (a rank reads only its own slice)."""
    with open(os.path.join(path, "meta.json")) as fh:
        meta = json.load(fh)
    cls = {"PartitionedGraph": PartitionedGraph,
           "PartitionedGraph2D": PartitionedGraph2D}[meta.pop("class")]
    kw = dict(meta)
    for f in dataclasses.fields(cls):
        if f.name not in kw:
            kw[f.name] = np.load(os.path.join(path, f.name + ".npy"),
                                 mmap_mode="r")
    return cls(**kw)


def request_x(seed: int, n: int, f_in: int) -> np.ndarray:
    """The smoke's request features (``chip_smoke._request_x``)."""
    return np.random.default_rng(seed).standard_normal((n, f_in),
                                                       dtype=np.float32)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _in_turn(ctx: RankContext, fn):
    """Run ``fn()`` on one rank at a time (the others wait at a barrier),
    so each rank's kernel times hold the card alone."""
    out = None
    for r in range(ctx.world):
        if r == ctx.rank:
            out = fn()
            if ctx.device.type == "cuda":
                torch.cuda.synchronize(ctx.device)
        dist.barrier()
    return out


def _model(spec, dev):
    m = build_model(spec["network"], spec["f_in"], spec["n_class"],
                    hidden=spec["hidden"], n_layers=2, heads=spec["heads"],
                    reorder=spec.get("reorder", False), device=dev)
    m.load_params(params_from_numpy(spec["params"], device=dev))
    return m


def _kernel_checks(ctx, tg, tgu, x, models, dts) -> dict:
    """K1 and K3 at the rank's shapes (layer inputs of GCN-2l and GAT-2l)
    against their plain versions, each within ``fixtures.kernel_error``'s
    bound; with a card, each timed beside its plain version and bound."""
    dev = ctx.device
    gen = torch.Generator(device="cpu").manual_seed(100 + ctx.rank)
    out = {"spmm_tiles": [], "gat_tiles": []}
    gcn = models["GCN-2l"]
    h0 = (x @ gcn.params["gcn_l0_w"].detach())
    widths = {"spmm_tiles": [h0, torch.randn(h0.shape[0], 41, generator=gen
                                             ).to(dev)],
              "gat_tiles": [(torch.randn(h0.shape[0], 128, generator=gen
                                         ).to(dev), 4),
                            (torch.randn(h0.shape[0], 41, generator=gen
                                         ).to(dev), 1)]}
    terms1, termsu = fixtures.row_terms(tg), fixtures.row_terms(tgu)
    for dtn, dt in dts:
        for li, h in enumerate(widths["spmm_tiles"]):
            hk = h.to(dt).contiguous()
            w = tg.weight

            def kern():
                return SP.spmm_tiles(tg, hk, w)

            def plain():
                return SP._spmm_reference(tg, hk, weight=w)
            err, share = fixtures.check_kernel(fixtures.KernelCase(
                "spmm_tiles", f"rank {ctx.rank} l{li}", dtn, kern(), plain(),
                terms=terms1))
            row = dict(layer=li, dtype=dtn, F=int(hk.shape[1]), err=err,
                       share=share)
            if dev.type == "cuda":
                work = roofline.spmm_tail(tg, hk, w.element_size())
                row.update(_in_turn(ctx, lambda: dict(
                    ms=median_ms(kern, device=dev, warmup=1,
                                 repeats=REPEATS, calls=CALLS),
                    plain_ms=median_ms(plain, device=dev, warmup=1,
                                       repeats=PLAIN_REPEATS))),
                    bound_ms=work.bound_ms, bound_by=work.bound_by)
            out["spmm_tiles"].append(row)
        for li, (h, H) in enumerate(widths["gat_tiles"]):
            hk = h.to(dt).contiguous()
            a_s = torch.randn(h.shape[0], H, generator=gen).to(dev)
            a_d = torch.randn(h.shape[0], H, generator=gen).to(dev)
            ms = a_s.amax(0, keepdim=True)
            m = tgu.weight
            HD = hk.shape[1]

            def kern():
                return A.gat_tiles(tgu, hk, m, a_d, ms, a_src=a_s,
                                   normalize=False)

            def plain():
                return A._gat_tiles_reference(tgu, hk, m, a_d, ms,
                                              a_src=a_s, normalize=False)
            err, share = fixtures.check_kernel(fixtures.KernelCase(
                "gat_tiles", f"rank {ctx.rank} l{li}", dtn, kern(), plain(),
                split=HD, terms=termsu))
            row = dict(layer=li, dtype=dtn, F=int(HD), H=H, err=err,
                       share=share)
            if dev.type == "cuda":
                work = roofline.gat_tail(tgu, hk, H, m.element_size(),
                                         derive=False)
                row.update(_in_turn(ctx, lambda: dict(
                    ms=median_ms(kern, device=dev, warmup=1,
                                 repeats=REPEATS, calls=CALLS),
                    plain_ms=median_ms(plain, device=dev, warmup=1,
                                       repeats=PLAIN_REPEATS))),
                    bound_ms=work.bound_ms, bound_by=work.bound_by)
            out["gat_tiles"].append(row)
    return out


def _step_grads(state) -> Dict[str, np.ndarray]:
    return {k: _np(p.grad) for k, p in state.params.items()}


def _exchange_ms(ctx, sh, n_local: int) -> float:
    """Host milliseconds of one layer's exchange of a [n_local, 128] bf16
    tensor (start to finish, the card synchronized), median of 5."""
    h = torch.randn(n_local, 128, device=ctx.device).to(torch.bfloat16)
    times = []
    for _ in range(6):
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
        dist.barrier()
        t0 = time.perf_counter()
        PD.Exchange(h, sh).finish()
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times[1:]))


def _aggregation_ms(ctx, sh, tg, h: torch.Tensor) -> float:
    """Device milliseconds of one layer's aggregation on this rank with
    the exchange done beforehand: K1 on the local edges plus the per-op
    remote half over the exchanged table (``dist.spmm_remote``), as the
    sharded GCN layer runs them; the ranks take turns."""
    with torch.inference_mode():
        table = PD.Exchange(h, sh).finish()
        return _in_turn(ctx, lambda: median_ms(
            lambda: PD._spmm_local_kernel(h, sh, tg)
            + PD.spmm_remote(table, sh), device=ctx.device, warmup=1,
            repeats=REPEATS, calls=CALLS))


def _traced_step(ctx, step_fn, trace_dir: str) -> dict:
    """``parallel/overlap.overlap_report`` of one traced sharded step."""
    from torch.profiler import ProfilerActivity, profile

    from ..parallel.overlap import overlap_report
    acts = [ProfilerActivity.CPU]
    if ctx.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        step_fn()
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
    path = os.path.join(trace_dir, f"step_rank{ctx.rank}.json")
    prof.export_chrome_trace(path)
    return overlap_report(path)


def gloo_rank(ctx: RankContext, spec) -> dict:
    """Phase 13a and 13b on this rank; see the module docstring.
    ``spec``: ``part_dir``, ``part2d_dir``, ``models`` (name -> network,
    widths, params), ``n_node``, ``f_in``, ``seed``, ``labels``, ``tile``,
    ``lr``, ``trace_dir``."""
    torch.manual_seed(0)
    t_start = time.perf_counter()
    dev, rank = ctx.device, ctx.rank
    part_h = load_partition(spec["part_dir"])
    sh = part_h.shard(rank, dev)
    geo = dict(zip(("block_rows", "block_cols", "tile_edges"), spec["tile"]),
               device=dev)
    t0 = time.perf_counter()
    tg = PD.shard_tiling(part_h, rank, **geo)
    tgu = PD.shard_tiling(part_h, rank, unit_weight=True, **geo)
    res = {"tiling_s": time.perf_counter() - t0, "n_tiles": tg.n_tiles,
           "n_tiles_unit": tgu.n_tiles,
           "local_edges": int(np.asarray(part_h.el_mask[rank]).sum()),
           "remote_edges": int(np.asarray(part_h.er_mask[rank]).sum())}
    x_all = request_x(spec["seed"], spec["n_node"], spec["f_in"])
    x = torch.as_tensor(PD.shard_rows(x_all, part_h, rank), device=dev)
    y = torch.as_tensor(PD.shard_rows(spec["labels"], part_h, rank),
                        device=dev)
    mask = torch.ones(part_h.n_local, dtype=torch.bool, device=dev)
    mask &= (torch.arange(part_h.n_local, device=dev)
             + rank * part_h.n_local) < spec["n_node"]
    del x_all
    models = {k: _model(m, dev) for k, m in spec["models"].items()}
    dts = (("bfloat16", torch.bfloat16), ("float32", torch.float32))
    res["kernels"] = _kernel_checks(ctx, tg, tgu, x, models, dts)

    kw = dict(use_kernels=True, tiles=tg, gat_tiles=tgu)
    qcomm.STAGED.update(calls=0, bytes=0)
    SP.spmm_tiles.launches = 0
    A.gat_tiles.launches = 0
    res["answers"] = {}
    with torch.inference_mode():
        for mname, model in models.items():
            for dtn, dt in dts:
                fwd = PD.make_dist_apply(
                    model.layers, None,
                    torch.bfloat16 if dtn == "bfloat16" else None, **kw)
                res["answers"][(mname, dtn)] = _np(
                    fwd(dict(model.params), sh, x))
    res["grads"], res["losses"] = {}, {}
    for mname, model in models.items():
        init = {k: v.detach().clone() for k, v in model.params.items()}
        state = TT.TrainState(model.params, TT.adamw(model.params,
                                                     spec["lr"]))
        step = PD.make_sharded_train_step(model.layers, None, None, **kw)
        state, loss = step(state, sh, x, y, mask)
        res["losses"][(mname, "float32")] = [float(loss)]
        res["grads"][mname] = _step_grads(state)
        model.load_params(init)
        state = TT.TrainState(model.params, TT.adamw(model.params,
                                                     spec["lr"]))
        step = PD.make_sharded_train_step(model.layers, None,
                                          torch.bfloat16, **kw)
        losses = []
        for _ in range(2):
            state, loss = step(state, sh, x, y, mask)
            losses.append(float(loss))
        res["losses"][(mname, "bfloat16")] = losses
        model.load_params(init)
    res["launches"] = {"spmm_tiles": SP.spmm_tiles.launches,
                       "gat_tiles": A.gat_tiles.launches}
    res["staged"] = dict(qcomm.STAGED)

    gat = models["GAT-2l"]
    with torch.inference_mode():
        fwd = PD.make_dist_apply(gat.layers, None, None,
                                 quantize_halo=True, **kw)
        res["answers"][("GAT-2l", "float32/quantized")] = _np(
            fwd(dict(gat.params), sh, x))
    res["exchange_ms"] = _exchange_ms(ctx, sh, part_h.n_local)

    gcn = models["GCN-2l"]
    if dev.type == "cuda":
        h0 = (x @ gcn.params["gcn_l0_w"].detach()).to(torch.bfloat16)
        res["aggregation_ms"] = _aggregation_ms(ctx, sh, tg, h0)
        del h0
    init = {k: v.detach().clone() for k, v in gcn.params.items()}
    state = TT.TrainState(gcn.params, TT.adamw(gcn.params, spec["lr"]))
    step = PD.make_sharded_train_step(gcn.layers, None, torch.bfloat16,
                                      **kw)
    step(state, sh, x, y, mask)                         # warm
    res["overlap"] = _traced_step(
        ctx, lambda: step(state, sh, x, y, mask), spec["trace_dir"])
    gcn.load_params(init)
    res["phase_a_s"] = time.perf_counter() - t_start

    # 13b: the 2 x 2 mesh over the same ranks
    t0 = time.perf_counter()
    mesh = make_mesh2d(2, 2)
    p2 = load_partition(spec["part2d_dir"])
    sh2 = p2.shard(rank, dev)
    kw2 = dict(use_kernels=True, tiles=PD.shard_tiling(p2, rank, **geo))
    with torch.inference_mode():
        fwd = PD.make_dist_apply(gcn.layers, mesh, None, **kw2)
        res["answers"][("GCN-2l", "float32/2x2")] = _np(
            fwd(dict(gcn.params), sh2, x))
    state = TT.TrainState(gcn.params, TT.adamw(gcn.params, spec["lr"]))
    step = PD.make_sharded_train_step(gcn.layers, mesh, None, **kw2)
    state, loss = step(state, sh2, x, y, mask)
    res["losses"][("GCN-2l", "float32/2x2")] = [float(loss)]
    res["grads"]["GCN-2l/2x2"] = _step_grads(state)
    gcn.load_params(init)
    res["phase_b_s"] = time.perf_counter() - t0
    return res


def nccl_rank(ctx: RankContext, spec) -> dict:
    """Phase 13c on a world of one over NCCL: GCN-2l requests (bf16,
    float32) and one float32 step through ``make_dist_apply`` /
    ``make_sharded_train_step`` on the one-shard partition
    (``part_dir``), and one Flickr epoch of ``train_sampled_scan`` with
    ``mesh=world`` (the all-reduce captured) beside ``mesh=None``
    (``sampled``: its keyword arguments)."""
    from ..data.datasets import load_dataset
    dev = ctx.device
    part_h = load_partition(spec["part_dir"])
    sh = part_h.shard(0, dev)
    geo = dict(zip(("block_rows", "block_cols", "tile_edges"), spec["tile"]),
               device=dev)
    tg = PD.shard_tiling(part_h, 0, **geo)
    x = torch.as_tensor(PD.shard_rows(request_x(
        spec["seed"], spec["n_node"], spec["f_in"]), part_h, 0), device=dev)
    y = torch.as_tensor(PD.shard_rows(spec["labels"], part_h, 0), device=dev)
    mask = (torch.arange(part_h.n_local, device=dev) < spec["n_node"])
    gcn = _model(spec["models"]["GCN-2l"], dev)
    kw = dict(use_kernels=True, tiles=tg)
    SP.spmm_tiles.launches = 0
    res = {"answers": {}}
    with torch.inference_mode():
        for dtn, dt in (("bfloat16", torch.bfloat16), ("float32", None)):
            fwd = PD.make_dist_apply(gcn.layers, dist.group.WORLD, dt, **kw)
            res["answers"][dtn] = _np(fwd(dict(gcn.params), sh, x))
    state = TT.TrainState(gcn.params, TT.adamw(gcn.params, spec["lr"]))
    step = PD.make_sharded_train_step(gcn.layers, dist.group.WORLD, None,
                                      **kw)
    state, loss = step(state, sh, x, y, mask)
    res["loss"] = float(loss)
    res["grads"] = _step_grads(state)
    res["launches"] = SP.spmm_tiles.launches
    del x, sh, tg, gcn, state

    ds = load_dataset("flickr")
    res["sampled"] = {}
    for name, mesh in (("mesh", dist.group.WORLD), ("none", None)):
        t0 = time.perf_counter()
        _, fr, bd = TT.train_sampled_scan(ds, mesh=mesh, device=dev,
                                          **spec["sampled"])
        res["sampled"][name] = dict(
            train_loss=fr.train_loss, epoch_losses=bd["epoch_losses"],
            steps=bd["steps_per_epoch"], seconds=time.perf_counter() - t0)
    return res
