"""Command line of the PyTorch port.

``run`` serves one forward pass of a model over a dataset and reports its
output and, on a CUDA device, its latency from CUDA events; ``train``
trains it full-batch and reports the JAX CLI's keys (loss, accuracies and,
on a CUDA device, the epoch time from CUDA events); ``tune`` measures the
candidate schedules of a layer (``tune/search.autotune``) and with
``--stack`` tunes each layer of the model and writes the per-layer
schedule JSON that ``run`` and ``train`` read:

    python -m gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.cli tune \\
        --dataset cora --network GAT --stack --schedule sched.json
    python -m gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.cli run \\
        --dataset cora --network GAT --schedule sched.json --device cuda
    python -m gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.cli train \\
        --dataset cora --network GAT --schedule sched.json --device cuda

``--schedule`` reads the schedule JSON of the JAX package's CLI (one
schedule, or ``{"layers": [...]}`` per layer).  With a schedule, ``train``
also splits the transposed graph so that gradients run on the kernels; the
JAX CLI does that only with ``--compiled``.  ``tune``'s memo and default
output go under ``build/tune/``.

``bench`` times the edge-tile SpMM (K1) and SDDMM (K11) over the dataset's
graph, ``--batch`` copies of it block-diagonally (the serving shape), and
prints their latency, edges per second and each kernel's bound
(``utils/roofline``) as a share of its time:

    python -m gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.cli bench \
        --dataset cora --batch 64 --json [--tile-classes auto] \
        [--sparse-block 256]

Its default geometry is the argmin of ``graph.tile_time_model_ns`` over
four block geometries, each at its ``best_tile_capacity``;
``--tile-classes`` tiles with capacity classes (a list, or ``auto``: 128,
256, 512, 1024) at ``--sparse-block`` (default 256).  A CPU run
(``--device cpu``) times with the host clock and prints only that.

``--compiled`` (``run`` and ``train``, without ``--schedule``) picks each
layer's schedule without measuring: the argmin of the latency model
(``compiler/latency.min_latency_schedule``, constants fitted on the card);
``run`` also reports the modelled time (``modelled_us``) and ``train``
splits the transposed graph as with ``--schedule``.  ``tune --ga`` searches
with the genetic tuner (``tune/genetic.GeneticTuner``) in place of the
enumeration:

    python -m gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.cli run \
        --dataset cora --network GAT --compiled --device cuda
    python -m gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.cli tune \
        --dataset cora --network GAT --ga --stack --target-s 0.01
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def _parse_tile(t):
    """A TileConfig from its key list: [rows, cols, edges, path] plus an
    optional "d<dense_block>" entry."""
    from .compiler.schedule import TileConfig
    dense = 0
    if len(t) > 4:
        dense = int(str(t[4]).lstrip("d"))
    return TileConfig(int(t[0]), int(t[1]), int(t[2]), str(t[3]),
                      dense_block=dense)


def load_schedules(path, n_layers):
    """Per-layer schedules from a schedule JSON file."""
    from .compiler.schedule import Schedule

    def one(spec):
        return Schedule(blocks=tuple(tuple(b) for b in spec["blocks"]),
                        tiles=tuple(_parse_tile(t) for t in spec["tiles"]))

    with open(path) as f:
        spec = json.load(f)
    if "layers" in spec:
        return [one(sp) for sp in spec["layers"]]
    return [one(spec)] * n_layers


def compiled_schedules(model, hg, dtype_bytes: int):
    """(per-layer schedules, modelled ns of the stack): each layer's
    compile-only pick at its own input width, over one cost oracle of
    ``hg``."""
    from .compiler.latency import GraphCost, min_latency_schedule
    cost = GraphCost(hg)
    sched, total = [], 0.0
    for graph in model.layers:
        sc, t_ns = min_latency_schedule(graph, hg, dtype_bytes=dtype_bytes,
                                        cost=cost)
        sched.append(sc)
        total += t_ns
    return sched, total


def _print(out, as_json: bool) -> None:
    if as_json:
        print(json.dumps(out))
    else:
        for k, v in out.items():
            print(f"{k}: {v}")


def _train(args, ds, model, sched, dtype, device) -> int:
    """``train``: full-batch training, the JAX CLI's output keys."""
    import math

    import torch

    from .models.train import train_node_classifier
    state, res = train_node_classifier(
        ds, args.network, epochs=args.epochs, lr=args.lr,
        compute_dtype=dtype, seed=args.seed, model=model, schedules=sched,
        build_transpose=sched is not None, device=device)
    out = dict(dataset=args.dataset, network=args.network,
               synthetic_data=ds.synthetic, node_reorder=args.node_reorder,
               dtype="bfloat16" if args.bf16 else "float32",
               device=str(device))
    if sched:
        out["schedule"] = [s.key() for s in sched]
    if args.ckpt:
        from .utils.checkpoint import save_state
        out["ckpt_step"] = save_state(args.ckpt, state)
    out.update(train_loss=res.train_loss, train_acc=res.train_acc,
               val_acc=res.val_acc, test_acc=res.test_acc,
               epoch_time_s=res.epoch_time_s, edges_per_s=res.edges_per_s)
    if device.type == "cuda":
        out["device_name"] = torch.cuda.get_device_name(device)
    _print(out, args.json)
    return 0 if math.isfinite(res.train_loss) else 1


def _train_multihost(args, ds, dtype) -> int:
    """``train --multihost``: :func:`~.parallel.multihost.train_multihost`
    on this rank, the JAX CLI's output keys."""
    import math

    import torch.distributed as dist

    from .parallel.multihost import train_multihost
    loss, losses = train_multihost(
        ds, args.network, hidden=args.hidden, n_layers=args.layers,
        heads=args.heads, epochs=args.epochs, lr=args.lr,
        compute_dtype=dtype, seed=args.seed, verbose=not args.json,
        device="cpu" if args.device == "cpu" else None)
    out = dict(dataset=args.dataset, network=args.network,
               synthetic_data=ds.synthetic, node_reorder=args.node_reorder,
               train_loss=loss, epoch_losses=losses, multihost=True,
               processes=dist.get_world_size() if dist.is_initialized()
               else 1)
    _print(out, args.json)
    return 0 if math.isfinite(loss) else 1


def _tune(args, ds, dtype, device) -> int:
    """``tune``: the JAX CLI's tune over ``tune/search.autotune``; with
    ``--stack`` per layer of the model, writing the schedule JSON."""
    import torch

    from .compiler.lower import init_params
    from .hwconfig import load_hw_config
    from .models.builders import build_op_graph
    from .models.zoo import build_model
    from .tune.genetic import GeneticTuner
    from .tune.search import autotune, default_memo_path

    hg = ds.host_graph
    g = hg.to_device(device)
    memo = args.memo or default_memo_path(args.network, args.dataset)
    dtype_bytes = 2 if dtype is not None else 4

    def tune_one(graph, in_w, warm=()):
        params = init_params(graph, torch.Generator().manual_seed(args.seed),
                             device=device)
        x = torch.randn((hg.n_node, in_w),
                        generator=torch.Generator().manual_seed(1)).to(device)
        if args.ga:
            tuner = GeneticTuner(graph, hg, compute_dtype=dtype,
                                 memo_path=memo, iters=args.iters,
                                 warm_start=warm,
                                 derive_palette=args.derive_palette,
                                 target_s=args.target_s or None,
                                 seed=args.seed, device=device)
            return tuner.search(params, g, x, verbose=not args.json)
        palette = (load_hw_config().derived_palette(in_w, dtype_bytes)
                   if args.derive_palette else None)
        return autotune(graph, hg, params, g, x, compute_dtype=dtype,
                        memo_path=memo, iters=args.iters,
                        target_s=args.target_s or None, tile_palette=palette,
                        verbose=not args.json, device=device)

    out = dict(dataset=args.dataset, network=args.network,
               synthetic_data=ds.synthetic,
               dtype="bfloat16" if args.bf16 else "float32",
               device=str(device), memo=memo,
               search="genetic" if args.ga else "enumerative")
    if device.type == "cuda":
        out["device_name"] = torch.cuda.get_device_name(device)
    if args.stack:
        model = build_model(args.network, ds.x.shape[1], ds.n_class,
                            hidden=args.hidden, n_layers=args.layers,
                            heads=args.heads, reorder=args.reorder,
                            generator=torch.Generator().manual_seed(args.seed),
                            device=device)
        specs, total = [], 0.0
        w = ds.x.shape[1]
        prev = ()        # the genetic tuner starts from the last layer's best
        for li, graph in enumerate(model.layers):
            res = tune_one(graph, w, warm=prev)
            prev = (res.best,)
            total += res.latency_s
            specs.append(dict(blocks=[list(b) for b in res.best.blocks],
                              tiles=[list(t.key()) for t in res.best.tiles],
                              latency_us=res.latency_s * 1e6))
            w = max(op.out_width for op in graph.ops
                    if op.op_id in graph.outputs)
            if not args.json:
                print(f"layer {li}: {res.latency_s*1e6:.1f}us "
                      f"{res.best.key()}", flush=True)
        path = args.schedule or os.path.join(
            os.path.dirname(memo),
            f"best_{args.network}_{args.dataset}_stack.json")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({"layers": specs}, f)
        out.update(stack_latency_us=total * 1e6, schedule_path=path,
                   schedules=[sp["tiles"] for sp in specs])
    else:
        graph = build_op_graph(args.network, args.hidden, args.hidden,
                               heads=args.heads, reorder=args.reorder,
                               layer_tag="tune")
        res = tune_one(graph, args.hidden)
        out.update(best_latency_us=res.latency_s * 1e6,
                   best_schedule=res.best.key(), n_trials=len(res.trials),
                   pareto=[dict(latency_us=m.latency_s * 1e6,
                                traffic_bytes=m.traffic,
                                schedule=m.schedule.key())
                           for m in res.pareto])
        if not args.json:
            print(res.report())
    _print(out, args.json)
    return 0


# ``bench``'s candidate geometries (block rows, block cols), the JAX CLI's
BENCH_GEOMETRIES = ((256, 256), (512, 512), (1024, 512), (1024, 1024))
AUTO_CLASSES = (128, 256, 512, 1024)


def bench_tiling(hg, args, device):
    """(tiling, geometry keys) of ``bench``: capacity classes, one fixed
    block size, or the modelled argmin geometry (the JAX CLI's pick)."""
    from .graph import (best_tile_capacity, run_nnz_hist, tile_graph,
                        tile_graph_classes, tile_time_model_ns)
    if args.tile_classes:
        sb = args.sparse_block or 256
        classes = (AUTO_CLASSES if args.tile_classes == "auto" else
                   tuple(int(c) for c in args.tile_classes.split(",")))
        return (tile_graph_classes(hg, block_rows=sb, block_cols=sb,
                                   tile_classes=classes, device=device),
                dict(tile_classes=list(classes), sparse_block=sb))
    if args.sparse_block:
        sb = args.sparse_block
        return (tile_graph(hg, block_rows=sb, block_cols=sb, device=device),
                dict(sparse_block=sb))
    best = None
    for tr, tc in BENCH_GEOMETRIES:
        nnz = run_nnz_hist(hg, tr, tc)
        if not len(nnz):
            best = (0.0, 256, 256, 512)
            break
        et = best_tile_capacity(nnz, tr, tc, feat_width=args.hidden)
        t = tile_time_model_ns(nnz, et, tr, tc, feat_width=args.hidden)
        if best is None or t < best[0]:
            best = (t, tr, tc, et)
    _, tr, tc, et = best
    return (tile_graph(hg, block_rows=tr, block_cols=tc, tile_edges=et,
                       device=device),
            dict(sparse_block=[tr, tc], tile_edges=et))


def _bench(args, ds, device) -> int:
    """``bench``: K1's SpMM and K11's one-head SDDMM over the (batched)
    dataset graph, each timed by ``utils/benchmark.time_layer_device``;
    on the card also edges per second and the bound's share of the time."""
    import math

    import torch

    from .ops import sddmm as sddmm_mod
    from .ops import spmm as spmm_mod
    from .utils import roofline
    from .utils.benchmark import time_layer_device

    hg = ds.host_graph
    out = dict(dataset=args.dataset, device=str(device),
               dtype="bfloat16" if args.bf16 else "float32")
    if args.batch > 1:
        from .data.batching import batch_graphs
        hg, _ = batch_graphs([hg] * args.batch)
        out["batch"] = args.batch
    tg, geo = bench_tiling(hg, args, device)
    out.update(geo)
    slots = sum(p.n_tiles * p.tile_edges for p in spmm_mod.parts_of(tg))
    out.update(n_node=hg.n_node, n_edge=hg.n_edge, slots=slots,
               fill=hg.n_edge / max(slots, 1))
    x = torch.randn((hg.n_node, args.hidden),
                    generator=torch.Generator().manual_seed(1)).to(
        device, torch.bfloat16 if args.bf16 else torch.float32)
    cuda = device.type == "cuda"
    kw = dict(iters=args.iters, target_s=args.target_s or None)
    with torch.inference_mode():
        finite = bool(torch.isfinite(spmm_mod.spmm(tg, x)).all())
    calls = (
        ("spmm", lambda p, t, v: spmm_mod.spmm(t, v),
         lambda: roofline.spmm_tail(
             tg, x, max(p.weight.element_size()
                        for p in spmm_mod.parts_of(tg)))),
        ("sddmm", lambda p, t, v: sddmm_mod.sddmm(t, v, v, heads=1),
         lambda: roofline.sddmm_tail(tg, x, x, 1)))
    for name, fn, work in calls:
        sec = time_layer_device(fn, None, tg, x, device=device, **kw)
        if not cuda:
            out[f"{name}_host_us"] = sec * 1e6
            continue
        w = work()
        out.update({f"{name}_latency_us": sec * 1e6,
                    f"{name}_edges_per_s": hg.n_edge / sec,
                    f"{name}_bound_us": w.bound_ms * 1e3,
                    f"{name}_bound_by": w.bound_by,
                    f"{name}_bound_share": w.bound_ms / 1e3 / sec})
    out["finite"] = finite
    if cuda:
        out["device_name"] = torch.cuda.get_device_name(device)
    _print(out, args.json)
    times = [v for k, v in out.items() if k.endswith("_us")]
    return 0 if finite and all(math.isfinite(t) for t in times) else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="gta-torch",
        description="GTA graph tensor accelerator, PyTorch/CUDA port")
    p.add_argument("command", choices=["run", "train", "tune", "bench"])
    p.add_argument("--dataset", default="cora")
    p.add_argument("--network", default="GAT")
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--reorder", action="store_true",
                   help="use the algebraically reordered (trans) op graph")
    p.add_argument("--node-reorder", default="none",
                   choices=["none", "degree", "cluster"],
                   help="relabel nodes to densify adjacency blocks before "
                        "execution (cluster = label-propagation communities, "
                        "the label-free preprocessing real graphs need for "
                        "the hybrid density-split path)")
    p.add_argument("--schedule", default=None,
                   help="schedule JSON to execute with (the JAX CLI's "
                        "format); default: every op on the per-op path")
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--f32", dest="bf16", action="store_false")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--iters", type=int, default=20,
                   help="timed forward passes (CUDA devices only)")
    p.add_argument("--json", action="store_true",
                   help="print one JSON object instead of text")
    p.add_argument("--device", default="cuda")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--ckpt", default=None,
                   help="checkpoint dir: train saves its final state here")
    p.add_argument("--compiled", action="store_true",
                   help="run/train without --schedule: each layer's "
                        "schedule picked by the latency model "
                        "(compiler/latency.py), without measuring")
    p.add_argument("--ga", action="store_true",
                   help="tune: genetic search (tune/genetic.py)")
    p.add_argument("--stack", action="store_true",
                   help="tune each layer of the model stack and write the "
                        "per-layer schedule JSON (--schedule path) that "
                        "run and train --schedule read")
    p.add_argument("--memo", default=None,
                   help="tune: memo CSV (default build/tune/memo_*.csv)")
    p.add_argument("--hw-config", default=None,
                   help="hardware config JSON (shared-memory budget, tile "
                        "palette); also via $GTA_HW_CONFIG")
    p.add_argument("--derive-palette", action="store_true",
                   help="tune over the palette derived from the maximal "
                        "feasible tile at the layer's input width")
    p.add_argument("--target-s", type=float, default=0.2,
                   help="tune and bench: size each measurement's loop to "
                        "about this many seconds (0: --iters applications)")
    p.add_argument("--batch", type=int, default=1,
                   help="bench: this many copies of the dataset's graph, "
                        "block-diagonally (the serving shape)")
    p.add_argument("--tile-classes", default=None,
                   help="bench: tile capacity classes, a comma list (e.g. "
                        "64,128,512) or 'auto' (128,256,512,1024)")
    p.add_argument("--sparse-block", type=int, default=None,
                   help="bench: block rows and cols of the edge tiles "
                        "(default: the modelled geometry; 256 with "
                        "--tile-classes)")
    p.add_argument("--multihost", action="store_true",
                   help="join a torch.distributed process group and train "
                        "full-batch over the (nodes x cards) mesh; run one "
                        "process per card (parallel/multihost.py)")
    p.add_argument("--coordinator", default=None,
                   help="multihost rendezvous address host:port (default: "
                        "the env:// variables, as torchrun sets them)")
    p.add_argument("--nprocs", type=int, default=None,
                   help="multihost process count (with --coordinator)")
    p.add_argument("--procid", type=int, default=None,
                   help="this process's rank (with --coordinator)")
    args = p.parse_args(argv)

    if args.hw_config:
        os.environ["GTA_HW_CONFIG"] = args.hw_config
    if args.multihost:
        # before any device use: join (or start) the process group
        from .parallel.multihost import init_multihost
        backend = "gloo" if args.device == "cpu" else None
        pid, pcount = init_multihost(args.coordinator, args.nprocs,
                                     args.procid, backend=backend)
        print(f"multihost: process {pid}/{pcount}", flush=True)

    import numpy as np
    import torch

    from .data.datasets import load_dataset
    from .graph import reorder_nodes, resolve_device
    from .models.zoo import build_model

    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dtype = torch.bfloat16 if args.bf16 else None
    ds = load_dataset(args.dataset, seed=args.seed)
    if args.node_reorder != "none":
        hg, perm = reorder_nodes(ds.host_graph, args.node_reorder)
        ds = dataclasses.replace(
            ds, host_graph=hg, x=ds.x[perm], y=ds.y[perm],
            train_mask=ds.train_mask[perm], val_mask=ds.val_mask[perm],
            test_mask=ds.test_mask[perm])
    hg, x_np = ds.host_graph, ds.x
    if args.command == "train" and args.multihost:
        return _train_multihost(args, ds, dtype)
    if args.command == "bench":
        return _bench(args, ds, resolve_device(args.device))
    if args.command == "tune":
        return _tune(args, ds, dtype, device)
    model = build_model(args.network, x_np.shape[1], ds.n_class,
                        hidden=args.hidden, n_layers=args.layers,
                        heads=args.heads, reorder=args.reorder,
                        generator=torch.Generator().manual_seed(args.seed),
                        device=device)
    sched = (load_schedules(args.schedule, args.layers)
             if args.schedule else None)
    modelled_ns = None
    if sched is None and args.compiled:
        sched, modelled_ns = compiled_schedules(model, hg,
                                                2 if args.bf16 else 4)
    if args.command == "train":
        return _train(args, ds, model, sched, dtype, device)
    fwd = model.make_apply(dtype, schedules=sched,
                           host_graph=hg if sched else None, device=device)
    g = hg.to_device(device)
    x = torch.tensor(x_np, device=device)
    params = dict(model.params)
    with torch.inference_mode():
        y = fwd(params, g, x)
        out = dict(dataset=args.dataset, network=args.network,
                   synthetic_data=ds.synthetic, node_reorder=args.node_reorder,
                   dtype="bfloat16" if args.bf16 else "float32",
                   device=str(device), out_shape=list(y.shape),
                   finite=bool(torch.isfinite(y).all()))
        if sched:
            out["schedule"] = [s.key() for s in sched]
        if modelled_ns is not None:
            out["modelled_us"] = modelled_ns / 1e3
        if device.type == "cuda":
            from .utils.benchmark import cuda_time_ms
            times = cuda_time_ms(lambda: fwd(params, g, x), device=device,
                                 warmup=2, repeats=args.iters)
            out.update(device_name=torch.cuda.get_device_name(device),
                       latency_ms_median=float(np.median(times)),
                       latency_ms_min=float(np.min(times)),
                       edges_per_s=hg.n_edge * args.layers
                       / (float(np.median(times)) / 1e3))
    _print(out, args.json)
    return 0 if out["finite"] else 1


if __name__ == "__main__":
    sys.exit(main())
