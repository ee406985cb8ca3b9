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
output go under ``build/tune/``.  ``--compiled``, ``tune --ga`` and
``bench`` are not ported yet and exit with status 2.
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


def _tune(args, ds, dtype, device) -> int:
    """``tune``: the JAX CLI's tune over ``tune/search.autotune``; with
    ``--stack`` per layer of the model, writing the schedule JSON."""
    import torch

    from .compiler.lower import init_params
    from .hwconfig import load_hw_config
    from .models.builders import build_op_graph
    from .models.zoo import build_model
    from .tune.search import autotune, default_memo_path

    hg = ds.host_graph
    g = hg.to_device(device)
    memo = args.memo or default_memo_path(args.network, args.dataset)
    dtype_bytes = 2 if dtype is not None else 4

    def tune_one(graph, in_w):
        params = init_params(graph, torch.Generator().manual_seed(args.seed),
                             device=device)
        x = torch.randn((hg.n_node, in_w),
                        generator=torch.Generator().manual_seed(1)).to(device)
        palette = (load_hw_config().derived_palette(in_w, dtype_bytes)
                   if args.derive_palette else None)
        return autotune(graph, hg, params, g, x, compute_dtype=dtype,
                        memo_path=memo, iters=args.iters,
                        target_s=args.target_s or None, tile_palette=palette,
                        verbose=not args.json, device=device)

    out = dict(dataset=args.dataset, network=args.network,
               synthetic_data=ds.synthetic,
               dtype="bfloat16" if args.bf16 else "float32",
               device=str(device), memo=memo)
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
        for li, graph in enumerate(model.layers):
            res = tune_one(graph, w)
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
                   choices=["none", "degree"],
                   help="relabel nodes degree-descending before execution")
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
                   help="schedule picked by the latency model (not ported)")
    p.add_argument("--ga", action="store_true",
                   help="tune: genetic search (not ported)")
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
                   help="tune: size each measurement's loop to about this "
                        "many seconds (0: --iters applications)")
    args = p.parse_args(argv)

    if args.command == "bench" or args.compiled or args.ga:
        what = ("--compiled" if args.compiled else "tune --ga" if args.ga
                else args.command)
        item = ("item 10 (compiler/latency.py)" if args.compiled
                else "item 10 (tune/genetic.py)" if args.ga else "item 6")
        print(f"gta-torch {what}: not yet ported (ROADMAP.md Queue 1 "
              f"{item})", file=sys.stderr)
        return 2
    if args.hw_config:
        os.environ["GTA_HW_CONFIG"] = args.hw_config

    import numpy as np
    import torch

    from .data.datasets import load_dataset
    from .graph import reorder_nodes
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
    if args.command == "tune":
        return _tune(args, ds, dtype, device)
    model = build_model(args.network, x_np.shape[1], ds.n_class,
                        hidden=args.hidden, n_layers=args.layers,
                        heads=args.heads, reorder=args.reorder,
                        generator=torch.Generator().manual_seed(args.seed),
                        device=device)
    sched = (load_schedules(args.schedule, args.layers)
             if args.schedule else None)
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
