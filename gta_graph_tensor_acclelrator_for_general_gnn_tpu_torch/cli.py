"""Command line of the PyTorch port.

``run`` serves one forward pass of a model over a dataset and reports its
output and, on a CUDA device, its latency from CUDA events:

    python -m gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.cli run \\
        --dataset cora --network GAT --schedule sched.json --device cuda

``--schedule`` reads the schedule JSON of the JAX package's CLI (one
schedule, or ``{"layers": [...]}`` per layer).  ``train``, ``tune`` and
``bench`` are not ported yet and exit with status 2.
"""
from __future__ import annotations

import argparse
import json
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
    args = p.parse_args(argv)

    if args.command != "run":
        print(f"gta-torch {args.command}: not yet ported (ROADMAP.md "
              "Queue 1)", file=sys.stderr)
        return 2

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
    hg, x_np = ds.host_graph, ds.x
    if args.node_reorder != "none":
        hg, perm = reorder_nodes(hg, args.node_reorder)
        x_np = x_np[perm]
    model = build_model(args.network, x_np.shape[1], ds.n_class,
                        hidden=args.hidden, n_layers=args.layers,
                        heads=args.heads, reorder=args.reorder,
                        generator=torch.Generator().manual_seed(args.seed),
                        device=device)
    sched = (load_schedules(args.schedule, args.layers)
             if args.schedule else None)
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
    if args.json:
        print(json.dumps(out))
    else:
        for k, v in out.items():
            print(f"{k}: {v}")
    return 0 if out["finite"] else 1


if __name__ == "__main__":
    sys.exit(main())
