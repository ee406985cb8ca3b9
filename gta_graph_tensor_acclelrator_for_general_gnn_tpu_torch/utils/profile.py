"""Where the device time of one served request, or one training step,
goes.

Builds the slice of ``chip_smoke.py`` (GCN-2l and GAT-2l at the Reddit
widths on a 232,965-node synthetic community graph), serves three warm-up
bf16 requests per model, then traces one more with ``torch.profiler``;
with ``--train`` it also splits the transposed graph, takes one warm-up
bf16 AdamW step per model (``models/train.make_train_step``, full batch)
and traces the next.  For each it prints:

- the host wall time, synchronised before and after;
- the device's busy time: the union of the trace's kernel, memcpy and
  memset intervals, so that overlapping work counts once (summing
  ``key_averages()`` rows would count an operator and its kernels twice);
- the idle share, 1 - busy / wall;
- device time and call count per kernel name.

Needs one CUDA device::

    python -m gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils.profile [--train]

Chrome traces go to ``build/profile/`` at the repository root (or
``--out``).
"""
from __future__ import annotations

import argparse
import collections
import json
import time
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

N_NODE, N_EDGE = 232_965, 11_461_589     # the smoke's graph
F_IN, HIDDEN, N_CLASS, HEADS = 602, 128, 41, 4
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
OUT_DIR = Path(__file__).resolve().parents[2] / "build" / "profile"


def busy_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    busy, cur = 0.0, None
    for a, b in sorted(intervals):
        if cur is None or a > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy


def device_events(trace: Dict) -> List[Dict]:
    """The device-side events of a chrome trace (kernels, copies, sets)."""
    return [e for e in trace["traceEvents"]
            if e.get("cat") in DEVICE_CATS and "dur" in e]


def summarize(events: List[Dict], wall_ms: float) -> Dict:
    """Busy time, idle share and per-name device time (ms) of ``events``
    over a request of ``wall_ms`` host wall time."""
    busy = busy_us((e["ts"], e["ts"] + e["dur"]) for e in events) / 1e3
    by = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        by[e["name"]][0] += e["dur"] / 1e3
        by[e["name"]][1] += 1
    return dict(wall_ms=wall_ms, busy_ms=busy,
                idle_share=1.0 - busy / wall_ms if wall_ms > 0 else 0.0,
                by_name=sorted(((n, t, c) for n, (t, c) in by.items()),
                               key=lambda r: -r[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=OUT_DIR)
    ap.add_argument("--train", action="store_true",
                    help="also trace one bf16 training step per model")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile: needs a CUDA device")
    from .. import graph as G
    from ..compiler.fusion import hybrid_schedules
    from ..data.datasets import synthetic_coo
    from ..models import train as TT
    from ..models.zoo import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    s, r, labels = synthetic_coo(N_NODE, N_EDGE, seed=1,
                                 communities=1000, p_in=0.7)
    hg = G.build_host_graph(s, r, N_NODE, add_self_loops=True,
                            symmetric_norm=True)
    hg, _ = G.reorder_nodes(hg, "hubs+labels", labels=labels)
    g = hg.to_device(dev)
    x = torch.tensor(np.random.default_rng(0).standard_normal(
        (N_NODE, F_IN), dtype=np.float32), device=dev)
    gen = torch.Generator().manual_seed(0)
    args.out.mkdir(parents=True, exist_ok=True)
    print(f"device {torch.cuda.get_device_name(0)}; graph N={hg.n_node} "
          f"E={hg.n_edge}", flush=True)
    # learnable labels for the training step: a linear probe of x
    wy = torch.tensor(np.random.default_rng(1).standard_normal(
        (F_IN, N_CLASS), dtype=np.float32), device=dev)
    y = (x @ wy).argmax(dim=1)
    mask = torch.ones(hg.n_node, dtype=torch.bool, device=dev)
    for net in ("GCN", "GAT"):
        model = build_model(net, F_IN, N_CLASS, hidden=HIDDEN, n_layers=2,
                            reorder=net == "GCN", heads=HEADS,
                            generator=gen, device=dev)
        fwd = model.make_apply(torch.bfloat16,
                               schedules=hybrid_schedules(model.layers),
                               host_graph=hg, device=dev,
                               build_transpose=args.train)
        params = dict(model.params)
        with torch.inference_mode():
            for _ in range(3):
                fwd(params, g, x)
            _trace(f"{net}-2l bf16 request", args.out / f"trace_{net}.json",
                   lambda: fwd(params, g, x), dev)
        if args.train:
            state = TT.TrainState(model.params,
                                  TT.adamw(model.params, 1e-2))
            step = TT.make_train_step(fwd)
            step(state, g, x, y, mask)
            _trace(f"{net}-2l bf16 training step",
                   args.out / f"trace_{net}_train.json",
                   lambda: step(state, g, x, y, mask), dev)
    return 0


def _trace(what: str, path: Path, fn, dev) -> None:
    """Trace one synchronised call of ``fn`` and print its summary."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(str(path))
    events = device_events(json.loads(path.read_text()))
    if not events:
        raise RuntimeError("the trace holds no device events")
    st = summarize(events, wall)
    print(f"{what}: wall {st['wall_ms']:.3f} ms (profiled), device busy "
          f"{st['busy_ms']:.3f} ms, idle share {st['idle_share']:.3f}",
          flush=True)
    for name, t, c in st["by_name"][:16]:
        print(f"  {t:9.3f} ms  {c:3d}x  {name[:90]}", flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
