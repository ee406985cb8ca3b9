"""Where the device time of one served request, or one training step,
goes; and the per-op cost reports of the JAX package's ``utils/profile``.

The library half, under the JAX package's names:

- :func:`op_report` / :func:`schedule_report`: analytic per-op FLOPs and
  device-memory bytes of one forward under a fusion partition (MM 2 rows
  in out, gather n_edge w, elementwise rows w; bytes only for values that
  leave their block), the same accounting and the same text as JAX's;
- :func:`trace`: a ``torch.profiler`` capture around a block (CPU activity
  always, CUDA activity where a card is present), written as a Chrome
  trace into ``outdir``; it runs on the CPU too, since a trace is not a
  device metric;
- :func:`trace_events` / :func:`measured_report`: the trace's complete
  (``"ph": "X"``) events summed by name into count and total
  microseconds, heaviest first, from every ``.json`` and ``.json.gz``
  under ``outdir``.

The script half (``main``) builds the slice of ``chip_smoke.py`` (GCN-2l
and GAT-2l at the Reddit
widths on a 232,965-node synthetic community graph), serves three warm-up
bf16 requests per model, then traces one more with ``torch.profiler``;
with ``--train`` it also splits the transposed graph, takes one warm-up
bf16 AdamW step per model (``models/train.make_train_step``, full batch)
and traces the next.  ``--grouped`` instead builds the port bench's two
Reddit recipes (``bench.spmm_recipe``, ``bench.gat_recipe``: int8 dense
blocks plus a grouped tail) on the same graph and traces one request of
each after three warm-up requests.  ``--pair`` traces one bf16 request of
DGN-2l and PNA-2l with their pair chains on K13
(``fusion.pair_agg_schedules``) and of GAT-2l with its logit blocks on
K11 (``fusion.sddmm_schedules``), the rest op by op.  ``--layer`` traces
one bf16 request of GAT-2l with every layer on the ``gat_layer`` kind (the
whole layer on K14, 512x1024x512 ``onehot`` tiles,
``fusion.gat_onehot_schedules``).  For each it prints (:func:`trace_call`):

- the host wall time, synchronised before and after;
- the device's busy time: the union of the trace's kernel, memcpy and
  memset intervals, so that overlapping work counts once (summing
  ``key_averages()`` rows would count an operator and its kernels twice);
- the idle share, 1 - busy / wall;
- device time and call count per kernel name.

``--report`` instead prints, per model, the measured report of one traced
bf16 request (:func:`measured_report`) and the analytic report of each
layer's schedule with that request's time (:func:`schedule_report`).

Needs one CUDA device::

    python -m gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils.profile [--train | --grouped | --pair | --layer | --report]

Chrome traces go to ``build/profile/`` at the repository root (or
``--out``).
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gzip
import json
import os
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import ir
from ..compiler import schedule as S
from . import spans

N_NODE, N_EDGE = 232_965, 11_461_589     # the smoke's graph
F_IN, HIDDEN, N_CLASS, HEADS = 602, 128, 41, 4
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
OUT_DIR = Path(__file__).resolve().parents[2] / "build" / "profile"
TRACE_DIR = str(OUT_DIR / "trace")


# ---------------------------------------------------------------------------
# analytic per-op costs (the JAX package's op_report / schedule_report)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class OpCost:
    op_id: int
    kind: str
    compute: str
    rows: int
    width: int
    flops: int
    hbm_bytes: int
    fused: bool          # True if the value never leaves its block


def op_report(
    graph: ir.OpGraph,
    blocks: Sequence[Sequence[int]],
    stats: S.GraphStats,
    dtype_bytes: int = 4,
) -> List[OpCost]:
    """Per-op FLOPs and device-memory bytes under a fusion partition: an
    MM counts 2 rows in out, a gather n_edge w, an elementwise op rows w;
    a value that leaves its block (or is an output) is written once and
    read by each consuming block, one that stays counts no bytes."""
    block_of = {o: i for i, b in enumerate(blocks) for o in b}
    consumers: Dict[int, set] = {}
    for u, v in graph.edges():
        if block_of[u] != block_of[v]:
            consumers.setdefault(u, set()).add(block_of[v])

    out = []
    for oid in graph.topo_order():
        op = graph.by_id[oid]
        rows = stats.n_node if op.out_domain == ir.NODE else stats.e_pad
        w = max(op.out_width, 1)
        if op.compute == ir.MM:
            _, iw, ow = op.extra["weight"]
            in_rows = stats.n_node if op.in_domain == ir.NODE else stats.e_pad
            flops = 2 * in_rows * iw * ow
        elif op.kind == ir.GATHER:
            flops = stats.n_edge * w
        elif op.compute in (ir.ADD, ir.MUL, ir.SUB, ir.DIV, ir.SF):
            flops = rows * w
        else:
            flops = 0
        outside = consumers.get(oid, set())
        materialised = bool(outside) or oid in graph.outputs
        hbm = rows * w * dtype_bytes * (1 + len(outside)) if materialised else 0
        out.append(OpCost(oid, op.kind, op.compute, rows, w, flops, hbm,
                          fused=not materialised))
    return out


def schedule_report(
    graph: ir.OpGraph,
    sched: S.Schedule,
    stats: S.GraphStats,
    measured_s: Optional[float] = None,
    dtype_bytes: int = 4,
) -> str:
    """The cost table of one forward under ``sched``: per op its rows,
    width, MFLOP and KB of device memory (``*``: fused, no bytes), the
    totals (``S.traffic_bytes``), and with ``measured_s`` the rates they
    imply.  The same text as the JAX package's for the same inputs."""
    costs = op_report(graph, sched.blocks, stats, dtype_bytes)
    total_f = sum(c.flops for c in costs)
    total_b = S.traffic_bytes(graph, sched.blocks, stats, dtype_bytes)
    lines = [f"schedule report: {graph.name}  blocks={len(sched.blocks)}",
             f"{'op':>4} {'kind':<11} {'comp':<5} {'rows':>9} {'w':>5} "
             f"{'MFLOP':>9} {'KB-hbm':>9}  fused"]
    for c in costs:
        lines.append(f"{c.op_id:>4} {c.kind:<11} {c.compute:<5} {c.rows:>9} "
                     f"{c.width:>5} {c.flops/1e6:>9.2f} {c.hbm_bytes/1024:>9.1f}"
                     f"  {'*' if c.fused else ''}")
    lines.append(f"total: {total_f/1e9:.3f} GFLOP, {total_b/2**20:.2f} MiB HBM "
                 f"(modelled)")
    if measured_s:
        lines.append(
            f"measured: {measured_s*1e6:.1f} us -> "
            f"{total_f/measured_s/1e12:.2f} TFLOP/s, "
            f"{total_b/measured_s/2**30:.1f} GiB/s effective")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# measured per-op times from a profiler trace
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def trace(outdir: str = TRACE_DIR):
    """Capture a ``torch.profiler`` trace around the block: ``with
    trace('dir'): fn(...)``.  CPU activity always, CUDA activity when a
    CUDA device is present (the card is synchronised before the capture
    stops); the Chrome trace lands in ``outdir`` as
    ``trace_<pid>_<ns>.json``.  The port's spans (``utils/spans``) are
    recorded for the block, so they land in the trace as
    ``user_annotation`` events.  Yields ``outdir``."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    Path(outdir).mkdir(parents=True, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    try:
        with spans.recording():
            yield outdir
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            outdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@dataclasses.dataclass
class MeasuredOp:
    name: str
    count: int
    total_us: float


def _trace_files(outdir: str) -> List[Path]:
    root = Path(outdir)
    return sorted(p for p in root.rglob("*")
                  if p.is_file() and p.name.endswith((".json", ".json.gz")))


def trace_events(outdir: str) -> List[MeasuredOp]:
    """Per-name measured time from the Chrome traces under ``outdir``
    (every ``.json`` and ``.json.gz``, recursively): complete (``"ph":
    "X"``) events summed by name into count and total microseconds,
    heaviest first (ties in the order first seen)."""
    agg: Dict[str, List[float]] = {}
    for p in _trace_files(outdir):
        opener = gzip.open if p.name.endswith(".gz") else open
        with opener(p, "rt") as f:
            data = json.load(f)
        for ev in data.get("traceEvents", []):
            if ev.get("ph") != "X":
                continue
            name = ev.get("name", "?")
            agg.setdefault(name, [0, 0.0])
            agg[name][0] += 1
            agg[name][1] += float(ev.get("dur", 0.0))
    out = [MeasuredOp(k, int(v[0]), v[1]) for k, v in agg.items()]
    out.sort(key=lambda m: -m.total_us)
    return out


def measured_report(outdir: str, top: int = 25) -> str:
    """Text table of the ``top`` heaviest names of :func:`trace_events`."""
    evs = trace_events(outdir)
    lines = [f"measured trace report ({outdir}):",
             f"{'total_us':>12} {'count':>7}  name"]
    for m in evs[:top]:
        lines.append(f"{m.total_us:>12.1f} {m.count:>7}  {m.name[:80]}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# the script: one traced request or step at the smoke's size
# ---------------------------------------------------------------------------


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
    ap.add_argument("--grouped", action="store_true",
                    help="trace one request of each of the bench's Reddit "
                         "recipes (grouped tails) instead of the models")
    ap.add_argument("--pair", action="store_true",
                    help="trace DGN-2l and PNA-2l on the pair aggregate and "
                         "GAT-2l on the sddmm kind instead")
    ap.add_argument("--layer", action="store_true",
                    help="trace GAT-2l on the whole-layer kind instead")
    ap.add_argument("--report", action="store_true",
                    help="print the measured and the analytic report of "
                         "one bf16 request per model instead")
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
    if args.grouped:
        from .. import bench as B
        for name, build in (("SpMM", B.spmm_recipe), ("GAT", B.gat_recipe)):
            rc = build(hg, dev)
            print(f"{name} recipe: {rc.detail()}", flush=True)
            with torch.inference_mode():
                for _ in range(3):
                    rc.run()
                trace_call(f"bench {name} recipe bf16 request",
                           args.out / f"trace_bench_{name}.json", rc.run,
                           dev)
        return 0
    if args.layer:
        from ..compiler.fusion import gat_onehot_schedules
        model = build_model("GAT", F_IN, N_CLASS, hidden=HIDDEN, n_layers=2,
                            heads=HEADS, generator=gen, device=dev)
        fwd = model.make_apply(
            torch.bfloat16, schedules=gat_onehot_schedules(
                model.layers, whole_layer=True), host_graph=hg, device=dev)
        params = dict(model.params)
        with torch.inference_mode():
            for _ in range(3):
                fwd(params, g, x)
            trace_call("GAT-2l bf16 request (gat_layer kind)",
                       args.out / "trace_GAT_layer.json",
                       lambda: fwd(params, g, x), dev)
        return 0
    if args.pair:
        from ..compiler.fusion import pair_agg_schedules, sddmm_schedules
        for net, make in (("DGN", pair_agg_schedules),
                          ("PNA", pair_agg_schedules),
                          ("GAT", sddmm_schedules)):
            model = build_model(net, F_IN, N_CLASS, hidden=HIDDEN,
                                n_layers=2, heads=HEADS, generator=gen,
                                device=dev)
            fwd = model.make_apply(torch.bfloat16,
                                   schedules=make(model.layers),
                                   host_graph=hg, device=dev)
            params = dict(model.params)
            with torch.inference_mode():
                for _ in range(3):
                    fwd(params, g, x)
                trace_call(f"{net}-2l bf16 request ({make.__name__})",
                           args.out / f"trace_{net}_pair.json",
                           lambda: fwd(params, g, x), dev)
        return 0
    # learnable labels for the training step: a linear probe of x
    wy = torch.tensor(np.random.default_rng(1).standard_normal(
        (F_IN, N_CLASS), dtype=np.float32), device=dev)
    y = (x @ wy).argmax(dim=1)
    mask = torch.ones(hg.n_node, dtype=torch.bool, device=dev)
    for net in ("GCN", "GAT"):
        model = build_model(net, F_IN, N_CLASS, hidden=HIDDEN, n_layers=2,
                            reorder=net == "GCN", heads=HEADS,
                            generator=gen, device=dev)
        scheds = hybrid_schedules(model.layers)
        fwd = model.make_apply(torch.bfloat16, schedules=scheds,
                               host_graph=hg, device=dev,
                               build_transpose=args.train)
        params = dict(model.params)
        with torch.inference_mode():
            for _ in range(3):
                fwd(params, g, x)
            if args.report:
                print_reports(f"{net}-2l bf16 request", model.layers, scheds,
                              hg, lambda: fwd(params, g, x), dev,
                              args.out / f"report_{net}")
                continue
            trace_call(f"{net}-2l bf16 request",
                       args.out / f"trace_{net}.json",
                       lambda: fwd(params, g, x), dev)
        if args.train:
            state = TT.TrainState(model.params,
                                  TT.adamw(model.params, 1e-2))
            step = TT.make_train_step(fwd)
            step(state, g, x, y, mask)
            trace_call(f"{net}-2l bf16 training step",
                       args.out / f"trace_{net}_train.json",
                       lambda: step(state, g, x, y, mask), dev)
    return 0


def print_reports(what: str, layers, schedules, hg, fn, dev,
                  outdir: Path) -> None:
    """Print the measured report of one traced call of ``fn`` (a bf16
    request of the model whose layers run ``schedules`` on ``hg``) and
    each layer's analytic report (``dtype_bytes=2``) beside the request's
    median CUDA-event time."""
    import shutil

    from .benchmark import median_ms
    ms = median_ms(fn, device=dev, warmup=1, repeats=10)
    shutil.rmtree(outdir, ignore_errors=True)
    with trace(str(outdir)):
        fn()
    print(f"{what}: median {ms:.3f} ms\n{measured_report(str(outdir))}",
          flush=True)
    stats = S.GraphStats(hg.n_node, hg.n_edge, hg.e_pad)
    for li, (layer, sc) in enumerate(zip(layers, schedules)):
        print(f"layer {li} (the request's time):\n"
              f"{schedule_report(layer, sc, stats, ms / 1e3, 2)}", flush=True)


def trace_call(what: str, path: Path, fn, dev) -> None:
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
