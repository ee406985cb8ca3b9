"""Schedule autotuning with measured fitness on the card.

Counterpart of the JAX package's ``tune/search.py``: the same search space
(fusion partition x per-block tile config x kernel-vs-per-op dispatch), a
CSV memo that doubles as resume state, and the analytic traffic model as a
pruner before paying for a lowering and a measurement.  Three deliberate
differences from the JAX tuner:

- a candidate that fails to lower, build or launch fails the tune: JAX
  records such a candidate as infinitely slow (its "Mosaic rejection");
  here infeasible tiles are pruned before lowering by the shared-memory
  rule (``schedule.tile_is_feasible``, per kernel block at its own width),
  so a failure is a fault to see, not a cost;
- the memo key is ``v{KERNEL_VERSION}|{graph name}|{schedule key}`` with
  the port's own ``compiler.fusion.KERNEL_VERSION``;
- the default memo path is under ``build/tune/``, not the JAX package's
  ``results/``.
"""
from __future__ import annotations

import csv
import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

from .. import ir
from ..compiler import schedule as S
from ..compiler.fusion import KERNEL_VERSION, classify_block, lower_schedule
from ..graph import HostGraph
from ..utils.benchmark import time_layer_device

# the tile palette swept per kernel block: the JAX package's TILE_PALETTE
TILE_PALETTE = (
    S.TileConfig(256, 256, 512),
    S.TileConfig(512, 512, 256),
    S.TileConfig(512, 512, 512),
    S.TileConfig(512, 1024, 512),
    S.TileConfig(512, 1024, 768),
    S.TileConfig(1024, 512, 512),
    S.TileConfig(512, 512, 1024),
    S.TileConfig(1024, 1024, 1024),
    S.TileConfig(256, 256, 512, S.PATH_HYBRID),
    S.TileConfig(512, 512, 512, S.PATH_HYBRID),
    S.TileConfig(512, 512, 128, S.PATH_GROUPED),
    S.TileConfig(512, 512, 256, S.PATH_GROUPED),
    S.TileConfig(path=S.PATH_DENSEFULL),          # full dense A (medium N)
    S.TileConfig(1024, 1024, 512, S.PATH_HYBRID, dense_block=256),
    S.TileConfig(2048, 1024, 128, S.PATH_HYBRID, dense_block=256),
    S.TileConfig(2048, 2048, 128, S.PATH_HYBRID, dense_block=256),
    S.TileConfig(tile_edges=8, path=S.PATH_STREAM),     # 16k-edge chunks
    S.TileConfig(tile_edges=128, path=S.PATH_STREAM),   # 256k-edge chunks
)

DEFAULT_MEMO_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build", "tune")


@dataclasses.dataclass
class Measurement:
    schedule: S.Schedule
    latency_s: float
    traffic: int


@dataclasses.dataclass
class TuneResult:
    best: S.Schedule
    latency_s: float
    trials: List[Measurement]

    @property
    def pareto(self) -> List[Measurement]:
        """The measured (latency, modelled traffic) Pareto frontier, sorted
        by latency: every entry trades latency for less traffic."""
        front: List[Measurement] = []
        for m in sorted(self.trials, key=lambda m: (m.latency_s, m.traffic)):
            if not any(f.traffic <= m.traffic for f in front):
                front.append(m)
        return front

    def report(self) -> str:
        lines = [f"{len(self.trials)} schedules measured; best "
                 f"{self.latency_s*1e6:.1f}us"]
        for m in sorted(self.trials, key=lambda m: m.latency_s)[:10]:
            lines.append(f"  {m.latency_s*1e6:9.1f}us  traffic={m.traffic:>12}"
                         f"  {m.schedule.key()}")
        front = self.pareto
        if len(front) > 1:
            lines.append(f"pareto (latency vs modelled traffic), {len(front)} "
                         "points:")
            for m in front:
                lines.append(f"  {m.latency_s*1e6:9.1f}us  "
                             f"traffic={m.traffic:>12}  {m.schedule.key()}")
        return "\n".join(lines)


class Memo:
    """(memo key) -> seconds, a CSV file appended to as measurements come
    (the reference's check_csv_for_sample / save_sample_to_csv), so an
    interrupted tune resumes where it stopped."""

    def __init__(self, path: Optional[str]):
        self.path = path
        self.data: Dict[str, float] = {}
        if path and os.path.exists(path):
            with open(path) as f:
                for row in csv.reader(f):
                    if len(row) == 2:
                        self.data[row[0]] = float(row[1])

    def get(self, key: str) -> Optional[float]:
        return self.data.get(key)

    def put(self, key: str, latency: float) -> None:
        self.data[key] = latency
        if self.path:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(self.path, "a", newline="") as f:
                csv.writer(f).writerow([key, latency])


def _exec_signature(graph: ir.OpGraph, sched: S.Schedule) -> tuple:
    """What a schedule executes: its kernel-dispatched blocks with their
    kinds and tiles.  Per-op blocks run the same ops whatever the
    partition, so two schedules with one signature measure the same
    program."""
    sig = []
    for b, tc in zip(sched.blocks, sched.tiles):
        if not tc.kernel:
            continue
        kind, _ = classify_block(graph, b, tc)
        if kind != "xla":
            sig.append((kind, tuple(b), tc.key()))
    return tuple(sorted(sig))


def _candidate_schedules(graph: ir.OpGraph, max_partitions: int,
                         tile_palette: Sequence[S.TileConfig]
                         ) -> List[S.Schedule]:
    """Candidate pool, deduplicated by execution signature: per partition
    one all-per-op schedule plus its kernel-matchable blocks swept over the
    palette.  Partitions lead with the most fused (whole layer, attention
    chain, aggregations, pair aggregation, max fusion), then the
    enumerator's, as in the JAX package."""
    parts: List[Tuple[Tuple[int, ...], ...]] = []
    for fn in (S.layer_partition, S.pattern_partition,
               S.aggregation_partition, S.pair_agg_partition):
        p = fn(graph)
        if p is not None and p not in parts:
            parts.append(p)
    mf = S.max_fusion_partition(graph)
    if mf not in parts:
        parts.append(mf)
    try:
        for part in S.enumerate_partitions(graph, limit=max_partitions):
            if part not in parts:
                parts.append(part)
    except ValueError:
        if S.singleton_partition(graph) not in parts:
            parts.append(S.singleton_partition(graph))

    out: List[S.Schedule] = []
    seen = set()

    def add(sched: S.Schedule):
        sig = _exec_signature(graph, sched)
        if sig not in seen:
            seen.add(sig)
            out.append(sched)

    probe = S.TileConfig(256, 256, 512, S.PATH_ONEHOT)
    for part in parts:
        pattern_idx = [i for i, b in enumerate(part)
                       if classify_block(graph, b, probe)[0] != "xla"]
        base = tuple(S.TileConfig(path=S.PATH_XLA) for _ in part)
        add(S.Schedule(blocks=part, tiles=base))
        for tc in (tile_palette if pattern_idx else ()):
            tiles = list(base)
            for i in pattern_idx:
                tiles[i] = tc
            add(S.Schedule(blocks=part, tiles=tuple(tiles)))
    return out


def _block_width(graph: ir.OpGraph, kind: str, plan) -> Tuple[int, int]:
    """(feature width, heads) a kernel block's kernels run at: HD and the
    heads for attention, the aggregated width otherwise."""
    if kind == "gat_layer":
        return graph.width_of(plan.out_op), plan.heads
    if kind in ("gat", "gat_hybrid", "gat_stream"):
        return graph.width_of(plan.h_op), plan.heads
    if kind == "sddmm":
        return graph.width_of(plan.src_op), 1
    if kind == "pair_agg":
        return plan.width, 1
    return graph.width_of(plan.in_op), 1


def schedule_is_feasible(graph: ir.OpGraph, sched: S.Schedule,
                         dtype_bytes: int = 4) -> bool:
    """Every kernel block of ``sched`` passes ``schedule.tile_is_feasible``
    at its own kind, width and heads."""
    for b, tc in zip(sched.blocks, sched.tiles):
        if not tc.kernel:
            continue
        kind, plan = classify_block(graph, b, tc)
        if kind == "xla":
            continue
        width, heads = _block_width(graph, kind, plan)
        if not S.tile_is_feasible(tc, width, heads=heads,
                                  dtype_bytes=dtype_bytes, kind=kind):
            return False
    return True


def default_memo_path(network: str, dataset: str) -> str:
    return os.path.join(DEFAULT_MEMO_DIR, f"memo_{network}_{dataset}.csv")


def autotune(
    graph: ir.OpGraph,
    host_graph: HostGraph,
    params,
    g_dev,
    x,
    *,
    compute_dtype=None,
    memo_path: Optional[str] = None,
    max_partitions: int = 64,
    tile_palette: Optional[Sequence[S.TileConfig]] = None,
    traffic_prune: float = 4.0,
    iters: int = 30,
    verbose: bool = False,
    target_s: Optional[float] = 0.2,
    seed_schedules: Sequence[S.Schedule] = (),
    device=None,
) -> TuneResult:
    """Measure the candidate schedules of ``graph`` on ``device`` (default
    the CUDA card) and return the fastest.

    ``traffic_prune``: skip candidates whose modelled traffic exceeds that
    multiple of the least (seeds and the first, all-per-op candidate are
    never pruned).  ``seed_schedules`` are measured first, unconditionally
    (``cli tune --stack`` seeds each layer with the previous layer's best).
    ``target_s`` sizes each measurement's loop to about that many seconds
    (:func:`~..utils.benchmark.time_layer_device`); None runs ``iters``
    applications.  Measurements are memoised under the port's
    ``KERNEL_VERSION``; a candidate that fails to lower or run raises."""
    import torch
    if tile_palette is None:
        from ..hwconfig import load_hw_config
        tile_palette = load_hw_config().palette()
    stats = S.GraphStats(n_node=host_graph.n_node, n_edge=host_graph.n_edge,
                         e_pad=host_graph.e_pad)
    dtype_bytes = (torch.tensor([], dtype=compute_dtype).element_size()
                   if compute_dtype is not None else 4)
    memo = Memo(memo_path)
    cands = _candidate_schedules(graph, max_partitions, tile_palette)
    seeds = list(seed_schedules)
    cands = seeds + [c for c in cands if c not in seeds]
    traffics = [S.traffic_bytes(graph, c.blocks, stats) for c in cands]
    t_min = min(traffics)

    trials: List[Measurement] = []
    for i, (sched, traffic) in enumerate(zip(cands, traffics)):
        if i > len(seeds) and traffic > traffic_prune * t_min:
            continue
        if not schedule_is_feasible(graph, sched, dtype_bytes):
            continue
        key = f"v{KERNEL_VERSION}|{graph.name}|{sched.key()}"
        lat = memo.get(key)
        if lat is None:
            fn = lower_schedule(graph, sched, host_graph, compute_dtype,
                                device=device)
            lat = time_layer_device(fn, params, g_dev, x, iters=iters,
                                    target_s=target_s, device=device)
            memo.put(key, lat)
        trials.append(Measurement(sched, lat, traffic))
        if verbose:
            print(f"  {lat*1e6:9.1f}us  {sched.key()}", flush=True)
    best = min(trials, key=lambda m: m.latency_s)
    return TuneResult(best=best.schedule, latency_s=best.latency_s,
                      trials=trials)
