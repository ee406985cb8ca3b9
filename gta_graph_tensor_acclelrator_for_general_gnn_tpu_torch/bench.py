"""The port's counterpart of the repository's root ``bench.py``: its three
JSON lines, under the same metric names and units, timed on the card with
CUDA events (``utils/benchmark.py``, median over repeats after warm-up).

- ``gat_cora_layer3_latency`` (us): one GAT layer at the reference's
  layer-3 shape (64 in, 16 heads of 1) on Cora, lowered with the tuned
  schedule ``results/best_gat_cora_l3.json`` (the ``gat`` kind on K3),
  bf16.
- ``reddit_spmm_throughput`` (Gedge/s): the root script's SpMM recipe
  (bench.py:158-183): 'rc' int8 256² dense blocks in supergroup-16 order
  with the symmetric-norm scales, plus a grouped 512²/ET128/G16 tail, F =
  128, bf16: K2 + K9.
- ``reddit_gat_throughput`` (Gedge/s): its GAT recipe (bench.py:224-251):
  'cr' int8 dense blocks at threshold 128 plus the grouped tail, H = 4,
  HD = 128, bf16, raw partials of both under one shift bound, then the
  normalisation: K4 + K10.

Both Reddit lines run on ``synthetic_coo(232965, E, seed=1,
communities=1000, p_in=0.7)`` with self loops, symmetric normalisation and
the hubs+labels reorder, as the root script builds it; E defaults to
Reddit's 114,615,892.  The host build of the graph and the splits is
set-up and is printed apart.  No line carries the root script's
``vs_baseline``: its baselines are a simulator's cycles (cora) and
records of its TPU runs (Reddit, bench.py:142, :215), not of this card.
On a device other than CUDA each function runs its work once and prints
``"value": null``: a CPU run gives no device time.

    python -m gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.bench [--edges N]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from . import graph as G
from .compiler.fusion import lower_schedule
from .compiler.lower import init_params
from .compiler.schedule import Schedule, TileConfig
from .data.datasets import load_dataset, synthetic_coo
from .models.builders import build_op_graph
from .ops import dense as D
from .ops.spmm import spmm
from .utils.benchmark import median_ms

REDDIT_NODES, REDDIT_EDGES = 232_965, 114_615_892
BEST_SCHEDULE = (Path(__file__).resolve().parents[1] / "results"
                 / "best_gat_cora_l3.json")
F_SPMM, HEADS, HD = 128, 4, 128


def _line(metric: str, unit: str, value: Optional[float],
          detail: str) -> Dict:
    out = dict(metric=metric, value=value, unit=unit, detail=detail)
    print(json.dumps(out), flush=True)
    return out


def _ms_text(ms: Optional[float]) -> str:
    return "not measured (no CUDA device)" if ms is None else f"{ms:.3f} ms"


def _time_ms(fn, dev: torch.device, repeats: int) -> Optional[float]:
    """Median CUDA-event time of ``fn()``; on another device one untimed
    call and None."""
    if dev.type != "cuda":
        fn()
        return None
    return median_ms(fn, device=dev, warmup=2, repeats=repeats)


def gat_cora_layer3_latency(device=None, repeats: int = 50) -> Dict:
    """One bf16 forward of the GAT-Cora layer-3 shape on the tuned
    schedule; microseconds."""
    dev = G.resolve_device(device)
    ds = load_dataset("cora")
    og = build_op_graph("GAT", 64, 16, heads=16, layer_tag="l3bench")
    params = init_params(og, torch.Generator().manual_seed(0), device=dev)
    spec = json.loads(BEST_SCHEDULE.read_text())
    sched = Schedule(blocks=tuple(tuple(b) for b in spec["blocks"]),
                     tiles=tuple(TileConfig(*t) for t in spec["tiles"]))
    fn = lower_schedule(og, sched, ds.host_graph, torch.bfloat16, device=dev)
    kinds = [k for k, _, _, _ in fn.plans if k != "xla"]
    g = ds.host_graph.to_device(dev)
    x = torch.randn((ds.host_graph.n_node, 64),
                    generator=torch.Generator().manual_seed(1)).to(dev)
    with torch.inference_mode():
        ms = _time_ms(lambda: fn(params, g, x), dev, repeats)
    hg = ds.host_graph
    return _line("gat_cora_layer3_latency", "us",
                 None if ms is None else ms * 1e3,
                 f"{_ms_text(ms)}: GAT 64->16, 16 heads, Cora "
                 f"N={hg.n_node} E={hg.n_edge}, bf16, kernel blocks {kinds}")


def reddit_graph(n_edge: int = REDDIT_EDGES,
                 n_node: int = REDDIT_NODES) -> G.HostGraph:
    """The root script's Reddit-dims synthetic community graph."""
    s, r, labels = synthetic_coo(n_node, n_edge, seed=1, communities=1000,
                                 p_in=0.7)
    hg = G.build_host_graph(s, r, n_node, add_self_loops=True,
                            symmetric_norm=True)
    return G.reorder_nodes(hg, "hubs+labels", labels=labels)[0]


@dataclasses.dataclass
class Recipe:
    """One of the root script's Reddit recipes, built: the density split,
    its inputs (made from a seed), ``run()`` (one request) and the host
    seconds the split took."""
    split: G.HybridGraph
    inputs: Dict[str, torch.Tensor]
    run: Callable[[], torch.Tensor]
    build_s: float

    def detail(self) -> str:
        t, d = self.split.tiles, self.split.dense
        tail = (f"grouped tail {self.split.n_sparse_edges} edges in "
                f"{t.n_chunks} chunks, {t.total_slots} slots"
                if isinstance(t, G.GroupedTiledGraph) else
                f"tail {self.split.n_sparse_edges} edges in {t.n_tiles} "
                "tiles")
        return (f"dense edges {self.split.n_dense_edges} in "
                f"{0 if d is None else d.n_blocks} blocks; {tail}; host "
                f"split {self.build_s:.1f} s")


def spmm_recipe(hg: G.HostGraph, device=None,
                tail_format: str = "grouped") -> Recipe:
    """The hybrid SpMM recipe (root bench.py:158-183): 'rc' int8 256²
    dense blocks in supergroup-16 order with the separable scales (K2) and
    the 512²/ET128/G16 grouped tail (K9); F = 128 bf16.  ``tail_format=
    "tiles"`` builds the same split with a per-tile tail (K1)."""
    dev = G.resolve_device(device)
    t0 = time.perf_counter()
    hyb = G.hybrid_graph(
        hg, block_rows=256, block_cols=256, tile_edges=128,
        min_nnz=D.spmm_dense_threshold(256, 256, fudge=0.5), supergroup=16,
        values_dtype=np.int8, sparse_block_rows=512, sparse_block_cols=512,
        tail_format=tail_format, tail_group=16, device=dev)
    build_s = time.perf_counter() - t0
    rs, cs = (torch.as_tensor(v, device=dev)
              for v in G.separable_weight_scales(hg))
    x = torch.randn((hg.n_node, F_SPMM),
                    generator=torch.Generator().manual_seed(0)).to(
                        dev, torch.bfloat16)

    def run():
        y = spmm(hyb.tiles, x)
        if hyb.dense is not None:
            y = y + D.spmm_dense(hyb.dense, x, row_scale=rs,
                                 col_scale=cs)[: y.shape[0]]
        return y

    return Recipe(hyb, dict(x=x), run, build_s)


def gat_recipe(hg: G.HostGraph, device=None,
               tail_format: str = "grouped") -> Recipe:
    """The hybrid GAT recipe (root bench.py:224-251): 'cr' int8 dense
    blocks at threshold 128 (K4) and the grouped tail (K10), given w_asrc:
    a_s = h @ w_asrc formed once for msrc and both partials, raw partials
    under one shift bound, then the normalisation; H = 4, HD = 128, bf16.
    ``tail_format="tiles"``: a per-tile tail (K3)."""
    dev = G.resolve_device(device)
    t0 = time.perf_counter()
    hyb = G.hybrid_graph(
        hg, block_rows=256, block_cols=256, tile_edges=128, min_nnz=128,
        unit_weight=True, block_layout="cr", values_dtype=np.int8,
        sparse_block_rows=512, sparse_block_cols=512,
        tail_format=tail_format, tail_group=16, device=dev)
    build_s = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(0)
    h = torch.randn((hg.n_node, HD), generator=gen).to(dev, torch.bfloat16)
    w_a = (torch.randn((HD, HEADS), generator=gen) * 0.1).to(
        dev, torch.bfloat16)
    a_d = torch.randn((hg.n_node, HEADS), generator=gen).to(dev)

    def run():
        acc, _ = D._gat_hybrid_raw(hyb, h, w_a, a_d, True, 0.2)
        den = acc[:, HD:].clamp(min=1e-20).repeat_interleave(HD // HEADS, 1)
        return acc[:, :HD] / den

    return Recipe(hyb, dict(h=h, w_asrc=w_a, a_dst=a_d), run, build_s)


def _throughput(metric: str, recipe: Recipe, hg: G.HostGraph,
                dev: torch.device, repeats: int, what: str) -> Dict:
    with torch.inference_mode():
        ms = _time_ms(recipe.run, dev, repeats)
    return _line(metric, "Gedge/s",
                 None if ms is None else hg.n_edge / (ms * 1e-3) / 1e9,
                 f"{_ms_text(ms)} for {hg.n_edge} edges, {what}; "
                 f"{recipe.detail()}")


def reddit_spmm_throughput(hg: G.HostGraph, device=None,
                           repeats: int = 5) -> Dict:
    """Gedge/s of :func:`spmm_recipe` over the graph's edges."""
    dev = G.resolve_device(device)
    return _throughput("reddit_spmm_throughput", spmm_recipe(hg, dev), hg,
                       dev, repeats, f"F={F_SPMM} bf16, hybrid int8-dense "
                       "+ grouped tail")


def reddit_gat_throughput(hg: G.HostGraph, device=None,
                          repeats: int = 5) -> Dict:
    """Gedge/s of :func:`gat_recipe` over the graph's edges."""
    dev = G.resolve_device(device)
    return _throughput("reddit_gat_throughput", gat_recipe(hg, dev), hg, dev,
                       repeats, f"H={HEADS} HD={HD} bf16, hybrid cr-dense + "
                       "grouped tail thr128")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--edges", type=int, default=REDDIT_EDGES,
                    help="synthetic edges before self loops")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card")
    args = ap.parse_args(argv)
    dev = G.resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    gat_cora_layer3_latency(dev)
    t0 = time.perf_counter()
    hg = reddit_graph(args.edges)
    print(f"# Reddit-dims graph N={hg.n_node} E={hg.n_edge}: host build "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    reddit_spmm_throughput(hg, dev)
    reddit_gat_throughput(hg, dev)
    if dev.type == "cuda":
        print(f"# peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
