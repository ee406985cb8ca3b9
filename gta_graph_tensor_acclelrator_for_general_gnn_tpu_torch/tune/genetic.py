"""Genetic schedule search with measured fitness on the card.

Counterpart of the JAX package's ``tune/genetic.py`` (the reference's
genetic_algorithm.py).  A genome is a fusion bitstring over the op DAG's
free edges, a palette index per kernel block, kernels on or off and the
attention chain's super-block on or off.  The operators are the JAX
package's, drawn from one ``random.Random(seed)`` in the same order, so one
seed walks the same genomes in both packages:

* seeds: no fusion, max fusion, max fusion on kernels, the warm-start
  schedules, the pattern block (with an attention chain), three random;
* crossover: a bitstring splice at a random cut and a per-block tile
  exchange;
* mutation: flip about a quarter of the fusion bits and move one block's
  tile one palette step;
* selection: the ``n_parents`` fastest; stop when the best is stable for
  ``stable_stop`` generations;
* prune: the modelled traffic bound before measuring.

Differences from the JAX tuner, as in ``tune/search.autotune``: a
candidate the port's kernels cannot run by the shared-memory rule
(``search.schedule_is_feasible``) is priced infinite without lowering (JAX
prices the VMEM rule's rejections so), and a candidate that fails to lower,
build or launch raises (JAX records it as infinitely slow); fitness is
``utils/benchmark.time_layer_device`` (CUDA events) and the memo is the
port's (``v{KERNEL_VERSION}|...`` keys, under ``build/tune/`` by default).
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import ir
from ..compiler import schedule as S
from ..compiler.fusion import KERNEL_VERSION, lower_schedule, match_spmm
from ..graph import HostGraph
from ..ops.gat import find_gat_chain, match_gat_block
from ..utils.benchmark import time_layer_device
from .search import Measurement, Memo, TuneResult, schedule_is_feasible


@dataclasses.dataclass(frozen=True)
class Genome:
    bits: Tuple[int, ...]          # over the free (non-breakpoint) DAG edges
    tile_idx: Tuple[int, ...]      # palette index per kernel block, by
                                   # ordinal; the last reused past the end
    kernels: bool                  # kernel blocks on their kernels?
    use_pattern: bool              # the attention chain as one block?


class GeneticTuner:
    def __init__(
        self,
        graph: ir.OpGraph,
        host_graph: HostGraph,
        *,
        compute_dtype=None,
        tile_palette: Optional[Sequence[S.TileConfig]] = None,
        memo_path: Optional[str] = None,
        seed: int = 0,
        n_parents: int = 8,
        n_offspring: int = 8,
        max_generations: int = 32,
        stable_stop: int = 5,
        traffic_prune: float = 4.0,
        iters: int = 30,
        warm_start: Optional[Sequence[S.Schedule]] = None,
        derive_palette: bool = False,
        target_s: Optional[float] = 0.2,
        device=None,
    ):
        import torch
        self.graph = graph
        self.hg = host_graph
        self.dtype = compute_dtype
        self.dtype_bytes = (
            torch.tensor([], dtype=compute_dtype).element_size()
            if compute_dtype is not None else 4)
        if tile_palette is None:
            from ..hwconfig import load_hw_config
            cfg = load_hw_config()
            if derive_palette:
                fw = max(op.out_width for op in graph.ops)
                tile_palette = cfg.derived_palette(fw, self.dtype_bytes)
            else:
                tile_palette = cfg.palette()
        self.palette = list(tile_palette)
        self.memo = Memo(memo_path)
        self.rng = random.Random(seed)
        self.n_parents = n_parents
        self.n_offspring = n_offspring
        self.max_generations = max_generations
        self.stable_stop = stable_stop
        self.traffic_prune = traffic_prune
        self.iters = iters
        self.target_s = target_s
        self.device = device

        self.edges = graph.edges()
        self.free = [e for e in self.edges
                     if not ir.is_breakpoint(graph.by_id[e[0]],
                                             graph.by_id[e[1]])]
        self.stats = S.GraphStats(host_graph.n_node, host_graph.n_edge,
                                  host_graph.e_pad)
        self.chain = find_gat_chain(graph)
        self.warm_start = list(warm_start or [])

    # -- genome -> schedule -------------------------------------------------
    def decode(self, gen: Genome) -> Optional[S.Schedule]:
        ids = [op.op_id for op in self.graph.ops]
        fused = [e for e, b in zip(self.free, gen.bits) if b]
        if gen.use_pattern and self.chain is not None:
            chain = self.chain.ops
            fused = [e for e in fused
                     if e[0] not in chain and e[1] not in chain]
        blocks = S._components(ids, fused)
        if gen.use_pattern and self.chain is not None:
            merged = sorted(self.chain.ops)
            blocks = [b for b in blocks if not set(b) & self.chain.ops]
            blocks.append(merged)
        if not S.partition_is_legal_with_patterns(self.graph, blocks):
            return None
        ordered = S._order_blocks(self.graph, blocks)
        part = tuple(tuple(b) for b in ordered)
        tiles = []
        k = 0
        for b in part:
            patt = (match_spmm(self.graph, b) is not None
                    or match_gat_block(self.graph, b) is not None)
            if patt and gen.kernels:
                ti = gen.tile_idx[min(k, len(gen.tile_idx) - 1)]
                tiles.append(self.palette[ti])
                k += 1
            else:
                tiles.append(S.TileConfig(path=S.PATH_XLA))
        return S.Schedule(blocks=part, tiles=tuple(tiles))

    def encode(self, sched: S.Schedule) -> Genome:
        """Inverse of :meth:`decode`: lift a schedule, possibly of another
        graph (another layer or dataset), into this graph's genome space.
        Fusion bits map by the rank of op ids, tile configs to the nearest
        palette entry."""
        block_of = {}
        for i, b in enumerate(sched.blocks):
            for o in b:
                block_of[o] = i
        f_ids = sorted(block_of)
        rank_of = {oid: i for i, oid in enumerate(
            sorted(op.op_id for op in self.graph.ops))}

        def fblock(o):
            i = rank_of[o]
            return block_of[f_ids[i]] if i < len(f_ids) else None

        bits = tuple(
            1 if (fblock(u) is not None and fblock(u) == fblock(v)) else 0
            for u, v in self.free)
        use_pattern = bool(
            self.chain is not None
            and any(set(b) == self.chain.ops for b in sched.blocks))
        kernels = any(tc.path != S.PATH_XLA for tc in sched.tiles)
        nt = self._n_tile_genes
        idxs = []
        for tc in sched.tiles:
            if tc.path == S.PATH_XLA:
                continue
            if tc in self.palette:
                idxs.append(self.palette.index(tc))
            else:   # nearest by block geometry
                idxs.append(min(
                    range(len(self.palette)),
                    key=lambda i: (
                        abs(self.palette[i].block_rows - tc.block_rows)
                        + abs(self.palette[i].block_cols - tc.block_cols)
                        + abs(self.palette[i].tile_edges - tc.tile_edges)
                        + (0 if self.palette[i].path == tc.path
                           else 10_000))))
        if not idxs:
            idxs = [len(self.palette) // 2]
        tile_idx = tuple((idxs + idxs * nt)[:nt])
        return Genome(bits, tile_idx, kernels, use_pattern)

    # -- operators ----------------------------------------------------------
    @property
    def _n_tile_genes(self) -> int:
        # at most one kernel block per gather op
        return max(sum(1 for op in self.graph.ops if op.kind == ir.GATHER), 1)

    def _seeds(self) -> List[Genome]:
        n = len(self.free)
        nt = self._n_tile_genes
        mid = (len(self.palette) // 2,) * nt
        seeds = [
            Genome((0,) * n, mid, False, False),           # no fusion
            Genome((1,) * n, mid, False, False),           # max fusion
            Genome((1,) * n, mid, True, False),            # ... on kernels
        ]
        seeds.extend(self.encode(s) for s in self.warm_start)
        if self.chain is not None:
            seeds.append(Genome((1,) * n, mid, True, True))
            seeds.append(Genome((0,) * n, mid, True, True))
        for _ in range(3):
            bits = tuple(self.rng.randint(0, 1) for _ in range(n))
            tiles = tuple(self.rng.randrange(len(self.palette))
                          for _ in range(nt))
            seeds.append(Genome(bits, tiles,
                                self.rng.random() < 0.5,
                                self.chain is not None
                                and self.rng.random() < 0.5))
        return seeds

    def _combine(self, a: Genome, b: Genome) -> Genome:
        n = len(a.bits)
        cut = self.rng.randrange(n + 1) if n else 0
        bits = a.bits[:cut] + b.bits[cut:]
        tiles = tuple(ta if self.rng.random() < 0.5 else tb
                      for ta, tb in zip(a.tile_idx, b.tile_idx))
        return Genome(bits, tiles,
                      a.kernels if self.rng.random() < 0.5 else b.kernels,
                      a.use_pattern if self.rng.random() < 0.5
                      else b.use_pattern)

    def _mutate(self, a: Genome) -> Genome:
        n = len(a.bits)
        bits = list(a.bits)
        for _ in range(max(n // 4, 1)):
            if n:
                i = self.rng.randrange(n)
                bits[i] ^= 1
        tiles = list(a.tile_idx)
        j = self.rng.randrange(len(tiles))
        r = self.rng.random()
        if r < 0.33 and tiles[j] + 1 < len(self.palette):
            tiles[j] += 1
        elif r < 0.66 and tiles[j] > 0:
            tiles[j] -= 1
        return Genome(tuple(bits), tuple(tiles),
                      not a.kernels if self.rng.random() < 0.3 else a.kernels,
                      not a.use_pattern if (self.chain is not None and
                                            self.rng.random() < 0.3)
                      else a.use_pattern)

    # -- fitness ------------------------------------------------------------
    def _measure(self, sched: S.Schedule, params, g_dev, x) -> float:
        """Seconds per application of ``sched`` on the card, from the memo
        when it has the key; infinite where the shared-memory rule refuses
        a kernel block.  A lowering or launch failure raises."""
        key = f"v{KERNEL_VERSION}|{self.graph.name}|{sched.key()}"
        lat = self.memo.get(key)
        if lat is not None:
            return lat
        if not schedule_is_feasible(self.graph, sched, self.dtype_bytes):
            return float("inf")
        fn = lower_schedule(self.graph, sched, self.hg, self.dtype,
                            device=self.device)
        lat = time_layer_device(fn, params, g_dev, x, iters=self.iters,
                                target_s=self.target_s, device=self.device)
        self.memo.put(key, lat)
        return lat

    # -- main loop ----------------------------------------------------------
    def search(self, params, g_dev, x, verbose: bool = False) -> TuneResult:
        population = self._seeds()
        measured: Dict[str, Measurement] = {}
        t_best_traffic = None

        def eval_genome(gen: Genome) -> Optional[Measurement]:
            nonlocal t_best_traffic
            sched = self.decode(gen)
            if sched is None:
                return None
            key = sched.key()
            if key in measured:
                return measured[key]
            traffic = S.traffic_bytes(self.graph, sched.blocks, self.stats)
            if t_best_traffic is None or traffic < t_best_traffic:
                t_best_traffic = traffic
            if traffic > self.traffic_prune * t_best_traffic:
                return None
            lat = self._measure(sched, params, g_dev, x)
            m = Measurement(sched, lat, traffic)
            measured[key] = m
            if verbose:
                print(f"  {lat*1e6:9.1f}us  {key}", flush=True)
            return m

        scored: List[Tuple[float, Genome]] = []
        for gen in population:
            m = eval_genome(gen)
            if m is not None:
                scored.append((m.latency_s, gen))

        if not scored:
            raise RuntimeError(
                "GeneticTuner: every seed genome failed to decode or was "
                "traffic-pruned: nothing to measure")
        best = min(s for s, _ in scored)
        stable = 0
        for _ in range(self.max_generations):
            scored.sort(key=lambda t: t[0])
            parents = [g for _, g in scored[: self.n_parents]]
            children: List[Genome] = []
            for _ in range(self.n_offspring // 2):
                a, b = self.rng.sample(parents, 2) if len(parents) >= 2 \
                    else (parents[0], parents[0])
                children.append(self._combine(a, b))
            for _ in range(self.n_offspring - self.n_offspring // 2):
                children.append(self._mutate(self.rng.choice(parents)))
            for gen in children:
                m = eval_genome(gen)
                if m is not None:
                    scored.append((m.latency_s, gen))
            new_best = min(s for s, _ in scored)
            if new_best < best * 0.999:
                best = new_best
                stable = 0
            else:
                stable += 1
                if stable >= self.stable_stop:
                    break

        trials = list(measured.values())
        top = min(trials, key=lambda m: m.latency_s)
        if not np.isfinite(top.latency_s):
            raise RuntimeError(
                "GeneticTuner: no measured candidate is feasible on the "
                "port's kernels")
        return TuneResult(best=top.schedule, latency_s=top.latency_s,
                          trials=trials)
