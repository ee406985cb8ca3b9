#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port on one NVIDIA GPU (H100).

Drives the port's serving forward of GCN-2l and GAT-2l on the hybrid
density-split path at the Reddit configuration's widths (602 features,
hidden 128, 41 classes, GAT 4 heads) over a synthetic community graph of
Reddit's node count, and checks every hand-written kernel on the way:

  1. environment: versions, card name and power limit, TF32 off;
  2. build: compiles the kernels from ``csrc/`` (seconds printed);
  3. kernels: each of K1-K4 against its plain PyTorch version on the card,
     on the edge cases of ``utils/fixtures.kernel_cases``;
  4. slice: builds the graph, lowers each model once per dtype with the
     hybrid splits and their transposed twins
     (``make_apply(build_transpose=True)``), checks K1-K4 again at
     every shape the slice gives them, both layers' (error and time beside
     the plain version; each row's error within its bound, see
     ``fixtures.kernel_error``; K3 in both forms of a_s: the float32
     per-node array the hybrid path hands it, in the kernels' row, and
     derive mode with its per-node pass, printed apart), then
     serves 3 bf16 requests and 1 float32 request per model through that
     forward under ``torch.inference_mode()`` and traces one more GAT-2l
     request as ``utils/profile.py`` does (wall and busy time, idle share,
     device time per kernel); checks that every kernel's
     launch count rose, and compares each answer with the per-op path
     (``make_apply(schedules=None)``) on the card;
  5. training: on the same lowered forward, checks the GAT backward
     kernels K5-K8 against their plain versions on the fixture cases
     (``fixtures.bwd_kernel_cases``: K7 at every head shape of its wgmma
     path with int8 and bf16 values, K5 and K6 at 1 head of 128, 2 of 64,
     4 of 32, 1 of 41 and 16 of 1 and with rows off the vector loads'
     alignment, both dtypes) and at both layers' shapes (and
     times them in bf16; K7's and K8's bf16 calls run their tensor-core
     paths and print their cell-heads per second beside the dense-cell
     floor, their float32 calls the per-cell walk), compares one
     float32 loss and every parameter's gradient with autograd through the
     per-op path, then takes 1 warm-up and 4 timed bf16 AdamW steps per
     model through ``models/train.make_train_step`` (and one more GAT-2l
     step traced as ``utils/profile.py --train`` does): each loss finite,
     the last below the first, and every one of K1-K8 launched during the
     steps;
  6. grouped tail: (a) K9 and K10 against their plain versions on the
     fixture's grouped tilings; (b) the root bench's two Reddit recipes
     (``bench.spmm_recipe``, ``bench.gat_recipe``: int8 dense blocks plus a
     512²/ET128/G16 grouped tail, F = 128 and H = 4 x 32, bf16) on the same
     graph, K9 and K10 checked and timed at their shapes (K10's work list
     against all NC G sub-tiles; K10 in both forms of a_s, the hybrid
     path's float32 array in the row and derive mode printed, also at
     GAT-2l's last layer, 1 head of 41, beside K3 on the same edges as a
     per-tile tail), K2 on the SpMM
     recipe's dense blocks and K1 on its per-tile tail checked and timed
     (printed, not in the kernels' rows), each recipe served and compared
     with the same split built with a per-tile tail; (c)
     GCN-2l lowered on PATH_GROUPED 512²/ET128 with the transposed twin:
     one bf16 and one float32 request against the per-op path, float32
     gradients against per-op autograd (K9 launched in the backward), and 1
     warm-up and 2 timed bf16 AdamW steps;
  7. SDDMM and pair aggregation: (a) K11-K13 against their plain versions
     on the fixture cases (K13's hub row cut into two chunks of its work
     list); (b) DGN-2l and PNA-2l (602/128/41) with their pair chains on
     K13 (``pair_agg_partition``, 1024²/ET512 ``onehot``): K13's work list
     built again and timed (its chunks and cut rows printed), K13 checked
     and timed at each layer's shape, 3 bf16 and 1 float32
     requests per model on the smoke's graph, and on a reduced graph of
     the same generator (a tenth of the edges, where the per-op path fits)
     answers, float32 losses and gradients against the per-op path; (c)
     GAT-2l with its logit blocks on the ``sddmm`` kind (K11 at the ADD
     shapes), one bf16 and one float32 request against the per-op path;
     (d) the hybrid SDDMM (dense-block logits plus K12 on phase 6's SpMM
     recipe split, and K11 on the same split with a per-tile tail; F =
     128, bf16), K11 and K12 also at 4 heads on the GAT recipe's tails,
     grouped and per-tile logits compared in edge order; at each of
     K11's timed shapes (c, d) its walk, its edges per second and
     ``sampled_addmm`` beside it;
  8. the whole-layer GAT kind, the gat kind's backward, the exp panels:
     (a) K14 and K15 against their plain versions on the fixture cases
     (``fixtures.layer_kernel_cases``: dead tile, empty rows, pad slots, 1
     and 4 heads, every final activation, a logit row above the clamp and
     one that underflows, both dtypes; K14 at F = 43, 70 and 64, so that
     its bf16 projection stages x rows by 2, 4 and 16 bytes, over 600
     rows, not a multiple of its 128; K15 at every head
     width of its tensor-core path, on int8 counts, on bf16 values and on
     row blocks of 17 dense blocks, two wide-segment runs); (b) GAT-2l
     (602/128/41) with every
     layer on ``layer_partition`` at 512x1024x512 ``onehot`` (the
     ``gat_layer`` kind): K14 checked stage by stage and timed at both
     layers' shapes, each stage also alone (the projection beside its
     bound and ``torch.matmul``; the walk with its edges per second; the
     epilogue), the
     logits' static-shift domain printed, 3 bf16 and 1 float32 requests
     against the per-op path; (c) GAT-2l with the attention chain as the
     ``gat`` kind on the same tile, lowered with the transposed twin:
     K3's rows, K5's dad and K6's [das | dh] (over the twin) against a
     float64 sum of the same terms (``HUB_TOL``), float32 loss and
     gradients against per-op autograd at the kernel path's layer inputs
     (so that both take the same side of leaky relu's kink) at the
     parameters phase 5 left (each leaf also within SPREAD_X times that
     reference's own spread) and at the seeded initial ones (as 5c; 8d
     both too), 1 warm-up and 2
     timed bf16 AdamW steps, K3, K5 and K6 launched; (d) the ``gat_layer``
     kind's float32 gradients against per-op autograd on phase 7's reduced
     graph; (e) ``cli tune --stack`` on cora (memo and schedule in a
     temporary directory), then ``cli run`` and ``cli train`` with that
     schedule; (f) run right after phase 4, on its lowered GAT-2l
     forward: ``DENSE_EXP_PANEL`` set, K15 checked and timed at both
     layers' dense splits beside K4 (each with its cell-heads per second
     and its own dense-cell floor), one bf16 and one float32 request
     against the K4 path, and 3 x 4 bf16 requests timed with the flag on
     and off in turns (the flag restored after).

Prints one JSON line of kernel results (per kernel its launches on the main
path, its worst error at the slice's shapes, and summed over its timed
calls its time, the plain version's, its bound on the card from
``utils/roofline`` and the time of the library call that computes the same
function, ``torch.sparse.mm`` for K1, K2 and K9, ``torch.sparse.
sampled_addmm`` at one head for K11 and K12, else null; each timed K2
and K4 call also prints the rate at which it streamed its count blocks,
each K4, K7 and K8 call its cell-heads per second beside its dense-cell
floor, each K3 and K11 call its edges per second, each K9 and K10 call
the sub-tiles its work list holds and its edges per second), the
card's name and power limit, and last ``{"ok": true, "device": {...}}``.  Any
failure raises: the script then exits non-zero without that line.  Needs
one CUDA device.

    python3 chip_smoke.py                 # E = 11,461,589 (a tenth of Reddit)
    python3 chip_smoke.py --edges 114615892
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

PKG = "gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch"
JAX_PKG = "gta_graph_tensor_acclelrator_for_general_gnn_tpu"
N_NODE = 232_965
F_IN, HIDDEN, N_CLASS, HEADS = 602, 128, 41, 4
REQUESTS = 3       # bf16 requests per model (plus one float32 request)
REPEATS = 5        # timing windows per kernel and shape
# calls in a row per timing window of a kernel or its library call (not
# of the plain versions): one call alone would also count the host's time
# to enqueue it, during which the card idles, tens of microseconds beside
# kernels that take a fraction of a millisecond
CALLS = 10

KERNELS = {
    "spmm_tiles": dict(source=f"{PKG}/csrc/spmm_tiles.cu",
                       replaces=f"{JAX_PKG}/ops/spmm.py:110"),
    "spmm_dense_blocks": dict(source=f"{PKG}/csrc/spmm_dense_blocks.cu",
                              replaces=f"{JAX_PKG}/ops/dense.py:102"),
    "gat_tiles": dict(source=f"{PKG}/csrc/gat_tiles.cu",
                      replaces=f"{JAX_PKG}/ops/gat.py:206"),
    "gat_dense_blocks": dict(source=f"{PKG}/csrc/gat_dense_blocks.cu",
                             replaces=f"{JAX_PKG}/ops/dense.py:371"),
    "gat_bwd_tiles_dad": dict(source=f"{PKG}/csrc/gat_bwd_tiles_dad.cu",
                              replaces=f"{JAX_PKG}/ops/gat.py:1346"),
    "gat_bwd_tiles_src": dict(source=f"{PKG}/csrc/gat_bwd_tiles_src.cu",
                              replaces=f"{JAX_PKG}/ops/gat.py:1418"),
    "gat_dense_bwd_dad": dict(source=f"{PKG}/csrc/gat_dense_bwd_dad.cu",
                              replaces=f"{JAX_PKG}/ops/dense.py:625"),
    "gat_dense_bwd_src": dict(source=f"{PKG}/csrc/gat_dense_bwd_src.cu",
                              replaces=f"{JAX_PKG}/ops/dense.py:667"),
    "spmm_grouped": dict(source=f"{PKG}/csrc/spmm_grouped.cu",
                         replaces=f"{JAX_PKG}/ops/spmm.py:45"),
    "gat_grouped": dict(source=f"{PKG}/csrc/gat_grouped.cu",
                        replaces=f"{JAX_PKG}/ops/gat.py:323"),
    "sddmm_tiles": dict(source=f"{PKG}/csrc/sddmm_tiles.cu",
                        replaces=f"{JAX_PKG}/ops/sddmm.py:84"),
    "sddmm_grouped": dict(source=f"{PKG}/csrc/sddmm_grouped.cu",
                          replaces=f"{JAX_PKG}/ops/sddmm.py:192"),
    "pair_agg": dict(source=f"{PKG}/csrc/pair_agg.cu",
                     replaces=f"{JAX_PKG}/ops/pairagg.py:59"),
    "gat_layer": dict(source=f"{PKG}/csrc/gat_layer.cu",
                      replaces=f"{JAX_PKG}/ops/gat.py:1691"),
    "gat_dense_panel": dict(source=f"{PKG}/csrc/gat_dense_blocks.cu",
                            replaces=f"{JAX_PKG}/ops/dense.py:317"),
}
# kernel path vs per-op path: the per-op path rounds only the matmul
# operands to bf16, the kernels also their gathered rows and products
E2E_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# float32 training: kernel path against autograd of the per-op path,
# relative to max |per-op|.  The kernels hold their plain versions to 1e-5
# of each cell's scale (phase 3 and 5b) and a served answer holds the
# per-op path to 1e-4 (E2E_TOL); the backward adds one more pass of sums
# of the same terms, and dad's softmax sums cancel, which magnifies their
# rounding relative to the result: a tenfold margin on the forward bound.
GRAD_TOL = {"loss": 1e-4, "grad": 1e-3}
# 8c and 8d at the parameters the earlier phases' AdamW steps left: both
# paths' gradients SPREAD_EVALS times; a leaf is held within the larger of
# GRAD_TOL and SPREAD_X times the per-op reference's own spread (two float32
# results that reorder the same sums differ by about that spread; the
# factor covers the maximum over two pairs and the kernel's other order)
SPREAD_EVALS = 3
SPREAD_X = 4
LR = 1e-2
TRAIN_STEPS = 4    # timed bf16 steps per model, after one warm-up step
# phase 7: the tiling of the pair-agg and sddmm blocks, (block rows, block
# cols, slots per tile) on the ``onehot`` path
PAIR_TILE = (1024, 1024, 512)
# phase 7b's reduced graph, where the per-op path holds DGN and PNA: a
# tenth of the smoke's edges from the same generator
REDUCED_EDGES = 1_146_158
LOGIT_SCALE = 10.0  # phase 7b's float32 gradients: max |logit| of the input
# phase 8: the one-hot GAT tiling (scripts/reddit_train.py:98's geometry)
LAYER_TILE = (512, 1024, 512)
TUNE_TARGET_S = 0.01   # phase 8e: seconds per candidate measurement
# phase 8c: K3's float32 [num | den], K5's dad and K6's [das | dh] per row
# against a float64 sum; a hub row's 209,253 terms added one float32
# atomic per slot would drift by about sqrt(n) ulps (~1e-4); summed per
# receiver run they stay near 1e-6
HUB_TOL = 2e-5


def say(msg: str) -> None:
    print(msg, flush=True)


def say_ptxas(log: str) -> None:
    """One line per compiled kernel from the build's ``ptxas -v`` report:
    its mangled name from the kernel's own name on (the template
    arguments follow it), registers, spill stores and loads."""
    import re
    entry, spill = None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = entry = m.group(1)
            # the kernel's own name: a mangled identifier ending in
            # "kernel", after its length in digits
            for k in re.finditer(r"\d+", name):
                digits = k.group(0)
                for i in range(len(digits)):
                    ident = name[k.end():k.end() + int(digits[i:])]
                    if ident.endswith("kernel") and ident.isidentifier():
                        entry = name[k.end():]
                        break
                if entry is not name:
                    break
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = f"spill {m.group(1)} / {m.group(2)} bytes"
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            say(f"  ptxas: {entry[:72]}: {m.group(1)} registers, {spill}")
            entry, spill = None, ""


def _timed(fn, *args):
    """(``fn(*args)``, its device time in ms by CUDA events)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(*args)
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


class Checks:
    """Kernel-vs-plain comparisons by ``fixtures.check_kernel``; raises on
    the first failure."""

    def __init__(self):
        self.worst = {}      # kernel -> max abs err at the slice shapes
        # kernel -> {call: (ms, plain_ms, roofline.Work, library ms or None)}
        self.times = {}
        self.csr = {}        # (graph id, dtype) -> CSR of its edges

    def sparse_mm(self, graph, x):
        """The library call that computes K1's, K2's and K9's function:
        ``torch.sparse.mm`` with a CSR matrix of ``graph``'s edges in x's
        dtype (built once, outside the timing)."""
        import torch

        from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import roofline
        key = (id(graph), x.dtype)
        if key not in self.csr:
            self.csr[key] = roofline.csr_of(graph, x.dtype, x.shape[0])
        a = self.csr[key]
        try:
            torch.sparse.mm(a, x)
        except NotImplementedError as e:
            # a PyTorch build without this dtype's sparse product: the
            # yardstick runs in float32 and says so
            say(f"  torch.sparse.mm in {x.dtype}: {e}; timed in float32")
            key, x = (id(graph), torch.float32), x.float()
            if key not in self.csr:
                self.csr[key] = roofline.csr_of(graph, x.dtype, x.shape[0])
            a = self.csr[key]
        return lambda: torch.sparse.mm(a, x)

    def sampled_addmm(self, graph, x_src, x_dst):
        """The library call that computes K11's and K12's function at one
        head: ``torch.sparse.sampled_addmm`` of x_dst @ x_srcᵀ sampled at a
        CSR matrix of ``graph``'s live edges (receiver rows, sender
        columns; duplicate edges merged), beta 0.  Built outside the
        timing; a build without the dtype's kernel runs it in float32 and
        says so."""
        import torch

        from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import roofline
        n = x_src.shape[0]
        for dt in (x_src.dtype, torch.float32):
            key = (id(graph), dt)
            if key not in self.csr:
                self.csr[key] = roofline.csr_of(graph, dt, n)
            a, xd, xs_t = self.csr[key], x_dst.to(dt), x_src.to(dt).t().contiguous()
            try:
                torch.sparse.sampled_addmm(a, xd, xs_t, beta=0.0)
            except (RuntimeError, NotImplementedError) as e:
                if dt == torch.float32:
                    raise
                say(f"  torch.sparse.sampled_addmm in {dt}: "
                    f"{str(e).splitlines()[0]}; timed in float32")
                continue
            call = lambda: torch.sparse.sampled_addmm(  # noqa: E731
                a, xd, xs_t, beta=0.0)
            call.label = f"torch.sparse.sampled_addmm ({dt})"
            return call

    def compare(self, c, slice_shape: bool = False) -> None:
        from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import fixtures
        err, share = fixtures.check_kernel(c)
        terms = ("" if c.terms is None
                 else f", most terms in a row {int(c.terms.max())}")
        say(f"  {c.kernel:18s} {c.case:34s} {c.dtype_name:8s} max_abs_err="
            f"{err:.3e}, worst row at {share:.3f} of its bound{terms}")
        if slice_shape:
            self.worst[c.kernel] = max(self.worst.get(c.kernel, 0.0), err)

    def slice_case(self, kernel, case, dtype_name, kern, plain, dev, *,
                   split=None, terms=None, scale=None, timed_as=None,
                   work=None, library=None, stream_bytes=None, note=None):
        """Compare ``kern()`` with ``plain()`` at a shape of the slice;
        with ``timed_as``, also time both (CUDA events, median of REPEATS)
        as that call of a request or step, beside the call's bound
        (``work()``, a ``roofline.Work``) and the library call's time
        (``library``, where one PyTorch call computes the same function)."""
        from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils.fixtures import KernelCase
        self.compare(KernelCase(kernel, case, dtype_name, kern(), plain(),
                                split, terms, scale), slice_shape=True)
        if timed_as is not None:
            self.time_call(kernel, timed_as, kern, plain, dev, work, library,
                           stream_bytes=stream_bytes, note=note)

    def time_call(self, kernel, timed_as, kern, plain, dev, work,
                  library=None, in_row=True, stream_bytes=None,
                  note=None) -> None:
        """Time ``kern()`` and ``plain()`` (CUDA events, median of
        REPEATS; the kernel and library calls per call over CALLS in a
        row) and the library call (named by its ``label``, else
        ``torch.sparse.mm``), beside the bound ``work()``; with ``in_row``
        the call counts in the kernel's line of the JSON result, else it
        is only printed.  ``stream_bytes`` (K2's and K4's count or value
        blocks) prints the rate at which the kernel streamed them beside
        the card's memory rate; ``note(ms)`` adds the call's own rates (K4:
        cell-heads per second; K9: its work list and edges per second)."""
        from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import roofline as RL
        from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils.benchmark import median_ms
        ms_k = median_ms(kern, device=dev, warmup=1, repeats=REPEATS,
                         calls=CALLS)
        ms_p = median_ms(plain, device=dev, warmup=1, repeats=REPEATS)
        ms_l = (median_ms(library, device=dev, warmup=1, repeats=REPEATS,
                          calls=CALLS) if library is not None else None)
        w = work()
        if in_row:
            self.times.setdefault(kernel, {})[timed_as] = (ms_k, ms_p, w,
                                                           ms_l)
        lib = "" if ms_l is None else (
            f"   {getattr(library, 'label', 'torch.sparse.mm')} {ms_l:.4f} ms")
        rate = "" if stream_bytes is None else (
            f"   blocks streamed at {stream_bytes / ms_k / 1e6:.1f} GB/s "
            f"(memory {RL.HBM_BYTES_PER_S / 1e9:.0f} GB/s)")
        say(f"  {kernel:18s} {timed_as:11s} kernel {ms_k:.4f} ms   "
            f"plain {ms_p:.4f} ms   bound {w.bound_ms:.4f} ms "
            f"({w.bound_by}){lib}{rate}{'' if note is None else note(ms_k)}"
            f"{'' if in_row else '   (not in the row)'}")


def _stream_bytes(kernel: str, graph):
    """K2's and K4's block values in bytes (the stream whose rate bounds
    K2, and K4's bytes bound), else None."""
    if kernel not in ("spmm_dense_blocks", "gat_dense_blocks"):
        return None
    return graph.values.numel() * graph.values.element_size()


def _cell_note(graph, heads: int):
    """K4's per-call rate: the cell-heads it forms p for (every cell of
    every dense block, per head) per second, and its floor on this card,
    the larger of one exp per cell-head at 16 per clock per SM and ~10
    float32 operations per cell-head at the card's f32 rate."""
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import roofline as RL
    cells = graph.n_blocks * graph.block_rows * graph.block_cols * heads
    floor_ms = RL.dense_cell_floor_ms(cells)
    return lambda ms: (f"   {cells / ms / 1e6:.1f} G cell-heads/s over "
                       f"{cells} (dense-cell floor {floor_ms:.4f} ms)")


def _panel_cell_note(graph, heads: int):
    """K15's per-call rate: the cell-heads it forms p for per second, and
    its own dense-cell floor (``roofline.dense_panel_cell_floor_ms``: the
    panel chain, no exponential)."""
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import roofline as RL
    cells = graph.n_blocks * graph.block_rows * graph.block_cols * heads
    floor_ms = RL.dense_panel_cell_floor_ms(cells)
    return lambda ms: (f"   {cells / ms / 1e6:.1f} G cell-heads/s over "
                       f"{cells} (panel dense-cell floor {floor_ms:.4f} ms)")


def _profile(what: str, name: str, fn, dev) -> None:
    """Trace one call of ``fn`` as ``utils/profile.py`` does and print its
    wall and busy time, idle share and device time per kernel."""
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import profile
    profile.OUT_DIR.mkdir(parents=True, exist_ok=True)
    profile.trace(what, profile.OUT_DIR / f"trace_{name}.json", fn, dev)


def _edge_note(tg):
    """K3's per-call rate: the live edges of its tiling per second."""
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import roofline as RL
    edges = RL.live_slots(tg)
    return lambda ms: f"   {edges / ms / 1e6:.3f} Gedge/s over {edges} edges"


def _bwd_cell_note(graph, heads: int):
    """K7's and K8's per-call rate: the cell-heads their bf16 paths run the
    chain for (every cell of every dense block, per head) per second,
    beside the dense-cell floor (``roofline.dense_bwd_cell_floor_ms``)."""
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import roofline as RL
    cells = graph.n_blocks * graph.block_rows * graph.block_cols * heads
    floor_ms = RL.dense_bwd_cell_floor_ms(cells)
    return lambda ms: (f"   {cells / ms / 1e6:.1f} G cell-heads/s over "
                       f"{cells} (dense-cell floor {floor_ms:.4f} ms)")


def _walk_note(tg):
    """K9's and K10's per-call rate: the sub-tiles their work list holds
    against all the tiling's sub-tiles, and the live edges per second."""
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import roofline as RL
    edges, listed = RL.live_slots(tg), int(tg.live_sub.shape[0])
    return lambda ms: (f"   {listed} of {tg.n_tiles} sub-tiles listed, "
                       f"{edges / ms / 1e6:.3f} Gedge/s over {edges} edges")


def edge_case_checks(checks: Checks, dev) -> None:
    """K1-K4 against their plain versions on the fixture graph."""
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import fixtures
    for c in fixtures.kernel_cases(dev):
        checks.compare(c)


def slice_kernel_checks(checks: Checks, gcn_hybs, gat_hybs, dev,
                        n: int) -> None:
    """K1-K4 at every shape the slice gives them, layer by layer (layer 0:
    F = 128, 4 heads of 32; layer 1: the 41 logits, 1 head of 41), on that
    layer's split: error beside the plain version in the serving dtype
    (bf16) and in float32, and time in bf16.  K3 reads the hybrid path's
    float32 per-node a_s there; its derive form (``w_asrc``, the per-node
    pass first) is checked and timed apart, outside the kernels' row."""
    import torch

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import dense as D
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import gat as A
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import spmm as SP
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import roofline as RL
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils.fixtures import row_terms

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    layers = ((0, HIDDEN, HEADS, HIDDEN), (1, N_CLASS, 1, N_CLASS))
    for li, F, H, HD in layers:
        tg, bg = gcn_hybs[li].tiles, gcn_hybs[li].dense
        tga, bga = gat_hybs[li].tiles, gat_hybs[li].dense
        terms = {k: row_terms(gr) for k, gr in (
            ("spmm_tiles", tg), ("spmm_dense_blocks", bg),
            ("gat_tiles", tga), ("gat_dense_blocks", bga))}
        for dt in (torch.bfloat16, torch.float32):
            name = str(dt).split(".")[1]
            timed = dt == torch.bfloat16
            x = torch.randn((n, F), generator=gen, device=dev).to(dt)
            xs = (x * gcn_hybs[li].col_scale[:, None].to(dt)).contiguous()
            h = torch.randn((n, HD), generator=gen, device=dev).to(dt)
            w = (torch.randn((HD, H), generator=gen, device=dev)
                 / HD ** 0.5).to(dt)
            a_d = torch.randn((n, H), generator=gen, device=dev).to(dt).float()
            # the hybrid path's per-node a_s (ops/dense._a_s_kernel), which
            # K3 reads as it is on the main path
            a_s = h.float() @ w.float()
            ms = a_s.amax(0, keepdim=True)
            # kernel, plain version, column split, bound, library call
            runs = {
                "spmm_tiles": (
                    lambda: SP.spmm_tiles(tg, x, tg.weight),
                    lambda: SP._spmm_reference(tg, x), None,
                    lambda: RL.spmm_tail(tg, x, tg.weight.element_size()),
                    checks.sparse_mm(tg, x) if timed else None),
                "spmm_dense_blocks": (
                    lambda: D.spmm_dense_blocks(bg, xs, bg.values),
                    lambda: D._spmm_dense_reference(bg, xs, bg.values), None,
                    lambda: RL.spmm_dense(bg, xs),
                    checks.sparse_mm(bg, xs) if timed else None),
                "gat_tiles": (
                    lambda: A.gat_tiles(tga, h, tga.weight, a_d, ms,
                                        a_src=a_s, normalize=False),
                    lambda: A._gat_tiles_reference(tga, h, tga.weight, a_d,
                                                   ms, a_src=a_s,
                                                   normalize=False), HD,
                    lambda: RL.gat_tail(tga, h, H, tga.weight.element_size(),
                                        derive=False),
                    None),
                "gat_dense_blocks": (
                    lambda: D.gat_dense_blocks(bga, h, bga.values, a_s, a_d,
                                               ms),
                    lambda: D._gat_dense_reference(bga, h, bga.values, a_s,
                                                   a_d, ms), HD,
                    lambda: RL.gat_dense(bga, h, H), None),
            }
            for kname, (kern, plain, split, work, lib) in runs.items():
                dense = bga if kname == "gat_dense_blocks" else bg
                checks.slice_case(kname, f"layer {li} F={F} H={H} HD={HD}",
                                  name, kern, plain, dev, split=split,
                                  terms=terms[kname],
                                  timed_as=f"layer {li}" if timed else None,
                                  work=work, library=lib,
                                  stream_bytes=_stream_bytes(kname, dense),
                                  note=(_cell_note(bga, H)
                                        if kname == "gat_dense_blocks"
                                        else _edge_note(tga)
                                        if kname == "gat_tiles" else None))
            # K3's derive form (the gat kind's; its per-node a_s pass runs
            # first), checked and timed apart from the main path's calls
            kern = lambda: A.gat_tiles(tga, h, tga.weight, a_d, ms,  # noqa: E731
                                       w_asrc=w, normalize=False)
            plain = lambda: A._gat_tiles_reference(  # noqa: E731
                tga, h, tga.weight, a_d, ms, w_asrc=w, normalize=False)
            checks.slice_case("gat_tiles",
                              f"layer {li} derive F={F} H={H} HD={HD}", name,
                              kern, plain, dev, split=HD,
                              terms=terms["gat_tiles"])
            if timed:
                checks.time_call(
                    "gat_tiles", f"l{li} derive", kern, plain, dev,
                    lambda: RL.gat_tail(tga, h, H, tga.weight.element_size()),
                    in_row=False, note=_edge_note(tga))


def twin_spmm_checks(checks: Checks, twins, dev, n: int) -> None:
    """K1 and K2 at the shapes of GCN's backward dx = Aᵀ ȳ: each layer's
    transposed twin (its tail tiles and 'rc' count blocks, the swapped
    separable scales), layer 0 at F = 128 and layer 1 at F = 41, in bf16
    and float32; timed in bf16."""
    import torch

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import dense as D
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import spmm as SP
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import roofline as RL
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils.fixtures import row_terms

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    for li, (F, tw) in enumerate(zip((HIDDEN, N_CLASS), twins)):
        tg, bg = tw.tiles, tw.dense
        for dt in (torch.bfloat16, torch.float32):
            name = str(dt).split(".")[1]
            timed = f"l{li} twin" if dt == torch.bfloat16 else None
            x = torch.randn((n, F), generator=gen, device=dev).to(dt)
            xs = (x * tw.col_scale[:, None].to(dt)).contiguous()
            checks.slice_case(
                "spmm_tiles", f"layer {li} twin F={F}", name,
                lambda: SP.spmm_tiles(tg, x, tg.weight),
                lambda: SP._spmm_reference(tg, x), dev,
                terms=row_terms(tg), timed_as=timed,
                work=lambda: RL.spmm_tail(tg, x, tg.weight.element_size()),
                library=checks.sparse_mm(tg, x) if timed else None)
            checks.slice_case(
                "spmm_dense_blocks", f"layer {li} twin F={F}", name,
                lambda: D.spmm_dense_blocks(bg, xs, bg.values),
                lambda: D._spmm_dense_reference(bg, xs, bg.values), dev,
                terms=row_terms(bg), timed_as=timed,
                work=lambda: RL.spmm_dense(bg, xs),
                library=checks.sparse_mm(bg, xs) if timed else None,
                stream_bytes=_stream_bytes("spmm_dense_blocks", bg))


def bwd_slice_checks(checks: Checks, pairs, dev, n: int) -> None:
    """K5-K8 at every shape the GAT training step gives them: layer 0 (4
    heads of 32) and layer 1 (1 head of 41), on that layer's forward split
    and its transposed twin, in bf16 and float32 (random inputs; the tail
    kernels read their side values rounded to the compute dtype, as the
    step does), each cell held to its plain version scaled by its sum of
    elementary-term magnitudes; timed in bf16 beside the plain version."""
    import torch

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import fixtures
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import roofline as RL
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils.fixtures import row_terms

    rng = np.random.default_rng(0)
    for li, (H, HD) in enumerate(((HEADS, HIDDEN), (1, N_CLASS))):
        hyb, twin = pairs[li]
        split_of = {"gat_dense_bwd_dad": hyb.dense,
                    "gat_dense_bwd_src": twin.dense}
        terms = {"gat_bwd_tiles_dad": row_terms(hyb.tiles),
                 "gat_bwd_tiles_src": row_terms(twin.tiles),
                 "gat_dense_bwd_dad": row_terms(hyb.dense)[:n],
                 "gat_dense_bwd_src": row_terms(twin.dense)[:n]}
        a_s = rng.standard_normal((n, H)).astype(np.float32)
        msrc = torch.tensor(a_s.max(0, keepdims=True), device=dev)
        for dt in (torch.bfloat16, torch.float32):
            name = str(dt).split(".")[1]
            h = torch.tensor(rng.standard_normal((n, HD), dtype=np.float32),
                             device=dev).to(dt)
            gbar = torch.tensor(rng.standard_normal((n, HD),
                                                    dtype=np.float32),
                                device=dev).to(dt)
            for tail, side_dt in ((True, dt), (False, torch.float32)):
                side = fixtures.bwd_side(rng, n, H, side_dt, dev, a_s=a_s)
                runs = fixtures.bwd_runs(hyb.tiles, twin.tiles, hyb.dense,
                                         twin.dense, h, gbar, side, msrc)
                mb = hyb.tiles.weight.element_size()
                works = {
                    "gat_bwd_tiles_dad": lambda: RL.gat_bwd_tail(
                        hyb.tiles, h, H, mb, False),
                    "gat_bwd_tiles_src": lambda: RL.gat_bwd_tail(
                        twin.tiles, h, H, mb, True),
                    "gat_dense_bwd_dad": lambda: RL.gat_dense_bwd(
                        hyb.dense, h, H, False),
                    "gat_dense_bwd_src": lambda: RL.gat_dense_bwd(
                        twin.dense, h, H, True)}
                for k, (kern, plain, mag, split) in runs.items():
                    if k.startswith("gat_bwd_tiles") != tail:
                        continue
                    checks.slice_case(
                        k, f"layer {li} H={H} HD={HD}", name, kern, plain,
                        dev, split=split, terms=terms[k], scale=mag(),
                        timed_as=(f"layer {li}" if dt == torch.bfloat16
                                  else None), work=works[k],
                        note=(_bwd_cell_note(split_of[k], H)
                              if k in split_of else None))


def training_phase(checks: Checks, models, fwd, hg, g, dev):
    """Phase 5 on the kernel path ``fwd`` that phase 4 served through
    (lowered with the twins); returns each kernel's launches during the
    bf16 steps."""
    import torch

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models import train as TT
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import dense as D
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import gat as A
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import spmm as SP
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import fixtures

    say("== 5a training: transposed twins (built in phase 4)")
    pairs = {}       # model -> [(forward split, transposed twin)] per layer
    for mname in models:
        for li, fn in enumerate(fwd[mname]["bfloat16"].layer_fns):
            for kind, _, data, twin in fn.plans:
                if not kind.endswith("_hybrid"):
                    continue
                if twin is None:
                    raise AssertionError(f"{mname} layer {li}: no twin")
                nb = twin.dense.n_blocks if twin.dense is not None else 0
                say(f"  {mname} layer {li} {kind} twin: dense edges "
                    f"{twin.n_dense_edges} in {nb} blocks, tail edges "
                    f"{twin.n_sparse_edges} in {twin.tiles.n_tiles} tiles")
                pairs.setdefault(mname, []).append((data, twin))

    say("== 5b backward kernels: edge cases and the step's shapes")
    for c in fixtures.bwd_kernel_cases(dev):
        checks.compare(c)
    bwd_slice_checks(checks, pairs["GAT-2l"], dev, hg.n_node)
    say("== 5b K1, K2 at the shapes of GCN's backward (the twins)")
    twin_spmm_checks(checks, [tw for _, tw in pairs["GCN-2l"]], dev,
                     hg.n_node)

    rng = np.random.default_rng(7)
    x = torch.tensor(rng.standard_normal((hg.n_node, F_IN),
                                         dtype=np.float32), device=dev)
    # learnable labels: a random linear probe of the features
    wy = torch.tensor(rng.standard_normal((F_IN, N_CLASS),
                                          dtype=np.float32), device=dev)
    y = (x @ wy).argmax(dim=1)
    mask = torch.ones(hg.n_node, dtype=torch.bool, device=dev)

    say("== 5c float32 gradients: kernel path against per-op autograd")
    say(f"bound: loss {GRAD_TOL['loss']:.0e} relative to max(1, |loss|), "
        f"each gradient {GRAD_TOL['grad']:.0e} relative to max |per-op|")
    for mname, model in models.items():
        res = {}
        for path, fn in (("kernel", fwd[mname].pop("float32")),
                         ("per-op", model.make_apply(None))):
            model.zero_grad(set_to_none=True)
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            loss = TT.masked_cross_entropy(fn(dict(model.params), g, x), y,
                                           mask)
            loss.backward()
            torch.cuda.synchronize(dev)
            res[path] = (loss.item(), {k: p.grad.detach().clone()
                                       for k, p in model.params.items()})
            say(f"  {mname} {path}: loss {res[path][0]:.6f}, forward + "
                f"backward {time.perf_counter() - t0:.2f} s, peak device "
                f"memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f}"
                " GiB")
            del loss
        (lk, gk), (lr, gr) = res["kernel"], res["per-op"]
        rel = abs(lk - lr) / max(1.0, abs(lr))
        say(f"  {mname} loss: relative {rel:.3e}")
        if not rel <= GRAD_TOL["loss"]:
            raise AssertionError(f"{mname}: loss {lk} vs per-op {lr}")
        for k in gr:
            if not bool(torch.isfinite(gk[k]).all()):
                raise AssertionError(f"{mname} {k}: non-finite gradient")
            err = float((gk[k] - gr[k]).abs().max())
            rel = err / float(gr[k].abs().max())
            say(f"  {mname} d{k}: max abs err {err:.3e}, relative {rel:.3e}")
            if not rel <= GRAD_TOL["grad"]:
                raise AssertionError(f"{mname} d{k}: relative error {rel}")
        model.zero_grad(set_to_none=True)
        del res, gk, gr

    say("== 5d bf16 training steps (AdamW, full batch)")
    counted = {"spmm_tiles": SP.spmm_tiles,
               "spmm_dense_blocks": D.spmm_dense_blocks,
               "gat_tiles": A.gat_tiles, "gat_dense_blocks": D.gat_dense_blocks,
               "gat_bwd_tiles_dad": A.gat_bwd_tiles_dad,
               "gat_bwd_tiles_src": A.gat_bwd_tiles_src,
               "gat_dense_bwd_dad": D.gat_dense_bwd_dad,
               "gat_dense_bwd_src": D.gat_dense_bwd_src}
    step_ms = {}

    def steps(mname, model, path, fn, n_steps):
        state = TT.TrainState(model.params, TT.adamw(model.params, LR))
        step = TT.make_train_step(fn)
        losses, times = [], []
        torch.cuda.reset_peak_memory_stats(dev)
        for i in range(n_steps):
            (state, loss), ms = _timed(step, state, g, x, y, mask)
            losses.append(float(loss))
            if i > 0:
                times.append(ms)
        step_ms[(mname, path)] = times
        say(f"  {mname} {path}: losses {['%.5f' % v for v in losses]}, "
            f"step ms {['%.2f' % t for t in times]} (median "
            f"{statistics.median(times):.2f}), peak device memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{mname} {path}: non-finite loss")
        if path == "kernel" and not losses[-1] < losses[0]:
            raise AssertionError(f"{mname}: loss did not fall {losses}")
        model.zero_grad(set_to_none=True)
        return lambda: step(state, g, x, y, mask)

    for fn in counted.values():
        fn.launches = 0
    more = {}
    for mname, model in models.items():
        more[mname] = steps(mname, model, "kernel", fwd[mname]["bfloat16"],
                            1 + TRAIN_STEPS)
    launches = {k: f.launches for k, f in counted.items()}
    say(f"launches during the kernel-path steps: {launches}")
    # one more GAT step under the profiler, after the counts are read:
    # utils/profile.py --train's breakdown of the step
    _profile("GAT-2l bf16 training step", "GAT_train", more.pop("GAT-2l"),
             dev)
    del more
    for mname, model in models.items():
        steps(mname, model, "per-op", model.make_apply(torch.bfloat16), 3)
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} was not launched by the "
                                 "training steps")
    for (mname, path), v in sorted(step_ms.items()):
        say(f"step {mname} bf16 {path}: median {statistics.median(v):.3f} ms"
            f" over {len(v)} steps {['%.3f' % t for t in v]}")
    return launches


def _rel_err(y, ref) -> float:
    return float((y - ref).abs().max()) / max(1.0, float(ref.abs().max()))


def _row_rel(y, ref):
    """Each row's max |y - ref| over its own max |ref| (raised to 1e-6 of
    the largest row's, so an all-zero row must come out near zero)."""
    y, ref = y.double(), ref.double()
    scale = ref.abs().amax(dim=1)
    scale = scale.clamp(min=1e-6 * max(1.0, float(scale.max())))
    return (y - ref).abs().amax(dim=1) / scale


def bench_recipes(checks: Checks, hg, dev) -> dict:
    """Phase 6b: the root bench's two Reddit recipes on the smoke's graph.
    K9 and K10 checked (bf16 and float32) and timed (bf16) at the recipes'
    tail shapes, K10 also at GAT-2l's last layer (1 head of 41); then each
    recipe serves requests (REPEATS after a warm-up, timed with CUDA events)
    and its answer is held to the same split with a per-tile tail, within
    the bf16 end-to-end bound.  Returns K9's and K10's launches during the
    requests."""
    import torch

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import bench as B
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import dense as D
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import gat as A
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import spmm as SP
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import fixtures
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import roofline as RL
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils.benchmark import median_ms
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils.fixtures import row_terms

    recipes = {}
    for name, build in (("SpMM", B.spmm_recipe), ("GAT", B.gat_recipe)):
        for tail in ("grouped", "tiles"):
            rc = build(hg, dev, tail)
            recipes[(name, tail)] = rc
            say(f"  {name} recipe, {tail} tail: {rc.detail()}")

    rs = recipes[("SpMM", "grouped")]
    tg, x = rs.split.tiles, rs.inputs["x"]
    for dt in (torch.bfloat16, torch.float32):
        xd = x.to(dt)
        w = None if tg.weight_all_unit else tg.weight
        timed = dt == torch.bfloat16
        checks.slice_case(
            "spmm_grouped", "bench SpMM tail F=128", str(dt).split(".")[1],
            lambda: SP.spmm_grouped(tg, xd, w),
            lambda: SP._spmm_grouped_reference(tg, xd), dev,
            terms=row_terms(tg), timed_as="bench" if timed else None,
            work=lambda: RL.spmm_tail(tg, xd, 0 if w is None else 4),
            library=checks.sparse_mm(tg, xd) if timed else None,
            note=_walk_note(tg))
    # K2 on the recipe's dense blocks and K1 on its per-tile tail (the
    # bench's shapes; printed with times, not in the kernels' rows)
    rt = recipes[("SpMM", "tiles")].split
    bg, tgt = rs.split.dense, rt.tiles
    for dt in (torch.bfloat16, torch.float32):
        xd = x.to(dt)
        xs = (xd if rs.split.col_scale is None
              else xd * rs.split.col_scale[:, None].to(dt)).contiguous()
        timed = dt == torch.bfloat16
        dn = str(dt).split(".")[1]
        for kname, kern, plain, terms, work, lib in (
                ("spmm_dense_blocks",
                 lambda: D.spmm_dense_blocks(bg, xs, bg.values),
                 lambda: D._spmm_dense_reference(bg, xs, bg.values),
                 row_terms(bg), lambda: RL.spmm_dense(bg, xs), (bg, xs)),
                ("spmm_tiles", lambda: SP.spmm_tiles(tgt, xd, tgt.weight),
                 lambda: SP._spmm_reference(tgt, xd), row_terms(tgt),
                 lambda: RL.spmm_tail(tgt, xd, tgt.weight.element_size()),
                 (tgt, xd))):
            checks.compare(fixtures.KernelCase(
                kname, "bench SpMM recipe F=128", dn, kern(), plain(), None,
                terms))
            if timed:
                checks.time_call(kname, "bench", kern, plain, dev, work,
                                 checks.sparse_mm(*lib), in_row=False,
                                 stream_bytes=_stream_bytes(kname, lib[0]))
    rg = recipes[("GAT", "grouped")]
    tga, tgt = rg.split.tiles, recipes[("GAT", "tiles")].split.tiles
    terms = row_terms(tga)
    mult_bytes = 0 if tga.weight_all_unit else 4
    say(f"  K10's work list: {int(tga.live_sub.shape[0])} of {tga.n_tiles} "
        f"sub-tiles (NC G = {tga.n_chunks} x {tga.group}) hold an edge")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    for H, HD in ((HEADS, HIDDEN), (1, N_CLASS)):
        for dt in (torch.bfloat16, torch.float32):
            if HD == HIDDEN:
                h, wa, ad = (rg.inputs[k] for k in ("h", "w_asrc", "a_dst"))
            else:
                h = torch.randn((hg.n_node, HD), generator=gen, device=dev)
                wa = torch.randn((HD, H), generator=gen, device=dev) / HD**0.5
                ad = torch.randn((hg.n_node, H), generator=gen, device=dev)
            h, wa = h.to(dt), wa.to(dt)
            # the grouped hybrid path's form: one float32 a_s, which msrc
            # and K4 read too
            a_s = D._a_s_kernel(h, wa)
            ms = a_s.amax(0, keepdim=True)
            timed = dt == torch.bfloat16
            dn, shape = str(dt).split(".")[1], f"H={H} HD={HD}"
            checks.slice_case(
                "gat_grouped", f"bench GAT tail {shape}", dn,
                lambda: A.gat_grouped(tga, h, ad, ms, a_src=a_s),
                lambda: A._gat_tiles_reference(tga, h, tga.weight, ad, ms,
                                               a_src=a_s, normalize=False),
                dev, split=HD, terms=terms,
                timed_as="bench" if timed and HD == HIDDEN else None,
                work=lambda: RL.gat_tail(tga, h, H, mult_bytes,
                                         derive=False),
                note=_walk_note(tga))
            # derive mode (w_asrc: the per-node pass first), printed
            kern = lambda: A.gat_grouped(tga, h, ad, ms, wa)  # noqa: E731
            plain = lambda: A._gat_grouped_reference(  # noqa: E731
                tga, h, ad, ms, wa)
            checks.compare(fixtures.KernelCase(
                "gat_grouped", f"bench GAT tail {shape} derive", dn, kern(),
                plain(), HD, terms))
            if timed:
                checks.time_call(
                    "gat_grouped", f"{shape} derive", kern, plain, dev,
                    lambda: RL.gat_tail(tga, h, H, mult_bytes),
                    in_row=False, note=_walk_note(tga))
                if HD != HIDDEN:
                    checks.time_call(
                        "gat_grouped", f"{shape} a_src",
                        lambda: A.gat_grouped(tga, h, ad, ms, a_src=a_s),
                        lambda: A._gat_tiles_reference(
                            tga, h, tga.weight, ad, ms, a_src=a_s,
                            normalize=False),
                        dev, lambda: RL.gat_tail(tga, h, H, mult_bytes,
                                                 derive=False),
                        in_row=False, note=_walk_note(tga))
                # K3 on the same edges as a per-tile tail: the per-edge
                # rate K10 is held to
                checks.time_call(
                    "gat_tiles", f"GAT recipe per-tile tail {shape}",
                    lambda: A.gat_tiles(tgt, h, tgt.weight, ad, ms,
                                        a_src=a_s, normalize=False),
                    lambda: A._gat_tiles_reference(tgt, h, tgt.weight, ad,
                                                   ms, a_src=a_s,
                                                   normalize=False),
                    dev, lambda: RL.gat_tail(tgt, h, H, 0, derive=False),
                    in_row=False, note=_edge_note(tgt))
    del terms

    counted = {"spmm_grouped": SP.spmm_grouped, "gat_grouped": A.gat_grouped}
    for fn in counted.values():
        fn.launches = 0
    out = {}
    with torch.inference_mode():
        for name in ("SpMM", "GAT"):
            run = recipes[(name, "grouped")].run
            ms = median_ms(run, device=dev, warmup=1, repeats=REPEATS)
            out[name] = run()
            say(f"  {name} recipe, grouped tail: request {ms:.3f} ms, "
                f"{hg.n_edge / (ms * 1e-3) / 1e9:.3f} Gedge/s over "
                f"{hg.n_edge} edges")
    launches = {k: fn.launches for k, fn in counted.items()}
    say(f"launches during the recipes' requests: {launches}")
    with torch.inference_mode():
        for name in ("SpMM", "GAT"):
            run = recipes[(name, "tiles")].run
            ms = median_ms(run, device=dev, warmup=1, repeats=REPEATS)
            ref = run()
            y = out[name]
            if y.shape != ref.shape or not bool(torch.isfinite(y).all()):
                raise AssertionError(f"{name} recipe: output {y.shape}, "
                                     "finite?")
            rel = _rel_err(y, ref)
            say(f"  {name} recipe, per-tile tail: request {ms:.3f} ms; "
                f"grouped vs per-tile: relative {rel:.3e} (bound "
                f"{E2E_TOL['bfloat16']:.0e})")
            if not rel <= E2E_TOL["bfloat16"]:
                raise AssertionError(f"{name} recipe: grouped tail differs "
                                     f"from per-tile by {rel}")
    return launches, recipes


def grouped_gcn(checks: Checks, model, hg, g, dev) -> int:
    """Phase 6c: GCN-2l on PATH_GROUPED 512²/ET128 (G = 16) with the
    transposed twin, lowered once per dtype over one tile cache.  K9
    checked at both layers' shapes on the tiling and its twin (timed in
    bf16); a bf16 and a float32 request against the per-op path; float32
    loss and gradients against per-op autograd, K9 launched in the
    backward; 1 warm-up and 2 timed bf16 AdamW steps.  Returns K9's
    launches during the requests, the gradient pass and the steps."""
    import torch

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import schedule as S
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler.fusion import (
        classify_block, lower_schedule)
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models import train as TT
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import spmm as SP
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import roofline as RL
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils.fixtures import row_terms

    tc = S.TileConfig(512, 512, 128, S.PATH_GROUPED)
    scheds = []
    for layer in model.layers:
        part = S.aggregation_partition(layer)
        scheds.append(S.Schedule(blocks=part, tiles=tuple(
            tc if classify_block(layer, b, tc)[0] == "spmm_grouped"
            else S.TileConfig(path=S.PATH_XLA) for b in part)))
    cache: dict = {}
    fns = {}
    for dtn, dt in (("bfloat16", torch.bfloat16), ("float32", None)):
        t0 = time.perf_counter()
        fns[dtn] = [lower_schedule(layer, s, hg, dt, device=dev,
                                   build_transpose=True, tile_cache=cache)
                    for layer, s in zip(model.layers, scheds)]
        say(f"  {dtn} lowering (grouped tiling, transposed graph and twin "
            f"on the first) {time.perf_counter() - t0:.1f} s")
    (tg, twin), = {(id(d), id(t)): (d, t) for fn in fns["bfloat16"]
                   for k, _, d, t in fn.plans if k == "spmm_grouped"}.values()
    for what, t in (("tiling", tg), ("twin", twin)):
        say(f"  GCN-2l grouped {what}: {t.n_chunks} chunks, {t.total_slots} "
            f"slots for {RL.live_slots(t)} edges "
            f"({t.total_slots / max(RL.live_slots(t), 1):.1f} slots per "
            "edge)")

    def stack(layer_fns):
        def apply(params, gg, x):
            for fn in layer_fns:
                x = fn(params, gg, x)
            return x
        return apply

    # Here the hub rows sit in the tail (up to ~209k terms in a row) and
    # their random-sign terms cancel, so the f32 reordering error of the
    # atomics scales with the sum of |terms|, not with |sum|: each cell is
    # held to its sum of term magnitudes, as the backward kernels are.
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    for li, F in enumerate((HIDDEN, N_CLASS)):
        for what, t in (("", tg), (" twin", twin)):
            terms = row_terms(t)
            for dt in (torch.bfloat16, torch.float32):
                x = torch.randn((hg.n_node, F), generator=gen,
                                device=dev).to(dt)
                timed = dt == torch.bfloat16
                checks.slice_case(
                    "spmm_grouped", f"GCN l{li}{what} F={F}",
                    str(dt).split(".")[1],
                    lambda: SP.spmm_grouped(t, x, t.weight),
                    lambda: SP._spmm_grouped_reference(t, x), dev,
                    terms=terms, scale=SP._spmm_grouped_reference(
                        t, x.abs(), weight=t.weight.abs()),
                    timed_as=f"l{li}{what}" if timed else None,
                    work=lambda: RL.spmm_tail(t, x, 4),
                    library=checks.sparse_mm(t, x) if timed else None,
                    note=_walk_note(t))

    rng = np.random.default_rng(11)
    x = torch.tensor(rng.standard_normal((hg.n_node, F_IN),
                                         dtype=np.float32), device=dev)
    SP.spmm_grouped.launches = 0
    with torch.inference_mode():
        params = dict(model.params)
        for dtn, dt in (("bfloat16", torch.bfloat16), ("float32", None)):
            y = stack(fns[dtn])(params, g, x)
            ref = model.make_apply(dt)(params, g, x)
            if tuple(y.shape) != (hg.n_node, N_CLASS) or not bool(
                    torch.isfinite(y).all()):
                raise AssertionError(f"GCN-2l grouped {dtn}: bad output")
            rel = _rel_err(y, ref)
            say(f"  GCN-2l grouped {dtn} request: relative {rel:.3e} to the "
                f"per-op path (bound {E2E_TOL[dtn]:.0e})")
            if not rel <= E2E_TOL[dtn]:
                raise AssertionError(f"GCN-2l grouped {dtn}: {rel}")
    say(f"  K9 launches in the two requests: {SP.spmm_grouped.launches}")
    if SP.spmm_grouped.launches <= 0:
        raise AssertionError("K9 was not launched in the forward")
    wy = torch.tensor(rng.standard_normal((F_IN, N_CLASS), dtype=np.float32),
                      device=dev)
    labels = (x @ wy).argmax(dim=1)
    mask = torch.ones(hg.n_node, dtype=torch.bool, device=dev)
    res = {}
    for path, fn in (("kernel", stack(fns["float32"])),
                     ("per-op", model.make_apply(None))):
        model.zero_grad(set_to_none=True)
        loss = TT.masked_cross_entropy(fn(dict(model.params), g, x), labels,
                                       mask)
        before = SP.spmm_grouped.launches
        loss.backward()
        if path == "kernel":
            bwd = SP.spmm_grouped.launches - before
            say(f"  K9 launches in the float32 backward: {bwd}")
            if bwd <= 0:
                raise AssertionError("K9 was not launched in the backward")
        res[path] = (loss.item(), {k: p.grad.detach().clone()
                                   for k, p in model.params.items()
                                   if p.grad is not None})
    (lk, gk), (lr, gr) = res["kernel"], res["per-op"]
    rel = abs(lk - lr) / max(1.0, abs(lr))
    say(f"  GCN-2l grouped float32 loss {lk:.6f}, per-op {lr:.6f}, relative "
        f"{rel:.3e}")
    if not rel <= GRAD_TOL["loss"] or set(gk) != set(gr):
        raise AssertionError(f"GCN-2l grouped loss {lk} vs {lr}")
    for k in gr:
        err = float((gk[k] - gr[k]).abs().max()) / float(gr[k].abs().max())
        say(f"  GCN-2l grouped d{k}: relative {err:.3e}")
        if not (bool(torch.isfinite(gk[k]).all())
                and err <= GRAD_TOL["grad"]):
            raise AssertionError(f"GCN-2l grouped d{k}: {err}")
    model.zero_grad(set_to_none=True)

    state = TT.TrainState(model.params, TT.adamw(model.params, LR))
    step = TT.make_train_step(stack(fns["bfloat16"]))
    losses, times = [], []
    for i in range(3):
        (state, loss), ms = _timed(step, state, g, x, labels, mask)
        losses.append(float(loss))
        if i > 0:
            times.append(ms)
    say(f"  GCN-2l grouped bf16 steps: losses "
        f"{['%.5f' % v for v in losses]}, step ms "
        f"{['%.3f' % t for t in times]}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"GCN-2l grouped steps: losses {losses}")
    model.zero_grad(set_to_none=True)
    return SP.spmm_grouped.launches


def grouped_phase(checks: Checks, model, hg, g, dev) -> tuple:
    """Phase 6; returns K9's and K10's launches on its main-path runs and
    the bench recipes it built."""
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import fixtures
    t0 = time.perf_counter()
    say("== 6a grouped kernels K9, K10: edge cases")
    for c in fixtures.grouped_kernel_cases(dev):
        checks.compare(c)
    say("== 6b the root bench's Reddit recipes on the smoke's graph")
    launches, recipes = bench_recipes(checks, hg, dev)
    checks.csr.clear()
    say("== 6c GCN-2l on PATH_GROUPED with the transposed twin")
    launches["spmm_grouped"] += grouped_gcn(checks, model, hg, g, dev)
    checks.csr.clear()
    say(f"launches of K9, K10 in phase 6: {launches}; phase 6 took "
        f"{time.perf_counter() - t0:.1f} s")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} was not launched in phase 6")
    return launches, recipes


def _request_x(seed: int, n: int, dev):
    import torch
    return torch.tensor(np.random.default_rng(seed).standard_normal(
        (n, F_IN), dtype=np.float32), device=dev)


def reduced_graph(dev):
    """(host graph, device graph) of phase 7b's and 8d's reduced graph: a
    tenth of the smoke's edges from the same generator, self loops,
    symmetric norm and the hubs+labels reorder."""
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import graph as G
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.data.datasets import synthetic_coo
    t0 = time.perf_counter()
    s, r, labels = synthetic_coo(N_NODE, REDUCED_EDGES, seed=1,
                                 communities=1000, p_in=0.7)
    hr = G.build_host_graph(s, r, N_NODE, add_self_loops=True,
                            symmetric_norm=True)
    hr, _ = G.reorder_nodes(hr, "hubs+labels", labels=labels)
    say(f"  reduced graph: N={hr.n_node} E={hr.n_edge}, host build "
        f"{time.perf_counter() - t0:.1f} s")
    return hr, hr.to_device(dev)


def pair_agg_checks(checks: Checks, plans, tg, dev, n: int) -> None:
    """K13 at each pair-agg layer's shape on the model's tiling, in bf16 and
    float32, sum, max and count apart (the sum scaled by each cell's sum of
    |term|, as in the fixture cases), timed in bf16."""
    import torch

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import ir
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import pairagg as PA
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import roofline as RL
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils.fixtures import KernelCase

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    for mname, li, plan in plans:
        D, want_max = plan.width, ir.MAX in plan.gathers
        kw = dict(sf=plan.sf, slope=plan.slope, want_max=want_max)
        what = f"{mname} l{li} D={D} {'+'.join(sorted(plan.gathers))}"
        for dt in (torch.bfloat16, torch.float32):
            name = str(dt).split(".")[1]
            u, v = (torch.randn((n, D), generator=gen, device=dev).to(dt)
                    for _ in range(2))
            out = PA.pair_agg(tg, u, v, **kw)
            ref = PA._pair_agg_reference(tg, u, v, **kw)
            mag = PA._pair_agg_reference(tg, u, v, magnitude=True, **kw)[0]
            checks.compare(KernelCase("pair_agg", f"sum {what}", name, out[0],
                                      ref[0], terms=ref[2][:, 0], scale=mag),
                           slice_shape=True)
            if want_max:
                checks.compare(KernelCase("pair_agg", f"max {what}", name,
                                          out[1], ref[1]), slice_shape=True)
            checks.compare(KernelCase("pair_agg", f"count {what}", name,
                                      out[2], ref[2]), slice_shape=True)
            del out, ref, mag
            if dt == torch.bfloat16:
                checks.time_call(
                    "pair_agg", f"{mname[:3]} l{li}",
                    lambda: PA.pair_agg(tg, u, v, **kw),
                    lambda: PA._pair_agg_reference(tg, u, v, **kw), dev,
                    lambda: RL.pair_agg(tg, u, want_max))


def pair_agg_models(checks: Checks, hg, g, dev) -> int:
    """Phase 7b: DGN-2l and PNA-2l ('original' PNA) at 602/128/41 with
    their pair chains on K13 (``pair_agg_partition``, the chain on
    1024²/ET512 ``onehot``, the rest op by op), lowered once per dtype;
    each lowering tiles the graph once for its two layers.  K13 checked
    and timed at each layer's shape on the model's tiling; 3 bf16 and 1
    float32 requests per model on the smoke's graph (finite, right shape:
    the per-op path cannot hold these models there); then on a reduced
    graph of the same generator each served answer against the per-op
    path (bf16 against bf16; float32 against the per-op path in float64,
    since the per-op path's own float32 sums over a hub row of ~2e4
    same-signed terms drift by more than the bound, which is printed),
    row by row, each row's error over its own max |answer|, since hub rows
    run orders of magnitude above the rest; and float32 losses and
    gradients against float64 per-op autograd.  Returns K13's launches
    during the served requests."""
    import torch

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import schedule as S
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler.fusion import (
        classify_block, pair_agg_schedules)
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models import train as TT
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models.zoo import build_model
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import pairagg as PA
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import roofline as RL

    tc = S.TileConfig(*PAIR_TILE, S.PATH_ONEHOT)
    gen = torch.Generator().manual_seed(4)
    models = {f"{net}-2l": build_model(net, F_IN, N_CLASS, hidden=HIDDEN,
                                       n_layers=2, generator=gen, device=dev)
              for net in ("DGN", "PNA")}
    scheds = {m: pair_agg_schedules(model.layers, tile=tc)
              for m, model in models.items()}
    dtypes = (("bfloat16", torch.bfloat16), ("float32", None))
    fwd = {}
    for mname, model in models.items():
        t0 = time.perf_counter()
        fwd[mname] = {dtn: model.make_apply(dt, schedules=scheds[mname],
                                            host_graph=hg, device=dev)
                      for dtn, dt in dtypes}
        say(f"  {mname}: schedules {[s.key()[:40] for s in scheds[mname]]}, "
            f"lowered in {time.perf_counter() - t0:.1f} s")
        found = [(mname, li, classify_block(model.layers[li], block, tc)[1],
                  data)
                 for li, fn in enumerate(fwd[mname]["bfloat16"].layer_fns)
                 for kind, block, data, _ in fn.plans if kind == "pair_agg"]
        if len(found) != len(model.layers):
            raise AssertionError(f"{mname}: expected one pair-agg block per "
                                 f"layer, found {len(found)}")
        tg = found[0][3]
        live, slots = RL.live_slots(tg), tg.src_local.numel()
        say(f"  {mname} pair-agg tiling {PAIR_TILE}: {tg.n_tiles} tiles, "
            f"{slots} slots for {live} edges ({slots / live:.2f} slots per "
            "edge)")
        # the lowering built K13's work list; built again here to time it
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        work = PA._build_pair_work(tg, hg.n_node)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        longest = int(torch.diff(work.chunk_ptr.long()).max())
        say(f"  {mname} K13 work list: built in {ms:.1f} ms, "
            f"{work.slot_src.numel()} slots in {work.n_chunks} chunks of at "
            f"most {PA.PAIR_CHUNK} ({longest} in the longest), "
            f"{work.split_rows.numel()} of {hg.n_node} rows cut")
        del work
        for f in found:
            pair_agg_checks(checks, [f[:3]], f[3], dev, hg.n_node)

    PA.pair_agg.launches = 0
    lat = {}
    with torch.inference_mode():
        for mname, model in models.items():
            params = dict(model.params)
            for dtn, seed in [("bfloat16", i) for i in range(REQUESTS)] + [
                    ("float32", 0)]:
                y, ms = _timed(fwd[mname][dtn], params, g,
                               _request_x(seed, hg.n_node, dev))
                if tuple(y.shape) != (hg.n_node, N_CLASS) or not bool(
                        torch.isfinite(y).all()):
                    raise AssertionError(f"{mname} {dtn}: bad output")
                lat.setdefault((mname, dtn), []).append(ms)
                say(f"  {mname} {dtn} request seed={seed}: {ms:.2f} ms")
    launches = PA.pair_agg.launches
    say(f"  K13 launches during the requests: {launches}")
    for (mname, dtn), v in sorted(lat.items()):
        say(f"latency {mname} {dtn} kernel: median "
            f"{statistics.median(v):.3f} ms over {len(v)} requests "
            f"{['%.3f' % t for t in v]}")
    del fwd

    hr, gr = reduced_graph(dev)
    rng = np.random.default_rng(12)
    wy = torch.tensor(rng.standard_normal((F_IN, N_CLASS), dtype=np.float32),
                      device=dev)
    mask = torch.ones(hr.n_node, dtype=torch.bool, device=dev)
    for mname, model in models.items():
        fns = {dtn: model.make_apply(dt, schedules=scheds[mname],
                                     host_graph=hr, device=dev)
               for dtn, dt in dtypes}
        x = _request_x(20, hr.n_node, dev)
        p64 = {k: p.detach().double() for k, p in model.params.items()}
        with torch.inference_mode():
            params = dict(model.params)
            ref64 = model.make_apply(None)(p64, gr, x.double())
            peak = float(ref64.abs().max())
            rel = _rel_err(model.make_apply(None)(params, gr, x), ref64)
            say(f"  {mname} reduced graph: per-op float32 vs per-op float64 "
                f"relative {rel:.3e}, max |answer| {peak:.4g}")
            for dtn, dt in dtypes:
                y = fns[dtn](params, gr, x)
                ref = ref64 if dt is None else model.make_apply(dt)(
                    params, gr, x)
                rows = _row_rel(y, ref)
                worst, med = float(rows.max()), float(rows.median())
                say(f"  {mname} reduced graph {dtn}: against the per-op path "
                    f"in {'float64' if dt is None else dtn}, relative "
                    f"{_rel_err(y, ref):.3e} of max |answer|; per row of its "
                    f"own max: worst {worst:.3e}, 99.9% "
                    f"{float(rows.quantile(0.999)):.3e}, median {med:.3e} "
                    f"(bound {E2E_TOL[dtn]:.0e} on every row)")
                if dt is not None:
                    k64, p64r = (_row_rel(a, ref64) for a in (y, ref))
                    say(f"  {mname} reduced graph {dtn} against float64 per "
                        f"row: kernel path worst {float(k64.max()):.3e} "
                        f"median {float(k64.median()):.3e}; per-op path worst "
                        f"{float(p64r.max()):.3e} median "
                        f"{float(p64r.median()):.3e}")
                    del k64, p64r
                if not (bool(torch.isfinite(y).all())
                        and worst <= E2E_TOL[dtn]):
                    raise AssertionError(f"{mname} reduced {dtn}: a row's "
                                         f"relative error is {worst}")
            del y, ref, ref64
        # The layers are positively homogeneous in x: scaled so the logits
        # are O(LOGIT_SCALE), the softmax does not saturate, where the f32
        # rounding of a near-tie would flip a row's gradient by O(1).
        x = x * (LOGIT_SCALE / peak)
        labels_r = (x @ wy).argmax(dim=1)
        model.zero_grad(set_to_none=True)
        loss = TT.masked_cross_entropy(
            fns["float32"](dict(model.params), gr, x), labels_r, mask)
        loss.backward()
        lk, gk = loss.item(), {k: p.grad.detach().clone()
                               for k, p in model.params.items()}
        p64 = {k: v.requires_grad_() for k, v in p64.items()}
        loss = TT.masked_cross_entropy(
            model.make_apply(None)(p64, gr, x.double()), labels_r, mask)
        loss.backward()
        lr, gref = loss.item(), {k: v.grad.float() for k, v in p64.items()}
        del loss, p64
        rel = abs(lk - lr) / max(1.0, abs(lr))
        say(f"  {mname} reduced graph float32 loss {lk:.6f}, per-op float64 "
            f"{lr:.6f}, relative {rel:.3e}")
        if not rel <= GRAD_TOL["loss"]:
            raise AssertionError(f"{mname} loss {lk} vs per-op {lr}")
        for k in gref:
            err = float((gk[k] - gref[k]).abs().max()) / float(
                gref[k].abs().max())
            say(f"  {mname} d{k}: relative {err:.3e}")
            if not (bool(torch.isfinite(gk[k]).all())
                    and err <= GRAD_TOL["grad"]):
                raise AssertionError(f"{mname} d{k}: {err}")
        model.zero_grad(set_to_none=True)
        del gk, gref, fns
    return launches


def k11_walk_and_library(checks: Checks, tg, xs, xd, H: int, what: str,
                         dev, library) -> None:
    """At one of K11's timed shapes: the walk it takes (``ops/sddmm.
    k11_walk``, named by the launch), and ``library`` (``sampled_addmm``)
    timed beside it where it is not already in the kernel's row (at H > 1:
    one head over the same F-wide rows, a yardstick, not the same
    function)."""
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import sddmm as SD
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import roofline as RL
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils.fixtures import _slots
    SD.sddmm_tiles(tg, xs, xd, H)
    say(f"  sddmm_tiles        {what}: walk {SD.k11_walk()!r}")
    if library is None:
        return
    kern = lambda: _slots(SD.sddmm_tiles(tg, xs, xd, H))  # noqa: E731
    plain = lambda: _slots(SD._sddmm_reference(tg, xs, xd, H))  # noqa: E731
    work = lambda: RL.sddmm_tail(tg, xs, xd, H)  # noqa: E731
    lib = library
    if H > 1:
        lib = lambda: library()  # noqa: E731
        lib.label = f"{library.label}, one head of the same rows"
    checks.time_call("sddmm_tiles", what, kern, plain, dev, work, lib,
                     in_row=False, note=_edge_note(tg))


def sddmm_gat(checks: Checks, model, hg, g, dev) -> int:
    """Phase 7c: GAT-2l with each layer's logit block on the ``sddmm``
    kind (K11 over a 1024²/ET512 ``onehot`` tiling), the rest op by
    op.  K11 checked at the ADD shapes (heads 4 and 1 of per-head width 2:
    [a | 1] . [1 | b]), timed in bf16; one bf16 and one float32 request
    against the per-op path.  Returns K11's launches during the
    requests."""
    import torch

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import schedule as S
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler.fusion import sddmm_schedules
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import sddmm as SD
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import roofline as RL
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils.fixtures import _slots

    scheds = sddmm_schedules(model.layers,
                             tile=S.TileConfig(*PAIR_TILE, S.PATH_ONEHOT))
    dtypes = (("bfloat16", torch.bfloat16), ("float32", None))
    t0 = time.perf_counter()
    fns = {dtn: model.make_apply(dt, schedules=scheds, host_graph=hg,
                                 device=dev)
           for dtn, dt in dtypes}
    say(f"  GAT-2l: schedules {[s.key()[:40] for s in scheds]}, lowered in "
        f"{time.perf_counter() - t0:.1f} s")
    tg, = {id(d): d for fn in fns["bfloat16"].layer_fns
           for k, _, d, _ in fn.plans if k == "sddmm"}.values()
    n = hg.n_node
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    for li, H in enumerate((HEADS, 1)):
        for dt in (torch.bfloat16, torch.float32):
            name = str(dt).split(".")[1]
            a, b = (torch.randn((n, H), generator=gen, device=dev).to(dt)
                    for _ in range(2))
            xs = torch.stack([a, torch.ones_like(a)], 2).view(n, 2 * H)
            xd = torch.stack([torch.ones_like(b), b], 2).view(n, 2 * H)
            timed = dt == torch.bfloat16
            kern = lambda: _slots(SD.sddmm_tiles(tg, xs, xd, H))  # noqa: E731
            plain = lambda: _slots(SD._sddmm_reference(tg, xs, xd, H))  # noqa: E731
            work = lambda: RL.sddmm_tail(tg, xs, xd, H)  # noqa: E731
            lib = checks.sampled_addmm(tg, xs, xd) if timed else None
            checks.slice_case(
                "sddmm_tiles", f"GAT l{li} ADD H={H} P=2", name, kern, plain,
                dev, scale=_slots(SD._sddmm_reference(tg, xs.abs(),
                                                      xd.abs(), H)),
                timed_as=f"GAT l{li} ADD" if timed and H == 1 else None,
                work=work, library=lib if H == 1 else None,
                note=_edge_note(tg))
            if timed:
                k11_walk_and_library(checks, tg, xs, xd, H, f"GAT l{li} ADD",
                                  dev, lib if H > 1 else None)
    checks.csr.clear()

    reqs = (("bfloat16", 0), ("float32", 0))
    params = dict(model.params)
    SD.sddmm_tiles.launches = 0
    outs = {}
    with torch.inference_mode():
        for dtn, seed in reqs:
            outs[dtn], ms = _timed(fns[dtn], params, g,
                                   _request_x(seed, n, dev))
            say(f"  GAT-2l sddmm kind {dtn} request: {ms:.2f} ms")
    launches = SD.sddmm_tiles.launches
    say(f"  K11 launches during the requests: {launches}")
    with torch.inference_mode():
        for dtn, seed in reqs:
            ref = model.make_apply(dict(dtypes)[dtn])(
                params, g, _request_x(seed, n, dev))
            y = outs.pop(dtn)
            rel = _rel_err(y, ref)
            say(f"  GAT-2l sddmm kind {dtn}: relative {rel:.3e} to the "
                f"per-op path (bound {E2E_TOL[dtn]:.0e})")
            if not (tuple(y.shape) == (n, N_CLASS)
                    and bool(torch.isfinite(y).all())
                    and rel <= E2E_TOL[dtn]):
                raise AssertionError(f"GAT-2l sddmm kind {dtn}: {rel}")
            del ref, y
    return launches


def hybrid_sddmm(checks: Checks, recipes, hg, dev) -> dict:
    """Phase 7d: the hybrid SDDMM of ``scripts/reddit_bench.py:220-242`` on
    phase 6's SpMM recipe split (dense-block logits by
    ``sddmm_dense_blocks``, the grouped tail's by K12) and on the same
    split with a per-tile tail (K11); F = 128, one head, bf16.  K12 and K11
    checked (bf16 and float32) and timed (bf16) at those tails, then at 4
    heads on the GAT recipe's tails (as ``scripts/hw_parity.py:285-292``);
    grouped and per-tile logits compared in edge order at the bf16 bound.
    Returns K11's and K12's launches during the hybrid requests."""
    import torch

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import dense as D
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import sddmm as SD
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import roofline as RL
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils.benchmark import median_ms
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils.fixtures import _slots

    n = hg.n_node
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    kernels = {"grouped": ("sddmm_grouped", SD.sddmm_grouped,
                           SD._sddmm_grouped_reference),
               "tiles": ("sddmm_tiles", SD.sddmm_tiles, SD._sddmm_reference)}

    def check(tg, tail, what, xs0, xd0, H, in_row):
        kernel, kern_fn, plain_fn = kernels[tail]
        note = _edge_note(tg) if tail == "tiles" else None
        for dt in (torch.bfloat16, torch.float32):
            xs, xd = xs0.to(dt), xd0.to(dt)
            kern = lambda: _slots(kern_fn(tg, xs, xd, H))  # noqa: E731
            plain = lambda: _slots(plain_fn(tg, xs, xd, H))  # noqa: E731
            work = lambda: RL.sddmm_tail(tg, xs, xd, H)  # noqa: E731
            timed = dt == torch.bfloat16
            lib = checks.sampled_addmm(tg, xs, xd) if timed else None
            checks.slice_case(
                kernel, f"{what} {tail} tail H={H}", str(dt).split(".")[1],
                kern, plain, dev, scale=_slots(plain_fn(tg, xs.abs(),
                                                        xd.abs(), H)),
                timed_as=what if timed and in_row else None, work=work,
                library=lib if in_row else None, note=note)
            if timed and not in_row:
                checks.time_call(kernel, what, kern, plain, dev, work,
                                 in_row=False, note=note)
            if timed and tail == "tiles":
                k11_walk_and_library(checks, tg, xs, xd, H, what, dev,
                                  None if in_row else lib)

    def edge_order(tg, e):
        return SD.tiles_to_edges(tg, e, int(tg.edge_id.max()) + 1)

    def agree(what, tgs, es):
        a, b = (edge_order(t, e) for t, e in zip(tgs, es))
        rel = _rel_err(a, b)
        say(f"  {what}: grouped vs per-tile logits in edge order, relative "
            f"{rel:.3e} (bound {E2E_TOL['bfloat16']:.0e})")
        if not (a.shape == b.shape and rel <= E2E_TOL["bfloat16"]):
            raise AssertionError(f"{what}: grouped and per-tile logits "
                                 f"differ by {rel}")

    splits = {t: recipes[("SpMM", t)].split for t in ("grouped", "tiles")}
    x = recipes[("SpMM", "grouped")].inputs["x"]
    p = torch.randn((n, x.shape[1]), generator=gen, device=dev).to(x.dtype)
    for tail, sp in splits.items():
        check(sp.tiles, tail, "hybrid F=128", x, p, 1, True)
    checks.csr.clear()

    def hybrid(sp):
        def run():
            e_tail = SD.sddmm(sp.tiles, x, p, heads=1)
            e_blk = (D.sddmm_dense_blocks(sp.dense, x, p)
                     if sp.dense is not None else None)
            return e_tail, e_blk
        return run

    SD.sddmm_tiles.launches = SD.sddmm_grouped.launches = 0
    outs = {}
    with torch.inference_mode():
        for tail, sp in splits.items():
            ms = median_ms(hybrid(sp), device=dev, warmup=1, repeats=REPEATS)
            outs[tail] = hybrid(sp)()
            say(f"  hybrid SDDMM F=128, {tail} tail: {ms:.3f} ms, "
                f"{hg.n_edge / (ms * 1e-3) / 1e9:.3f} Gedge/s over "
                f"{hg.n_edge} edges")
    launches = {"sddmm_tiles": SD.sddmm_tiles.launches,
                "sddmm_grouped": SD.sddmm_grouped.launches}
    say(f"  launches during the hybrid SDDMM requests: {launches}")
    agree("hybrid SDDMM tail", [splits[t].tiles for t in outs],
          [outs[t][0] for t in outs])
    if not torch.equal(outs["grouped"][1], outs["tiles"][1]):
        raise AssertionError("the two splits' dense-block logits differ")
    del outs

    gat = {t: recipes[("GAT", t)].split.tiles for t in ("grouped", "tiles")}
    h = recipes[("GAT", "grouped")].inputs["h"]
    q = torch.randn(h.shape, generator=gen, device=dev).to(h.dtype)
    for tail, tg in gat.items():
        check(tg, tail, "GAT tail", h, q, HEADS, False)
    with torch.inference_mode():
        agree("GAT recipe tail, 4 heads", list(gat.values()),
              [SD.sddmm(t, h, q, heads=HEADS) for t in gat.values()])
    return launches


def sddmm_pair_phase(checks: Checks, gat_model, recipes, hg, g,
                     dev) -> dict:
    """Phase 7; returns K11's, K12's and K13's launches on its main-path
    runs (7b's and 7c's requests, 7d's hybrid SDDMM requests)."""
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import fixtures
    t0 = time.perf_counter()
    say("== 7a SDDMM and pair-aggregate kernels K11-K13: edge cases")
    for c in (*fixtures.sddmm_kernel_cases(dev),
              *fixtures.pair_agg_kernel_cases(dev)):
        checks.compare(c)
    say("== 7b DGN-2l and PNA-2l on the pair-aggregate kernel")
    launches = {"pair_agg": pair_agg_models(checks, hg, g, dev)}
    say("== 7c GAT-2l with its logit blocks on the sddmm kind")
    launches["sddmm_tiles"] = sddmm_gat(checks, gat_model, hg, g, dev)
    say("== 7d the hybrid SDDMM on the bench recipes' splits")
    d = hybrid_sddmm(checks, recipes, hg, dev)
    launches["sddmm_tiles"] += d["sddmm_tiles"]
    launches["sddmm_grouped"] = d["sddmm_grouped"]
    checks.csr.clear()
    say(f"launches of K11-K13 in phase 7: {launches}; phase 7 took "
        f"{time.perf_counter() - t0:.1f} s")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} was not launched in phase 7")
    return launches


def _loss_and_grads(model, f, g, x, labels, mask) -> tuple:
    """Float32 loss and every parameter's gradient of ``f`` at the model's
    parameters, and the seconds the forward and backward took."""
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models import train as TT
    model.zero_grad(set_to_none=True)
    t0 = time.perf_counter()
    loss = TT.masked_cross_entropy(f(dict(model.params), g, x), labels, mask)
    loss.backward()
    out = (loss.item(), {k: p.grad.detach().clone()
                         for k, p in model.params.items()})
    model.zero_grad(set_to_none=True)
    return out + (time.perf_counter() - t0,)


def _recording(fn):
    """``fn`` layer by layer, keeping the input it gave each layer
    (detached) in ``.inputs`` after every call."""
    def apply(params, g, x):
        apply.inputs = []
        h = x
        for lf in fn.layer_fns:
            apply.inputs.append(h.detach())
            h = lf(params, g, h)
        return h

    return apply


def _per_op_at_layer_inputs(model, inputs):
    """The per-op path with every layer after the first evaluated at
    ``inputs`` (what one evaluation of the kernel path gave each layer,
    :func:`_recording`): the value is the kernel path's, the gradient flows
    into the per-op path's own previous layer.  GAT's leaky relu has a kink
    at logit 0; a layer-1 logit within the two forwards' rounding of 0 (or
    within the rounding of the kernel path's float32 atomics from one
    evaluation to the next) takes the other branch in each, which moves
    every upstream gradient by far more than rounding, while each gradient
    is right for its own forward.  At the same layer inputs both paths
    take the same branches, so the comparison measures the backward alone;
    the forward is held by the loss and by the served answers' checks."""
    import torch

    class AtValue(torch.autograd.Function):
        @staticmethod
        def forward(ctx, own, value):
            if own.shape != value.shape or own.dtype != value.dtype:
                raise AssertionError(f"layer input {tuple(own.shape)} "
                                     f"{own.dtype} vs the kernel path's "
                                     f"{tuple(value.shape)} {value.dtype}")
            return value.clone()

        @staticmethod
        def backward(ctx, gy):
            return gy, None

    ref = model.make_apply(None)
    if len(ref.layer_fns) != len(inputs):
        raise AssertionError("the kernel path and the per-op path have "
                             "different layer counts")

    def apply(params, g, x):
        h = x
        for i, lf in enumerate(ref.layer_fns):
            if i:
                h = AtValue.apply(h, inputs[i])
            h = lf(params, g, h)
        return h

    return apply


def _grads_against_per_op(what: str, model, fn, g, x, labels, mask,
                          spread: bool = False) -> None:
    """Float32 loss of ``fn`` against the per-op path, within GRAD_TOL, and
    every parameter's gradient against autograd of the per-op path at the
    layer inputs of the same evaluation of ``fn``
    (:func:`_per_op_at_layer_inputs`), within GRAD_TOL; the gradients of
    the per-op path's own forward are printed beside them.  With
    ``spread`` (the trained parameters), the kernel path and the reference
    run SPREAD_EVALS times and a leaf's bound is the larger of GRAD_TOL and
    SPREAD_X times the reference's own spread in this run (its float32
    atomics reorder from one evaluation to the next): at trained parameters
    a leaf whose terms cancel can be small beside its rounding noise."""
    import torch

    n = SPREAD_EVALS if spread else 1
    at = "per-op at the kernel path's layer inputs"
    kfn = _recording(fn)
    res = {"kernel": [_loss_and_grads(model, kfn, g, x, labels, mask)]}
    inputs = kfn.inputs
    res["kernel"] += [_loss_and_grads(model, kfn, g, x, labels, mask)
                      for _ in range(n - 1)]
    for path, f, evals in (("per-op", model.make_apply(None), 1),
                           (at, _per_op_at_layer_inputs(model, inputs), n)):
        res[path] = [_loss_and_grads(model, f, g, x, labels, mask)
                     for _ in range(evals)]
    del inputs
    for path, r in res.items():
        say(f"  {what} {path}: loss {r[0][0]:.6f}, forward + backward "
            f"{r[0][2]:.2f} s")
    (lk, gk, _), (lr, gown, _) = res["kernel"][0], res["per-op"][0]
    gr = res[at][0][1]
    rel = abs(lk - lr) / max(1.0, abs(lr))
    say(f"  {what} loss: relative {rel:.3e} (bound {GRAD_TOL['loss']:.0e})")
    if not rel <= GRAD_TOL["loss"]:
        raise AssertionError(f"{what}: loss {lk} vs per-op {lr}")

    def dev_from(ref, evals):   # the largest of max |grad - ref| / max |ref|
        return max([0.0] + [float((e[1][k] - ref).abs().max())
                            / float(ref.abs().max()) for e in evals])
    for k in gr:
        err = dev_from(gr[k], res["kernel"][:1])
        bound, extra = GRAD_TOL["grad"], ""
        if spread:
            own = dev_from(gr[k], res[at][1:])
            k_own = dev_from(gk[k], res["kernel"][1:])
            bound = max(bound, SPREAD_X * own)
            extra = (f"; the reference's own spread {own:.3e}, the kernel "
                     f"path's {k_own:.3e}")
        unaligned = float((gk[k] - gown[k]).abs().max()) / float(
            gown[k].abs().max())
        say(f"  {what} d{k}: relative {err:.3e} (bound {bound:.3e}){extra}; "
            f"to the per-op path's own forward {unaligned:.3e}")
        if not (bool(torch.isfinite(gk[k]).all()) and err <= bound):
            raise AssertionError(f"{what} d{k}: {err}")


def _grads_at_both_states(what: str, model, fn, init_params, g, x, labels,
                          mask) -> None:
    """:func:`_grads_against_per_op` at the parameters the model holds (the
    trained state the earlier phases left), with the per-op spread, and at
    its seeded initial parameters (``init_params``), with GRAD_TOL alone, as
    5c; the trained parameters are put back after."""
    trained = {k: p.detach().clone() for k, p in model.params.items()}
    _grads_against_per_op(f"{what}, trained", model, fn, g, x, labels, mask,
                          spread=True)
    _restore(model, init_params)
    _grads_against_per_op(f"{what}, initial", model, fn, g, x, labels, mask)
    _restore(model, trained)


def layer_domain(tg, a_s, a_d, slope: float = 0.2) -> tuple:
    """(min, max) of the logits leaky(a_s[s] + a_d[d]) over the live slots
    of ``tg``, and the rows in which every live slot's p = exp(min(e,
    SHIFT + 60) - SHIFT) underflows to 0 in some head: where the whole-layer
    kernel leaves the exact softmax."""
    import torch

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import gat as A
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops.spmm import (
        _live_slots, _unit_steps)
    n, H = a_d.shape
    lo, hi = float("inf"), float("-inf")
    live = torch.zeros((n, H), dtype=torch.int32, device=a_d.device)
    seen = torch.zeros((n, 1), dtype=torch.int32, device=a_d.device)
    for t0, t1 in _unit_steps(tg, 8 * H):
        _, src, dst = _live_slots(tg, t0, t1)
        e = A._leaky(a_s.index_select(0, src).float()
                     + a_d.index_select(0, dst), slope)
        lo, hi = min(lo, float(e.min())), max(hi, float(e.max()))
        p = torch.exp(torch.clamp(e, max=A.SHIFT + 60.0) - A.SHIFT)
        live.index_add_(0, dst, (p > 0).int())
        seen.index_add_(0, dst, torch.ones_like(dst, dtype=torch.int32)[:, None])
    dead = int(((seen > 0) & (live == 0)).any(dim=1).sum())
    return lo, hi, dead


def layer_stage_times(checks: Checks, tg, xk, w, ws, wd, kw, li: int,
                      dev) -> None:
    """Phase 8b, per layer in bf16: K14's stages timed apart (printed, not
    in the kernel's row).  The projection on ``xk`` (x as the lowering
    casts it, contiguous) beside its own bound and ``torch.matmul`` of the
    same product; the walk on that projection with its edges per second;
    the epilogue."""
    import torch

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import gat as A
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import roofline as RL
    HD, H = w.shape[1], ws.shape[1]
    mm = lambda: torch.matmul(xk, w)  # noqa: E731
    mm.label = "torch.matmul (x W alone)"
    checks.time_call(
        "gat_layer", f"l{li} projection",
        lambda: A.gat_layer_projection(xk, w, ws, wd),
        lambda: A._gat_layer_project_plain(xk, w, ws, wd),
        dev, lambda: RL.gat_layer_projection(xk, HD, H),
        library=mm, in_row=False)
    proj = A.gat_layer_projection(xk, w, ws, wd)
    acc = torch.zeros((xk.shape[0], HD + H), dtype=torch.float32, device=dev)
    edges = RL.live_slots(tg)
    for stage, what in ((2, "walk"), (4, "epilogue")):
        ms = _median_calls(lambda: A._gat_layer_launch(
            tg, xk, w, ws, wd, kw["negative_slope"], kw["final_sf"], stage,
            proj=proj, acc=acc), dev)
        rate = (f", {edges / ms / 1e6:.3f} Gedge/s over {edges} edges"
                if stage == 2 else "")
        say(f"  gat_layer          l{li} {what} alone: {ms:.4f} ms{rate}")


def _median_calls(fn, dev) -> float:
    """ms per call of ``fn`` (CUDA events, CALLS in a row, median of
    REPEATS)."""
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils.benchmark import median_ms
    return median_ms(fn, device=dev, warmup=1, repeats=REPEATS, calls=CALLS)


def whole_layer_gat(checks: Checks, model, hg, g, dev) -> int:
    """Phase 8b: GAT-2l with every layer on the ``gat_layer`` kind (K14)
    over 512x1024x512 ``onehot`` tiles, lowered once per dtype.  K14 held
    to its plain version stage by stage at both layers' shapes (the
    model's weights; layer 0 on a request's features, layer 1 on the
    kernel path's layer-0 output), in bf16 and float32, and timed in bf16
    (the projection also beside ``torch.matmul`` of the same product); the
    static-shift domain of both layers' logits; 3 bf16 and 1 float32
    requests against the per-op path.  Returns K14's launches during the
    requests."""
    import torch

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler.fusion import (
        classify_block, gat_onehot_schedules)
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler.schedule import TileConfig
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import gat as A
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import fixtures
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import roofline as RL

    scheds = gat_onehot_schedules(model.layers, whole_layer=True,
                                  tile=TileConfig(*LAYER_TILE))
    dtypes = (("bfloat16", torch.bfloat16), ("float32", None))
    t0 = time.perf_counter()
    fns = {dtn: model.make_apply(dt, schedules=scheds, host_graph=hg,
                                 device=dev) for dtn, dt in dtypes}
    say(f"  GAT-2l: schedules {[sc.key()[-30:] for sc in scheds]}, lowered "
        f"in {time.perf_counter() - t0:.1f} s")
    tg, = {id(d): d for fn in fns["bfloat16"].layer_fns
           for k, _, d, _ in fn.plans if k == "gat_layer"}.values()
    say(f"  tiling {LAYER_TILE}: {tg.n_tiles} tiles, "
        f"{tg.src_local.numel()} slots for {RL.live_slots(tg)} edges")
    terms = fixtures.row_terms(tg)
    params = dict(model.params)
    plans = [classify_block(layer, sc.blocks[0], sc.tiles[0])[1]
             for layer, sc in zip(model.layers, scheds)]
    x = _request_x(0, hg.n_node, dev)
    for dtn, dt in dtypes:
        cdt = dt or torch.float32
        xin = x
        for li, lp in enumerate(plans):
            xk = xin.to(cdt).contiguous()       # as the lowering casts it
            w, ws, wd = (params[k].detach().to(cdt).contiguous()
                         for k in (lp.w_name, lp.was_name, lp.wad_name))
            HD, H = w.shape[1], ws.shape[1]
            case = f"layer {li} F={xk.shape[1]} H={H} HD={HD}"
            with torch.inference_mode():
                for c in fixtures.gat_layer_checks(
                        tg, xk, w, ws, wd, dtype_name=dtn, case=case,
                        negative_slope=lp.negative_slope,
                        final_sf=lp.final_sf, terms=terms):
                    checks.compare(c, slice_shape=True)
                if dtn == "bfloat16":
                    hq, a_s, a_d = A.gat_layer_projection(xk, w, ws, wd)
                    lo, hi, dead = layer_domain(tg, a_s, a_d,
                                                lp.negative_slope)
                    say(f"  layer {li} static-shift domain: logits in "
                        f"[{lo:.3f}, {hi:.3f}] (clamp at {A.SHIFT + 60:g}; "
                        f"p underflows below about {A.SHIFT - 103:g}); "
                        f"rows whose p all underflow in a head: {dead}")
                    del hq, a_s, a_d
                    kw = dict(negative_slope=lp.negative_slope,
                              final_sf=lp.final_sf)
                    checks.time_call(
                        "gat_layer", f"layer {li}",
                        lambda: A.gat_layer_tiles(tg, xk, w, ws, wd, **kw),
                        lambda: A._gat_layer_plain(tg, xk, w, ws, wd, **kw),
                        dev, lambda: RL.gat_layer(tg, xk, HD, H))
                    layer_stage_times(checks, tg, xk, w, ws, wd, kw, li,
                                      dev)
                xin = fns[dtn].layer_fns[li](params, g, xin)

    A.gat_layer_tiles.launches = 0
    outs, lat = {}, {}
    reqs = [("bfloat16", i) for i in range(REQUESTS)] + [("float32", 0)]
    with torch.inference_mode():
        for dtn, seed in reqs:
            outs[(dtn, seed)], ms = _timed(fns[dtn], params, g,
                                           _request_x(seed, hg.n_node, dev))
            lat.setdefault(dtn, []).append(ms)
            say(f"  GAT-2l gat_layer kind {dtn} request seed={seed}: "
                f"{ms:.2f} ms")
    launches = A.gat_layer_tiles.launches
    say(f"  K14 launches during the requests: {launches}")
    for dtn, v in lat.items():
        say(f"latency GAT-2l {dtn} gat_layer kind: median "
            f"{statistics.median(v):.3f} ms over {len(v)} requests "
            f"{['%.3f' % t for t in v]}")
    with torch.inference_mode():
        for dtn, seed in reqs:
            ref = model.make_apply(dict(dtypes)[dtn])(
                params, g, _request_x(seed, hg.n_node, dev))
            y = outs.pop((dtn, seed))
            rel = _rel_err(y, ref)
            say(f"  GAT-2l gat_layer kind {dtn} seed={seed}: relative "
                f"{rel:.3e} to the per-op path (bound {E2E_TOL[dtn]:.0e})")
            if not (tuple(y.shape) == (hg.n_node, N_CLASS)
                    and bool(torch.isfinite(y).all())
                    and rel <= E2E_TOL[dtn]):
                raise AssertionError(f"GAT-2l gat_layer kind {dtn}: {rel}")
            del ref, y
    return launches


def hub_rows_check(tg, dev) -> None:
    """Phase 8c: K3's raw float32 [num | den] on the one-hot tiling (derive
    mode, random inputs, both layers' widths) against a float64 sum under
    the same shift bound, row by row: den over its own value, num over
    the row's sum of |p h| per column, each within HUB_TOL; the worst row
    printed per in-degree class."""
    import torch

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import gat as A
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops.spmm import _live_slots
    n = tg.n_node
    _, src, dst = _live_slots(tg, 0, tg.n_tiles)
    deg = torch.bincount(dst, minlength=n)
    f64 = torch.float64
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    for H, HD in ((HEADS, HIDDEN), (1, N_CLASS)):
        D = HD // H
        h = torch.randn((n, HD), generator=gen, device=dev)
        w = torch.randn((HD, H), generator=gen, device=dev) / HD ** 0.5
        a_d = torch.randn((n, H), generator=gen, device=dev)
        raw = A._gat_forward(tg, h, None, a_d, w_asrc=w, normalize=False)
        a_s, ad, h64 = (h @ w).double(), a_d.double(), h.double()
        bound = A._leaky(a_s.amax(0, keepdim=True) + ad, 0.2)
        num = torch.zeros((n, HD), dtype=f64, device=dev)
        mag = torch.zeros((n, HD), dtype=f64, device=dev)
        den = torch.zeros((n, H), dtype=f64, device=dev)
        for c0 in range(0, src.numel(), 1 << 21):
            s_, d_ = src[c0:c0 + (1 << 21)], dst[c0:c0 + (1 << 21)]
            p = torch.exp(torch.clamp(
                A._leaky(a_s[s_] + ad[d_], 0.2) - bound[d_], max=60.0))
            ph = p.repeat_interleave(D, dim=1) * h64[s_]
            den.index_add_(0, d_, p)
            num.index_add_(0, d_, ph)
            mag.index_add_(0, d_, ph.abs())
        err = torch.maximum(
            ((raw[:, :HD].double() - num).abs()
             / mag.clamp(min=1e-300)).amax(1),
            ((raw[:, HD:].double() - den).abs()
             / den.clamp(min=1e-300)).amax(1))
        worst = _degree_classes(err, deg)
        say(f"  K3 on the one-hot tiling H={H} HD={HD}, each row against a "
            f"float64 sum (bound {HUB_TOL:.0e}), worst by in-degree: "
            + ", ".join(f"{k}: {v:.3e}" for k, v in worst.items()))
        if not float(err[deg > 0].max()) <= HUB_TOL:
            raise AssertionError(f"K3 row sums: {worst}")


def _degree_classes(err, deg) -> dict:
    """The worst of ``err`` (one value per row) by the rows' term counts."""
    live = deg > 0
    e, dl = err[live], deg[live]
    return {f"{lo}-{hi}": float(e[(dl >= lo) & (dl < hi)].max())
            for lo, hi in ((1, 100), (100, 10_000), (10_000, 1 << 40))
            if bool(((dl >= lo) & (dl < hi)).any())}


def bwd_hub_rows_check(tg, tg_t, dev) -> None:
    """Phase 8c: K5's float32 dad over the one-hot tiling and K6's [das |
    dh] over its twin (random inputs, both layers' widths) against a
    float64 sum of the same terms, row by row: each row's error over its
    sum of elementary-term magnitudes (the plain versions' ``magnitude``
    scale), within HUB_TOL; the worst row printed per in-degree class."""
    import torch

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import gat as A
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops.spmm import _live_slots, _unit_steps
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import fixtures
    n, slope = tg.n_node, 0.2
    rng = np.random.default_rng(10)
    for H, HD in ((HEADS, HIDDEN), (1, N_CLASS)):
        D = HD // H
        a_s = rng.standard_normal((n, H)).astype(np.float32)
        msrc = torch.tensor(a_s.max(0, keepdims=True), device=dev)
        h = torch.tensor(rng.standard_normal((n, HD), dtype=np.float32),
                         device=dev)
        gbar = torch.tensor(rng.standard_normal((n, HD), dtype=np.float32),
                            device=dev)
        side = fixtures.bwd_side(rng, n, H, torch.float32, dev, a_s=a_s)
        sd64, h64, g64 = side.double(), h.double(), gbar.double()
        ms = msrc.double()
        for name, kern, tgx, src_mode in (
                ("K5 dad", A.gat_bwd_tiles_dad, tg, False),
                ("K6 [das | dh]", A.gat_bwd_tiles_src, tg_t, True)):
            out = kern(tgx, h, gbar, side, msrc).double()
            W = out.shape[1]
            want = torch.zeros((n, W), dtype=torch.float64, device=dev)
            mag = torch.zeros((n, W), dtype=torch.float64, device=dev)
            deg = torch.zeros(n, dtype=torch.int64, device=dev)
            for t0, t1 in _unit_steps(tgx, 4 * HD + 8 * H):
                valid, col, row = _live_slots(tgx, t0, t1)
                s_, d_ = (row, col) if src_mode else (col, row)
                m = tgx.weight[t0:t1].double()[valid][:, None]
                hg_ = (h64[s_] * g64[d_]).view(-1, H, D)
                te, te_mag = hg_.sum(-1), hg_.abs().sum(-1)
                ad = sd64[d_, H:2 * H]
                lraw = sd64[s_, :H] + ad
                p = torch.exp(torch.clamp(A._leaky(lraw, slope)
                                          - A._leaky(ms + ad, slope),
                                          max=60.0))
                alpha = p * m * sd64[d_, 2 * H:3 * H]
                lk = torch.where(lraw >= 0, 1.0, slope)
                s2 = sd64[d_, 3 * H:]
                v, vm = alpha * (te - s2) * lk, alpha * (te_mag + s2.abs()) * lk
                if src_mode:
                    ag = alpha.repeat_interleave(D, dim=1) * g64[d_]
                    v, vm = torch.cat([v, ag], 1), torch.cat([vm, ag.abs()], 1)
                want.index_add_(0, row, v)
                mag.index_add_(0, row, vm)
                deg += torch.bincount(row, minlength=n)
            err = ((out - want).abs() / mag.clamp(min=1e-300)).amax(1)
            worst = _degree_classes(err, deg)
            say(f"  {name} on the {'twin' if src_mode else 'one-hot'} "
                f"tiling H={H} HD={HD}, each row against a float64 sum "
                f"(bound {HUB_TOL:.0e}), worst by in-degree: "
                + ", ".join(f"{k}: {v:.3e}" for k, v in worst.items()))
            if not float(err[deg > 0].max()) <= HUB_TOL:
                raise AssertionError(f"{name} row sums: {worst}")


def gat_kind_training(model, init_params, hg, g, dev) -> dict:
    """Phase 8c: GAT-2l with the attention chain as the ``gat`` kind (K3)
    over 512x1024x512 ``onehot`` tiles and its transposed twin (the JAX
    one-hot training recipe), lowered per dtype: float32 loss and
    gradients against per-op autograd (at the kernel path's layer inputs)
    at the trained and the initial parameters, then 1 warm-up and 2 timed
    bf16 AdamW steps.  Returns K3's, K5's and K6's launches during the
    steps."""
    import torch

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler.fusion import gat_onehot_schedules
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler.schedule import TileConfig
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models import train as TT
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import gat as A

    scheds = gat_onehot_schedules(model.layers, whole_layer=False,
                                  tile=TileConfig(*LAYER_TILE))
    rng = np.random.default_rng(13)
    x = torch.tensor(rng.standard_normal((hg.n_node, F_IN),
                                         dtype=np.float32), device=dev)
    wy = torch.tensor(rng.standard_normal((F_IN, N_CLASS), dtype=np.float32),
                      device=dev)
    labels = (x @ wy).argmax(dim=1)
    mask = torch.ones(hg.n_node, dtype=torch.bool, device=dev)
    t0 = time.perf_counter()
    fn = model.make_apply(None, schedules=scheds, host_graph=hg, device=dev,
                          build_transpose=True)
    say(f"  float32 lowering (tiling and transposed twin) "
        f"{time.perf_counter() - t0:.1f} s")
    twins = [tw for lf in fn.layer_fns for k, _, _, tw in lf.plans
             if k == "gat"]
    if len(twins) != 2 or any(tw is None for tw in twins):
        raise AssertionError("GAT-2l gat kind: expected a twin per layer")
    tiling = next(d for lf in fn.layer_fns for k, _, d, _ in lf.plans
                  if k == "gat")
    hub_rows_check(tiling, dev)
    bwd_hub_rows_check(tiling, twins[0][0], dev)
    _grads_at_both_states("GAT-2l gat kind", model, fn, init_params, g, x,
                          labels, mask)
    del fn
    t0 = time.perf_counter()
    fn = model.make_apply(torch.bfloat16, schedules=scheds, host_graph=hg,
                          device=dev, build_transpose=True)
    say(f"  bfloat16 lowering {time.perf_counter() - t0:.1f} s")
    counted = {"gat_tiles": A.gat_tiles, "gat_bwd_tiles_dad":
               A.gat_bwd_tiles_dad, "gat_bwd_tiles_src": A.gat_bwd_tiles_src}
    for f in counted.values():
        f.launches = 0
    state = TT.TrainState(model.params, TT.adamw(model.params, LR))
    step = TT.make_train_step(fn)
    losses, times = [], []
    for i in range(3):
        (state, loss), ms = _timed(step, state, g, x, labels, mask)
        losses.append(float(loss))
        if i > 0:
            times.append(ms)
    launches = {k: f.launches for k, f in counted.items()}
    say(f"  GAT-2l gat kind bf16 steps: losses "
        f"{['%.5f' % v for v in losses]}, step ms "
        f"{['%.3f' % t for t in times]}; launches {launches}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"GAT-2l gat kind steps: losses {losses}")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} was not launched by the gat "
                                 "kind's training steps")
    model.zero_grad(set_to_none=True)
    return launches


def whole_layer_grads(model, init_params, dev) -> None:
    """Phase 8d: the ``gat_layer`` kind's float32 loss and gradients (its
    backward is autograd of the exact edge formulation, [E, HD] tensors)
    against per-op autograd (at the kernel path's layer inputs) on phase
    7's reduced graph, at the trained and the initial parameters."""
    import torch

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler.fusion import gat_onehot_schedules
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler.schedule import TileConfig

    hr, gr = reduced_graph(dev)
    fn = model.make_apply(None, schedules=gat_onehot_schedules(
        model.layers, whole_layer=True, tile=TileConfig(*LAYER_TILE)),
        host_graph=hr, device=dev)
    rng = np.random.default_rng(14)
    x = _request_x(21, hr.n_node, dev)
    wy = torch.tensor(rng.standard_normal((F_IN, N_CLASS), dtype=np.float32),
                      device=dev)
    labels = (x @ wy).argmax(dim=1)
    mask = torch.ones(hr.n_node, dtype=torch.bool, device=dev)
    _grads_at_both_states("GAT-2l gat_layer kind (reduced graph)", model,
                          fn, init_params, gr, x, labels, mask)


def tune_cli() -> None:
    """Phase 8e: ``cli tune --stack`` for GAT on cora on the card (memo and
    schedule JSON in a temporary directory), then ``cli run`` and ``cli
    train`` with the schedule it wrote; prints each layer's winner."""
    import shutil
    import tempfile

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import cli
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler.fusion import classify_block
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models.zoo import build_model
    tmp = tempfile.mkdtemp(prefix="gta_tune_")
    try:
        sched = os.path.join(tmp, "stack.json")
        base = ["--dataset", "cora", "--network", "GAT", "--json"]
        t0 = time.perf_counter()
        rc = cli.main(["tune", *base, "--stack", "--memo",
                       os.path.join(tmp, "memo.csv"), "--schedule", sched,
                       "--target-s", str(TUNE_TARGET_S)])
        with open(os.path.join(tmp, "memo.csv")) as f:
            n_meas = sum(1 for _ in f)
        say(f"  cli tune --stack: rc {rc}, {n_meas} measurements in "
            f"{time.perf_counter() - t0:.1f} s")
        if rc != 0:
            raise AssertionError(f"cli tune exited {rc}")
        schedules = cli.load_schedules(sched, 2)
        model = build_model("GAT", 1433, 7, device="cpu")
        for li, (layer, sc) in enumerate(zip(model.layers, schedules)):
            kinds = [classify_block(layer, b, tc)[0]
                     for b, tc in zip(sc.blocks, sc.tiles)]
            say(f"  layer {li} winner: {sc.key()[-60:]}; kinds {kinds}; "
                f"gat_layer: {'gat_layer' in kinds}")
        for cmd in (["run", *base, "--schedule", sched],
                    ["train", *base, "--schedule", sched, "--epochs", "3"]):
            rc = cli.main(cmd)
            say(f"  cli {cmd[0]} --schedule: rc {rc}")
            if rc != 0:
                raise AssertionError(f"cli {cmd[0]} exited {rc}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def exp_panel_phase(checks: Checks, gat_fwd, gat_hybs, model, hg, g,
                    dev) -> int:
    """Phase 8f on phase 4's lowered GAT-2l forward (``gat_fwd`` per
    dtype) with ``DENSE_EXP_PANEL`` set: K15 held to its plain version (bf16
    and float32) and timed (bf16) at both layers' dense splits, with K4
    timed beside it on the same inputs; one bf16 and one float32 request
    against the same forward with the flag off (the K4 path).  The flag is
    restored after.  Returns K15's launches during the requests."""
    import torch

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import dense as D
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import roofline as RL
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils.fixtures import row_terms

    n = hg.n_node
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    for li, (H, HD) in enumerate(((HEADS, HIDDEN), (1, N_CLASS))):
        bga = gat_hybs[li].dense
        terms = row_terms(bga)
        for dt in (torch.bfloat16, torch.float32):
            name = str(dt).split(".")[1]
            timed = dt == torch.bfloat16
            h = torch.randn((n, HD), generator=gen, device=dev).to(dt)
            w = (torch.randn((HD, H), generator=gen, device=dev)
                 / HD ** 0.5).to(dt)
            a_d = torch.randn((n, H), generator=gen, device=dev).to(dt).float()
            a_s = h.float() @ w.float()
            ms = a_s.amax(0, keepdim=True)
            ps, pd = D.exp_panels(a_s, a_d, ms,
                                  bga.n_col_blocks * bga.block_cols,
                                  bga.n_row_blocks * bga.block_rows)
            checks.slice_case(
                "gat_dense_panel", f"layer {li} H={H} HD={HD}", name,
                lambda: D.gat_dense_panel_blocks(bga, h, bga.values, a_s, ps,
                                                 pd),
                lambda: D._gat_dense_panel_reference(bga, h, bga.values, a_s,
                                                     ps, pd), dev,
                split=HD, terms=terms,
                timed_as=f"layer {li}" if timed else None,
                work=lambda: RL.gat_dense_panel(bga, h, H),
                note=_panel_cell_note(bga, H))
            if timed:
                checks.time_call(
                    "gat_dense_blocks", f"l{li} beside K15",
                    lambda: D.gat_dense_blocks(bga, h, bga.values, a_s, a_d,
                                               ms),
                    lambda: D._gat_dense_reference(bga, h, bga.values, a_s,
                                                   a_d, ms), dev,
                    lambda: RL.gat_dense(bga, h, H), in_row=False,
                    note=_cell_note(bga, H))
    params = dict(model.params)
    reqs = (("bfloat16", 0), ("float32", 0))
    outs = {}
    D.gat_dense_panel_blocks.launches = 0
    D.DENSE_EXP_PANEL = True
    try:
        with torch.inference_mode():
            for dtn, seed in reqs:
                outs[dtn], ms = _timed(gat_fwd[dtn], params, g,
                                       _request_x(seed, n, dev))
                say(f"  GAT-2l hybrid {dtn} request, exp panels: {ms:.2f} ms")
    finally:
        D.DENSE_EXP_PANEL = False
    launches = D.gat_dense_panel_blocks.launches
    say(f"  K15 launches during the requests: {launches}")
    tol = {"float32": 1e-5, "bfloat16": E2E_TOL["bfloat16"]}
    with torch.inference_mode():
        for dtn, seed in reqs:
            ref, ms = _timed(gat_fwd[dtn], params, g, _request_x(seed, n, dev))
            rel = _rel_err(outs[dtn], ref)
            say(f"  GAT-2l hybrid {dtn}: K4 path {ms:.2f} ms; exp panels "
                f"against it: relative {rel:.3e} (bound {tol[dtn]:.0e})")
            if not (bool(torch.isfinite(outs[dtn]).all())
                    and rel <= tol[dtn]):
                raise AssertionError(f"exp-panel path {dtn}: {rel}")
    # bf16 request latency, the two paths in turns (after the counts)
    lat = {}
    xr = _request_x(0, n, dev)
    with torch.inference_mode():
        for _ in range(REQUESTS):
            for panel in (False, True, True, False):
                D.DENSE_EXP_PANEL = panel
                try:
                    lat.setdefault(panel, []).append(
                        _timed(gat_fwd["bfloat16"], params, g, xr)[1])
                finally:
                    D.DENSE_EXP_PANEL = False
    for panel, v in lat.items():
        say(f"latency GAT-2l bfloat16 hybrid, "
            f"{'exp panels (K15)' if panel else 'K4'}: median "
            f"{statistics.median(v):.3f} ms over {len(v)} requests")
    return launches


def _restore(model, params) -> None:
    """Put ``params`` (tensors keyed like ``model.params``) back into the
    model's parameters, in place."""
    import torch
    with torch.no_grad():
        for k, p in model.params.items():
            p.copy_(params[k])


def layer_phase(checks: Checks, gat_model, init_params, hg, g, dev) -> dict:
    """Phase 8a-8e; returns K14's launches on 8b's requests.  8c and 8d
    compare gradients at the parameters the earlier phases left and at the
    model's seeded initial parameters (``init_params``, as 5c does): the
    trained state depends on the order of earlier float32 atomics (Adam
    turns the rounding noise of a near-zero gradient into full steps), so
    there each leaf is held within the per-op reference's own spread
    too."""
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import fixtures
    t0 = time.perf_counter()
    say("== 8a whole-layer and exp-panel kernels K14, K15: edge cases")
    for c in fixtures.layer_kernel_cases(dev):
        checks.compare(c)
    say("== 8b GAT-2l on the whole-layer kind")
    launches = {"gat_layer": whole_layer_gat(checks, gat_model, hg, g, dev)}
    say("== 8c GAT-2l training on the gat kind with its transposed twin")
    gat_kind_training(gat_model, init_params, hg, g, dev)
    say("== 8d whole-layer kind gradients on the reduced graph")
    whole_layer_grads(gat_model, init_params, dev)
    say("== 8e cli tune --stack, run and train --schedule")
    tune_cli()
    say(f"launches of K14 in phase 8: {launches}; phase 8a-8e took "
        f"{time.perf_counter() - t0:.1f} s")
    if launches["gat_layer"] <= 0:
        raise AssertionError("kernel gat_layer was not launched in phase 8b")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--edges", type=int, default=11_461_589,
                    help="synthetic edges before self loops (Reddit has "
                         "114,615,892)")
    args = ap.parse_args(argv)

    import torch
    say("== 1 environment")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card_line = smi.stdout.strip().splitlines()[0].strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    say(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")
    say(f"card: {card_line}")

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import graph as G
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler.fusion import hybrid_schedules
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.data.datasets import synthetic_coo
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models.zoo import build_model
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import _ext
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import dense as D
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import gat as A
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import spmm as SP
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import fixtures

    say("== 2 build")
    t0 = time.perf_counter()
    _ext.library()
    say(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_ext.build_seconds if _ext.build_seconds is not None else 0:.1f} s)")
    say_ptxas(_ext.build_log)

    checks = Checks()
    say("== 3 kernels: edge cases")
    say(f"bound per row: {fixtures.KERNEL_TOL} times the row's max |plain| "
        "(num and den columns apart); a float32 row that sums n > 1,759 "
        f"terms gets {fixtures.SUM_ORDER:g} sqrt(n) 2^-24 instead, since "
        "reordering an f32 sum moves it by about sqrt(n) ulps")
    edge_case_checks(checks, dev)

    say("== 4 slice")
    t0 = time.perf_counter()
    s, r, labels = synthetic_coo(N_NODE, args.edges, seed=1,
                                 communities=1000, p_in=0.7)
    hg = G.build_host_graph(s, r, N_NODE, add_self_loops=True,
                            symmetric_norm=True)
    hg, _ = G.reorder_nodes(hg, "hubs+labels", labels=labels)
    del s, r, labels
    say(f"graph: N={hg.n_node} E={hg.n_edge} (self loops included), host "
        f"build {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator().manual_seed(0)
    models = {
        "GCN-2l": build_model("GCN", F_IN, N_CLASS, hidden=HIDDEN,
                              n_layers=2, reorder=True, generator=gen,
                              device=dev),
        "GAT-2l": build_model("GAT", F_IN, N_CLASS, hidden=HIDDEN,
                              n_layers=2, heads=HEADS, generator=gen,
                              device=dev),
    }
    init_params = {mname: {k: p.detach().clone()
                           for k, p in model.params.items()}
                   for mname, model in models.items()}
    fwd = {}         # per model and dtype: the kernel path, with twins
    hybs = {}
    for mname, model in models.items():
        sched = hybrid_schedules(model.layers)
        say(f"{mname}: schedules {[sc.key()[:48] for sc in sched]}")
        fwd[mname] = {}
        for dtn, dt in (("bfloat16", torch.bfloat16), ("float32", None)):
            t0 = time.perf_counter()
            fwd[mname][dtn] = model.make_apply(
                dt, schedules=sched, host_graph=hg, device=dev,
                build_transpose=True)
            say(f"  {dtn} lowering (forward splits, transposed graph and "
                f"twins) {time.perf_counter() - t0:.1f} s")
        for li, fn in enumerate(fwd[mname]["bfloat16"].layer_fns):
            for kind, _, data, _ in fn.plans:
                if kind.endswith("_hybrid"):
                    hybs.setdefault(mname, []).append(data)
                    nb = data.dense.n_blocks if data.dense is not None else 0
                    say(f"  layer {li} {kind}: dense edges "
                        f"{data.n_dense_edges} in {nb} blocks, tail edges "
                        f"{data.n_sparse_edges} in {data.tiles.n_tiles} "
                        f"tiles")
    g = hg.to_device(dev)

    say("== 4a kernels at the slice's shapes")
    for mname, hl in hybs.items():
        if len(hl) != 2:
            raise AssertionError(f"{mname}: {len(hl)} hybrid blocks, "
                                 "expected one per layer")
    slice_kernel_checks(checks, hybs["GCN-2l"], hybs["GAT-2l"], dev,
                        hg.n_node)

    say("== 4b requests (kernel path)")
    counted = {"spmm_tiles": SP.spmm_tiles,
               "spmm_dense_blocks": D.spmm_dense_blocks,
               "gat_tiles": A.gat_tiles, "gat_dense_blocks": D.gat_dense_blocks}
    reqs = [("bfloat16", i) for i in range(REQUESTS)] + [("float32", 0)]
    outs, lat = {}, {}
    for fn in counted.values():
        fn.launches = 0
    with torch.inference_mode():
        for mname, model in models.items():
            params = dict(model.params)
            for dtn, seed in reqs:
                y, ms = _timed(fwd[mname][dtn], params, g,
                               _request_x(seed, hg.n_node, dev))
                outs[(mname, dtn, seed)] = y
                lat.setdefault((mname, dtn, "kernel"), []).append(ms)
                say(f"  {mname} {dtn} request seed={seed}: {ms:.2f} ms")
        launches = {k: fn.launches for k, fn in counted.items()}
        say(f"launches during the requests: {launches}")
        # one more GAT-2l request under the profiler, after the counts are
        # read: utils/profile.py's breakdown of the request
        params = dict(models["GAT-2l"].params)
        xr = _request_x(0, hg.n_node, dev)
        _profile("GAT-2l bf16 request", "GAT",
                 lambda: fwd["GAT-2l"]["bfloat16"](params, g, xr), dev)
        del xr
    serving_launches = launches
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} was not launched by the "
                                 "serving path")

    say("== 4c per-op path and comparison")
    with torch.inference_mode():
        for mname, model in models.items():
            params = dict(model.params)
            ref_fn = {"bfloat16": model.make_apply(torch.bfloat16),
                      "float32": model.make_apply(None)}
            for dtn, seed in reqs:
                ref, ms = _timed(ref_fn[dtn], params, g,
                                 _request_x(seed, hg.n_node, dev))
                lat.setdefault((mname, dtn, "per-op"), []).append(ms)
                y = outs[(mname, dtn, seed)]
                if tuple(y.shape) != (hg.n_node, N_CLASS):
                    raise AssertionError(f"{mname}: output {tuple(y.shape)}")
                if not bool(torch.isfinite(y).all()):
                    raise AssertionError(f"{mname}: non-finite output")
                err = float((y - ref).abs().max())
                scale = max(1.0, float(ref.abs().max()))
                rel = err / scale
                say(f"  {mname} {dtn} seed={seed}: max|kernel-per-op| "
                    f"{err:.3e}, relative {rel:.3e} (bound "
                    f"{E2E_TOL[dtn]:.0e}); per-op {ms:.2f} ms")
                if not rel <= E2E_TOL[dtn]:
                    raise AssertionError(f"{mname} {dtn}: relative error "
                                         f"{rel} > {E2E_TOL[dtn]}")
                del ref
    for (mname, dtn, path), v in sorted(lat.items()):
        say(f"latency {mname} {dtn} {path}: median {statistics.median(v):.3f}"
            f" ms over {len(v)} requests {['%.3f' % t for t in v]}")

    # 8f before phase 5, which drops the float32 forwards it differentiates
    say("== 8f exp panels on phase 4's lowered GAT-2l forward")
    panel_launches = exp_panel_phase(
        checks, fwd["GAT-2l"], hybs["GAT-2l"], models["GAT-2l"], hg, g, dev)
    launches = training_phase(checks, models, fwd, hg, g, dev)
    launches["gat_dense_panel"] = panel_launches
    checks.csr.clear()
    del fwd
    grouped_launches, recipes = grouped_phase(checks, models["GCN-2l"], hg,
                                              g, dev)
    launches.update(grouped_launches)
    launches.update(sddmm_pair_phase(checks, models["GAT-2l"], recipes, hg,
                                     g, dev))
    del recipes
    launches.update(layer_phase(checks, models["GAT-2l"],
                                init_params["GAT-2l"], hg, g, dev))
    if launches["gat_dense_panel"] <= 0:
        raise AssertionError("kernel gat_dense_panel was not launched in "
                             "phase 8f")

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils.roofline import bound_of
    kernels = []
    for k, meta in KERNELS.items():
        # summed over the kernel's timed calls: K1-K8 per bf16 training
        # step (both layers' shapes; K1 and K2 also GCN's backward over the
        # twins); K9 one bench SpMM request plus one PATH_GROUPED GCN-2l
        # step (forward and twin at both layers); K10 one bench GAT request;
        # K11 GAT-2l's one-head logit block plus the hybrid SDDMM's per-tile
        # tail, K12 its grouped tail; K13 one DGN-2l and one PNA-2l request;
        # K14 one GAT-2l request on the gat_layer kind (both layers); K15
        # both layers' dense splits of one GAT-2l hybrid request
        calls = list(checks.times[k].values())
        bound_ms, bound_by = bound_of(c[2] for c in calls)
        libs = [c[3] for c in calls]
        row = dict(name=k, route="cuda", source=meta["source"],
                   replaces=meta["replaces"], launches=launches[k],
                   max_abs_err=checks.worst[k],
                   ms=sum(c[0] for c in calls),
                   plain_ms=sum(c[1] for c in calls), bound_ms=bound_ms,
                   bound_by=bound_by,
                   library_ms=None if None in libs else sum(libs))
        if k in serving_launches:
            row["serving_launches"] = serving_launches[k]
        kernels.append(row)
    say(json.dumps({"kernels": kernels}))
    say(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
