#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port on one NVIDIA GPU (H100).

Drives the port's serving forward of GCN-2l and GAT-2l on the hybrid
density-split path at the Reddit configuration's widths (602 features,
hidden 128, 41 classes, GAT 4 heads) over a synthetic community graph of
Reddit's node count, and checks every hand-written kernel on the way:

  1. environment: versions, card name and power limit, TF32 off;
  2. build: compiles the kernels from ``csrc/`` in a thread of nvcc
     processes while the main thread builds the host graphs that need no
     kernel (phase 4's graph, phase 12c's Reddit dataset; seconds of
     each printed);
  3. kernels: each of K1-K4 against its plain PyTorch version on the card,
     on the edge cases of ``utils/fixtures.kernel_cases``; (b) K16 (x W)
     against its plain version at the main path's shapes and ragged ones,
     x̂ bit for bit, its layer-0 and layer-1 products timed (its launches
     are counted in 4b's requests and 5d's steps);
  4. slice: lowers each model once per dtype with the hybrid splits and
     their transposed twins (``make_apply(build_transpose=True)``, one tile
     cache for both models and dtypes, kept for 10d and 11d), checks
     K1-K4 again at
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
     list); (b) DGN-2l, PNA-2l and PNA-4x3-2l (PNA as published, the
     benchmark's ``pna2_e11m_serve`` model; 602/128/41) with their pair
     chains on K13 (``pair_agg_partition``, 1024²/ET512 ``onehot``): K13's
     work list built again and timed (its chunks and cut rows printed), K13
     checked and timed at each layer's shape (PNA-4x3's min and sum of
     squares too), 3 bf16 and 1 float32 requests per model on the smoke's
     graph (K13 launched once a layer), and on a reduced graph of
     the same generator (a tenth of the edges, where the per-op path fits)
     answers, float32 losses and gradients against the per-op path; (c)
     GAT-2l with its logit blocks on the ``sddmm`` kind (K11 at the ADD
     shapes), one bf16 and one float32 request against the per-op path;
     (d) the hybrid SDDMM (dense-block logits plus K12 on phase 6's SpMM
     recipe split, and K11 on the same split with a per-tile tail; F =
     128, bf16), K11 and K12 also at 4 heads on the GAT recipe's tails,
     grouped and per-tile logits compared in edge order; at each of
     K11's timed shapes (c, d) its walk, its edges per second and
     ``sampled_addmm`` beside it; at K12's (d) its walk (K11's rule);
     (e) GATv2-2l (the benchmark's ``gatv2_e11m_serve`` model, 602 ->
     4 heads of 32 -> 1 head of 41) through ``hybrid_schedules``: K17
     against its plain version at both layers' shapes on the model's
     tiling, bf16 and float32, each row's error over its magnitude within
     ``fixtures.K17_TOL`` (the cut rows apart), timed in bf16 beside its
     bound; 3 bf16 and 1 float32 requests (K17 launched once a layer), and
     on the reduced graph the answers against the per-op path;
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
     graph; (e) ``cli tune --stack`` for GAT and GCN on cora (memo and
     schedules in a temporary directory; schedules with a stream and with
     a densefull block must be among the measured), then ``cli run`` and
     ``cli train`` with GAT's schedule; (f) run right after phase 4, on
     its lowered GAT-2l
     forward: ``DENSE_EXP_PANEL`` set, K15 checked and timed at both
     layers' dense splits beside K4 (each with its cell-heads per second
     and its own dense-cell floor), one bf16 and one float32 request
     against the K4 path, and 3 x 4 bf16 requests timed with the flag on
     and off in turns (the flag restored after);
  9. the paths that run no kernel of their own (plain PyTorch, as the JAX
     package leaves them to XLA), through ``lower_schedule``: (a) GCN-2l
     and GAT-2l on PATH_STREAM (262,144-edge chunks) on the smoke's
     graph, one float32 and 3 bf16 requests against the per-op path, and
     one bf16 request at 16,384-edge chunks, with times and peak device
     memory; (b) GCN-2l on PATH_DENSEFULL on a 65,536-node graph of the
     same generator (the bf16 adjacency's build time and bytes, 3 bf16
     and one float32 request against the per-op path, peak memory, the
     gradient in x against per-op autograd); (c)
     a densefull schedule on the smoke's graph lowers its block op by op
     (past ``DENSEFULL_MAX_N``);
 10. tile classes, sparse input, ``auto_hybrid`` and ``cli.py bench``:
     (a) K1, K3 and K11 on every part of ``fixtures.class_tilings`` (heavy
     and scattered runs, a class that wins no run, a unit-weight GAT
     tiling, an edge-less graph) and K1 and K2 on the sparse-input feature
     graph in both directions, against their plain versions (the errors
     join the kernels' rows); (b) the GCN and GAT layer-0 splits with the
     tail as capacity classes (128, 256, 512, 1024) beside phase 4's
     one-class splits: fill per class, K1 / K3 / K11 per class, summed,
     through the dispatch and on the one-class tail, one bf16 and one
     float32 ``spmm_hybrid`` and ``gat_hybrid`` request against the
     one-class split, and the float32 gradient in x of a class-tail
     ``spmm_hybrid`` (K1 per class of the twin) against per-op autograd
     on phase 7's reduced graph; (c) ``auto_hybrid`` (spmm, gat at 4 heads
     of 32): its threshold, tail geometry and capacity, one bf16 request
     each against the per-op formulation; (d) GCN-2l lowered with
     ``x_host`` = a seeded Zipf bag of words of 602 words at Cora's
     density: the feature graph's split, the first layer against the
     dense x W (and the per-call cast of the float32 blocks), one bf16
     request against the per-op path and one float32 request against the
     per-op path in float64 (as 7b), the float32 loss and
     W0's gradient against per-op autograd, 1 warm-up and 2 timed bf16
     AdamW steps with K1 and K2 launched in both directions of the
     product; (e) ``cli.py bench`` on cora at ``--batch 64``: the default
     geometry, ``--tile-classes auto`` and ``--sparse-block 256``.  K1,
     K2, K3, K4 and K11 must launch on these paths (``phase10_launches``).
 11. the compile-only pick (``compiler/latency.py`` with the card's fitted
     constants): (a) each layer's pick for GCN-2l, GAT-2l, DGN-2l and
     PNA-2l on the smoke's graph, every candidate's modelled ms and the
     host seconds per pick; (b) each pick lowered per dtype and served (3
     bf16 and 1 float32 requests, phase 4's seeds, every kernel's count
     set to 0 first: at least one of K1-K15 must launch): GCN-2l and
     GAT-2l (at their seeded initial parameters) against phase 4c's
     per-op answers, DGN-2l and PNA-2l against phase 7b's served answers
     (E2E_TOL of max |answer|), and on phase 7b's reduced graph picked
     again and held row by row to the per-op path (float32 to float64);
     (c) GCN-2l's and GAT-2l's whole 2-layer schedules that the phases
     serve on this graph (hybrid, grouped or the ``gat_layer`` and ``gat``
     kinds, stream, per-op) and the pick, modelled against measured (the
     phases' bf16 request medians; 3 requests here for 6c's and 8c's
     schedules): Spearman's rho >= 0.8 and the pick's measured time
     within 1.2x of the fastest; (d) 4 bf16 AdamW steps of GCN-2l and
     GAT-2l on their picks with the transposed twins (``train
     --compiled``'s lowering): losses finite and falling, step times,
     peak memory; (e) on cora, ``cli run --compiled``, ``cli train
     --compiled --epochs 3`` and ``cli tune --ga --stack`` for GCN and
     GAT, the GA's best against 8e's ``autotune`` best.
 12. neighbour-sampled training, float32, on the per-op path (no kernel
     of K1-K15 may launch): (a) the native host library builds on the
     card's host (the phase fails otherwise); on the smoke's graph its
     receiver sort, degrees, ``build_host_graph`` and 256²/ET512 tiling
     equal numpy's (both timed), ``cluster_labels`` and
     ``reorder_nodes("cluster")`` (a permutation; the dense share of a
     256² int8 split after it beside ``hubs+labels`` with the planted
     labels); (b) Flickr at the published counts, GraphSAGE, fanouts
     (10, 10), batch 512, hidden 128, 3 epochs (BASELINE.json's sampled
     configuration): ``train_sampled_scan(measure_device_epoch=True)``
     (wall and device epoch, ``sample_s``, ``h2d_dispatch_s``, Medge/s,
     epoch losses, which must fall) and ``train_sampled`` (prefetch 2,
     full-graph accuracies); (c) Reddit at its full 114,615,892 edges
     (its host build during phase 2): the same scan run and peak device
     memory, one epoch
     of ``train_sampled``; (d) on one seeded Reddit epoch, the captured
     graph's replays against the eager loop (the first 8 losses within
     1e-4 relative; epoch wall times: per-step dispatch against the
     captured graph), batch 0's float32 loss and gradients on the card
     against the port on the CPU (E2E_TOL, GRAD_TOL), the native
     sampler's repeat, and the device-epoch measurement's restore of the
     parameters and AdamW state, bit for bit.
 13. the sharded path (``parallel/``, phase 12's graph kept from phase 4):
     GCN-2l and GAT-2l at the smoke's widths, the graph partitioned into 4
     shards (each shard's comm_report at F = 128, bf16); (a) four gloo
     ranks on cuda:0 (``parallel.launch``; their exchanges staged through
     pinned host memory), ``use_kernels=True``: per rank K1 and K3 against
     their plain versions at its shapes (timed in turns), one bf16 and one
     float32 request per model against the single-card per-op answers
     (E2E_TOL), one float32 sharded step's loss and gradients against
     per-op autograd (GRAD_TOL), two bf16 steps (falling), GAT-2l with
     ``quantize_halo`` (5% of the exact answer and loss, JAX's quantized
     step bound), one layer's exchange time, K1's and K3's launches on
     every rank, and one traced step for ``overlap_report``; (b) the 2 x 2
     mesh over the same ranks: a GCN-2l request and float32 step; (c) a
     world of one over NCCL: GCN-2l through ``make_dist_apply`` and
     ``make_sharded_train_step`` against the single-card hybrid kernel
     path, then one Flickr epoch of ``train_sampled_scan(mesh=world)``
     (the all-reduce in the captured graph) against ``mesh=None``; (d)
     ``predicted_scaling`` at D = 4 and 8 from 13a's per-shard rate (a
     rank's layer-0 aggregation, local K1 plus the per-op remote half,
     over its edges), the vendor's NVLink and NIC rates, at overlap 0 and
     1 (the traced gloo fraction is printed as the artefact it is).
 14. the measurement layer and the remainders, run right after phase 4
     on its lowered bf16 forwards (as 8f is): (a) one GCN-2l and one
     GAT-2l request traced with ``utils/profile.trace``, its
     ``measured_report`` printed, and each of K1-K4 whose launch count
     rose during the request found in ``trace_events`` under its CUDA
     symbol (``KERNEL_SYMBOL``) as many times; (b) ``schedule_report`` of
     both models' layer schedules at bf16 with the phase-4b median as
     ``measured_s``; (c) ``time_fn`` and ``time_fn_pipelined`` on a GCN-2l
     request beside the CUDA-event median (``time_fn``'s median at least
     ``TIMER_FLOOR`` of it); (d) ``gat_attention(guard_shift=True)``: JAX's
     adversarial logits (tests/test_value_domain.py:41-70; K3 unguarded
     off by more than 0.1, guarded within 1e-4 of ``_gat_reference``),
     benign logits on a graph of in-degree <= 2 (guarded equal to
     unguarded bit for bit, K3 launched), the guard's cost and
     ``gat_shift_gap``'s host read on the smoke's graph; (e) karate and
     digits from the port's own ``data/fixtures/``: GCN trained on the
     card to JAX's accuracy bars (tests/test_real_data.py:20-41), GCN-2l
     and GAT-2l on hybrid schedules against the per-op path (E2E_TOL),
     some of K1-K4 launched; (f) the port bench's cora line, its
     microseconds positive.

Every phase prints its seconds, and a line before the kernels' line
lists them all.

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
import contextlib
import csv
import json
import os
import statistics
import subprocess
import sys
import threading
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
    "dense_xw": dict(source=f"{PKG}/csrc/dense_xw.cu",
                     replaces="none: XLA's dot of bf16 operands with "
                              "preferred_element_type=float32"),
    "gatv2_attn": dict(source=f"{PKG}/csrc/gatv2_attn.cu",
                       replaces="none: the JAX package has no GATv2"),
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
# phase 7b, PNA-4x3 on the reduced graph: its std, a difference of two
# moments, amplifies its precision's own rounding on rows of small
# variance, and the per-op path in bf16 (answers) and float32 (gradients)
# drifts from float64 by as much as the kernel path, past E2E_TOL and
# GRAD_TOL on graphs this large; so the kernel path is held against
# float64 within the larger of those bounds and OWN_X times the per-op
# path's own error in the same precision (the kernel path rounds z to bf16
# where the per-op path does not, so bf16 against bf16 tells nothing)
OWN_FLOOR = ("PNA-4x3-2l",)
OWN_X = 2
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


T_START = time.perf_counter()
PHASE_S = {}       # phase -> its seconds, printed together at the end


def say(msg: str) -> None:
    """Print a line; a section heading (``== ...``) carries the seconds
    since the script started."""
    if msg.startswith("== "):
        msg = f"{msg}  [t={time.perf_counter() - T_START:.1f} s]"
    print(msg, flush=True)


def _took(phase: str, t0: float) -> float:
    """Record and return the seconds of ``phase`` since ``t0``."""
    PHASE_S[phase] = time.perf_counter() - t0
    return PHASE_S[phase]


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
    profile.trace_call(what, profile.OUT_DIR / f"trace_{name}.json", fn, dev)


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


def dense_xw_checks(checks: Checks, dev) -> None:
    """K16 (``ops/primitives.dense_mm``'s x W) against its plain version at
    the main path's shapes (232,965 rows: 602 -> 128, 128 -> 41, 4, 1) and
    ragged ones (rows off the 64-row tile, strided and unaligned rows, K
    odd, K past one k-segment, N past one column tile, bf16 x); x̂ bit for
    bit.  A row's scale is its sum of |term| (|x̂| |Ŵ|).  The layer-0 and
    layer-1 products are timed beside their bound, the plain version and
    ``torch.mm`` of bf16 operands with a float32 result, the cast
    included; layer 0 also with x̂ (a training forward), printed only."""
    import torch

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import primitives as P
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import roofline as RL
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils.fixtures import KernelCase
    gen = torch.Generator(device=dev).manual_seed(22)

    def inputs(m, k, n, x_dtype=torch.float32, width=None, off=0):
        x = torch.randn((m, width or k), generator=gen, device=dev)
        w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
        return x[:, off:off + k].to(x_dtype), w

    cases = [("l0 602->128", inputs(N_NODE, F_IN, HIDDEN), "layer 0"),
             ("l1 128->41", inputs(N_NODE, HIDDEN, N_CLASS), "layer 1"),
             ("a_s 128->4", inputs(N_NODE, HIDDEN, HEADS), None),
             ("a_s 128->1", inputs(N_NODE, HIDDEN, 1), None),
             ("bf16 x 602->128", inputs(N_NODE, F_IN, HIDDEN, torch.bfloat16),
              None),
             ("1000 rows", inputs(1000, F_IN, HIDDEN), None),
             ("strided rows", inputs(1000, F_IN, N_CLASS, width=640), None),
             ("unaligned rows", inputs(999, F_IN, HIDDEN, width=611, off=3),
              None),
             ("K odd", inputs(1000, 43, N_CLASS), None),
             ("two k-segments", inputs(777, 1500, HIDDEN), None),
             ("two column tiles", inputs(300, F_IN, 200), None)]
    for name, (x, w), timed in cases:
        y, xh = P._xw_kernel(x, w, True)
        ref, ref_h = P.dense_xw_plain(x, w, True)
        if not torch.equal(xh, ref_h):
            raise AssertionError(f"dense_xw {name}: x̂ differs from "
                                 "x.to(bf16).float()")
        scale = ref_h.abs() @ w.to(torch.bfloat16).float().abs()
        terms = torch.full((x.shape[0],), x.shape[1], device=dev)
        checks.compare(KernelCase("dense_xw", name, "float32", y, ref,
                                  terms=terms, scale=scale),
                       slice_shape=True)
        del y, xh, ref, ref_h, scale
        if timed is None:
            continue

        def library(x=x, w=w):
            return torch.mm(x.to(torch.bfloat16), w.to(torch.bfloat16),
                            out_dtype=torch.float32)
        library.label = "torch.mm(bf16, bf16 -> f32) with the cast"
        checks.time_call("dense_xw", timed,
                         lambda x=x, w=w: P._xw_kernel(x, w, False),
                         lambda x=x, w=w: P.dense_xw_plain(x, w, False),
                         dev, lambda x=x, w=w: RL.dense_xw(x, w), library)
        if timed == "layer 0":
            checks.time_call("dense_xw", "layer 0 +x̂",
                             lambda x=x, w=w: P._xw_kernel(x, w, True),
                             lambda x=x, w=w: P.dense_xw_plain(x, w, True),
                             dev, lambda x=x, w=w: RL.dense_xw(x, w, True),
                             in_row=False)
    torch.cuda.empty_cache()


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
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import primitives as P
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
               "gat_dense_bwd_src": D.gat_dense_bwd_src,
               "dense_xw": P.dense_mm}     # K16: the forwards' products, x̂
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
        f"{_took('6', t0):.1f} s")
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
    |term|, as in the fixture cases), and where the plan takes PNA's four
    aggregators also the min (exact), the sum of squares (its own scale:
    every term is a square) and the final layout the ``pair_agg`` block
    reads (against the PyTorch formulas over the moments: bit for bit on
    the rows of one chunk, min, max and count exact, the cut rows' mean
    and std within the sum-order bound of ``fixtures.pair_layout_gaps``),
    timed in bf16 (the final layout apart, not in the kernels' row)."""
    import torch

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import ir
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import pairagg as PA
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import fixtures
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import roofline as RL
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils.fixtures import KernelCase

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    for mname, li, plan in plans:
        D, four = plan.width, plan.want_min_sq
        want_max = four or ir.MAX in plan.gathers
        kw = dict(sf=plan.sf, slope=plan.slope, want_max=want_max,
                  want_min_sq=four)
        what = f"{mname} l{li} D={D} {'+'.join(sorted(plan.gathers))}"
        order = sorted(plan.gathers, key=plan.gathers.get)
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
            if four:
                checks.compare(KernelCase("pair_agg", f"min {what}", name,
                                          out[3], ref[3]), slice_shape=True)
                checks.compare(KernelCase(
                    "pair_agg", f"sum of squares {what}", name, out[4],
                    ref[4], terms=ref[2][:, 0], scale=ref[4]),
                    slice_shape=True)
                gap = fixtures.pair_layout_gaps(tg, u, v, order, sf=plan.sf,
                                                slope=plan.slope)
                say(f"  pair_agg           final layout {what} {name}: rows "
                    f"of one chunk equal bit for bit {gap['one_chunk']}, "
                    f"min / max / count exact {gap['exact']}, "
                    f"{gap['cut_rows']} cut rows at {gap['cut_err']:.2e} "
                    "of their sum-order bound")
                if not (gap["one_chunk"] and gap["exact"]
                        and gap["cut_err"] <= 1.0):
                    raise AssertionError(f"K13's final layout {what} {name} "
                                         f"differs from its moments: {gap}")
            del out, ref, mag
            if dt == torch.bfloat16:
                checks.time_call(
                    "pair_agg", f"{mname[:-3]} l{li}",
                    lambda: PA.pair_agg(tg, u, v, **kw),
                    lambda: PA._pair_agg_reference(tg, u, v, **kw), dev,
                    lambda: RL.pair_agg(tg, u, want_max, four))
            if dt == torch.bfloat16 and four:
                checks.time_call(
                    "pair_agg", f"{mname[:-3]} l{li} layout",
                    lambda: PA.pair_agg(tg, u, v, layout=order, **kw),
                    lambda: PA.finish_moments(
                        *PA._pair_agg_reference(tg, u, v, **kw), order),
                    dev, lambda: RL.pair_agg(tg, u, want_max, four),
                    in_row=False)


def pair_agg_models(checks: Checks, hg, g, dev, measured) -> int:
    """Phase 7b: DGN-2l, PNA-2l ('original' PNA) and PNA-4x3-2l (PNA as
    published, the benchmark's ``pna2_e11m_serve`` model) at 602/128/41
    with their pair chains on K13 (``pair_agg_partition``, the chain on
    1024²/ET512 ``onehot``, the rest op by op; PNA-4x3 through
    ``hybrid_schedules``, as the benchmark lowers it, which gives the same
    blocks and tile), lowered once per dtype; each lowering tiles the graph
    once for its two layers.  K13 checked and timed at each layer's shape
    on the model's tiling (PNA-4x3's min and sum of squares too); 3 bf16
    and 1 float32 requests per model on the smoke's graph (finite, right
    shape: the per-op path cannot hold these models there), each launching
    K13 once a layer; then on a reduced graph of the same generator each
    served answer against the per-op path (bf16 against bf16; float32
    against the per-op path in float64, since the per-op path's own
    float32 sums over a hub row of ~2e4 same-signed terms drift by more
    than the bound, which is printed), row by row, each row's error over
    its own max |answer|, since hub rows run orders of magnitude above the
    rest; and float32 losses and gradients against float64 per-op
    autograd.  PNA-4x3's bf16 answers and float32 gradients are held
    against float64 within the larger of the bound and OWN_X times the
    per-op path's own error in that precision (``OWN_FLOOR``).  DGN-2l's
    and PNA-2l's models and served answers go into ``measured`` (phase 11
    holds its picks to them).  Returns K13's launches during the served
    requests."""
    import torch

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import schedule as S
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler.fusion import (
        classify_block, hybrid_schedules, pair_agg_schedules)
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models import train as TT
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models.zoo import build_model
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import pairagg as PA
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import roofline as RL

    tc = S.TileConfig(*PAIR_TILE, S.PATH_ONEHOT)
    gen = torch.Generator().manual_seed(4)
    models = {f"{net}-2l": build_model(net, F_IN, N_CLASS, hidden=HIDDEN,
                                       n_layers=2, generator=gen, device=dev)
              for net in ("DGN", "PNA", "PNA-4x3")}
    scheds = {m: (hybrid_schedules(model.layers) if m == "PNA-4x3-2l"
                  else pair_agg_schedules(model.layers, tile=tc))
              for m, model in models.items()}
    measured["pair models"] = {m: models[m] for m in ("DGN-2l", "PNA-2l")}
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

    launches, lat = 0, {}
    requests = [("bfloat16", i) for i in range(REQUESTS)] + [("float32", 0)]
    with torch.inference_mode():
        for mname, model in models.items():
            params = dict(model.params)
            PA.pair_agg.launches = 0
            for dtn, seed in requests:
                y, ms = _timed(fwd[mname][dtn], params, g,
                               _request_x(seed, hg.n_node, dev))
                if tuple(y.shape) != (hg.n_node, N_CLASS) or not bool(
                        torch.isfinite(y).all()):
                    raise AssertionError(f"{mname} {dtn}: bad output")
                lat.setdefault((mname, dtn), []).append(ms)
                measured.setdefault((mname, "answers"), {})[(dtn, seed)] = y
                say(f"  {mname} {dtn} request seed={seed}: {ms:.2f} ms")
            got, want = PA.pair_agg.launches, len(model.layers) * len(requests)
            say(f"  {mname}: K13 launches during its requests: {got}")
            if got != want:
                raise AssertionError(f"{mname}: K13 launched {got} times in "
                                     f"{len(requests)} requests, not {want}")
            launches += got
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
                bound = E2E_TOL[dtn]
                if dt is not None:
                    k64, p64r = (_row_rel(a, ref64) for a in (y, ref))
                    say(f"  {mname} reduced graph {dtn} against float64 per "
                        f"row: kernel path worst {float(k64.max()):.3e} "
                        f"median {float(k64.median()):.3e}; per-op path worst "
                        f"{float(p64r.max()):.3e} median "
                        f"{float(p64r.median()):.3e}")
                    if mname in OWN_FLOOR:
                        worst = float(k64.max())
                        bound = max(bound, OWN_X * float(p64r.max()))
                        say(f"  {mname} reduced graph {dtn}: the kernel path "
                            f"held against float64 within {bound:.3e}")
                    del k64, p64r
                if not (bool(torch.isfinite(y).all()) and worst <= bound):
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
        own = {}
        if mname in OWN_FLOOR:
            # the per-op path's own float32 error, leaf by leaf
            p32 = {k: v.detach().float().requires_grad_()
                   for k, v in p64.items()}
            TT.masked_cross_entropy(model.make_apply(None)(p32, gr, x),
                                    labels_r, mask).backward()
            own = {k: float((v.grad - gref[k]).abs().max())
                   / float(gref[k].abs().max()) for k, v in p32.items()}
            del p32
        del loss, p64
        rel = abs(lk - lr) / max(1.0, abs(lr))
        say(f"  {mname} reduced graph float32 loss {lk:.6f}, per-op float64 "
            f"{lr:.6f}, relative {rel:.3e}")
        if not rel <= GRAD_TOL["loss"]:
            raise AssertionError(f"{mname} loss {lk} vs per-op {lr}")
        for k in gref:
            err = float((gk[k] - gref[k]).abs().max()) / float(
                gref[k].abs().max())
            bound = max(GRAD_TOL["grad"], OWN_X * own.get(k, 0.0))
            say(f"  {mname} d{k}: relative {err:.3e}"
                + (f" (per-op float32 {own[k]:.3e}; bound {bound:.3e})"
                   if k in own else ""))
            if not (bool(torch.isfinite(gk[k]).all()) and err <= bound):
                raise AssertionError(f"{mname} d{k}: {err}")
        model.zero_grad(set_to_none=True)
        del gk, gref, fns
    return launches


def gatv2_model(checks: Checks, hg, g, dev) -> int:
    """Phase 7e: GATv2-2l, the benchmark's ``gatv2_e11m_serve`` model (602
    -> 128 as 4 heads of 32 -> 41 as one head), through
    ``hybrid_schedules`` and ``make_apply`` as the benchmark lowers it: its
    attention on the ``gatv2`` kind (K17 on K13's work list over
    ``fusion.PAIR_TILE``), x [W_l | W_r] on K16, lowered once per dtype.
    K17 checked at both layers' shapes on the model's tiling against its
    plain version in bf16 and float32, each row's error over the row's sum
    of alpha |u_j| within ``fixtures.K17_TOL`` over every row and over the
    work list's cut rows apart (the finishing kernel's), and timed in bf16
    beside its bound (``roofline.gatv2_attn``); 3 bf16 and 1 float32
    requests on the smoke's graph, each launching K17 once a layer; then
    on phase 7b's reduced graph each answer against the per-op path (bf16
    against bf16 within E2E_TOL of max |answer|; float32 against the
    per-op path in float64 row by row, each row's error over its own max
    |answer|).  Returns K17's launches during the served requests."""
    import torch

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler.fusion import (
        PAIR_TILE as TILE, classify_block, hybrid_schedules)
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models.zoo import build_model
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import gatv2 as GV
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import fixtures
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import roofline as RL

    model = build_model("GATv2", F_IN, N_CLASS, hidden=HIDDEN, n_layers=2,
                        heads=HEADS, generator=torch.Generator().manual_seed(4),
                        device=dev)
    sched = hybrid_schedules(model.layers)
    dtypes = (("bfloat16", torch.bfloat16), ("float32", None))
    t0 = time.perf_counter()
    fwd = {dtn: model.make_apply(dt, schedules=sched, host_graph=hg,
                                 device=dev)
           for dtn, dt in dtypes}
    say(f"  GATv2-2l: schedules {[s.key()[:40] for s in sched]}, lowered "
        f"in {time.perf_counter() - t0:.1f} s")
    found = [(li, classify_block(model.layers[li], block, TILE)[1], data)
             for li, fn in enumerate(fwd["bfloat16"].layer_fns)
             for kind, block, data, _ in fn.plans if kind == "gatv2"]
    shapes = [(p.heads, p.width) for _, p, _ in found]
    if shapes != [(HEADS, HIDDEN), (1, N_CLASS)]:
        raise AssertionError(f"GATv2-2l: gatv2 blocks of (heads, width) "
                             f"{shapes}, expected one a layer")
    n = hg.n_node
    tg = found[0][2]
    work = GV.gatv2_work(tg, n)
    cut = work.pair.split_rows
    say(f"  GATv2-2l K17 work list: {work.pair.slot_src.numel()} slots in "
        f"{work.pair.n_chunks} chunks over {tg.n_tiles} tiles, "
        f"{cut.numel()} of {n} rows cut into {work.n_parts} partial rows")

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    for li, plan, tgl in found:
        H, C = plan.heads, plan.width // plan.heads
        for dt in (torch.bfloat16, torch.float32):
            name = str(dt).split(".")[1]
            u, v = (torch.randn((n, H * C), generator=gen, device=dev).to(dt)
                    for _ in range(2))
            att = torch.randn((H, C), generator=gen, device=dev)
            got = GV.gatv2_attn(tgl, u, v, att)
            want = GV._gatv2_attn_reference(tgl, u, v, att)
            mag = GV._gatv2_attn_reference(tgl, u, v, att, magnitude=True)
            err = float((got - want).abs().max())
            rows = fixtures.k17_error(got, want, mag)
            rows_cut = fixtures.k17_error(got, want, mag, cut)
            say(f"  {'gatv2_attn':18s} {f'GATv2 l{li} H={H} C={C}':34s} "
                f"{name:8s} max_abs_err={err:.3e}, worst row {rows:.3e} of "
                f"its magnitude, worst cut row {rows_cut:.3e} (bound "
                f"{fixtures.K17_TOL:.0e})")
            if not (bool(torch.isfinite(got).all())
                    and max(rows, rows_cut) <= fixtures.K17_TOL):
                raise AssertionError(f"K17 GATv2 l{li} {name}: a row's "
                                     f"error is {max(rows, rows_cut)} of "
                                     "its magnitude")
            checks.worst["gatv2_attn"] = max(
                checks.worst.get("gatv2_attn", 0.0), err)
            del got, want, mag
            if dt == torch.bfloat16:
                checks.time_call(
                    "gatv2_attn", f"GATv2 l{li}",
                    lambda: GV.gatv2_attn(tgl, u, v, att),
                    lambda: GV._gatv2_attn_reference(tgl, u, v, att), dev,
                    lambda: RL.gatv2_attn(tgl, u, H))
        del u, v

    lat = {}
    requests = [("bfloat16", i) for i in range(REQUESTS)] + [("float32", 0)]
    with torch.inference_mode():
        params = dict(model.params)
        GV.gatv2_attn.launches = 0
        for dtn, seed in requests:
            y, ms = _timed(fwd[dtn], params, g, _request_x(seed, n, dev))
            if tuple(y.shape) != (n, N_CLASS) or not bool(
                    torch.isfinite(y).all()):
                raise AssertionError(f"GATv2-2l {dtn}: bad output")
            lat.setdefault(dtn, []).append(ms)
            say(f"  GATv2-2l {dtn} request seed={seed}: {ms:.2f} ms")
        launches = GV.gatv2_attn.launches
    want = len(model.layers) * len(requests)
    say(f"  GATv2-2l: K17 launches during its requests: {launches}")
    if launches != want:
        raise AssertionError(f"GATv2-2l: K17 launched {launches} times in "
                             f"{len(requests)} requests, not {want}")
    for dtn, v in sorted(lat.items()):
        say(f"latency GATv2-2l {dtn} kernel: median "
            f"{statistics.median(v):.3f} ms over {len(v)} requests "
            f"{['%.3f' % t for t in v]}")
    del fwd, y

    hr, gr = reduced_graph(dev)
    x = _request_x(20, hr.n_node, dev)
    with torch.inference_mode():
        params = dict(model.params)
        p64 = {k: p.detach().double() for k, p in params.items()}
        ref64 = model.make_apply(None)(p64, gr, x.double())
        for dtn, dt in dtypes:
            y = model.make_apply(dt, schedules=sched, host_graph=hr,
                                 device=dev)(params, gr, x)
            if dt is None:
                rows = _row_rel(y, ref64)
                worst = float(rows.max())
                say(f"  GATv2-2l reduced graph float32: against the per-op "
                    f"path in float64 per row of its own max: worst "
                    f"{worst:.3e}, median {float(rows.median()):.3e} (bound "
                    f"{E2E_TOL[dtn]:.0e} on every row)")
            else:
                ref = model.make_apply(dt)(params, gr, x)
                worst = _rel_err(y, ref)
                rows = _row_rel(y, ref)
                say(f"  GATv2-2l reduced graph {dtn}: against the per-op "
                    f"path in {dtn}, relative {worst:.3e} of max |answer| "
                    f"(bound {E2E_TOL[dtn]:.0e}); per row of its own max: "
                    f"worst {float(rows.max()):.3e}, median "
                    f"{float(rows.median()):.3e}; against float64 "
                    f"{_rel_err(y, ref64):.3e}")
                del ref
            if not (bool(torch.isfinite(y).all()) and worst <= E2E_TOL[dtn]):
                raise AssertionError(f"GATv2-2l reduced {dtn}: relative "
                                     f"error {worst}")
            del y, rows
        del ref64
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
            if timed and tail == "grouped":
                say(f"  sddmm_grouped      {what}: walk {SD.k12_walk()!r}")
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
                     dev, measured) -> dict:
    """Phase 7; returns K11's, K12's, K13's and K17's launches on its
    main-path runs (7b's and 7c's requests, 7d's hybrid SDDMM requests,
    7e's GATv2-2l requests)."""
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import fixtures
    t0 = time.perf_counter()
    say("== 7a SDDMM and pair-aggregate kernels K11-K13: edge cases")
    for c in (*fixtures.sddmm_kernel_cases(dev),
              *fixtures.pair_agg_kernel_cases(dev)):
        checks.compare(c)
    say("== 7b DGN-2l, PNA-2l and PNA-4x3-2l on the pair-aggregate kernel")
    launches = {"pair_agg": pair_agg_models(checks, hg, g, dev, measured)}
    say("== 7c GAT-2l with its logit blocks on the sddmm kind")
    launches["sddmm_tiles"] = sddmm_gat(checks, gat_model, hg, g, dev)
    say("== 7d the hybrid SDDMM on the bench recipes' splits")
    d = hybrid_sddmm(checks, recipes, hg, dev)
    launches["sddmm_tiles"] += d["sddmm_tiles"]
    launches["sddmm_grouped"] = d["sddmm_grouped"]
    checks.csr.clear()
    say("== 7e GATv2-2l on K17")
    launches["gatv2_attn"] = gatv2_model(checks, hg, g, dev)
    say(f"launches of K11-K13 and K17 in phase 7: {launches}; phase 7 took "
        f"{_took('7', t0):.1f} s")
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


def whole_layer_gat(checks: Checks, model, hg, g, dev, measured) -> int:
    """Phase 8b: GAT-2l with every layer on the ``gat_layer`` kind (K14)
    over 512x1024x512 ``onehot`` tiles, lowered once per dtype.  K14 held
    to its plain version stage by stage at both layers' shapes (the
    model's weights; layer 0 on a request's features, layer 1 on the
    kernel path's layer-0 output), in bf16 and float32, and timed in bf16
    (the projection also beside ``torch.matmul`` of the same product); the
    static-shift domain of both layers' logits; 3 bf16 and 1 float32
    requests against the per-op path (their bf16 median into
    ``measured``, for phase 11).  Returns K14's launches during the
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
    measured[("GAT-2l", "gat_layer")] = statistics.median(lat["bfloat16"])
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


def tune_cli(measured) -> None:
    """Phase 8e: ``cli tune --stack`` for GAT and for GCN on cora on the
    card (memo and schedule JSON in a temporary directory), counting the
    measurements with a stream or densefull block (both must be swept),
    then ``cli run`` and ``cli train`` with GAT's schedule and ``cli
    train`` with GCN's; prints each GAT layer's winner.  Each model's
    tuned stack latency goes into ``measured`` (phase 11e's yardstick)."""
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
        # GCN too: its aggregation is the block the densefull path takes
        if rc == 0:
            rc = cli.main(["tune", "--dataset", "cora", "--network", "GCN",
                           "--json", "--stack", "--memo",
                           os.path.join(tmp, "memo.csv"), "--schedule",
                           os.path.join(tmp, "gcn.json"), "--target-s",
                           str(TUNE_TARGET_S)])
        with open(os.path.join(tmp, "memo.csv"), newline="") as f:
            keys = [row[0] for row in csv.reader(f)]
        paths = {p: sum(f"x{p}" in k for k in keys)
                 for p in ("stream", "densefull")}
        say(f"  cli tune --stack: rc {rc}, {len(keys)} measurements in "
            f"{time.perf_counter() - t0:.1f} s; with a stream block "
            f"{paths['stream']}, with a densefull block {paths['densefull']}")
        if rc != 0:
            raise AssertionError(f"cli tune exited {rc}")
        if not all(paths.values()):
            raise AssertionError(f"cli tune swept no schedule of a path: "
                                 f"{paths}")
        for net, path in (("GAT", sched), ("GCN", os.path.join(tmp,
                                                               "gcn.json"))):
            with open(path) as f:
                measured[("tune", net)] = sum(
                    sp["latency_us"] for sp in json.load(f)["layers"])
        schedules = cli.load_schedules(sched, 2)
        model = build_model("GAT", 1433, 7, device="cpu")
        for li, (layer, sc) in enumerate(zip(model.layers, schedules)):
            kinds = [classify_block(layer, b, tc)[0]
                     for b, tc in zip(sc.blocks, sc.tiles)]
            say(f"  layer {li} winner: {sc.key()[-60:]}; kinds {kinds}; "
                f"gat_layer: {'gat_layer' in kinds}")
        gcn = ["--dataset", "cora", "--network", "GCN", "--json",
               "--schedule", os.path.join(tmp, "gcn.json")]
        for cmd in (["run", *base, "--schedule", sched],
                    ["train", *base, "--schedule", sched, "--epochs", "3"],
                    ["train", *gcn, "--epochs", "3"]):
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


def layer_phase(checks: Checks, gat_model, init_params, hg, g, dev,
                measured) -> dict:
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
    launches = {"gat_layer": whole_layer_gat(checks, gat_model, hg, g, dev,
                                             measured)}
    say("== 8c GAT-2l training on the gat kind with its transposed twin")
    gat_kind_training(gat_model, init_params, hg, g, dev)
    say("== 8d whole-layer kind gradients on the reduced graph")
    whole_layer_grads(gat_model, init_params, dev)
    say("== 8e cli tune --stack, run and train --schedule")
    tune_cli(measured)
    say(f"launches of K14 in phase 8: {launches}; phase 8a-8e took "
        f"{_took('8a-8e', t0):.1f} s")
    if launches["gat_layer"] <= 0:
        raise AssertionError("kernel gat_layer was not launched in phase 8b")
    return launches


# phase 9: the stream path's chunks (tile_edges * 2048 edges: 262,144,
# and 16,384 for one more timed request) and the densefull graph's nodes
# (the JAX package's DENSEFULL_MAX_N) and edges per node
STREAM_TILE_EDGES = (128, 8)
DENSE_NODES = 65_536
DENSE_EDGES_PER_NODE = 49


def path_schedules(model, tc):
    """Per-layer schedules of ``model`` with its one aggregation block on
    ``tc`` (GAT's attention chain, ``pattern_partition``; else the
    aggregation, ``aggregation_partition``), every other block op by op."""
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import schedule as S
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler.fusion import classify_block
    out = []
    for layer in model.layers:
        part = S.pattern_partition(layer) or S.aggregation_partition(layer)
        tiles = tuple(tc if classify_block(layer, b, tc)[0] != "xla"
                      else S.TileConfig(path=S.PATH_XLA) for b in part)
        if sum(t is tc for t in tiles) != 1:
            raise AssertionError(f"{layer.name}: no one block on {tc}")
        out.append(S.Schedule(blocks=part, tiles=tiles))
    return out


def _path_requests(what, model, fns, g, n, dev, reqs, tol) -> dict:
    """Serve ``reqs`` ((dtype name, seed)) through ``fns[dtype name]``
    under ``torch.inference_mode()``, after one untimed request per dtype,
    print each request's time, the medians and the peak device memory
    above what was held before,
    then hold each answer to the per-op path within ``tol[dtype name]``
    of max |per-op|; returns the median ms per dtype."""
    import torch
    dtypes = {"bfloat16": torch.bfloat16, "float32": None}
    outs, lat = {}, {}
    with torch.inference_mode():
        for dtn in {d for d, _ in reqs}:      # warm-up, untimed
            fns[dtn](dict(model.params), g, _request_x(0, n, dev))
        torch.cuda.synchronize(dev)
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        for dtn, seed in reqs:
            outs[(dtn, seed)], ms = _timed(fns[dtn], dict(model.params), g,
                                           _request_x(seed, n, dev))
            lat.setdefault(dtn, []).append(ms)
    peak = torch.cuda.max_memory_allocated(dev) - held
    say(f"  {what}: requests {[(d, round(t, 3)) for d, ts in lat.items() for t in ts]} ms; "
        f"median {', '.join(f'{d} {statistics.median(ts):.3f}' for d, ts in lat.items())} ms; "
        f"peak device memory {peak / 2**30:.3f} GiB above the {held / 2**30:.3f} "
        "GiB held before")
    with torch.inference_mode():
        for (dtn, seed), y in outs.items():
            ref = model.make_apply(dtypes[dtn])(dict(model.params), g,
                                                _request_x(seed, n, dev))
            rel = _rel_err(y, ref)
            say(f"  {what} {dtn} seed={seed}: relative {rel:.3e} to the "
                f"per-op path (bound {tol[dtn]:.0e})")
            if not (y.shape == ref.shape and bool(torch.isfinite(y).all())
                    and rel <= tol[dtn]):
                raise AssertionError(f"{what} {dtn} seed={seed}: {rel}")
            del ref
    return {d: statistics.median(ts) for d, ts in lat.items()}


def stream_densefull_phase(models, hg, g, dev, measured) -> None:
    """Phase 9: the paths that run no kernel of their own, through
    ``lower_schedule`` (``make_apply(schedules=...)``) on the card.  (a)
    GCN-2l and GAT-2l on PATH_STREAM (262,144-edge chunks) on the smoke's
    graph: one float32 and 3 bf16 requests against the per-op path, and
    one bf16 request at 16,384-edge chunks; (b) GCN-2l on PATH_DENSEFULL
    on a 65,536-node graph of the smoke's generator (E/N about 50, self
    loops, symmetric norm): the bf16 adjacency's build time and bytes, 3
    bf16 requests and one float32 request against the per-op path (the
    adjacency holds bf16 weights, as the JAX package's, so the float32
    request is held to the bf16 bound), and d (y . r) / dx in both dtypes
    against per-op autograd, everything freed after; (c) a
    densefull schedule on the smoke's graph, past the node cap, lowers its
    block op by op.  (a)'s bf16 medians at 262,144-edge chunks go into
    ``measured`` for phase 11."""
    import torch

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import graph as G
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import schedule as S
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.data.datasets import synthetic_coo
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models.zoo import build_model
    t_phase = time.perf_counter()
    dtypes = {"bfloat16": torch.bfloat16, "float32": None}
    reqs = [("float32", 0)] + [("bfloat16", i) for i in range(REQUESTS)]
    say("== 9a the stream path")
    for mname, model in models.items():
        for te in STREAM_TILE_EDGES:
            scheds = path_schedules(model, S.TileConfig(tile_edges=te,
                                                        path=S.PATH_STREAM))
            fns = {dtn: model.make_apply(dt, schedules=scheds, host_graph=hg,
                                         device=dev)
                   for dtn, dt in dtypes.items()}
            kinds = [p[0] for fn in fns["bfloat16"].layer_fns
                     for p in fn.plans if p[0] != "xla"]
            what = f"{mname} stream, {te * 2048}-edge chunks"
            say(f"  {what}: kinds {kinds}")
            med = _path_requests(what, model, fns, g, hg.n_node, dev,
                                 reqs if te == STREAM_TILE_EDGES[0]
                                 else [("bfloat16", 0)], E2E_TOL)
            if te == STREAM_TILE_EDGES[0]:
                measured[(mname, "stream")] = med["bfloat16"]

    say("== 9b the densefull path")
    t0 = time.perf_counter()
    s, r, _ = synthetic_coo(DENSE_NODES, DENSE_NODES * DENSE_EDGES_PER_NODE,
                            seed=2, communities=DENSE_NODES * 1000 // N_NODE,
                            p_in=0.7)
    hd = G.build_host_graph(s, r, DENSE_NODES, add_self_loops=True,
                            symmetric_norm=True)
    del s, r
    gd = hd.to_device(dev)
    say(f"  graph: N={hd.n_node} E={hd.n_edge} (E/N {hd.n_edge / hd.n_node:.1f}), "
        f"host build {time.perf_counter() - t0:.1f} s")
    gcn = build_model("GCN", F_IN, N_CLASS, hidden=HIDDEN, n_layers=2,
                      reorder=True, generator=torch.Generator().manual_seed(9),
                      device=dev)
    scheds = path_schedules(gcn, S.TileConfig(path=S.PATH_DENSEFULL))
    fns = {}
    for dtn, dt in dtypes.items():
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fns[dtn] = gcn.make_apply(dt, schedules=scheds, host_graph=hd,
                                  device=dev)
        torch.cuda.synchronize(dev)
        adj = {id(p[2]): p[2] for fn in fns[dtn].layer_fns for p in fn.plans
               if p[0] == "spmm_densefull"}
        say(f"  {dtn} lowering {time.perf_counter() - t0:.2f} s; "
            f"adjacencies {[(tuple(a.shape), str(a.dtype), a.numel() * a.element_size()) for a in adj.values()]} "
            "(bytes)")
        if len(adj) != 1:
            raise AssertionError(f"densefull {dtn}: {len(adj)} adjacencies")
    _path_requests("GCN-2l densefull", gcn, fns, gd, hd.n_node, dev,
                   [("bfloat16", i) for i in range(REQUESTS)]
                   + [("float32", 0)],
                   {"bfloat16": E2E_TOL["bfloat16"],
                    "float32": E2E_TOL["bfloat16"]})
    # the backward (fusion._Densefull: the bf16 forward's torch.mm with
    # float32 output has no autograd derivative of its own) against
    # autograd of the per-op path, d (y . r) / dx
    r = torch.randn((hd.n_node, N_CLASS), generator=torch.Generator(
        device=dev).manual_seed(10), device=dev)
    for dtn, dt in dtypes.items():
        grads = {}
        for path, fn in (("densefull", fns[dtn]),
                         ("per-op", gcn.make_apply(dt))):
            x = _request_x(0, hd.n_node, dev).requires_grad_(True)
            (fn(dict(gcn.params), gd, x).float() * r).sum().backward()
            grads[path] = x.grad
        rel = _rel_err(grads["densefull"], grads["per-op"])
        say(f"  GCN-2l densefull {dtn} d(y.r)/dx: relative {rel:.3e} to "
            f"per-op autograd (bound {E2E_TOL['bfloat16']:.0e})")
        if not (bool(torch.isfinite(grads["densefull"]).all())
                and rel <= E2E_TOL["bfloat16"]):
            raise AssertionError(f"densefull {dtn} gradient: {rel}")
    del fns, adj, gcn, gd, hd, grads, r
    torch.cuda.empty_cache()

    say("== 9c densefull past the node cap")
    fn, = models["GCN-2l"].make_apply(
        torch.bfloat16, schedules=path_schedules(
            models["GCN-2l"], S.TileConfig(path=S.PATH_DENSEFULL)),
        host_graph=hg, device=dev).layer_fns[:1]
    kinds = [p[0] for p in fn.plans]
    say(f"  {hg.n_node} nodes (cap {G.DENSEFULL_MAX_N}): layer 0 kinds {kinds}")
    if "spmm_densefull" in kinds or any(p[2] is not None for p in fn.plans):
        raise AssertionError(f"densefull past the cap lowered to {kinds}")
    say(f"phase 9 took {_took('9', t_phase):.1f} s")


# phase 10: the capacity classes of the JAX bench's ``auto`` list; the
# sparse-input X, a Zipf bag of words of F_IN words at Cora's density
# (draws per cell before duplicates merge); cli bench's three runs
CLASSES = (128, 256, 512, 1024)
BOW_DENSITY = 0.0127
BENCH_RUNS = (("default geometry", []),
              ("--tile-classes auto", ["--tile-classes", "auto"]),
              ("--sparse-block 256", ["--sparse-block", "256"]))
# the kernels phase 10 drives on its new paths
P10_KERNELS = ("spmm_tiles", "spmm_dense_blocks", "gat_tiles",
               "gat_dense_blocks", "sddmm_tiles")


def _p10_counted():
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import dense as D
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import gat as A
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import sddmm as SD
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import spmm as SP
    return {"spmm_tiles": SP.spmm_tiles,
            "spmm_dense_blocks": D.spmm_dense_blocks,
            "gat_tiles": A.gat_tiles, "gat_dense_blocks": D.gat_dense_blocks,
            "sddmm_tiles": SD.sddmm_tiles}


class _PathLaunches:
    """Sums the launches of phase 10's kernels over the windows in which it
    drives a path (requests, steps, cli bench): each window sets the counts
    to 0 first and adds them after, so the kernel checks and timed calls
    between the windows do not count."""

    def __init__(self):
        self.total = {k: 0 for k in P10_KERNELS}

    def __enter__(self):
        for f in _p10_counted().values():
            f.launches = 0
        return self

    def __exit__(self, *exc):
        for k, f in _p10_counted().items():
            self.total[k] += f.launches


def _gcn_split(hg, dev, tile_classes=None):
    """The smoke's GCN split (``fusion.hybrid_schedules``' SpMM recipe: int8
    counts on 256² blocks with the separable scales, the tail at 1024² and
    512 slots), with its tail as capacity classes when given."""
    import dataclasses

    import torch

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import graph as G
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import dense as D
    thr = D.hybrid_threshold(hg, "spmm", value_bytes=1)
    hyb = G.hybrid_graph(hg, block_rows=256, block_cols=256,
                         sparse_block_rows=1024, sparse_block_cols=1024,
                         tile_edges=512, min_nnz=thr, supergroup=16,
                         values_dtype=np.int8, tile_classes=tile_classes,
                         device=dev)
    sc = G.separable_weight_scales(hg)
    return dataclasses.replace(
        hyb, row_scale=torch.as_tensor(sc[0], device=dev),
        col_scale=torch.as_tensor(sc[1], device=dev))


def _gat_split(hg, dev, tile_classes=None):
    """The smoke's GAT layer-0 split (the attention recipe at 4 heads of
    32: int8 unit counts in 'cr' 256² blocks, the tail at 512 x 1024 and
    512 slots), with its tail as capacity classes when given."""
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import graph as G
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import dense as D
    thr = D.hybrid_threshold(hg, "gat", heads=HEADS, head_dim=HIDDEN // HEADS)
    return G.hybrid_graph(hg, block_rows=256, block_cols=256,
                          sparse_block_rows=512, sparse_block_cols=1024,
                          tile_edges=512, min_nnz=thr, unit_weight=True,
                          block_layout="cr", values_dtype=np.int8,
                          tile_classes=tile_classes, device=dev)


def _class_table(what, m, one) -> None:
    """Per class: capacity, tiles, slots, live slots and fill, against the
    one-class tail."""
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import roofline as RL
    for p in m.parts:
        live = RL.live_slots(p)
        slots = p.n_tiles * p.tile_edges
        say(f"  {what} class ET={p.tile_edges}: {p.n_tiles} tiles, {slots} "
            f"slots, {live} live, fill {live / max(slots, 1):.4f}")
    live = RL.live_slots(m)
    say(f"  {what} classes: {m.n_tiles} tiles, {m.total_slots} slots, fill "
        f"{live / m.total_slots:.4f}; one class (ET {one.tile_edges}): "
        f"{one.n_tiles} tiles, {one.n_tiles * one.tile_edges} slots, fill "
        f"{RL.live_slots(one) / (one.n_tiles * one.tile_edges):.4f}")
    if live != RL.live_slots(one):
        raise AssertionError(f"{what}: the classes hold {live} edges, the "
                             f"one-class tail {RL.live_slots(one)}")


def _class_kernel_times(checks: Checks, kernel, what, m, one, run, plain,
                        case, dispatch, dev) -> None:
    """``run(tiling)`` on every class part and on the one-class tail,
    each checked against ``plain(tiling)`` (``case(out, ref, tiling)``
    makes the KernelCase; the errors join the kernel's row) and timed
    (median of REPEATS, per call over CALLS); prints each class, their
    sum, the classes through the op's dispatch (``dispatch()``: the
    classes adding into one output where the op has one) and the
    one-class tail."""
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils.benchmark import median_ms

    def timed(fn):
        return median_ms(fn, device=dev, warmup=1, repeats=REPEATS,
                         calls=CALLS)

    total = 0.0
    for tag, t in [(f"ET={p.tile_edges}", p) for p in m.parts] + [
            (f"one class ET={one.tile_edges}", one)]:
        checks.compare(case(f"10b {what} {tag}", run(t), plain(t), t),
                       slice_shape=True)
        ms = timed(lambda: run(t))
        if t is one:
            ms_d = timed(dispatch)
            say(f"  {kernel:18s} {what}: classes summed {total:.4f} ms, "
                f"through the dispatch {ms_d:.4f} ms, one class {ms:.4f} "
                f"ms; ratios {total / ms:.3f}, {ms_d / ms:.3f}")
        else:
            total += ms
            say(f"  {kernel:18s} {what} {tag}: {ms:.4f} ms")


def _rel(y, ref) -> float:
    return float((y.float() - ref.float()).abs().max()) / max(
        1.0, float(ref.float().abs().max()))


def _hold(what, y, ref, tol) -> None:
    import torch
    if not bool(torch.isfinite(y).all()):
        raise AssertionError(f"{what}: non-finite output")
    rel = _rel(y, ref)
    say(f"  {what}: relative {rel:.3e} (bound {tol:.0e})")
    if not rel <= tol:
        raise AssertionError(f"{what}: relative error {rel} > {tol}")


def classes_on_smoke_graph(checks: Checks, hybs, hg, g, dev,
                           counts: _PathLaunches) -> None:
    """10b: the GCN and GAT splits with tile classes beside phase 4's
    one-class splits: the classes' fill, K1 / K3 / K11 per class and
    summed against the one-class tail, bf16 and float32 requests of
    spmm_hybrid and gat_hybrid against the one-class split, and the
    float32 gradient in x of a class-tail spmm_hybrid (K1 per class of the
    transposed graph's split) against per-op autograd on phase 7's reduced
    graph."""
    import torch

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import graph as G
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import dense as D
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import gat as A
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import sddmm as SD
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import spmm as SP
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import fixtures
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils.benchmark import median_ms
    K = fixtures.KernelCase
    t0 = time.perf_counter()
    gcn_one, gat_one = hybs["GCN-2l"][0], hybs["GAT-2l"][0]
    gcn = _gcn_split(hg, dev, CLASSES)
    gat = _gat_split(hg, dev, CLASSES)
    say(f"  class splits built in {time.perf_counter() - t0:.1f} s")
    for what, hy, one in (("GCN", gcn, gcn_one), ("GAT l0", gat, gat_one)):
        if hy.n_dense_edges != one.n_dense_edges:
            raise AssertionError(f"{what}: the class split moved dense edges")
        _class_table(what, hy.tiles, one.tiles)

    n = hg.n_node
    gen = torch.Generator(device=dev).manual_seed(10)
    xb = torch.randn((n, HIDDEN), generator=gen, device=dev).bfloat16()
    _class_kernel_times(
        checks, "spmm_tiles", "GCN F=128 bf16", gcn.tiles, gcn_one.tiles,
        lambda t: SP.spmm_tiles(t, xb, t.weight),
        lambda t: SP._spmm_reference(t, xb),
        lambda c, o, r, t: K("spmm_tiles", c, "bfloat16", o, r,
                             terms=fixtures.row_terms(t)),
        lambda: SP._spmm_raw(gcn.tiles, xb), dev)
    _class_kernel_times(
        checks, "sddmm_tiles", "GCN F=128 1 head bf16", gcn.tiles,
        gcn_one.tiles, lambda t: SD.sddmm_tiles(t, xb, xb, 1),
        lambda t: SD._sddmm_reference(t, xb, xb, 1),
        lambda c, o, r, t: K("sddmm_tiles", c, "bfloat16", fixtures._slots(o),
                             fixtures._slots(r),
                             scale=fixtures._slots(SD._sddmm_reference(
                                 t, xb.abs(), xb.abs(), 1))),
        lambda: SD.sddmm(gcn.tiles, xb, xb, heads=1), dev)
    w = (torch.randn((HIDDEN, HEADS), generator=gen, device=dev)
         / HIDDEN ** 0.5).bfloat16()
    a_d = torch.randn((n, HEADS), generator=gen, device=dev)
    a_s = D._a_s_kernel(xb, w)
    ms = a_s.amax(0, keepdim=True)
    _class_kernel_times(
        checks, "gat_tiles", "GAT l0 4x32 bf16", gat.tiles, gat_one.tiles,
        lambda t: A.gat_tiles(t, xb, t.weight, a_d, ms, a_src=a_s,
                              normalize=False),
        lambda t: A._gat_tiles_reference(t, xb, t.weight, a_d, ms,
                                         a_src=a_s, normalize=False),
        lambda c, o, r, t: K("gat_tiles", c, "bfloat16", o, r, HIDDEN,
                             fixtures.row_terms(t)),
        lambda: A._gat_forward(gat.tiles, xb, None, a_d, a_s=a_s,
                               normalize=False, msrc=ms), dev)

    say("  requests: class tail against the one-class split")
    for dtn, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        x, h, wk = xb.to(dt), xb.to(dt), w.to(dt)
        with torch.inference_mode():
            with counts:
                yc, msc = _timed(D.spmm_hybrid, gcn, g, x)
                oc, mgc = _timed(lambda: D.gat_hybrid(gat, g, h, None, a_d,
                                                      w_asrc=wk))
            y1, ms1 = _timed(D.spmm_hybrid, gcn_one, g, x)
            o1, mg1 = _timed(lambda: D.gat_hybrid(gat_one, g, h, None, a_d,
                                                  w_asrc=wk))
        say(f"  spmm_hybrid {dtn}: classes {msc:.3f} ms, one class "
            f"{ms1:.3f} ms; gat_hybrid: {mgc:.3f} / {mg1:.3f} ms (single "
            "calls)")
        _hold(f"spmm_hybrid {dtn} classes vs one class", yc, y1,
              E2E_TOL[dtn])
        _hold(f"gat_hybrid {dtn} classes vs one class", oc, o1, E2E_TOL[dtn])
        del yc, y1, oc, o1
    for what, hy, one, f in (
            ("spmm_hybrid", gcn, gcn_one, lambda hy: D.spmm_hybrid(hy, g, xb)),
            ("gat_hybrid", gat, gat_one,
             lambda hy: D.gat_hybrid(hy, g, xb, None, a_d, w_asrc=w))):
        with torch.inference_mode():
            t_c = median_ms(lambda: f(hy), device=dev, warmup=1,
                            repeats=REPEATS)
            t_1 = median_ms(lambda: f(one), device=dev, warmup=1,
                            repeats=REPEATS)
        say(f"  {what} bf16 request: classes {t_c:.4f} ms, one class "
            f"{t_1:.4f} ms (median of {REPEATS})")
    del gcn, gat, xb, a_d, a_s

    say("  float32 gradient in x of a class-tail spmm_hybrid (K1 per class "
        "of the transposed graph's split), reduced graph")
    hr, gr = reduced_graph(dev)
    hr_t, _ = G.transpose_host_graph(hr)
    hyb_r, twin_r = _gcn_split(hr, dev, CLASSES), _gcn_split(hr_t, dev,
                                                            CLASSES)
    xr = torch.randn((hr.n_node, HIDDEN), generator=gen, device=dev)
    rr = torch.randn((hr.n_node, HIDDEN), generator=gen, device=dev)
    dx = {}
    for path, f in (("kernel", lambda v: D.spmm_hybrid(hyb_r, gr, v,
                                                       hyb_t=twin_r)),
                    ("per-op", lambda v: D._spmm_ref_g(gr, v))):
        v = xr.clone().requires_grad_(True)
        with counts if path == "kernel" else contextlib.nullcontext():
            (f(v) * rr).sum().backward()
        dx[path] = v.grad
    _hold("d (spmm_hybrid . r) / dx float32", dx["kernel"], dx["per-op"],
          GRAD_TOL["grad"])
    del hyb_r, twin_r, gr, xr, rr, dx


def auto_hybrid_phase(hg, g, dev, counts: _PathLaunches) -> None:
    """10c: ``auto_hybrid`` (kind spmm, and gat at 4 heads of 32) on the
    smoke's graph: the threshold, tail geometry and capacity it picks, and
    one bf16 request each against the per-op formulation."""
    import dataclasses

    import torch

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import graph as G
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import dense as D
    n = hg.n_node
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn((n, HIDDEN), generator=gen, device=dev).bfloat16()
    for kind in ("spmm", "gat"):
        kw = dict(kind=kind, heads=HEADS, head_dim=HIDDEN // HEADS)
        t0 = time.perf_counter()
        plan = D.auto_hybrid_plan(hg, **kw)
        hy = D.auto_hybrid(hg, device=dev, **kw)
        nb = hy.dense.n_blocks if hy.dense is not None else 0
        say(f"  auto_hybrid {kind}: {plan}; dense edges {hy.n_dense_edges} "
            f"in {nb} blocks, tail {hy.n_sparse_edges} edges in "
            f"{hy.tiles.n_tiles} tiles; built in "
            f"{time.perf_counter() - t0:.1f} s")
        with torch.inference_mode():
            if kind == "spmm":
                sc = G.separable_weight_scales(hg)
                hy = dataclasses.replace(
                    hy, row_scale=torch.as_tensor(sc[0], device=dev),
                    col_scale=torch.as_tensor(sc[1], device=dev))
                with counts:
                    y, ms = _timed(D.spmm_hybrid, hy, g, x)
                ref = D._spmm_ref_g(g, x)
            else:
                w = (torch.randn((HIDDEN, HEADS), generator=gen, device=dev)
                     / HIDDEN ** 0.5).bfloat16()
                a_d = torch.randn((n, HEADS), generator=gen, device=dev)
                with counts:
                    y, ms = _timed(lambda: D.gat_hybrid(hy, g, x, None, a_d,
                                                        w_asrc=w))
                ref = D._gat_reference_g(g, x, D._a_s_kernel(x, w), a_d,
                                         0.2, weighted=False)
        say(f"  auto_hybrid {kind} bf16 request {ms:.3f} ms (single call)")
        _hold(f"auto_hybrid {kind} bf16 vs per-op", y[:n], ref,
              E2E_TOL["bfloat16"])
        del hy, y, ref


def sparse_input_phase(checks: Checks, model, hg, g, dev,
                       counts: _PathLaunches, tile_cache) -> None:
    """10d: GCN-2l (602, 128, 41) lowered with ``x_host`` = a seeded Zipf
    bag of words on the smoke's graph: the feature graph, its first layer
    against the dense x W, one bf16 request against the per-op path and
    one float32 request against it in float64, the float32 loss and W0's
    gradient against per-op autograd, and 1 warm-up and 2 timed bf16 AdamW steps in which K1 and
    K2 run in both directions of the sparse-input product.  The lowering
    takes phase 4's splits, twins and transposed graph from ``tile_cache``
    (the same hybrid schedules on the same graph)."""
    import torch

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import ir
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import fusion
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models import train as TT
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import primitives as P
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import sinput as SI
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import fixtures
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils.benchmark import median_ms
    n = hg.n_node
    t0 = time.perf_counter()
    X = fixtures.zipf_features(n, F_IN, density=BOW_DENSITY, seed=12)
    say(f"  X: {n} x {F_IN}, density {SI.density(X):.5f}, made in "
        f"{time.perf_counter() - t0:.1f} s")
    sched = fusion.hybrid_schedules(model.layers)
    cache, fns = _cache_from(tile_cache), {}
    t0 = time.perf_counter()
    for dtn, dt in (("bfloat16", torch.bfloat16), ("float32", None)):
        fns[dtn] = [fusion.lower_schedule(
            lg, s, hg, dt, device=dev, x_host=X if i == 0 else None,
            build_transpose=True, tile_cache=cache)
            for i, (lg, s) in enumerate(zip(model.layers, sched))]
    say(f"  lowered with x_host (both dtypes, twins; phase 4's splits) in "
        f"{time.perf_counter() - t0:.1f} s")

    def apply_of(fl):
        def apply(params, g_, x_):
            h = x_
            for f in fl:
                h = f(params, g_, h)
            return h
        return apply

    fwd = {dtn: apply_of(fl) for dtn, fl in fns.items()}
    fg = fns["bfloat16"][0].feature_graph
    if fg is None or fns["bfloat16"][1].feature_graph is not None:
        raise AssertionError("x_host must reach the first layer only")
    for tag, hy in (("forward", fg.fwd), ("backward", fg.bwd)):
        nb = hy.dense.n_blocks if hy.dense is not None else 0
        say(f"  feature graph {tag}: nnz {fg.nnz}, dense {hy.n_dense_edges} "
            f"in {nb} blocks, tail {hy.n_sparse_edges} in "
            f"{hy.tiles.n_tiles} tiles")
    for c in fixtures.sinput_kernel_cases(dev):
        checks.compare(c, slice_shape=True)
    w0 = next(op.extra["weight"][0] for op in model.layers[0].ops
              if op.compute == ir.MM and op.inputs == [ir.X_INPUT])
    params = dict(model.params)
    x = torch.tensor(X, device=dev)
    with torch.inference_mode():
        t_s = median_ms(lambda: SI.sparse_input_mm(
            fg, params[w0], compute_dtype=torch.bfloat16), device=dev,
            warmup=1, repeats=REPEATS, calls=CALLS)
        t_d = median_ms(lambda: P.dense_mm(x, params[w0], torch.bfloat16),
                        device=dev, warmup=1, repeats=REPEATS, calls=CALLS)
        t_c = median_ms(lambda: fg.fwd.dense.values.to(torch.bfloat16),
                        device=dev, warmup=1, repeats=REPEATS, calls=CALLS)
    say(f"  first layer bf16: sparse input {t_s:.4f} ms (of it the dense "
        f"blocks' float32 -> bf16 cast {t_c:.4f} ms) against the dense x W "
        f"{t_d:.4f} ms (its cast of x included)")

    with torch.inference_mode():
        for dtn, dt in (("bfloat16", torch.bfloat16), ("float32", None)):
            with counts:
                y, ms = _timed(fwd[dtn], params, g, x)
            ref, ms_r = _timed(model.make_apply(dt), params, g, x)
            say(f"  GCN-2l sparse-input {dtn} request {ms:.3f} ms, per-op "
                f"{ms_r:.3f} ms (single calls)")
            if tuple(y.shape) != (n, N_CLASS):
                raise AssertionError(f"sparse input: output {tuple(y.shape)}")
            if dt is None:
                # float32 against the per-op path in float64 (as 7b): both
                # float32 paths reorder their sums over the hub rows by
                # atomics, and at the trained parameters the two orders
                # drift apart by about the bound (printed, unbound)
                say(f"  GCN-2l sparse-input float32 vs per-op float32: "
                    f"relative {_rel(y, ref):.3e} (unbound)")
                p64 = {k: p.detach().double() for k, p in params.items()}
                ref64 = model.make_apply(None)(p64, g, x.double())
                say(f"  per-op float32 vs per-op float64: relative "
                    f"{_rel(ref, ref64):.3e}")
                ref = ref64
                del p64
            _hold(f"GCN-2l sparse-input {dtn} vs per-op"
                  f"{' float64' if dt is None else ''}", y, ref,
                  E2E_TOL[dtn])
            del y, ref
        t_k = median_ms(lambda: fwd["bfloat16"](params, g, x), device=dev,
                        warmup=1, repeats=REPEATS)
        say(f"  GCN-2l sparse-input bf16 request median {t_k:.3f} ms")

    rng = np.random.default_rng(13)
    wy = torch.tensor(rng.standard_normal((F_IN, N_CLASS),
                                          dtype=np.float32), device=dev)
    labels = (x @ wy).argmax(dim=1)
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    lk, gk, sk = _loss_and_grads(model, fwd["float32"], g, x, labels, mask)
    lr, gr, sr = _loss_and_grads(model, model.make_apply(None), g, x,
                                 labels, mask)
    rel = abs(lk - lr) / max(1.0, abs(lr))
    say(f"  float32 loss {lk:.6f} against per-op {lr:.6f}: relative "
        f"{rel:.3e} (bound {GRAD_TOL['loss']:.0e}); {sk:.2f} / {sr:.2f} s")
    if not rel <= GRAD_TOL["loss"]:
        raise AssertionError(f"sparse input: loss {lk} vs per-op {lr}")
    _hold(f"d loss / d {w0} float32", gk[w0], gr[w0], GRAD_TOL["grad"])
    del gk, gr

    # K1 and K2 launches per direction of the sparse-input product during
    # the steps, read from the wrappers' counts around each product
    tally = {"forward": [0, 0], "backward": [0, 0]}
    orig = SI._apply_hybrid
    k12 = (_p10_counted()["spmm_tiles"], _p10_counted()["spmm_dense_blocks"])

    def recording(hyb, v, rows):
        before = [f.launches for f in k12]
        y = orig(hyb, v, rows)
        side = tally["forward" if hyb is fg.fwd else "backward"]
        for i, f in enumerate(k12):
            side[i] += f.launches - before[i]
        return y

    state = TT.TrainState(model.params, TT.adamw(model.params, LR))
    step = TT.make_train_step(fwd["bfloat16"])
    losses, times = [], []
    SI._apply_hybrid = recording
    try:
        with counts:
            for i in range(3):
                (state, loss), ms = _timed(step, state, g, x, labels, mask)
                losses.append(float(loss))
                if i:
                    times.append(ms)
    finally:
        SI._apply_hybrid = orig
    model.zero_grad(set_to_none=True)
    say(f"  GCN-2l sparse-input bf16 steps: losses "
        f"{['%.5f' % v for v in losses]}, step ms "
        f"{['%.3f' % t for t in times]}; K1, K2 launches of the product "
        f"{tally}")
    if not all(np.isfinite(losses)):
        raise AssertionError("sparse input: non-finite loss")
    for side, (k1, k2) in tally.items():
        if k1 <= 0 or k2 <= 0:
            raise AssertionError(f"sparse input {side}: K1 {k1}, K2 {k2} "
                                 "launches")
    del fns, fwd, fg, cache, x, state, step


def cli_bench_phase(counts: _PathLaunches) -> None:
    """10e: ``cli.py bench`` on cora at --batch 64, three runs in this
    process; each must return 0 and print finite numbers."""
    import io
    import math

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import cli
    for tag, extra in BENCH_RUNS:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with counts, contextlib.redirect_stdout(buf):
            rc = cli.main(["bench", "--dataset", "cora", "--batch", "64",
                           "--json", "--device", "cuda"] + extra)
        out = json.loads(buf.getvalue().strip().splitlines()[-1])
        nums = [v for v in out.values() if isinstance(v, float)]
        say(f"  cli bench {tag} ({time.perf_counter() - t0:.1f} s): "
            f"geometry {out.get('sparse_block')} ET {out.get('tile_edges')} "
            f"classes {out.get('tile_classes')}, {out['n_edge']} edges, "
            f"fill {out['fill']:.4f}; SpMM {out['spmm_latency_us']:.1f} us, "
            f"{out['spmm_edges_per_s'] / 1e9:.3f} Gedge/s, bound share "
            f"{out['spmm_bound_share']:.3f}; SDDMM "
            f"{out['sddmm_latency_us']:.1f} us, "
            f"{out['sddmm_edges_per_s'] / 1e9:.3f} Gedge/s, bound share "
            f"{out['sddmm_bound_share']:.3f}")
        say("    " + json.dumps(out))
        if rc != 0 or not out["finite"] or not all(
                math.isfinite(v) for v in nums):
            raise AssertionError(f"cli bench {tag}: rc {rc}, {out}")


def classes_sinput_phase(checks: Checks, models, hybs, hg, g, dev,
                         tile_cache) -> dict:
    """Phase 10; returns the launches of its kernels on its paths
    (``tile_cache``: phase 4's, for 10d)."""
    import torch

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import fixtures
    t_phase = time.perf_counter()
    counts = _PathLaunches()
    say("== 10a K1, K3, K11 on the class fixtures; K1, K2 on the "
        "sparse-input fixture")
    for c in fixtures.class_kernel_cases(dev):
        checks.compare(c, slice_shape=True)
    say("== 10b tile classes on the smoke's graph")
    classes_on_smoke_graph(checks, hybs, hg, g, dev, counts)
    torch.cuda.empty_cache()
    say("== 10c auto_hybrid on the smoke's graph")
    auto_hybrid_phase(hg, g, dev, counts)
    torch.cuda.empty_cache()
    say("== 10d sparse input: GCN-2l with x_host")
    sparse_input_phase(checks, models["GCN-2l"], hg, g, dev, counts,
                       tile_cache)
    torch.cuda.empty_cache()
    say("== 10e cli bench, cora x 64")
    cli_bench_phase(counts)
    torch.cuda.empty_cache()
    say(f"launches on phase 10's paths: {counts.total}; phase 10 took "
        f"{_took('10', t_phase):.1f} s")
    for k, v in counts.total.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} was not launched in phase 10")
    return counts.total


# phase 11: the compile-only pick.  The GA's measurements per candidate
# (``cli tune --ga``'s ``--target-s``) are phase 8e's
PICK_BOUND = {"spearman": 0.8, "argmin_regret": 1.20}


def _all_counted():
    """Every kernel's wrapper, by the kernels line's names."""
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import dense as D
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import gat as A
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import gatv2 as GV
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import pairagg as PA
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import sddmm as SD
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import spmm as SP
    return {"spmm_tiles": SP.spmm_tiles,
            "spmm_dense_blocks": D.spmm_dense_blocks,
            "gat_tiles": A.gat_tiles, "gat_dense_blocks": D.gat_dense_blocks,
            "gat_bwd_tiles_dad": A.gat_bwd_tiles_dad,
            "gat_bwd_tiles_src": A.gat_bwd_tiles_src,
            "gat_dense_bwd_dad": D.gat_dense_bwd_dad,
            "gat_dense_bwd_src": D.gat_dense_bwd_src,
            "spmm_grouped": SP.spmm_grouped, "gat_grouped": A.gat_grouped,
            "sddmm_tiles": SD.sddmm_tiles, "sddmm_grouped": SD.sddmm_grouped,
            "pair_agg": PA.pair_agg, "gat_layer": A.gat_layer_tiles,
            "gat_dense_panel": D.gat_dense_panel_blocks,
            "gatv2_attn": GV.gatv2_attn}


@contextlib.contextmanager
def _launch_window(what: str):
    """Sets every kernel's count to 0, yields, then prints the kernels that
    launched and fails if none did."""
    counted = _all_counted()
    for f in counted.values():
        f.launches = 0
    yield
    launched = {k: f.launches for k, f in counted.items() if f.launches}
    say(f"  {what}: launches {launched}")
    if not launched:
        raise AssertionError(f"{what}: no kernel K1-K15 launched")


def _kinds(layer, sc):
    """The kinds of a layer schedule's kernel blocks."""
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler.fusion import classify_block
    return [classify_block(layer, b, tc)[0]
            for b, tc in zip(sc.blocks, sc.tiles) if tc.kernel]


def _tiles(sc) -> str:
    return ";".join("x".join(map(str, t.key())) for t in sc.tiles
                    if t.kernel) or "per-op"


def compile_picks(models, hg, cost) -> dict:
    """11a: each layer's compile-only pick at its own input width, every
    candidate's modelled ms printed, and the host seconds per pick."""
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler.latency import priced_candidates
    picks = {}
    for mname, model in models.items():
        scheds, total = [], 0.0
        for li, layer in enumerate(model.layers):
            t0 = time.perf_counter()
            priced = priced_candidates(layer, hg, cost=cost)
            best, t_ns = min(priced, key=lambda p: p[1])
            secs = time.perf_counter() - t0
            scheds.append(best)
            total += t_ns
            say(f"  {mname} layer {li} (F={layer.in_width}): pick "
                f"{_kinds(layer, best)} {_tiles(best)}, "
                f"modelled {t_ns / 1e6:.3f} ms; {len(priced)} candidates "
                f"priced in {secs:.2f} s")
            for cand, t in sorted(priced, key=lambda p: p[1]):
                say(f"    {t / 1e6:10.3f} ms  {_kinds(layer, cand)} "
                    f"{_tiles(cand)}")
        picks[mname] = (scheds, total / 1e6)
    return picks


def _cache_from(*caches) -> dict:
    """A tile cache (``lower_schedule``'s) holding the entries of
    ``caches``, their nested dicts merged; what a lowering adds to it stays
    out of theirs."""
    out = {}
    for c in caches:
        for k, v in c.items():
            if isinstance(v, dict):
                out.setdefault(k, {}).update(v)
            else:
                out[k] = v
    return out


def _lower_both(model, scheds, hg, dev, cache=None):
    """The stack under ``scheds`` per dtype, over one tile cache
    (``cache``, default a fresh one)."""
    import torch

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler.fusion import lower_schedule
    cache = {} if cache is None else cache
    out = {}
    for dtn, dt in (("bfloat16", torch.bfloat16), ("float32", None)):
        fns = [lower_schedule(layer, sc, hg, dt, device=dev,
                              tile_cache=cache)
               for layer, sc in zip(model.layers, scheds)]

        def apply(params, g, x, fns=fns):
            for fn in fns:
                x = fn(params, g, x)
            return x
        out[dtn] = apply
    return out


def _serve(what, fns, params, g, n, dev) -> tuple:
    """3 bf16 and 1 float32 requests through ``fns`` (phase 4's seeds), in
    one launch window: (answers, bf16 median ms)."""
    import torch
    reqs = [("bfloat16", i) for i in range(REQUESTS)] + [("float32", 0)]
    outs, lat = {}, []
    with torch.inference_mode(), _launch_window(what):
        for dtn, seed in reqs:
            y, ms = _timed(fns[dtn], params, g, _request_x(seed, n, dev))
            outs[(dtn, seed)] = y
            if dtn == "bfloat16":
                lat.append(ms)
    say(f"  {what}: bf16 requests {['%.3f' % t for t in lat]} ms, median "
        f"{statistics.median(lat):.3f}")
    return outs, statistics.median(lat)


def _hold_answers(what, outs, refs, rows: bool = False) -> None:
    """Each answer within E2E_TOL of its reference (of max |ref|, or per
    row of the row's own max)."""
    import torch
    for (dtn, seed), y in outs.items():
        ref = refs[(dtn, seed)]
        rel = float(_row_rel(y, ref).max()) if rows else _rel_err(y, ref)
        say(f"  {what} {dtn} seed={seed}: relative {rel:.3e} "
            f"{'(worst row) ' if rows else ''}to the reference (bound "
            f"{E2E_TOL[dtn]:.0e})")
        if not (y.shape == ref.shape and bool(torch.isfinite(y).all())
                and rel <= E2E_TOL[dtn]):
            raise AssertionError(f"{what} {dtn} seed={seed}: {rel}")


def _time_requests(what, model, scheds, hg, g, dev) -> float:
    """Median ms of 3 bf16 requests under ``scheds`` (after a warm-up)."""
    import torch
    fn = model.make_apply(torch.bfloat16, schedules=scheds, host_graph=hg,
                          device=dev)
    params = dict(model.params)
    lat = []
    with torch.inference_mode():
        fn(params, g, _request_x(0, hg.n_node, dev))
        for seed in range(REQUESTS):
            lat.append(_timed(fn, params, g,
                              _request_x(seed, hg.n_node, dev))[1])
    say(f"  {what}: bf16 requests {['%.3f' % t for t in lat]} ms")
    return statistics.median(lat)


def rank_on_card(mname, model, pick, measured, hg, g, dev, cost) -> dict:
    """11c: modelled against measured whole 2-layer schedules: the ones
    the smoke serves on this graph and the pick."""
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import schedule as S
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler.fusion import (
        gat_onehot_schedules, hybrid_schedules)
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler.latency import (
        rank_stats, schedule_ns)
    per_op = [S.Schedule(blocks=S.singleton_partition(layer),
                         tiles=tuple(S.TileConfig(path=S.PATH_XLA)
                                     for _ in layer.ops))
              for layer in model.layers]
    stream = path_schedules(model, S.TileConfig(
        tile_edges=STREAM_TILE_EDGES[0], path=S.PATH_STREAM))
    rows = [("hybrid (phase 4)", hybrid_schedules(model.layers),
             measured[(mname, "hybrid")]),
            ("stream (phase 9)", stream, measured[(mname, "stream")]),
            ("per-op (phase 4c)", per_op, measured[(mname, "per-op")])]
    if mname == "GCN-2l":
        tc = S.TileConfig(512, 512, 128, S.PATH_GROUPED)
        grouped = path_schedules(model, tc)
        rows.insert(1, ("grouped (6c)", grouped, _time_requests(
            f"{mname} grouped (6c's schedule)", model, grouped, hg, g,
            dev)))
    else:
        tile = S.TileConfig(*LAYER_TILE)
        rows.insert(1, ("gat_layer kind (8b)",
                        gat_onehot_schedules(model.layers, whole_layer=True,
                                             tile=tile),
                        measured[(mname, "gat_layer")]))
        gat = gat_onehot_schedules(model.layers, whole_layer=False,
                                   tile=tile)
        rows.insert(2, ("gat kind (8c)", gat, _time_requests(
            f"{mname} gat kind (8c's schedule)", model, gat, hg, g, dev)))
    rows.append(("pick (11b)", pick, measured[(mname, "pick")]))
    mod = [sum(schedule_ns(layer, sc, cost) for layer, sc in
               zip(model.layers, scheds)) / 1e6 for _, scheds, _ in rows]
    meas = [r[2] for r in rows]
    st = rank_stats(meas, mod)
    for (what, _, m), t in zip(rows, mod):
        say(f"  {mname} {what:22s} measured {m:9.3f} ms, modelled "
            f"{t:9.3f} ms")
    say(f"  {mname}: Spearman's rho {st['spearman']:.3f} (bound >= "
        f"{PICK_BOUND['spearman']}), argmin regret {st['argmin_regret']:.3f}"
        f" (the pick's measured time over the fastest; bound <= "
        f"{PICK_BOUND['argmin_regret']})")
    if not (st["spearman"] >= PICK_BOUND["spearman"]
            and st["argmin_regret"] <= PICK_BOUND["argmin_regret"]):
        raise AssertionError(f"{mname}: rank check {st}")
    return st


def compiled_training(mname, model, scheds, hg, g, dev, cache) -> None:
    """11d: 4 bf16 AdamW steps on the pick with its transposed twins
    (``train --compiled``'s lowering, over ``cache``: 11b's splits of the
    pick and phase 4's transposed graph and twins): losses finite and
    falling."""
    import torch

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models import train as TT
    t0 = time.perf_counter()
    fn = model.make_apply(torch.bfloat16, schedules=scheds, host_graph=hg,
                          device=dev, build_transpose=True, tile_cache=cache)
    say(f"  {mname} lowering with twins (11b's splits and phase 4's "
        f"transposed graph reused) {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(14)
    x = torch.tensor(rng.standard_normal((hg.n_node, F_IN),
                                         dtype=np.float32), device=dev)
    wy = torch.tensor(rng.standard_normal((F_IN, N_CLASS), dtype=np.float32),
                      device=dev)
    labels = (x @ wy).argmax(dim=1)
    mask = torch.ones(hg.n_node, dtype=torch.bool, device=dev)
    state = TT.TrainState(model.params, TT.adamw(model.params, LR))
    step = TT.make_train_step(fn)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    losses, times = [], []
    with _launch_window(f"{mname} train --compiled steps"):
        for _ in range(TRAIN_STEPS):
            (state, loss), ms = _timed(step, state, g, x, labels, mask)
            losses.append(float(loss))
            times.append(ms)
    say(f"  {mname} train --compiled: losses {['%.5f' % v for v in losses]}"
        f", step ms {['%.2f' % t for t in times]}, peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{mname} train --compiled: losses {losses}")
    model.zero_grad(set_to_none=True)


def _cli_json(argv) -> tuple:
    """(exit code, last JSON line) of ``cli.main(argv)``."""
    import io

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    return rc, json.loads(lines[-1]) if lines else {}


def cora_rank_check(net, memo) -> None:
    """The model's ranking at cora's size against the GA's memo
    (``latency.rank_check``), per layer of the CLI's model; printed, not
    bound: at this size a request's time is the host's."""
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler.latency import rank_check
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.data.datasets import load_dataset
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models.zoo import build_model
    ds = load_dataset("cora")
    model = build_model(net, ds.x.shape[1], ds.n_class, device="cpu")
    for li, layer in enumerate(model.layers):
        r = rank_check(memo, layer.name, layer, ds.host_graph)
        if r is not None:
            say(f"  {net} on cora layer {li}: rank_check over the GA's "
                f"{len(r['rows'])} measurements: rho {r['spearman']:.3f}, "
                f"argmin regret {r['argmin_regret']:.3f}")


def compiled_cli(measured) -> None:
    """11e: on cora through ``cli.main``, for GCN and GAT: ``run
    --compiled``, ``train --compiled --epochs 3`` and ``tune --ga --stack``
    at phase 8e's seconds per measurement; the GA's best against 8e's
    ``autotune`` best, and the model's rank check over the GA's memo."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="gta_ga_")
    try:
        for net in ("GCN", "GAT"):
            base = ["--dataset", "cora", "--network", net, "--json"]
            runs = (("run", ["run", *base, "--compiled"]),
                    ("train", ["train", *base, "--compiled", "--epochs",
                               "3"]),
                    ("tune --ga", ["tune", *base, "--ga", "--stack",
                                   "--target-s", str(TUNE_TARGET_S),
                                   "--memo", os.path.join(tmp, "memo.csv"),
                                   "--schedule",
                                   os.path.join(tmp, f"{net}.json")]))
            for what, argv in runs:
                t0 = time.perf_counter()
                rc, out = _cli_json(argv)
                keys = {k: out.get(k) for k in (
                    "modelled_us", "latency_ms_median", "train_loss",
                    "stack_latency_us", "schedule") if k in out}
                say(f"  cli {what} {net}: rc {rc} in "
                    f"{time.perf_counter() - t0:.1f} s; {keys}")
                if rc != 0:
                    raise AssertionError(f"cli {what} {net} exited {rc}")
            ga, at = out["stack_latency_us"], measured[("tune", net)]
            say(f"  {net} on cora: GA best {ga:.1f} us against 8e's autotune "
                f"best {at:.1f} us ({ga / at:.3f}x)")
            cora_rank_check(net, os.path.join(tmp, "memo.csv"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def compiled_phase(models, init_params, measured, hg, g, dev,
                   tile_cache) -> None:
    """Phase 11: the compile-only pick on the card (see the module
    docstring); ``tile_cache``: phase 4's, whose transposed graph and twins
    11d's lowerings share."""
    import torch

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler.latency import GraphCost
    t_phase = time.perf_counter()
    say("== 11a compile-only picks (the card's LatencyConstants)")
    every = dict(models)
    every.update(measured["pair models"])
    for mname, model in models.items():
        _restore(model, init_params[mname])
    picks = compile_picks(every, hg, GraphCost(hg))

    say("== 11b serving the picks")
    caches = {}      # GCN-2l's and GAT-2l's pick splits, for 11d
    for mname, model in every.items():
        scheds = picks[mname][0]
        t0 = time.perf_counter()
        cache = {}
        if mname in models:
            caches[mname] = cache
        fns = _lower_both(model, scheds, hg, dev, cache)
        say(f"  {mname} pick lowered in {time.perf_counter() - t0:.1f} s")
        outs, measured[(mname, "pick")] = _serve(
            f"{mname} pick", fns, dict(model.params), g, hg.n_node, dev)
        _hold_answers(f"{mname} pick", outs, measured[(mname, "answers")])
        del fns, outs
    hr, gr = reduced_graph(dev)
    rpicks = compile_picks(measured["pair models"], hr, GraphCost(hr))
    for mname, model in measured["pair models"].items():
        fns = _lower_both(model, rpicks[mname][0], hr, dev)
        x = _request_x(21, hr.n_node, dev)
        params = dict(model.params)
        p64 = {k: p.detach().double() for k, p in model.params.items()}
        with torch.inference_mode():
            outs = {(dtn, 0): fns[dtn](params, gr, x)
                    for dtn in ("bfloat16", "float32")}
            refs = {("bfloat16", 0): model.make_apply(torch.bfloat16)(
                params, gr, x),
                ("float32", 0): model.make_apply(None)(p64, gr, x.double())}
        _hold_answers(f"{mname} reduced-graph pick (bf16: per-op bf16; float32: "
              "per-op float64)", outs, refs, rows=True)
        del fns, outs, refs
    del hr, gr

    say("== 11c rank check on the card: whole 2-layer schedules")
    cost = GraphCost(hg)
    for mname in ("GCN-2l", "GAT-2l"):
        rank_on_card(mname, models[mname], picks[mname][0], measured, hg, g,
                     dev, cost)

    say("== 11d train --compiled on the smoke's graph")
    for mname in ("GCN-2l", "GAT-2l"):
        compiled_training(mname, models[mname], picks[mname][0], hg, g, dev,
                          _cache_from(tile_cache, caches.pop(mname)))
        _restore(models[mname], init_params[mname])

    say("== 11e cli run / train --compiled and tune --ga on cora")
    compiled_cli(measured)
    say(f"phase 11 took {_took('11', t_phase):.1f} s")


# phase 12: neighbour-sampled training, float32 (TF32 off), the per-op
# path (no kernel of K1-K15 launches there).  Flickr is BASELINE.json's
# sampled configuration (scripts/baseline_configs.py:66-79), Reddit at its
# full edge count the north star's epoch (scripts/reddit_epoch.py:52-56).
SAMPLED = dict(fanouts=(10, 10), batch_size=512, hidden=128, epochs=3)
REDDIT_EDGES = 114_615_892
CAPTURE_STEPS = 8      # 12d: 3 eager warm-up steps, then 5 replays
# 12d.1: captured replays against the eager loop, relative per loss: the
# two run the same kernels, but index_add_'s float atomics reorder sums
CAPTURE_TOL = 1e-4


@contextlib.contextmanager
def _numpy_host_path():
    """The host builders' numpy formulations (``native.HAVE_NATIVE``
    off) inside the block."""
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import native
    was, native.HAVE_NATIVE = native.HAVE_NATIVE, False
    try:
        yield
    finally:
        native.HAVE_NATIVE = was


def _equal_arrays(what, a, b) -> None:
    for k in a:
        if not np.array_equal(np.asarray(a[k]), np.asarray(b[k])):
            raise AssertionError(f"{what}: {k} differs")


def native_phase(smoke_coo, dev) -> None:
    """12a: the native host library on the smoke's graph (``smoke_coo``:
    phase 4's senders, receivers and planted labels): its sort, degrees
    and tiling against numpy's, ``build_host_graph`` both ways,
    ``cluster_labels`` and the cluster reorder's dense share."""
    import torch

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import graph as G
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import native

    say("== 12a native host library")
    if not native.HAVE_NATIVE:
        raise AssertionError("the native host library did not build on the "
                             f"card's host: {native.BUILD_ERROR}")
    say(f"  built and self-tested (g++ {native.build_seconds or 0:.1f} s "
        "in this process)")
    s, r, labels = smoke_coo
    order = native.sort_by_receiver_native(r, N_NODE)
    if not np.array_equal(order, np.argsort(r, kind="stable")):
        raise AssertionError("sort_by_receiver_native differs from numpy")
    out_deg, in_deg = native.degrees_native(s, r, N_NODE)
    if not (np.array_equal(in_deg, np.bincount(r, minlength=N_NODE))
            and np.array_equal(out_deg, np.bincount(s, minlength=N_NODE))):
        raise AssertionError("degrees_native differs from numpy")
    kw = dict(add_self_loops=True, symmetric_norm=True)
    t0 = time.perf_counter()
    hg = G.build_host_graph(s, r, N_NODE, **kw)
    t_nat = time.perf_counter() - t0
    with _numpy_host_path():
        t0 = time.perf_counter()
        hg_np = G.build_host_graph(s, r, N_NODE, **kw)
        t_np = time.perf_counter() - t0
    _equal_arrays("build_host_graph", vars(hg), vars(hg_np))
    say(f"  build_host_graph ({hg.n_edge} edges): native {t_nat:.2f} s, "
        f"numpy {t_np:.2f} s, arrays equal; sort and degrees equal numpy's")
    del hg_np, order, s, r
    geo = dict(block_rows=256, block_cols=256, tile_edges=512, device="cpu")
    t0 = time.perf_counter()
    tg = G.tile_graph(hg, **geo)
    t_nat = time.perf_counter() - t0
    with _numpy_host_path():
        t0 = time.perf_counter()
        tg_np = G.tile_graph(hg, **geo)
        t_np = time.perf_counter() - t0
    for f in ("tile_rb", "tile_cb", "src_local", "dst_local", "edge_id",
              "weight", "row_first_tile"):
        if not torch.equal(getattr(tg, f), getattr(tg_np, f)):
            raise AssertionError(f"tile_graph: {f} differs")
    say(f"  tile_graph 256x256 ET512 ({tg.n_tiles} tiles): native "
        f"{t_nat:.2f} s, numpy {t_np:.2f} s, arrays equal")
    del tg, tg_np

    t0 = time.perf_counter()
    found = G.cluster_labels(hg)
    t_lab = time.perf_counter() - t0
    t0 = time.perf_counter()
    hc, perm = G.reorder_nodes(hg, "cluster")
    t_re = time.perf_counter() - t0
    if not np.array_equal(np.sort(perm), np.arange(N_NODE)):
        raise AssertionError("reorder_nodes('cluster') is not a permutation")
    hl, _ = G.reorder_nodes(hg, "hubs+labels", labels=labels)
    say(f"  cluster_labels: {int(found.max()) + 1} communities (1000 "
        f"planted) in {t_lab:.2f} s; reorder_nodes('cluster') "
        f"{t_re:.2f} s, a permutation")
    for what, g2 in (("cluster", hc), ("hubs+labels (planted)", hl)):
        h = G.hybrid_graph(g2, block_rows=256, block_cols=256,
                           tile_edges=512, min_nnz=64, unit_weight=True,
                           values_dtype=np.int8, device=dev)
        share = h.n_dense_edges / max(h.n_dense_edges + h.n_sparse_edges, 1)
        say(f"  256² int8 hybrid split (thr 64) after {what}: dense share "
            f"{share:.4f} ({h.n_dense_edges} edges)")
        del h


def _say_sampled(what, res, bd) -> None:
    say(f"  {what}: wall epoch {res.epoch_time_s:.4f} s, device epoch "
        f"{bd.get('device_epoch_s', float('nan')):.4f} s, sample_s "
        f"{bd['sample_s']:.4f}, h2d_dispatch_s {bd['h2d_dispatch_s']:.4f}, "
        f"{bd['steps_per_epoch']} steps an epoch, sampler {bd['sampler']}, "
        f"{res.edges_per_s / 1e6:.2f} Medge/s sampled; epoch mean losses "
        f"{['%.4f' % v for v in bd['epoch_losses']]}, last {res.train_loss:.4f}")
    if not bd["epoch_losses"][-1] < bd["epoch_losses"][0]:
        raise AssertionError(f"{what}: losses did not fall")
    if bd["sampler"] != "native":
        raise AssertionError(f"{what}: sampled with {bd['sampler']}")


def _seeded_sage(ds, dev):
    """GraphSAGE at SAMPLED's widths, parameters from seed 0."""
    import torch

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models.zoo import build_model
    return build_model("GraphSAGE", ds.x.shape[1], ds.n_class,
                       hidden=SAMPLED["hidden"],
                       generator=torch.Generator().manual_seed(0),
                       device=dev)


def _sampled_runner(ds, dev, capture: bool, cap_n: int, e_pad: int):
    """A seeded GraphSAGE, its capturable AdamW state and an EpochRunner
    over it."""
    import torch

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models import train as TT
    model = _seeded_sage(ds, dev)
    state = TT.TrainState(model.params, TT.adamw(model.params, LR,
                                                 capturable=True))
    update = TT.make_sampled_update(
        model.make_apply(), state, cap_n, e_pad,
        torch.as_tensor(ds.x, device=dev),
        torch.as_tensor(ds.y.astype(np.int64), device=dev))
    return state, TT.EpochRunner(update, capture=capture)


def _wall_epoch(runner, stacked, n) -> float:
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.run(stacked, n)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def sampled_card_checks(ds, dev) -> None:
    """12d on Reddit: captured replays against the eager loop (losses and
    epoch times: per-step dispatch against the captured graph), one
    batch's loss and gradients on the card against the port on the CPU,
    the native sampler's repeat, and the device-epoch measurement's
    restore."""
    import torch

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import native
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.data.sampling import NeighborSampler
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.graph import GraphTensor
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models import train as TT

    say("== 12d sampled training on the card: checks")
    b = SAMPLED["batch_size"]
    sampler = NeighborSampler(ds.host_graph, SAMPLED["fanouts"], b, seed=0)
    perm = sampler.rng.permutation(np.flatnonzero(ds.train_mask))
    n = len(perm) // b
    args = (sampler.row_ptr, sampler.senders, perm[: n * b],
            SAMPLED["fanouts"], b, sampler.cap_nodes, sampler.e_pad, 12)
    t0 = time.perf_counter()
    stacked_np = native.sample_epoch_native(*args)
    t_s = time.perf_counter() - t0
    _equal_arrays("sample_epoch_native repeat", stacked_np,
                  native.sample_epoch_native(*args))
    say(f"  12d.3 sample_epoch_native: {n} batches in {t_s:.3f} s; a second "
        "call with the seed gives the same arrays")
    stacked = TT.batch_to_device(stacked_np, dev)
    cap_n, e_pad = sampler.cap_nodes, sampler.e_pad

    losses, walls, runners = {}, {}, {}
    for mode, capture in (("captured", True), ("eager", False)):
        state, runner = _sampled_runner(ds, dev, capture, cap_n, e_pad)
        lv = torch.zeros(n, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.run(stacked, n, lv)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        walls[mode] = [first] + [_wall_epoch(runner, stacked, n)
                                 for _ in range(2)]
        losses[mode] = lv.cpu()
        runners[mode] = (runner, state)
        say(f"  {mode}: one epoch of {n} steps, wall {walls[mode][0]:.4f} s "
            f"(first, {runner.eager_steps} eager steps, "
            f"{runner.replays} replays), then "
            f"{walls[mode][1]:.4f} / {walls[mode][2]:.4f} s")
    k = min(CAPTURE_STEPS, n)
    rel = float(((losses["captured"][:k] - losses["eager"][:k]).abs()
                 / losses["eager"][:k].abs()).max())
    say(f"  12d.1 first {k} losses (3 warm-up, 5 replays), captured "
        f"{['%.6f' % v for v in losses['captured'][:k].tolist()]} vs eager: "
        f"max relative {rel:.2e} (bound {CAPTURE_TOL:g})")
    if not rel <= CAPTURE_TOL:
        raise AssertionError(f"captured vs eager losses: {rel}")
    say(f"  per-step dispatch (eager loop) {min(walls['eager'][1:]):.4f} s "
        f"an epoch against the captured graph's "
        f"{min(walls['captured'][1:]):.4f} s")

    runner, state = runners["captured"]
    snap = TT.snapshot(state)
    sec = TT.device_epoch_seconds(runner, state, stacked, n)
    same = all(torch.equal(a, c) for a, c in zip(TT.snapshot(state), snap,
                                                 strict=True))
    say(f"  12d.4 device epoch {sec:.4f} s; parameters and AdamW state after "
        f"the measurement equal the snapshot bit for bit: {same}")
    if not same:
        raise AssertionError("device_epoch_seconds did not restore the state")
    del runners, runner, state

    # 12d.2: batch 0, card against the port on the CPU, seeded parameters
    out = {}
    for side, where in (("card", dev), ("cpu", torch.device("cpu"))):
        model = _seeded_sage(ds, where)
        bt = {key: v[0].to(where) for key, v in stacked.items()}
        g = GraphTensor(senders=bt["senders"], receivers=bt["receivers"],
                        edge_mask=bt["mask"], edge_weight=bt["weight"],
                        n_node=cap_n, n_edge=e_pad)
        xb, yb = TT.gather_rows(torch.as_tensor(ds.x, device=where),
                                torch.as_tensor(ds.y.astype(np.int64),
                                                device=where), bt["ids"])
        params = dict(model.params)
        loss = TT.masked_cross_entropy(model.make_apply()(params, g, xb), yb,
                                       bt["seed"])
        grads = torch.autograd.grad(loss, list(params.values()))
        out[side] = (float(loss.detach()), [gr.cpu() for gr in grads],
                     list(params))
    (lc, gc, names), (lh, gh, _) = out["card"], out["cpu"]
    rel = abs(lc - lh) / abs(lh)
    say(f"  12d.2 Reddit batch 0: loss card {lc:.6f} cpu {lh:.6f}, "
        f"relative {rel:.2e} (bound {E2E_TOL['float32']:g})")
    if not rel <= E2E_TOL["float32"]:
        raise AssertionError(f"batch loss card vs cpu: {rel}")
    for name, a, c in zip(names, gc, gh):
        err = float((a - c).abs().max()) / max(float(c.abs().max()), 1e-30)
        say(f"    grad {name}: max |card - cpu| / max |cpu| {err:.2e} "
            f"(bound {GRAD_TOL['grad']:g})")
        if not err <= GRAD_TOL["grad"]:
            raise AssertionError(f"grad {name} card vs cpu: {err}")


def sampled_phase(dev, smoke_coo, reddit) -> None:
    """Phase 12: the native host library on ``smoke_coo`` (phase 4's COO),
    then sampled training on Flickr and on Reddit at its full edge count
    (``reddit``: ``load_dataset("reddit")``, built on the host during phase
    2), float32 with TF32 off; no kernel of K1-K15 may launch (the sampled
    path runs per op, as in JAX)."""
    import torch

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.data.datasets import load_dataset
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models import train as TT

    t_phase = time.perf_counter()
    counted = _all_counted()
    for f in counted.values():
        f.launches = 0
    native_phase(smoke_coo, dev)

    say("== 12b Flickr (BASELINE.json: GraphSAGE, fanouts 10,10, batch 512)")
    ds = load_dataset("flickr")
    say(f"  flickr: N={ds.host_graph.n_node} E={ds.host_graph.n_edge} "
        f"F={ds.x.shape[1]} C={ds.n_class}, train "
        f"{int(ds.train_mask.sum())} nodes")
    _, res, bd = TT.train_sampled_scan(ds, measure_device_epoch=True,
                                       device=dev, **SAMPLED)
    _say_sampled("flickr train_sampled_scan", res, bd)
    _, res = TT.train_sampled(ds, prefetch=2, eval_full=True, device=dev,
                              **SAMPLED)
    say(f"  flickr train_sampled (prefetch 2): epoch {res.epoch_time_s:.4f} s "
        f"(CUDA events), {res.edges_per_s / 1e6:.2f} Medge/s sampled, loss "
        f"{res.train_loss:.4f}, accuracy train {res.train_acc:.4f} val "
        f"{res.val_acc:.4f} test {res.test_acc:.4f}")
    if not (res.train_loss < np.log(ds.n_class) and res.val_acc > 0.5):
        raise AssertionError(f"flickr train_sampled did not learn: {res}")
    del ds

    say(f"== 12c Reddit at its full edge count ({REDDIT_EDGES} edges)")
    ds = reddit
    say(f"  reddit: N={ds.host_graph.n_node} E={ds.host_graph.n_edge} "
        f"F={ds.x.shape[1]} C={ds.n_class}, train "
        f"{int(ds.train_mask.sum())} nodes; host build during phase 2")
    torch.cuda.reset_peak_memory_stats(dev)
    _, res, bd = TT.train_sampled_scan(ds, measure_device_epoch=True,
                                       device=dev, **SAMPLED)
    _say_sampled("reddit train_sampled_scan", res, bd)
    say(f"  peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f}"
        " GiB")
    torch.cuda.reset_peak_memory_stats(dev)
    kw = dict(SAMPLED, epochs=1)
    _, res = TT.train_sampled(ds, prefetch=2, device=dev, **kw)
    say(f"  reddit train_sampled, one epoch (per-step dispatch, numpy "
        f"sampler, prefetch 2): epoch {res.epoch_time_s:.4f} s (CUDA events),"
        f" {res.edges_per_s / 1e6:.2f} Medge/s sampled, loss "
        f"{res.train_loss:.4f}; peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    sampled_card_checks(ds, dev)
    del ds

    launched = {k: f.launches for k, f in counted.items() if f.launches}
    if launched:
        raise AssertionError(f"phase 12 launched kernels {launched}: the "
                             "sampled path runs per op")
    say(f"launches of K1-K15 in phase 12: none (the per-op path); phase 12 "
        f"took {_took('12', t_phase):.1f} s")


# phase 13: the sharded path (parallel/) on the card.  Four gloo ranks share
# the one card (NCCL refuses two ranks of a communicator on one device);
# their exchanges run on the host.  Each rank's local edges run K1 and K3
# on its own tiling of this geometry (parallel/dist.py's defaults)
SHARDS = 4
SHARD_TILE = (256, 256, 512)
# 13a: a GAT-2l answer with quantize_halo against the exact one, and its
# loss: the bound of JAX's tests/test_qcomm.py for a quantized step (5%)
QUANT_TOL = 0.05


def _gather_rows(res, key, n):
    return np.concatenate([r["answers"][key] for r in res])[:n]


def _hold_answer(what, y, ref, tol) -> float:
    if not np.isfinite(y).all():
        raise AssertionError(f"{what}: non-finite output")
    if y.shape != ref.shape:
        raise AssertionError(f"{what}: shape {y.shape} != {ref.shape}")
    rel = float(np.abs(y - ref).max()) / max(1.0, float(np.abs(ref).max()))
    say(f"  {what}: relative error {rel:.3e} (bound {tol:g})")
    if not rel <= tol:
        raise AssertionError(f"{what}: {rel} > {tol}")
    return rel


def _hold_grads(what, loss, grads, ref_loss, ref_grads) -> None:
    rel = abs(loss - ref_loss) / max(1.0, abs(ref_loss))
    say(f"  {what}: loss {loss:.6f} against {ref_loss:.6f}, relative "
        f"{rel:.2e} (bound {GRAD_TOL['loss']:g})")
    if not rel <= GRAD_TOL["loss"]:
        raise AssertionError(f"{what}: loss {rel}")
    for k, g in ref_grads.items():
        err = float(np.abs(grads[k] - g).max()) / max(float(np.abs(g).max()),
                                                      1e-30)
        say(f"    grad {k}: {err:.2e} of max |reference| (bound "
            f"{GRAD_TOL['grad']:g})")
        if not err <= GRAD_TOL["grad"]:
            raise AssertionError(f"{what}: grad {k} {err}")


def _shard_report(part, F: int = HIDDEN) -> None:
    """The plan's comm_report at F and bf16, and each shard's edges,
    halo rows and exchange bytes a layer (what it sends)."""
    rep = part.comm_report(F, 2)
    say(f"  plan D={part.n_shards}: halo width {rep['halo_width']}, hub cap "
        f"{rep['hub_cap']}, local-edge share {rep['local_edges_frac']:.4f}, "
        f"exchange {(rep['halo_bytes'] + rep['hub_bytes']) / 2**20:.1f} MiB "
        "a layer (all ranks, bf16, F=128)")
    D, H, Kh = part.n_shards, part.halo, part.hub_cap
    for d in range(D):
        el, er = int(part.el_mask[d].sum()), int(part.er_mask[d].sum())
        sent = (D * H + (D - 1) * Kh) * F * 2
        say(f"    shard {d}: {el} local + {er} remote edges (local share "
            f"{el / max(el + er, 1):.4f}), halo rows sent "
            f"{int(part.send_mask[d].sum())} of {D * H} slots, hub rows "
            f"{int(part.hub_mask[d].sum())} of {Kh}; sends "
            f"{sent / 2**20:.1f} MiB a layer")


def _sharded_refs(models, specs, hg, dev, x, labels) -> dict:
    """The single-card references: per-op answers (bf16, float32) and
    float32 loss and gradients of both models; the hybrid kernel path's
    GCN-2l answers and float32 loss and gradients (13c's yardstick)."""
    import torch

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler.fusion import hybrid_schedules
    g = hg.to_device(dev)
    xt = torch.tensor(x, device=dev)
    y = torch.tensor(labels, device=dev)
    mask = torch.ones(hg.n_node, dtype=torch.bool, device=dev)
    refs = {}
    for mname, model in models.items():
        paths = {"per-op": {"bfloat16": model.make_apply(torch.bfloat16),
                            "float32": model.make_apply(None)}}
        if mname == "GCN-2l":
            sched = hybrid_schedules(model.layers)
            paths["kernel"] = {dtn: model.make_apply(
                dt, schedules=sched, host_graph=hg, device=dev)
                for dtn, dt in (("bfloat16", torch.bfloat16),
                                ("float32", None))}
        for path, fns in paths.items():
            with torch.inference_mode():
                for dtn, fn in fns.items():
                    refs[(mname, path, dtn)] = fn(dict(model.params), g,
                                                  xt).float().cpu().numpy()
            loss, grads, sec = _loss_and_grads(model, fns["float32"], g, xt,
                                               y, mask)
            refs[(mname, path, "grads")] = (
                loss, {k: v.cpu().numpy() for k, v in grads.items()})
    del g, xt, y, mask
    torch.cuda.empty_cache()
    return refs


def sharded_phase(hg, dev) -> dict:
    """Phase 13: the sharded path over four gloo ranks on the card (13a
    the 1-D plan, 13b the 2 x 2 mesh), a world of one over NCCL (13c) and
    the predicted scaling (13d).  Returns K1's and K3's launches per rank
    on the sharded path (13a's requests and steps)."""
    import tempfile

    import torch

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models.zoo import build_model
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.parallel import (
        launch, overlap_fraction, partition_graph, partition_graph_2d,
        predicted_scaling)
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import shard_smoke as SS

    t_phase = time.perf_counter()
    n = hg.n_node
    say(f"== 13 the sharded path (parallel/): {SHARDS} gloo ranks on "
        f"cuda:0, K1 and K3 on each rank's local edges")
    gen = torch.Generator().manual_seed(0)      # phase 4's seeded models
    models = {
        "GCN-2l": build_model("GCN", F_IN, N_CLASS, hidden=HIDDEN,
                              n_layers=2, reorder=True, generator=gen,
                              device=dev),
        "GAT-2l": build_model("GAT", F_IN, N_CLASS, hidden=HIDDEN,
                              n_layers=2, heads=HEADS, generator=gen,
                              device=dev),
    }
    specs = {m: dict(network=m.split("-")[0], f_in=F_IN, n_class=N_CLASS,
                     hidden=HIDDEN, heads=HEADS, reorder=m == "GCN-2l",
                     params={k: v.detach().cpu().numpy()
                             for k, v in model.params.items()})
             for m, model in models.items()}
    x = SS.request_x(0, n, F_IN)
    wy = np.random.default_rng(7).standard_normal((F_IN, N_CLASS),
                                                  dtype=np.float32)
    labels = (x @ wy).argmax(1)       # learnable: a linear probe of x
    t0 = time.perf_counter()
    refs = _sharded_refs(models, specs, hg, dev, x, labels)
    say(f"  single-card references (per-op answers and float32 gradients, "
        f"GCN-2l's hybrid kernel path) {time.perf_counter() - t0:.1f} s")
    del models

    t0 = time.perf_counter()
    parts = {4: partition_graph(hg, SHARDS)}
    part2d = partition_graph_2d(hg, 2, 2)
    parts[1] = partition_graph(hg, 1)
    parts[8] = partition_graph(hg, 8)
    say(f"  partitions D=4, 2x2, 1, 8 on the host in "
        f"{time.perf_counter() - t0:.1f} s")
    _shard_report(parts[4])
    rep2 = part2d.comm_report(HIDDEN, 2)
    say(f"  plan 2x2: intra-node {rep2['ici_bytes'] / 2**20:.1f} MiB, "
        f"inter-node {rep2['dcn_bytes'] / 2**20:.1f} MiB a layer (bf16, "
        f"F=128), halo_in {rep2['halo_in']}, halo_out {rep2['halo_out']}")

    tmp = tempfile.mkdtemp(prefix="gta_sharded_")
    for name, p in (("p4", parts[4]), ("p22", part2d), ("p1", parts[1])):
        SS.save_partition(p, os.path.join(tmp, name))
    spec = dict(part_dir=os.path.join(tmp, "p4"),
                part2d_dir=os.path.join(tmp, "p22"), models=specs,
                n_node=n, f_in=F_IN, seed=0, labels=labels,
                tile=SHARD_TILE, lr=LR, trace_dir=tmp)

    say("== 13a four gloo ranks, the 1-D plan (13b: the 2 x 2 mesh)")
    t0 = time.perf_counter()
    res = launch(SS.gloo_rank, SHARDS, backend="gloo", args=(spec,),
                 threads=2)
    say(f"  world of {SHARDS} (spawn, partition load, tilings, 13a, 13b) "
        f"{time.perf_counter() - t0:.1f} s")
    card = None
    rates = []
    for r, rr in enumerate(res):
        say(f"  rank {r}: {rr['local_edges']} local, {rr['remote_edges']} "
            f"remote edges; tilings {rr['n_tiles']} / {rr['n_tiles_unit']} "
            f"tiles (weighted / unit) in {rr['tiling_s']:.1f} s; 13a "
            f"{rr['phase_a_s']:.1f} s, 13b {rr['phase_b_s']:.1f} s")
        for k, rows in rr["kernels"].items():
            for row in rows:
                times = ("   (not timed: no card)" if "ms" not in row else
                         f"   kernel {row['ms']:.4f} ms   plain "
                         f"{row['plain_ms']:.4f} ms   bound "
                         f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
                say(f"    {k:10s} l{row['layer']} {row['dtype']:8s} F="
                    f"{row['F']:<3d} max_abs_err={row['err']:.3e} "
                    f"({row['share']:.3f} of its bound){times}")
        if "aggregation_ms" in rr:
            rates.append((rr["local_edges"] + rr["remote_edges"])
                         / (rr["aggregation_ms"] / 1e3))
            say(f"    layer-0 aggregation without the exchange (K1 on the "
                f"local edges + the per-op remote half, bf16 F=128): "
                f"{rr['aggregation_ms']:.4f} ms, {rates[-1]:.3e} edges/s")
        st = rr["staged"]
        say(f"    exchange of one layer ([n_local, 128] bf16, halo "
            f"all-to-all and hub all-gather): {rr['exchange_ms']:.2f} ms, "
            "staged through the host (gloo); on the main path "
            f"{st['calls']} collectives staged through pinned host memory, "
            f"{st['bytes'] / 2**20:.1f} MiB")
        say(f"    launches on the sharded path (1 bf16 + 1 float32 request "
            f"per model, 1 float32 + 2 bf16 steps per model): "
            f"{rr['launches']}")
        for k, v in rr["launches"].items():
            # (a CPU rehearsal takes the plain versions: nothing launches)
            if v <= 0 and dev.type == "cuda":
                raise AssertionError(f"rank {r}: kernel {k} was not launched"
                                     " on the sharded path")
        if card is None:
            card = rr
    for mname in ("GCN-2l", "GAT-2l"):
        for dtn in ("bfloat16", "float32"):
            _hold_answer(f"13a {mname} {dtn} request, 4 ranks against the "
                         "single-card per-op path",
                         _gather_rows(res, (mname, dtn), n),
                         refs[(mname, "per-op", dtn)], E2E_TOL[dtn])
        loss = card["losses"][(mname, "float32")][0]
        _hold_grads(f"13a {mname} float32 step, 4 ranks against single-card "
                    "per-op autograd", loss, card["grads"][mname],
                    *refs[(mname, "per-op", "grads")])
        for r, rr in enumerate(res):
            if rr["grads"][mname].keys() != card["grads"][mname].keys() or \
                    any(not np.array_equal(rr["grads"][mname][k], v)
                        for k, v in card["grads"][mname].items()):
                raise AssertionError(f"rank {r}: {mname} gradients differ "
                                     "from rank 0's")
        bl = card["losses"][(mname, "bfloat16")]
        say(f"  13a {mname} bf16 steps: losses {['%.5f' % v for v in bl]}")
        if not (np.isfinite(bl).all() and bl[-1] < bl[0]):
            raise AssertionError(f"{mname} bf16 sharded losses {bl}")
    exact = _gather_rows(res, ("GAT-2l", "float32"), n)
    quant = _gather_rows(res, ("GAT-2l", "float32/quantized"), n)
    qrel = float(np.abs(quant - exact).max()) / float(np.abs(exact).max())
    ce = [float(torch.nn.functional.cross_entropy(torch.from_numpy(a),
                                                  torch.from_numpy(labels)))
          for a in (exact, quant)]
    say(f"  13a GAT-2l float32 with quantize_halo (int8 payloads and "
        f"per-row scales): {qrel:.3e} of max |exact answer|, loss "
        f"{ce[1]:.6f} against {ce[0]:.6f} (bounds {QUANT_TOL:g}, JAX's "
        "quantized-step bound)")
    if not (qrel <= QUANT_TOL
            and abs(ce[1] - ce[0]) <= QUANT_TOL * abs(ce[0]) + 1e-3):
        raise AssertionError(f"quantized halo: {qrel}, losses {ce}")

    say("== 13b the 2 x 2 mesh over the same four gloo ranks")
    _hold_answer("13b GCN-2l float32 request against the single-card per-op "
                 "path", _gather_rows(res, ("GCN-2l", "float32/2x2"), n),
                 refs[("GCN-2l", "per-op", "float32")], E2E_TOL["float32"])
    _hold_grads("13b GCN-2l float32 step against single-card per-op "
                "autograd", card["losses"][("GCN-2l", "float32/2x2")][0],
                card["grads"]["GCN-2l/2x2"],
                *refs[("GCN-2l", "per-op", "grads")])

    say("== 13c a world of one over NCCL")
    spec1 = dict(spec, part_dir=os.path.join(tmp, "p1"),
                 sampled=dict(SAMPLED, epochs=1))
    t0 = time.perf_counter()
    one = launch(SS.nccl_rank, 1, backend="nccl", args=(spec1,),
                 threads=4)[0]
    say(f"  world of one (spawn, tiling, requests, step, a Flickr epoch "
        f"with and without the group) {time.perf_counter() - t0:.1f} s; "
        f"K1 launches "
        f"{one['launches']}")
    if one["launches"] <= 0 and dev.type == "cuda":
        raise AssertionError("13c: K1 was not launched")
    for dtn in ("bfloat16", "float32"):
        _hold_answer(f"13c GCN-2l {dtn} request against the single-card "
                     "hybrid kernel path", one["answers"][dtn][:n],
                     refs[("GCN-2l", "kernel", dtn)], E2E_TOL[dtn])
    _hold_grads("13c GCN-2l float32 step against the single-card kernel "
                "path's autograd", one["loss"], one["grads"],
                *refs[("GCN-2l", "kernel", "grads")])
    sm, sn = one["sampled"]["mesh"], one["sampled"]["none"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(
        sm["epoch_losses"] + [sm["train_loss"]],
        sn["epoch_losses"] + [sn["train_loss"]]))
    say(f"  13c Flickr, one epoch of train_sampled_scan ({sm['steps']} "
        f"steps): mesh=world (NCCL all-reduce in the captured graph) loss "
        f"{sm['train_loss']:.6f}, mean {sm['epoch_losses'][0]:.6f}, "
        f"{sm['seconds']:.1f} s; mesh=None {sn['train_loss']:.6f}, mean "
        f"{sn['epoch_losses'][0]:.6f}, {sn['seconds']:.1f} s; relative "
        f"{rel:.2e} (bound {CAPTURE_TOL:g})")
    if not rel <= CAPTURE_TOL:
        raise AssertionError(f"13c captured data-parallel epoch: {rel}")

    say("== 13d predicted scaling (a prediction: one card, no link measured)")
    ov = [overlap_fraction(rr["overlap"]) for rr in res]
    say(f"  overlap_report of one traced bf16 GCN-2l step per rank: "
        f"windows {[rr['overlap']['n_windows'] for rr in res]}, window "
        f"{[round(rr['overlap']['window_us']) for rr in res]} us, compute "
        f"inside {[round(rr['overlap']['hidden_us']) for rr in res]} us; "
        f"fraction {['%.3f' % v for v in ov]}: a gloo-loopback artefact "
        "(host-staged windows about 100x the device work inside them), "
        "not an NVLink overlap; the prediction is read at its bounds 0 "
        "and 1")
    if not rates:
        raise AssertionError("13d needs 13a's aggregation times (a card)")
    rate = min(rates)
    say(f"  per-shard rate: a rank's whole layer-0 aggregation (local K1 "
        f"plus the remote per-op half) over its edges, "
        f"{['%.3e' % v for v in rates]} edges/s; the slowest, {rate:.3e}")
    for D in (4, 8):
        p = parts[D]
        counts = p.el_mask.sum(1) + p.er_mask.sum(1)
        plan = dict(p.comm_report(HIDDEN, 2), n_shards=D,
                    edge_balance=float(counts.max() / counts.mean()))
        pr = predicted_scaling(plan, edges_per_s_chip=rate,
                               n_edge=hg.n_edge, overlap=float(np.mean(ov)))
        say(f"  prediction D={D} (edge balance {plan['edge_balance']:.3f}, "
            f"the largest shard's edges over the mean): NVLink "
            f"{pr['t_ici_s'] * 1e3:.3f} ms, compute "
            f"{pr['t_comp_s'] * 1e3:.3f} ms a layer; efficiency "
            f"{pr['efficiency_no_overlap']:.3f} without overlap, "
            f"{pr['efficiency_full_overlap']:.3f} with full overlap "
            f"(at most 1 / edge balance = {1 / plan['edge_balance']:.3f} "
            f"by construction), comm-bound {pr['comm_bound']} "
            "(NVLink 450 GB/s and NIC 50 GB/s: the vendor's spec)")
    import shutil
    shutil.rmtree(tmp, ignore_errors=True)
    say(f"phase 13 took {_took('13', t_phase):.1f} s")
    return {k: [rr["launches"][k] for rr in res]
            for k in ("spmm_tiles", "gat_tiles")}


# phase 14: the measurement layer and the remainders.  The CUDA symbol of
# the kernel each counted wrapper launches once a call (14a)
KERNEL_SYMBOL = {
    "spmm_tiles": r"\bspmm_tiles_kernel<",
    "spmm_dense_blocks": r"\bspmm_dense_(wgmma|fma)_kernel<",
    "gat_tiles": r"\bgat_tiles_kernel<",
    "gat_dense_blocks": r"\bgat_dense_(wgmma_)?kernel<",
}
TIMER_ITERS = 20


def _serving_counted():
    """The wrappers of K1-K4, the kernels of a hybrid request."""
    return {k: f for k, f in _all_counted().items() if k in KERNEL_SYMBOL}

# 14c: time_fn's median (host wall, synchronised) against the CUDA-event
# median of the same request: the wall holds the device time and more,
# less the two clocks' noise
TIMER_FLOOR = 0.95
# 14d: JAX's value-domain graph and tiling (tests/test_value_domain.py:18-21,
# :58-60) and its bounds there: the unguarded kernel off by more than
# COLLAPSE, the guarded call within GUARD_TOL of the exact reference
GUARD_N, GUARD_E, GUARD_TILE = 300, 2000, (128, 128, 64)
COLLAPSE, GUARD_TOL = 0.1, 1e-4
# the benign graph: a random in-edge and a self loop a node, so that each
# output value is at most two float atomics into zero, which commute: K3's
# result is then the same bits in every launch
BENIGN_N = 4096
# 14e: JAX's real-graph bars (tests/test_real_data.py:20-41): hidden width
# and test accuracy after 120 epochs at lr 1e-2
REAL = (("karate", 16, 0.9), ("digits", 64, 0.93))


def trace_and_count(what: str, fn, outdir) -> dict:
    """14a: one call of ``fn`` under ``utils/profile.trace``; prints
    ``measured_report`` and holds each of K1-K4's launch-count rise during
    the call to its CUDA symbol's count in ``trace_events``."""
    import re
    import shutil

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import profile as PR
    counted = _serving_counted()
    shutil.rmtree(outdir, ignore_errors=True)
    before = {k: f.launches for k, f in counted.items()}
    with PR.trace(str(outdir)):
        fn()
    rose = {k: f.launches - before[k] for k, f in counted.items()}
    say(f"  {what}:\n{PR.measured_report(str(outdir), top=12)}")
    evs = PR.trace_events(str(outdir))
    for k, n in rose.items():
        if n == 0:
            continue
        pat = re.compile(KERNEL_SYMBOL[k])
        hits = [m for m in evs if pat.search(m.name)]
        seen = sum(m.count for m in hits)
        us = sum(m.total_us for m in hits)
        say(f"    {k}: counter rose {n}, trace holds {seen} "
            f"{KERNEL_SYMBOL[k]} events, {us:.1f} us")
        if seen != n:
            raise AssertionError(f"{what}: {k} launched {n} times, the trace "
                                 f"holds {seen}")
    if not any(rose.values()):
        raise AssertionError(f"{what}: no kernel of K1-K4 launched")
    return rose


def guard_shift_checks(g_smoke, dev) -> None:
    """14d: ``gat_attention(guard_shift=True)`` on JAX's adversarial logits
    and on benign ones, and the cost of its host read."""
    import torch

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import graph as G
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import gat as A
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils.benchmark import median_ms, time_fn
    br, bc, et = GUARD_TILE

    def tiled(hg):
        return G.tile_graph(hg, block_rows=br, block_cols=bc, tile_edges=et,
                            unit_weight=True, device=dev)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    # JAX's construction, its rng draws in its order (rng fixture seed 0)
    rng = np.random.default_rng(0)
    s = rng.integers(0, GUARD_N, GUARD_E).astype(np.int32)
    r = rng.integers(0, GUARD_N, GUARD_E).astype(np.int32)
    hg = G.build_host_graph(s, r, GUARD_N, add_self_loops=True)
    g, tg = hg.to_device(dev), tiled(hg)
    h = t(rng.standard_normal((GUARD_N, 8)))
    a_s = rng.standard_normal((GUARD_N, 2)) - 100.0
    a_s[0, :] = 100.0
    a_s, a_d = t(a_s), t(rng.standard_normal((GUARD_N, 2)))
    gap = float(A.gat_shift_gap(g, a_s))
    exact = A._gat_reference(tg, h, a_s, a_d, 0.2)
    k0 = A.gat_tiles.launches
    raw = A.gat_attention(tg, h, a_s, a_d, heads=2)
    guarded = A.gat_attention(tg, h, a_s, a_d, heads=2, g=g,
                              guard_shift=True)
    err_raw = float((raw - exact).abs().max())
    err_g = float((guarded - exact).abs().max())
    say(f"  adversarial (a_src spread 200, JAX's construction): gap "
        f"{gap:.2f} (safe below {A.SHIFT_GAP_SAFE:g}); K3 unguarded off the "
        f"exact result by {err_raw:.3e} (must exceed {COLLAPSE:g}), guarded "
        f"{err_g:.3e} (bound {GUARD_TOL:g}); K3 launches "
        f"{A.gat_tiles.launches - k0} (the guard took the reference)")
    if not (gap > A.SHIFT_GAP_SAFE and err_raw > COLLAPSE
            and err_g <= GUARD_TOL):
        raise AssertionError("guard_shift on adversarial logits: gap "
                             f"{gap}, unguarded {err_raw}, guarded {err_g}")
    if A.gat_tiles.launches - k0 != 1:
        raise AssertionError("the guarded adversarial call launched K3")

    s = rng.integers(0, BENIGN_N, BENIGN_N).astype(np.int32)
    hb = G.build_host_graph(s, np.arange(BENIGN_N, dtype=np.int32),
                            BENIGN_N, add_self_loops=True,
                            symmetric_norm=False)
    gb, tb = hb.to_device(dev), tiled(hb)
    h = t(rng.standard_normal((BENIGN_N, 8)))
    a_s, a_d = (t(rng.standard_normal((BENIGN_N, 2))) for _ in range(2))
    raw = A.gat_attention(tb, h, a_s, a_d, heads=2)
    k0 = A.gat_tiles.launches
    guarded = A.gat_attention(tb, h, a_s, a_d, heads=2, g=gb,
                              guard_shift=True)
    launched = A.gat_tiles.launches - k0
    same = torch.equal(raw, guarded)
    say(f"  benign (N={BENIGN_N}, in-degree <= 2): gap "
        f"{float(A.gat_shift_gap(gb, a_s)):.2f}; guarded equals unguarded "
        f"bit for bit: {same}; K3 launched {launched}")
    if not (same and launched == 1):
        raise AssertionError("guard_shift on benign logits: equal "
                             f"{same}, K3 launches {launched}")
    med_g, _ = time_fn(A.gat_attention, tb, h, a_s, a_d, heads=2, g=gb,
                       guard_shift=True, iters=TIMER_ITERS)
    med_u, _ = time_fn(A.gat_attention, tb, h, a_s, a_d, heads=2,
                       iters=TIMER_ITERS)
    say(f"  time_fn on the benign graph: guarded {med_g * 1e3:.3f} ms, "
        f"unguarded {med_u * 1e3:.3f} ms a call (host wall)")

    # the check's own cost at the smoke's size, 4 heads
    a_big = torch.randn((g_smoke.n_node, HEADS), device=dev,
                        generator=torch.Generator(dev).manual_seed(3))
    dev_ms = median_ms(lambda: A.gat_shift_gap(g_smoke, a_big), device=dev,
                       warmup=1, repeats=10)
    read_s, _ = time_fn(lambda: float(A.gat_shift_gap(g_smoke, a_big)),
                        iters=TIMER_ITERS, device=dev)
    say(f"  gat_shift_gap on the smoke's graph ({g_smoke.n_edge} edge "
        f"slots, 4 heads): device {dev_ms:.3f} ms (CUDA events); with the "
        f"host read, {read_s * 1e3:.3f} ms host wall a check")


def real_graph_checks(dev) -> None:
    """14e: the karate and digits fixtures from the port's own directory:
    GCN trained on the card to JAX's bars, GCN-2l and GAT-2l served on
    hybrid schedules against the per-op path."""
    import torch

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler.fusion import hybrid_schedules
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.data import datasets as DS
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models import train as TT
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models.zoo import build_model
    counted = _serving_counted()
    say(f"  fixtures from {DS.FIXTURES_DIR}")
    if "_torch" not in os.path.basename(os.path.dirname(os.path.dirname(
            DS.FIXTURES_DIR))):
        raise AssertionError("the fixtures are not the port's own")
    for name, hidden, bar in REAL:
        ds = DS.load_dataset(name)
        hg = ds.host_graph
        if ds.synthetic:
            raise AssertionError(f"{name}: not loaded from its fixture")
        t0 = time.perf_counter()
        _, res = TT.train_node_classifier(ds, "GCN", hidden=hidden,
                                          epochs=120, lr=1e-2, device=dev)
        say(f"  {name} (N={hg.n_node} E={hg.n_edge} F={ds.x.shape[1]} "
            f"C={ds.n_class}): GCN hidden {hidden}, 120 epochs, test "
            f"accuracy {res.test_acc:.4f} (JAX's bar {bar}), "
            f"{time.perf_counter() - t0:.1f} s")
        if not res.test_acc >= bar:
            raise AssertionError(f"{name}: test accuracy {res.test_acc}")
        g = hg.to_device(dev)
        x = torch.as_tensor(ds.x, device=dev)
        for net in ("GCN", "GAT"):
            model = build_model(net, ds.x.shape[1], ds.n_class,
                                hidden=hidden, n_layers=2,
                                reorder=net == "GCN", heads=HEADS,
                                generator=torch.Generator().manual_seed(0),
                                device=dev)
            params = dict(model.params)
            sched = hybrid_schedules(model.layers)
            for f in counted.values():
                f.launches = 0
            with torch.inference_mode():
                for dtn, dt in (("bfloat16", torch.bfloat16),
                                ("float32", None)):
                    y = model.make_apply(dt, schedules=sched, host_graph=hg,
                                         device=dev)(params, g, x)
                    ref = model.make_apply(dt)(params, g, x)
                    rel = _rel_err(y, ref)
                    say(f"    {net}-2l {dtn} hybrid against per-op: "
                        f"relative {rel:.3e} (bound {E2E_TOL[dtn]:g})")
                    if not (bool(torch.isfinite(y).all())
                            and rel <= E2E_TOL[dtn]):
                        raise AssertionError(f"{name} {net}-2l {dtn}: {rel}")
            launched = {k: f.launches for k, f in counted.items()
                        if f.launches}
            say(f"    {net}-2l launches: {launched}")
            if not launched:
                raise AssertionError(f"{name} {net}-2l: no kernel launched")


def measurement_phase(models, fwd, measured, hg, g, dev) -> None:
    """Phase 14 on phase 4's lowered bf16 forwards (see the module
    docstring)."""
    import torch

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import bench as B
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import schedule as S
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler.fusion import hybrid_schedules
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import profile as PR
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils.benchmark import (
        median_ms, time_fn, time_fn_pipelined)

    t_phase = time.perf_counter()
    say("== 14a traced requests: measured_report, kernels by CUDA symbol")
    x = _request_x(0, hg.n_node, dev)
    requests = {mname: (lambda f=fwd[mname]["bfloat16"],
                        p=dict(model.params): f(p, g, x))
                for mname, model in models.items()}
    with torch.inference_mode():
        for mname, fn in requests.items():
            trace_and_count(f"{mname} bf16 request", fn,
                            PR.OUT_DIR / f"phase14_{mname}")

    say("== 14b schedule_report of the layer schedules (bf16, the request's "
        "phase-4b median as measured_s)")
    stats = S.GraphStats(hg.n_node, hg.n_edge, hg.e_pad)
    for mname, model in models.items():
        sec = measured[(mname, "hybrid")] / 1e3
        for li, (layer, sc) in enumerate(zip(
                model.layers, hybrid_schedules(model.layers))):
            say(f"  {mname} layer {li}, with the 2-layer request's "
                f"{sec * 1e3:.3f} ms:")
            say(PR.schedule_report(layer, sc, stats, measured_s=sec,
                                   dtype_bytes=2))

    say("== 14c wall-clock timers on a GCN-2l bf16 request")
    fn = requests["GCN-2l"]
    with torch.inference_mode():
        ev_ms = median_ms(fn, device=dev, warmup=2, repeats=TIMER_ITERS)
        med_s, best_s = time_fn(fn, iters=TIMER_ITERS)
        pipe_s = time_fn_pipelined(fn, iters=TIMER_ITERS, reps=3)
    say(f"  time_fn median {med_s * 1e3:.3f} ms, best {best_s * 1e3:.3f} ms;"
        f" time_fn_pipelined {pipe_s * 1e3:.3f} ms; CUDA-event median "
        f"{ev_ms:.3f} ms (time_fn / events {med_s * 1e3 / ev_ms:.3f}, floor "
        f"{TIMER_FLOOR})")
    if not med_s * 1e3 >= TIMER_FLOOR * ev_ms:
        raise AssertionError(f"time_fn {med_s * 1e3} ms below the CUDA-event"
                             f" median {ev_ms} ms")
    del requests, fn, x

    say("== 14d gat_attention(guard_shift=True) on the card")
    guard_shift_checks(g, dev)

    say("== 14e karate and digits, the port's own fixtures")
    real_graph_checks(dev)

    say("== 14f the port bench's cora line")
    line = B.gat_cora_layer3_latency(dev)
    if line["value"] is None or not line["value"] > 0:
        raise AssertionError(f"bench cora line: value = {line['value']}")
    torch.cuda.empty_cache()
    say(f"phase 14 took {_took('14', t_phase):.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--edges", type=int, default=11_461_589,
                    help="synthetic edges before self loops (Reddit has "
                         "114,615,892)")
    args = ap.parse_args(argv)

    import torch
    t_phase = time.perf_counter()
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
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.data.datasets import load_dataset, synthetic_coo
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models.zoo import build_model
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import _ext
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import fixtures
    say(f"phase 1 took {_took('1', t_phase):.1f} s")

    # the kernels build in nvcc processes while this thread builds the host
    # graphs that need no kernel: phase 4's graph and phase 12c's Reddit
    # dataset at its full edge count
    say("== 2 build (phase 4's graph and phase 12c's Reddit dataset built "
        "on the host meanwhile)")
    t_phase = time.perf_counter()
    built = {}

    def build():
        try:
            _ext.library()
        except BaseException as e:      # re-raised below, in this thread
            built["error"] = e
        built["s"] = time.perf_counter() - t_phase
    builder = threading.Thread(target=build, name="nvcc")
    builder.start()
    t0 = time.perf_counter()
    s, r, labels = synthetic_coo(N_NODE, args.edges, seed=1,
                                 communities=1000, p_in=0.7)
    hg = G.build_host_graph(s, r, N_NODE, add_self_loops=True,
                            symmetric_norm=True)
    hg, _ = G.reorder_nodes(hg, "hubs+labels", labels=labels)
    smoke_coo = (s, r, labels)      # phase 12a builds from the same COO
    del s, r, labels
    graph_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    reddit = load_dataset("reddit")
    reddit_s = time.perf_counter() - t0
    builder.join()
    if "error" in built:
        raise built["error"]
    say(f"kernels built and loaded in {built['s']:.1f} s "
        f"(nvcc {_ext.build_seconds if _ext.build_seconds is not None else 0:.1f} s); "
        f"meanwhile phase 4's graph {graph_s:.1f} s and the Reddit "
        f"dataset {reddit_s:.1f} s on the host")
    say_ptxas(_ext.build_log)
    say(f"phase 2 took {_took('2', t_phase):.1f} s")

    checks = Checks()
    t_phase = time.perf_counter()
    say("== 3 kernels: edge cases")
    say(f"bound per row: {fixtures.KERNEL_TOL} times the row's max |plain| "
        "(num and den columns apart); a float32 row that sums n > 1,759 "
        f"terms gets {fixtures.SUM_ORDER:g} sqrt(n) 2^-24 instead, since "
        "reordering an f32 sum moves it by about sqrt(n) ulps")
    edge_case_checks(checks, dev)
    say("== 3b K16 (x W) at the main path's shapes and ragged ones")
    dense_xw_checks(checks, dev)
    say(f"phase 3 took {_took('3', t_phase):.1f} s")

    t_phase = time.perf_counter()
    say("== 4 slice")
    say(f"graph: N={hg.n_node} E={hg.n_edge} (self loops included), host "
        f"build {graph_s:.1f} s (during phase 2)")

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
    # one tile cache for both models and dtypes: the splits depend on
    # neither the compute dtype nor the model beyond their schedules, and
    # phases 10d and 11d lower the same splits and the same transposed
    # graph again
    tile_cache = {}
    for mname, model in models.items():
        sched = hybrid_schedules(model.layers)
        say(f"{mname}: schedules {[sc.key()[:48] for sc in sched]}")
        fwd[mname] = {}
        for dtn, dt in (("bfloat16", torch.bfloat16), ("float32", None)):
            t0 = time.perf_counter()
            fwd[mname][dtn] = model.make_apply(
                dt, schedules=sched, host_graph=hg, device=dev,
                build_transpose=True, tile_cache=tile_cache)
            say(f"  {dtn} lowering (forward splits, transposed graph and "
                f"twins; the tile cache shared) "
                f"{time.perf_counter() - t0:.1f} s")
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
    counted = _serving_counted()
    reqs = [("bfloat16", i) for i in range(REQUESTS)] + [("float32", 0)]
    outs, lat = {}, {}
    for fn in counted.values():
        fn.launches = 0
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import primitives as P
    xw_before = P.dense_mm.launches
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
        launches["dense_xw"] = P.dense_mm.launches - xw_before
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
    # what phase 11 compares its picks with: the per-op answers and the
    # medians of the schedules the phases serve
    measured = {}
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
                measured.setdefault((mname, "answers"), {})[(dtn, seed)] = ref
    for (mname, dtn, path), v in sorted(lat.items()):
        say(f"latency {mname} {dtn} {path}: median {statistics.median(v):.3f}"
            f" ms over {len(v)} requests {['%.3f' % t for t in v]}")
    for mname in models:
        measured[(mname, "hybrid")] = statistics.median(
            lat[(mname, "bfloat16", "kernel")])
        measured[(mname, "per-op")] = statistics.median(
            lat[(mname, "bfloat16", "per-op")])
    say(f"phase 4 took {_took('4', t_phase):.1f} s")

    # phase 14 on phase 4's lowered forwards, before phase 5 drops them
    measurement_phase(models, fwd, measured, hg, g, dev)

    # 8f before phase 5, which drops the float32 forwards it differentiates
    t_phase = time.perf_counter()
    say("== 8f exp panels on phase 4's lowered GAT-2l forward")
    panel_launches = exp_panel_phase(
        checks, fwd["GAT-2l"], hybs["GAT-2l"], models["GAT-2l"], hg, g, dev)
    say(f"phase 8f took {_took('8f', t_phase):.1f} s")
    t_phase = time.perf_counter()
    launches = training_phase(checks, models, fwd, hg, g, dev)
    say(f"phase 5 took {_took('5', t_phase):.1f} s")
    launches["gat_dense_panel"] = panel_launches
    checks.csr.clear()
    del fwd
    grouped_launches, recipes = grouped_phase(checks, models["GCN-2l"], hg,
                                              g, dev)
    launches.update(grouped_launches)
    launches.update(sddmm_pair_phase(checks, models["GAT-2l"], recipes, hg,
                                     g, dev, measured))
    del recipes
    launches.update(layer_phase(checks, models["GAT-2l"],
                                init_params["GAT-2l"], hg, g, dev, measured))
    if launches["gat_dense_panel"] <= 0:
        raise AssertionError("kernel gat_dense_panel was not launched in "
                             "phase 8f")
    stream_densefull_phase(models, hg, g, dev, measured)
    p10_launches = classes_sinput_phase(checks, models, hybs, hg, g, dev,
                                        tile_cache)
    compiled_phase(models, init_params, measured, hg, g, dev, tile_cache)
    del models, init_params, measured, hybs, g, tile_cache
    sampled_phase(dev, smoke_coo, reddit)
    del smoke_coo, reddit
    sharded_launches = sharded_phase(hg, dev)
    del hg
    say("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                      for k, v in PHASE_S.items())
        + f"; in all {time.perf_counter() - T_START:.1f} s")

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
        # both layers' dense splits of one GAT-2l hybrid request; K16 a
        # GCN-2l forward's two products (602 -> 128, 128 -> 41); its
        # launches are phase 5d's, as K1-K8's; K17 both layers of one
        # GATv2-2l request (4 heads of 32, then 1 of 41), its launches
        # phase 7e's requests
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
        if k in p10_launches:
            row["phase10_launches"] = p10_launches[k]
        if k in sharded_launches:
            row["phase13_launches_per_rank"] = sharded_launches[k]
        kernels.append(row)
    say(json.dumps({"kernels": kernels}))
    say(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
