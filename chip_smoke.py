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
     ``fixtures.kernel_error``), then
     serves 3 bf16 requests and 1 float32 request per model through that
     forward under ``torch.inference_mode()``; checks that every kernel's
     launch count rose, and compares each answer with the per-op path
     (``make_apply(schedules=None)``) on the card;
  5. training: on the same lowered forward, checks the GAT backward
     kernels K5-K8 against their plain versions on the fixture cases and at
     both layers' shapes (and times them in bf16), compares one float32
     loss and every parameter's gradient with autograd through the per-op
     path, then takes 1 warm-up and 4 timed bf16 AdamW steps per model
     through ``models/train.make_train_step``: each loss finite, the last
     below the first, and every one of K1-K8 launched during the steps.

Prints one JSON line of kernel results, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.  Any failure raises: the script
then exits non-zero without that line.  Needs one CUDA device.

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
LR = 1e-2
TRAIN_STEPS = 4    # timed bf16 steps per model, after one warm-up step


def say(msg: str) -> None:
    print(msg, flush=True)


class Checks:
    """Kernel-vs-plain comparisons by ``fixtures.check_kernel``; raises on
    the first failure."""

    def __init__(self):
        self.worst = {}      # kernel -> max abs err at the slice shapes
        self.times = {}      # kernel -> {call: (ms, plain_ms)}

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
                   split=None, terms=None, scale=None, timed_as=None):
        """Compare ``kern()`` with ``plain()`` at a shape of the slice;
        with ``timed_as``, also time both (CUDA events, median of REPEATS)
        as that call of a request or step."""
        from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils.benchmark import median_ms
        from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils.fixtures import KernelCase
        self.compare(KernelCase(kernel, case, dtype_name, kern(), plain(),
                                split, terms, scale), slice_shape=True)
        if timed_as is not None:
            ms_k = median_ms(kern, device=dev, warmup=1, repeats=REPEATS)
            ms_p = median_ms(plain, device=dev, warmup=1, repeats=REPEATS)
            self.times.setdefault(kernel, {})[timed_as] = (ms_k, ms_p)
            say(f"  {kernel:18s} {timed_as:9s} kernel {ms_k:.4f} ms   "
                f"plain {ms_p:.4f} ms")


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
    (bf16) and in float32, and time in bf16."""
    import torch

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import dense as D
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import gat as A
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import spmm as SP
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
            a_s = h.float() @ w.float()
            ms = a_s.amax(0, keepdim=True)
            runs = {
                "spmm_tiles": (lambda: SP.spmm_tiles(tg, x, tg.weight),
                               lambda: SP._spmm_reference(tg, x), None),
                "spmm_dense_blocks": (
                    lambda: D.spmm_dense_blocks(bg, xs, bg.values),
                    lambda: D._spmm_dense_reference(bg, xs, bg.values), None),
                "gat_tiles": (
                    lambda: A.gat_tiles(tga, h, tga.weight, a_d, ms, w_asrc=w,
                                        normalize=False),
                    lambda: A._gat_tiles_reference(tga, h, tga.weight, a_d,
                                                   ms, w_asrc=w,
                                                   normalize=False), HD),
                "gat_dense_blocks": (
                    lambda: D.gat_dense_blocks(bga, h, bga.values, a_s, a_d,
                                               ms),
                    lambda: D._gat_dense_reference(bga, h, bga.values, a_s,
                                                   a_d, ms), HD),
            }
            for kname, (kern, plain, split) in runs.items():
                checks.slice_case(kname, f"layer {li} F={F} H={H} HD={HD}",
                                  name, kern, plain, dev, split=split,
                                  terms=terms[kname],
                                  timed_as=f"layer {li}" if timed else None)


def twin_spmm_checks(checks: Checks, twins, dev, n: int) -> None:
    """K1 and K2 at the shapes of GCN's backward dx = Aᵀ ȳ: each layer's
    transposed twin (its tail tiles and 'rc' count blocks, the swapped
    separable scales), layer 0 at F = 128 and layer 1 at F = 41, in bf16
    and float32; timed in bf16."""
    import torch

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import dense as D
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import spmm as SP
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
                terms=row_terms(tg), timed_as=timed)
            checks.slice_case(
                "spmm_dense_blocks", f"layer {li} twin F={F}", name,
                lambda: D.spmm_dense_blocks(bg, xs, bg.values),
                lambda: D._spmm_dense_reference(bg, xs, bg.values), dev,
                terms=row_terms(bg), timed_as=timed)


def bwd_slice_checks(checks: Checks, pairs, dev, n: int) -> None:
    """K5-K8 at every shape the GAT training step gives them: layer 0 (4
    heads of 32) and layer 1 (1 head of 41), on that layer's forward split
    and its transposed twin, in bf16 and float32 (random inputs; the tail
    kernels read their side values rounded to the compute dtype, as the
    step does), each cell held to its plain version scaled by its sum of
    elementary-term magnitudes; timed in bf16 beside the plain version."""
    import torch

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import fixtures
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils.fixtures import row_terms

    rng = np.random.default_rng(0)
    for li, (H, HD) in enumerate(((HEADS, HIDDEN), (1, N_CLASS))):
        hyb, twin = pairs[li]
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
                for k, (kern, plain, mag, split) in runs.items():
                    if k.startswith("gat_bwd_tiles") != tail:
                        continue
                    checks.slice_case(
                        k, f"layer {li} H={H} HD={HD}", name, kern, plain,
                        dev, split=split, terms=terms[k], scale=mag(),
                        timed_as=(f"layer {li}" if dt == torch.bfloat16
                                  else None))


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
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, loss = step(state, g, x, y, mask)
            end.record()
            end.synchronize()
            losses.append(float(loss))
            if i > 0:
                times.append(start.elapsed_time(end))
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

    for fn in counted.values():
        fn.launches = 0
    for mname, model in models.items():
        steps(mname, model, "kernel", fwd[mname]["bfloat16"],
              1 + TRAIN_STEPS)
    launches = {k: f.launches for k, f in counted.items()}
    say(f"launches during the kernel-path steps: {launches}")
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
    for line in _ext.build_log.splitlines():
        if "registers" in line or "spill stores" in line:
            say(f"  ptxas: {line.strip()}")

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
                x = torch.tensor(np.random.default_rng(seed).standard_normal(
                    (hg.n_node, F_IN), dtype=np.float32), device=dev)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                y = fwd[mname][dtn](params, g, x)
                end.record()
                end.synchronize()
                outs[(mname, dtn, seed)] = y
                lat.setdefault((mname, dtn, "kernel"), []).append(
                    start.elapsed_time(end))
                say(f"  {mname} {dtn} request seed={seed}: "
                    f"{start.elapsed_time(end):.2f} ms")
    launches = {k: fn.launches for k, fn in counted.items()}
    say(f"launches during the requests: {launches}")
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
                x = torch.tensor(np.random.default_rng(seed).standard_normal(
                    (hg.n_node, F_IN), dtype=np.float32), device=dev)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                ref = ref_fn[dtn](params, g, x)
                end.record()
                end.synchronize()
                lat.setdefault((mname, dtn, "per-op"), []).append(
                    start.elapsed_time(end))
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
                    f"{E2E_TOL[dtn]:.0e}); per-op {start.elapsed_time(end):.2f} ms")
                if not rel <= E2E_TOL[dtn]:
                    raise AssertionError(f"{mname} {dtn}: relative error "
                                         f"{rel} > {E2E_TOL[dtn]}")
                del ref
    for (mname, dtn, path), v in sorted(lat.items()):
        say(f"latency {mname} {dtn} {path}: median {statistics.median(v):.3f}"
            f" ms over {len(v)} requests {['%.3f' % t for t in v]}")

    launches = training_phase(checks, models, fwd, hg, g, dev)

    kernels = []
    for k, meta in KERNELS.items():
        # per bf16 training step: every call at both layers' shapes (K1
        # and K2 also run GCN's backward over the twins)
        ms_k = sum(t[0] for t in checks.times[k].values())
        ms_p = sum(t[1] for t in checks.times[k].values())
        row = dict(name=k, route="cuda", source=meta["source"],
                   replaces=meta["replaces"], launches=launches[k],
                   max_abs_err=checks.worst[k], ms=ms_k, plain_ms=ms_p)
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
