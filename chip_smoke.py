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
  4. slice: builds the graph and the hybrid splits, checks K1-K4 again at
     every shape the slice gives them, both layers' (error and time beside
     the plain version; each row's error within its bound, see
     ``fixtures.kernel_error``), then
     serves 3 bf16 requests and 1 float32 request per model through
     ``Model.make_apply(schedules=...)``; checks that every kernel's launch
     count rose, and compares each answer with the per-op path
     (``make_apply(schedules=None)``) on the card.

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
}
# kernel path vs per-op path: the per-op path rounds only the matmul
# operands to bf16, the kernels also their gathered rows and products
E2E_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def say(msg: str) -> None:
    print(msg, flush=True)


class Checks:
    """Kernel-vs-plain comparisons by ``fixtures.check_kernel``; raises on
    the first failure."""

    def __init__(self):
        self.worst = {}      # kernel -> max abs err at the slice shapes
        self.times = {}      # kernel -> {layer: (ms, plain_ms)}

    def compare(self, c, slice_shape: bool = False) -> None:
        from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import fixtures
        err, share = fixtures.check_kernel(c)
        terms = ("" if c.terms is None
                 else f", most terms in a row {int(c.terms.max())}")
        say(f"  {c.kernel:18s} {c.case:34s} {c.dtype_name:8s} max_abs_err="
            f"{err:.3e}, worst row at {share:.3f} of its bound{terms}")
        if slice_shape:
            self.worst[c.kernel] = max(self.worst.get(c.kernel, 0.0), err)


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
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils.benchmark import median_ms
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils.fixtures import KernelCase, row_terms

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
                checks.compare(KernelCase(
                    kname, f"layer {li} F={F} H={H} HD={HD}", name, kern(),
                    plain(), split, terms[kname]), slice_shape=True)
                if timed:
                    ms_k = median_ms(kern, device=dev, warmup=1,
                                     repeats=REPEATS)
                    ms_p = median_ms(plain, device=dev, warmup=1,
                                     repeats=REPEATS)
                    checks.times.setdefault(kname, {})[li] = (ms_k, ms_p)
                    say(f"  {kname:18s} layer {li} kernel {ms_k:.4f} ms   "
                        f"plain {ms_p:.4f} ms")


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
    fwd = {}
    hybs = {}
    for mname, model in models.items():
        sched = hybrid_schedules(model.layers)
        t0 = time.perf_counter()
        fwd[mname] = {
            dtn: model.make_apply(dt, schedules=sched, host_graph=hg,
                                  device=dev)
            for dtn, dt in (("bfloat16", torch.bfloat16), ("float32", None))}
        say(f"{mname}: schedules {[sc.key()[:48] for sc in sched]}, "
            f"lowering (hybrid builds) {time.perf_counter() - t0:.1f} s")
        for li, fn in enumerate(fwd[mname]["bfloat16"].layer_fns):
            for kind, _, data in fn.plans:
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

    kernels = []
    for k, meta in KERNELS.items():
        # per request: the kernel's calls at both layers' shapes
        ms_k = sum(t[0] for t in checks.times[k].values())
        ms_p = sum(t[1] for t in checks.times[k].values())
        kernels.append(dict(name=k, route="cuda", source=meta["source"],
                            replaces=meta["replaces"], launches=launches[k],
                            max_abs_err=checks.worst[k], ms=ms_k,
                            plain_ms=ms_p))
    say(json.dumps({"kernels": kernels}))
    say(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
