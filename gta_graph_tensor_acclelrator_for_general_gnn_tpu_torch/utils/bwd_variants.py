"""Device time of the GAT backward kernels K5-K8 at the smoke's GAT-2l
shapes, for the sources as they are and for variants of them.

Builds the slice of ``chip_smoke.py`` (GAT-2l at the Reddit widths on the
232,965-node synthetic community graph, lowered with its transposed
twins), makes the random bf16 inputs of its phase 5b, and for each variant
builds the kernel library from a patched copy of ``csrc/`` (under
``build/bwd_variants/`` at the repository root), checks K5-K8 against
their plain versions on both layers (``fixtures.check_kernel``) and times
each kernel per layer as the smoke does (CUDA events, median of 5 windows
of 10 calls in a row).  The variants are timed in turns, in alternating
order over ``--rounds`` rounds, in one process on one card, and each time
printed is the median over the rounds.  A variant is one or more patches
joined by ``+``; each patch replaces one text of one source and fails if
the text is not there:

- ``base``: the sources as they are;
- ``k6_pfN``: the tail walk of K5 and K6 gathers N edges a lane group at
  a time (``gat_bwd.cuh`` ``BWD_PF``);
- ``k6_blocksN``, ``k5_blocksN``: K6's (K5's) registers held to N blocks
  an SM for every walk shape;
- ``k5_e1``: K5's walk by whole warps, one edge at a time (bf16 rows of
  128 by 8-byte loads, 41 logits one feature a lane);
- ``k7_skip_all``, ``k7_noskip``: K7 skips its cell steps without a count
  at every head count, or at none;
- ``k7_blocks2``: K7 at two blocks an SM (at most 128 registers): no te
  issued ahead, counts read per cell and head, no skip.

Needs one CUDA device::

    python -m gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils.\\
bwd_variants --variants base,k5_e1,k5_blocks3,k6_pf2 [--rounds 2]
"""
from __future__ import annotations

import argparse
import shutil
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

N_NODE, N_EDGE = 232_965, 11_461_589     # the smoke's graph
F_IN, HIDDEN, N_CLASS, HEADS = 602, 128, 41, 4
OUT_DIR = Path(__file__).resolve().parents[2] / "build" / "bwd_variants"

_K7_CHUNK = '''    float te[32];
#pragma unroll
    for (int hh = 0; hh < H; ++hh) {
      gta::dense_bwd_te<KT>(te, frag[hh], sp + hh * KT * 128);
      gta::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 32; ++i) gta::fence_reg(te[i]);
#pragma unroll
      for (int j = 0; j < TC_KC / 8; ++j) {
        const float2 as2 = *reinterpret_cast<const float2*>(
            as + hh * TC_KC + 8 * j + 2 * t);
#pragma unroll
        for (int v = 0; v < 2; ++v)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const float k = gta::count_f(
                tile + (8 * j + 2 * t + u) * St::CT::STRIDE + (ra + 8 * v) * SZ,
                VT());
            float alpha, dz;
            gta::dense_bwd_cell(u ? as2.y : as2.x, ad[hh][v], bnd[hh][v],
                                rden[hh][v], s2[hh][v], k,
                                te[4 * j + 2 * v + u], slope, alpha, dz);
            dad[hh][v] += dz;
          }
      }
    }
  }
'''


def _replace(path: Path, old: str, new: str) -> None:
    text = path.read_text()
    if old not in text:
        raise ValueError(f"{path.name}: the patch's text is not there: "
                         f"{old[:60]!r}")
    path.write_text(text.replace(old, new))


def _patch(csrc: Path, patch: str) -> None:
    """Apply one patch of the module docstring's list to ``csrc``."""
    bwd, dad = csrc / "gat_bwd.cuh", csrc / "gat_dense_bwd_dad.cu"
    if patch.startswith("k6_pf"):
        _replace(bwd, "constexpr int BWD_PF = 1;",
                 f"constexpr int BWD_PF = {int(patch[5:])};")
    elif patch.startswith(("k6_blocks", "k5_blocks")):
        mine = "Acc::SRC" if patch.startswith("k6") else "!Acc::SRC"
        _replace(bwd, "TAIL_WARPS * 32, walk_blocks<NV>())",
                 f"TAIL_WARPS * 32, {mine} ? {int(patch[9:])} : "
                 "walk_blocks<NV>())")
    elif patch == "k5_e1":
        _replace(bwd, "return a.HD <= 128 ? tail_run<Acc, HT, MT, 4, 2, 2>(a)",
                 "return !Acc::SRC && a.HD <= 128 ? tail_run<Acc, HT, MT, 4, 1, 1>(a)"
                 " : a.HD <= 128 ? tail_run<Acc, HT, MT, 4, 2, 2>(a)")
        _replace(bwd, "return a.HD <= 48 ? tail_run<Acc, HT, MT, 1, 3, 2>(a)",
                 "return Acc::SRC && a.HD <= 48 ? tail_run<Acc, HT, MT, 1, 3, 2>(a)"
                 " : !Acc::SRC && a.HD <= 64 ? tail_run<Acc, HT, MT, 1, 2, 1>(a)")
    elif patch == "k7_skip_all":
        _replace(dad, "unsigned live = H > 1 ? 0xffu : 0u;",
                 "unsigned live = 0u;")
        _replace(dad, "if (H == 1) live |=", "live |=")
    elif patch == "k7_noskip":
        _replace(dad, "unsigned live = H > 1 ? 0xffu : 0u;",
                 "unsigned live = 0xffu;")
        _replace(dad, "if (H == 1) live |=", "if (false) live |=")
    elif patch == "k7_blocks2":
        text = dad.read_text()
        i0 = text.index("    // te of head 0 runs on the tensor cores")
        i1 = text.index("  gta::cp_async_wait<0>();\n  if (!active) return;")
        dad.write_text(text[:i0] + _K7_CHUNK + text[i1:])
        kernel = "\ngat_dense_bwd_dad_wgmma_kernel"
        _replace(dad, "__launch_bounds__(TC_THREADS, 1)" + kernel,
                 "__launch_bounds__(TC_THREADS, 2)" + kernel)
    elif patch != "base":
        raise ValueError(f"unknown patch {patch!r}")


def _use(variant: str) -> None:
    """Load the kernel library of ``variant``, building it on first use."""
    from ..ops import _ext
    csrc = OUT_DIR / variant / "csrc"
    if not csrc.exists():
        shutil.copytree(Path(__file__).resolve().parents[1] / "csrc", csrc)
        for patch in variant.split("+"):
            _patch(csrc, patch)
    _ext.CSRC, _ext.BUILD_DIR, _ext._lib = csrc, csrc.parent / "kernels", None
    t0 = time.perf_counter()
    _ext.library()
    print(f"[{variant}] library loaded in {time.perf_counter() - t0:.1f} s",
          flush=True)


def _inputs(dev):
    """Per GAT-2l layer: its hybrid split and twin and phase 5b's bf16
    inputs (the tail kernels' side values rounded to bf16)."""
    from .. import graph as G
    from ..compiler.fusion import hybrid_schedules
    from ..data.datasets import synthetic_coo
    from ..models.zoo import build_model
    from . import fixtures
    s, r, labels = synthetic_coo(N_NODE, N_EDGE, seed=1, communities=1000,
                                 p_in=0.7)
    hg = G.build_host_graph(s, r, N_NODE, add_self_loops=True,
                            symmetric_norm=True)
    hg, _ = G.reorder_nodes(hg, "hubs+labels", labels=labels)
    model = build_model("GAT", F_IN, N_CLASS, hidden=HIDDEN, n_layers=2,
                        heads=HEADS,
                        generator=torch.Generator().manual_seed(0),
                        device=dev)
    fwd = model.make_apply(torch.bfloat16,
                           schedules=hybrid_schedules(model.layers),
                           host_graph=hg, device=dev, build_transpose=True)
    pairs = [(data, twin) for fn in fwd.layer_fns
             for kind, _, data, twin in fn.plans if kind.endswith("_hybrid")]
    rng = np.random.default_rng(0)
    out = []
    for (hyb, twin), (H, HD) in zip(pairs, ((HEADS, HIDDEN), (1, N_CLASS))):
        a_s = rng.standard_normal((N_NODE, H)).astype(np.float32)
        msrc = torch.tensor(a_s.max(0, keepdims=True), device=dev)
        h, gbar = (torch.tensor(rng.standard_normal((N_NODE, HD),
                                                    dtype=np.float32),
                                device=dev).to(torch.bfloat16)
                   for _ in range(2))
        sides = {tail: fixtures.bwd_side(rng, N_NODE, H, dt, dev, a_s=a_s)
                 for tail, dt in ((True, torch.bfloat16),
                                  (False, torch.float32))}
        out.append((hyb, twin, h, gbar, sides, msrc))
    return out


def _run(layers, check: bool) -> dict:
    """{(kernel, layer): ms} of K5-K8, each held to its plain version
    first when ``check``."""
    from .benchmark import median_ms
    from . import fixtures
    times = {}
    for li, (hyb, twin, h, gbar, sides, msrc) in enumerate(layers):
        graphs = {"gat_bwd_tiles_dad": hyb.tiles,
                  "gat_bwd_tiles_src": twin.tiles,
                  "gat_dense_bwd_dad": hyb.dense,
                  "gat_dense_bwd_src": twin.dense}
        for k in fixtures.BWD_KERNELS:
            tail = k.startswith("gat_bwd_tiles")
            kern, plain, mag, split = fixtures.bwd_runs(
                hyb.tiles, twin.tiles, hyb.dense, twin.dense, h, gbar,
                sides[tail], msrc)[k]
            if check:
                fixtures.check_kernel(fixtures.KernelCase(
                    k, f"layer {li}", "bfloat16", kern(), plain(), split,
                    fixtures.row_terms(graphs[k])[:N_NODE], mag()))
            times[(k, li)] = median_ms(kern, device=h.device, warmup=1,
                                       repeats=5, calls=10)
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default="base",
                    help="comma-separated variants (the module's docstring)")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bwd_variants: needs a CUDA device")
    from ..ops import _ext
    kept = (_ext.CSRC, _ext.BUILD_DIR, _ext._lib)
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    layers = _inputs(dev)
    print(f"set-up {time.perf_counter() - t0:.1f} s", flush=True)
    names = args.variants.split(",")
    for name in names:              # patched afresh from the sources
        shutil.rmtree(OUT_DIR / name, ignore_errors=True)
    try:
        for name in names:      # build each, hold it to the plain versions
            _use(name)
            _run(layers, check=True)
        runs = {name: [] for name in names}
        for rnd in range(args.rounds):
            for name in (names if rnd % 2 == 0 else names[::-1]):
                _use(name)
                runs[name].append(_run(layers, check=False))
    finally:
        _ext.CSRC, _ext.BUILD_DIR, _ext._lib = kept
    for name in names:
        cells = [f"{k.replace('gat_', '')}/{li} "
                 f"{statistics.median(r[(k, li)] for r in runs[name]):.4f}"
                 for (k, li) in runs[name][0]]
        print(f"[{name}] ms: " + "  ".join(cells), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
