"""Device time of K14 (the whole GAT layer, stage by stage) and K15 (the
exp-panel dense partial) at the smoke's GAT-2l shapes, for the sources as
they are and for variants of them.

Builds the slices of ``chip_smoke.py`` that run them (GAT-2l at the Reddit
widths on the 232,965-node synthetic community graph: every layer on the
``gat_layer`` kind over 512x1024x512 ``onehot`` tiles for K14, and the
hybrid split's dense blocks for K15), makes random bf16 inputs (layer 0's
x; layer 1's x is K14's layer-0 output), and for each variant builds the
kernel library from a patched copy of ``csrc/`` (under
``build/layer_variants/`` at the repository root), holds K14 stage by
stage (``fixtures.gat_layer_checks``) and K15 to their plain versions on
both layers and times each as the smoke does (CUDA events, median of 5
windows of 10 calls in a row).  The variants are timed in turns, in
alternating order over ``--rounds`` rounds, in one process on one card,
and each time printed is the median over the rounds.  A variant is one or
more patches joined by ``+``; each patch replaces one text of one source
and fails unless the text is there exactly once:

- ``base``: the sources as they are;
- ``fold``: K14's epilogue folded into the walk's last flush of each row
  (a C entry of its own, ``gta_gat_layer_fold``): a per-row count of live
  slots, set from the tiling before each call, counted down by one atomic
  a run after a fence; the lane group that takes a row's count to zero
  writes its output.  Timed as zeroing [num | den], setting the counts and
  the folded walk, beside zeroing, the walk and the epilogue, and held to
  the plain walk and epilogue; one pass of the walk a tile only (both
  layers' widths);
- ``walk_blocksN``: K14's walk held to N blocks an SM (the sources: 3);
- ``proj_blocksN``: K14's bf16 projection held to N blocks an SM (the
  sources: 2);
- ``proj_stagesN``: its ring of x and W k-chunks N stages deep (the
  sources: 3; the wrapper's shared-memory size follows);
- ``k15_packed``: K15's column terms staged as one 16-byte entry {a_s,
  E1s, E2s, -} a column and head (columns padded by 16 bytes when H > 1,
  one shared load a cell column) in place of three arrays [KC][H] (the
  wrapper's shared-memory size follows);
- ``x_padded``: K14's bf16 projection reads x rows at a stride of F
  rounded up to 8 elements, all by 16-byte copies, and layer 0's x (F =
  602) is cast from float32 into such row-padded storage (the wrapper's
  contiguity check is lifted for it); the two casts are timed beside each
  other.

Needs one CUDA device::

    python -m gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils.\\
layer_variants --variants base,fold,k15_packed [--rounds 2]
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import statistics
import subprocess
import time
from pathlib import Path

import torch

from ..compiler import schedule as S
from ..ops import _ext
from ..ops import dense as D
from ..ops import gat as A

N_NODE, N_EDGE = 232_965, 11_461_589     # the smoke's graph
F_IN, HIDDEN, N_CLASS, HEADS = 602, 128, 41, 4
LAYER_TILE = (512, 1024, 512)
OUT_DIR = Path(__file__).resolve().parents[2] / "build" / "layer_variants"

# ``fold``: the walk's finishing policy (tile_walk.cuh) ...
_FIN = '''// What a lane group does after it adds a run of receiver r into acc:
// nothing, or (RowFin) count down left[r], the live slots of row r still to
// add, and where that took it to zero write out[r] = sf(num / max(den,
// 1e-30)) from acc (one pass of the walk a tile: the launch checks)
struct NoFin {
  template <int E>
  __device__ __forceinline__ void finish(int64_t, int, const float*, int, int, int,
                                         int) const {}
};
struct RowFin {
  int* left;
  float* out;
  int sf;
  float slope;
  template <int E>
  __device__ __forceinline__ void finish(int64_t r, int run, const float* acc, int HD, int H,
                                         int grp, int k) const {
    constexpr int LG = 32 / E;
    const unsigned mask = E == 1 ? 0xffffffffu : 0xffffu << (16 * grp);
    __threadfence();  // this group's adds before its count
    __syncwarp(mask);
    int last = 0;
    if (k == 0) last = atomicSub(left + r, run) == run;
    last = __shfl_sync(mask, last, grp * LG);
    if (!last) return;
    __threadfence();
    const int WA = HD + H, D = HD / H;
    const float* arow = acc + r * WA;
    for (int f = k; f < HD; f += LG) {
      const float v = __ldcg(arow + f) / fmaxf(__ldcg(arow + HD + f / D), 1e-30f);
      out[r * HD + f] = sf == 1   ? fmaxf(v, 0.f)
                        : sf == 2 ? (v > 0.f ? v : expf(fminf(v, 0.f)) - 1.f)
                        : sf == 3 ? (v >= 0.f ? v : slope * v)
                                  : v;
    }
  }
};

'''
# ... threaded through gat_prefix_walk (each: old, new) ...
_DOC = "// GAT softmax-aggregate of each live slot src -> r of one tile"
_WALK = "template <typename HT, typename MT, typename Logit, int VEC, int NV, int E>\n"
_FOLD_WALK = [
    (_DOC, _FIN + _DOC),
    (_WALK, _WALK.replace("int E>", "int E, typename Fin = NoFin>")),
    ("float slope, int lane) {", "float slope, int lane, Fin fin = Fin()) {"),
    ("int64_t cur = -1;  // the group's current run's receiver",
     "int64_t cur = -1;  // the group's current run's receiver\n"
     "    int run = 0;"),
    ("        if (own[i]) atomicAdd(arow + HD + hk[i], den[i]);\n      }\n",
     "        if (own[i]) atomicAdd(arow + HD + hk[i], den[i]);\n      }\n"
     "      fin.template finish<E>(cur, run, acc, HD, H, grp, k);\n"),
    ("            cur = row0 + dq[q];\n",
     "            cur = row0 + dq[q];\n            run = 0;\n"),
    ("#pragma unroll\n          for (int i = 0; i < NV; ++i) {\n"
     "            const float p = Logit::p(",
     "          ++run;\n#pragma unroll\n          for (int i = 0; i < NV; ++i) {\n"
     "            const float p = Logit::p("),
]
# ... and a walk kernel and C entry of its own (gat_layer.cu)
# ``k15_packed``: a column's terms per head, padded (floats), and the read
_PACKED = "4 * H + (H > 1 ? 4 : 0)"
_SPLIT_READ = '''          ct.x = as[col * H + hh];
          if constexpr (PANEL) {
            ct.y = as[KC * H + col * H + hh];
            ct.z = as[2 * KC * H + col * H + hh];
          }
'''
_PACKED_READ = f'''          if constexpr (PANEL)
            ct = *reinterpret_cast<const float4*>(as + col * ({_PACKED}) + 4 * hh);
          else
            ct.x = as[col * H + hh];
'''
_FOLD_ENTRY = '''
namespace {

template <typename XT, int VEC, int NV, int E>
__global__ void __launch_bounds__(WARPS * 32, 3)
gat_layer_walk_fold(const int* __restrict__ tile_rb, const int* __restrict__ tile_cb,
                    const int16_t* __restrict__ src_local,
                    const int16_t* __restrict__ dst_local, const XT* __restrict__ hq,
                    const float* __restrict__ a_s, const float* __restrict__ a_d,
                    float* __restrict__ acc, int T, int R, int C, int ET, int HD, int H,
                    int64_t n, float slope, gta::RowFin fin) {
  const int t = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (t >= T) return;
  const int cb = tile_cb[t];
  if (cb < 0) return;
  gta::gat_prefix_walk<XT, float, gta::StaticShift, VEC, NV, E, gta::RowFin>(
      src_local, dst_local, nullptr, static_cast<int64_t>(t) * ET, ET, R, C,
      static_cast<int64_t>(tile_rb[t]) * R, static_cast<int64_t>(cb) * C, hq, a_s, a_d,
      nullptr, acc, HD, H, n, n, n, slope, threadIdx.x & 31, fin);
}

template <typename XT>
struct FoldLaunch {
  const Args& a;
  gta::RowFin fin;
  template <int VEC, int NV, int E>
  cudaError_t run() const {
    if (a.HD > (32 / E) * VEC * NV) return cudaErrorInvalidValue;  // one pass a tile
    gat_layer_walk_fold<XT, VEC, NV, E><<<(a.T + WARPS - 1) / WARPS, WARPS * 32, 0, a.st>>>(
        a.rb, a.cb, a.s, a.d, static_cast<const XT*>(a.hq), a.a_s, a.a_d, a.acc, a.T, a.R,
        a.C, a.ET, a.HD, a.H, a.n, a.slope, fin);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" int gta_gat_layer_fold(const void* tile_rb, const void* tile_cb,
                                  const void* src_local, const void* dst_local,
                                  const void* hq, int dtype, void* a_s, void* a_d, void* acc,
                                  void* out, void* left, int T, int R, int C, int ET,
                                  int64_t n, int HD, int H, int sf, float slope,
                                  void* stream) {
  Args a{};
  a.rb = static_cast<const int*>(tile_rb);
  a.cb = static_cast<const int*>(tile_cb);
  a.s = static_cast<const int16_t*>(src_local);
  a.d = static_cast<const int16_t*>(dst_local);
  a.hq = const_cast<void*>(hq);
  a.a_s = static_cast<float*>(a_s);
  a.a_d = static_cast<float*>(a_d);
  a.acc = static_cast<float*>(acc);
  a.T = T, a.R = R, a.C = C, a.ET = ET, a.n = n, a.HD = HD, a.H = H, a.slope = slope;
  a.st = static_cast<cudaStream_t>(stream);
  const gta::RowFin fin{static_cast<int*>(left), static_cast<float*>(out), sf, slope};
  if (T <= 0) return 0;
  if (dtype == gta::BF16)
    return static_cast<int>(
        gta::gat_walk_config<__nv_bfloat16>(hq, HD, H, FoldLaunch<__nv_bfloat16>{a, fin}));
  return static_cast<int>(gta::gat_walk_config<float>(hq, HD, H, FoldLaunch<float>{a, fin}));
}
'''
_FOLD_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 5
              + [ctypes.c_int] * 4 + [ctypes.c_int64] + [ctypes.c_int] * 3
              + [ctypes.c_float, ctypes.c_void_p])


def _replace(path: Path, old: str, new: str, lo: str = "",
             hi: str = "") -> None:
    """Replace ``old`` by ``new`` in ``path``, between the texts ``lo`` and
    ``hi`` where given; ``old`` must be there exactly once."""
    text = path.read_text()
    i0 = text.index(lo) if lo else 0
    i1 = text.index(hi, i0) if hi else len(text)
    part = text[i0:i1]
    if part.count(old) != 1:
        raise ValueError(f"{path.name}: the patch's text is there "
                         f"{part.count(old)} times: {old[:60]!r}")
    path.write_text(text[:i0] + part.replace(old, new) + text[i1:])


def _patch(csrc: Path, patch: str) -> None:
    """Apply one patch of the module docstring's list to ``csrc``."""
    walk, layer = csrc / "tile_walk.cuh", csrc / "gat_layer.cu"
    if patch == "fold":
        for old, new in _FOLD_WALK:
            _replace(walk, old, new, lo="// The logit of an edge of the "
                     "prefix walk", hi="// Runs launch.template run")
        layer.write_text(layer.read_text() + _FOLD_ENTRY)
    elif patch.startswith("walk_blocks"):
        _replace(layer, "__launch_bounds__(WARPS * 32, 3)\ngat_layer_walk(",
                 f"__launch_bounds__(WARPS * 32, {int(patch[11:])})\n"
                 "gat_layer_walk(")
    elif patch.startswith("proj_blocks"):
        _replace(layer, "__launch_bounds__(P_THREADS, 2)",
                 f"__launch_bounds__(P_THREADS, {int(patch[11:])})")
    elif patch.startswith("proj_stages"):
        _replace(layer, "P_STAGES = 3;", f"P_STAGES = {int(patch[11:])};")
    elif patch == "k15_packed":
        dense = csrc / "gat_dense_blocks.cu"
        _replace(dense, "KC * 4 * (PANEL ? 3 : 1) * H + 1023)",
                 f"KC * 4 * (PANEL ? {_PACKED} : H) + 1023)")
        _replace(dense, "ss + 4 * (w * KC * H + cc * H + hh)",
                 f"ss + 4 * (cc * ({_PACKED}) + 4 * hh + w)")
        _replace(dense, _SPLIT_READ, _PACKED_READ)
    elif patch == "x_padded":
        _replace(layer, "  const int iters = (F + P_KC - 1) / P_KC;\n",
                 "  const int iters = (F + P_KC - 1) / P_KC;\n"
                 "  const int64_t ldx = (F + 7) / 8 * 8;  // row-padded x\n")
        for old in ("bytes ? x + row * F + k", "ok ? x + row * F + k",
                    "x[row * F + k] :"):
            _replace(layer, old, old.replace("* F +", "* ldx +"),
                     lo="gat_layer_project_wgmma(", hi="// ---- stage 1, float32")
        _replace(layer, "if (a.F % 8 == 0 && xp % 16 == 0)", "if (xp % 16 == 0)")
    elif patch != "base":
        raise ValueError(f"unknown patch {patch!r}")


def _stages(variant: str) -> int:
    """The depth of K14's projection ring in ``variant``."""
    deep = [int(p[11:]) for p in variant.split("+")
            if p.startswith("proj_stages")]
    return deep[-1] if deep else 3


def _panel_smem(packed: bool):
    """``compiler/schedule._dense_attention_smem`` with K15's column terms
    packed 16 bytes a head (``k15_packed``) or as they are."""

    def smem(HD, H, dtype_bytes, panel, values_bytes=None):
        n = S._gat_wgmma_width(H, HD // H) if dtype_bytes == 2 else 0
        if not (packed and panel and n):
            return S._dense_attention_smem(HD, H, dtype_bytes, panel,
                                           values_bytes)
        cols = 4 * H + (4 if H > 1 else 0)

        def ring(vb):
            tile = max(64 * (256 * vb + 16), 256 * (64 * vb + 16))
            stage = -(-(H * n * 128 + tile + 64 * 4 * cols) // 1024) * 1024
            return 3 * stage + 1024 + 3 * 256 * H * 4
        return (max(ring(1), ring(2)) if values_bytes is None
                else ring(values_bytes))
    return smem


def _layer_smem(deep: int):
    """``compiler/schedule._gat_layer_smem`` for a projection ring ``deep``
    stages deep."""

    def smem(HD: int, H: int, dtype_bytes: int) -> int:
        n = S._gat_wgmma_width(1, HD) if dtype_bytes == 2 else 0
        if not n:
            return S._gat_layer_smem(HD, H, dtype_bytes)
        return (max(deep * (128 * 128 + n * 128), 128 * (n + 1) * 4) + 1024
                + 8 * HD * H)
    return smem


_CHECK_X = A._require_layer     # K14's wrappers' input checks


def _use(variant: str) -> None:
    """Load the kernel library of ``variant``, building it on first use, and
    give K14's wrapper its projection's shared-memory size (and, for
    ``x_padded``, no contiguity check of x)."""
    csrc = OUT_DIR / variant / "csrc"
    if not csrc.exists():
        shutil.copytree(Path(__file__).resolve().parents[1] / "csrc", csrc)
        for patch in variant.split("+"):
            _patch(csrc, patch)
    _ext.CSRC, _ext.BUILD_DIR, _ext._lib = csrc, csrc.parent / "kernels", None
    t0 = time.perf_counter()
    lib = _ext.library()
    if "fold" in variant.split("+"):
        lib.gta_gat_layer_fold.argtypes = _FOLD_ARGS
        lib.gta_gat_layer_fold.restype = ctypes.c_int
    print(f"[{variant}] library loaded in {time.perf_counter() - t0:.1f} s",
          flush=True)
    A._gat_layer_smem = _layer_smem(_stages(variant))
    D._dense_attention_smem = _panel_smem("k15_packed" in variant.split("+"))
    A._require_layer = ((lambda *args: None)
                        if "x_padded" in variant.split("+") else _CHECK_X)


def _padded(x32: torch.Tensor) -> torch.Tensor:
    """``x32`` cast to bf16 into storage with rows of F rounded up to 8
    elements, as the [n, F] view."""
    n, F = x32.shape
    buf = torch.empty((n, -(-F // 8) * 8), dtype=torch.bfloat16,
                      device=x32.device)
    buf[:, :F] = x32
    return buf[:, :F]


def _fold(tg, proj, acc, out, left, H: int, kw) -> None:
    """One call of the ``fold`` variant's walk into ``acc`` and ``out``."""
    hq, a_s, a_d = proj
    n, HD = hq.shape
    with torch.cuda.device(hq.device):
        rc = _ext.library().gta_gat_layer_fold(
            tg.tile_rb.data_ptr(), tg.tile_cb.data_ptr(),
            tg.src_local.data_ptr(), tg.dst_local.data_ptr(), hq.data_ptr(),
            _ext.DTYPE_CODE[hq.dtype], a_s.data_ptr(), a_d.data_ptr(),
            acc.data_ptr(), out.data_ptr(), left.data_ptr(), tg.n_tiles,
            tg.block_rows, tg.block_cols, tg.tile_edges, n, HD, H,
            A.SF_CODE[kw["final_sf"]], float(kw["negative_slope"]),
            _ext.stream(hq))
    _ext.check(rc, "gat_layer_fold")


def _inputs(dev):
    """(K14's layers, K15's layers): per GAT-2l layer the ``gat_layer``
    tiling, float32 x, w, wa_s and wa_d in bf16, its keywords and live
    slots per row; the hybrid split's dense blocks with phase 8f's random
    bf16 h, a_s and exp panels."""
    from .. import graph as G
    from ..compiler.fusion import (classify_block, gat_onehot_schedules,
                                   hybrid_schedules)
    from ..compiler.schedule import TileConfig
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
    params = dict(model.params)
    bf = torch.bfloat16
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    scheds = gat_onehot_schedules(model.layers, whole_layer=True,
                                  tile=TileConfig(*LAYER_TILE))
    fwd = model.make_apply(bf, schedules=scheds, host_graph=hg, device=dev)
    tg, = {id(d): d for fn in fwd.layer_fns
           for k, _, d, _ in fn.plans if k == "gat_layer"}.values()
    left = fixtures.row_terms(tg).round().int()
    layers = []
    x = torch.randn((N_NODE, F_IN), generator=gen, device=dev)
    for layer, sc in zip(model.layers, scheds):
        lp = classify_block(layer, sc.blocks[0], sc.tiles[0])[1]
        w, ws, wd = (params[k].detach().to(bf).contiguous()
                     for k in (lp.w_name, lp.was_name, lp.wad_name))
        kw = dict(negative_slope=lp.negative_slope, final_sf=lp.final_sf)
        layers.append((tg, x, w, ws, wd, kw, left))
        with torch.inference_mode():
            x = A.gat_layer_tiles(tg, x.to(bf), w, ws, wd, **kw)
    del fwd

    hyb = model.make_apply(bf, schedules=hybrid_schedules(model.layers),
                           host_graph=hg, device=dev)
    dense = [data.dense for fn in hyb.layer_fns
             for kind, _, data, _ in fn.plans if kind.endswith("_hybrid")]
    panels = []
    for bga, (H, HD) in zip(dense, ((HEADS, HIDDEN), (1, N_CLASS))):
        h = torch.randn((N_NODE, HD), generator=gen, device=dev).to(bf)
        w = (torch.randn((HD, H), generator=gen, device=dev)
             / HD ** 0.5).to(bf)
        a_d = torch.randn((N_NODE, H), generator=gen, device=dev).to(bf)
        a_s = h.float() @ w.float()
        ps, pd = D.exp_panels(a_s, a_d.float(), a_s.amax(0, keepdim=True),
                              bga.n_col_blocks * bga.block_cols,
                              bga.n_row_blocks * bga.block_rows)
        panels.append((bga, h, a_s, ps, pd))
    return layers, panels


def _run(layers, panels, variant: str, check: bool) -> dict:
    """{(what, layer): ms} of K14's stages and K15, each held to its plain
    version first when ``check``."""
    from . import fixtures
    from .benchmark import median_ms

    dev = layers[0][1].device

    def ms(fn):
        return median_ms(fn, device=dev, warmup=1, repeats=5, calls=10)

    fold = "fold" in variant.split("+")
    padded = "x_padded" in variant.split("+")
    times = {}
    for li, (tg, x32, w, ws, wd, kw, left) in enumerate(layers):
        n, HD, H = x32.shape[0], w.shape[1], ws.shape[1]
        terms = left.float()
        with torch.inference_mode():
            cast = ((lambda: _padded(x32)) if padded  # noqa: E731
                    else (lambda: x32.to(torch.bfloat16).contiguous()))
            x = cast()
            times[("cast", li)] = ms(cast)
            if check:
                for c in fixtures.gat_layer_checks(
                        tg, x, w, ws, wd, dtype_name="bfloat16",
                        case=f"layer {li}", terms=terms, **kw):
                    fixtures.check_kernel(c)
            proj = A.gat_layer_projection(x, w, ws, wd)
            acc = torch.zeros((n, HD + H), dtype=torch.float32, device=dev)
            out = torch.zeros((n, HD), dtype=torch.float32, device=dev)
            cnt = torch.empty_like(left)

            def stages(bits):
                return lambda: A._gat_layer_launch(
                    tg, x, w, ws, wd, kw["negative_slope"], kw["final_sf"],
                    bits, proj=proj, acc=acc)

            def walk_epilogue():
                acc.zero_()
                stages(6)()

            def folded():
                acc.zero_()
                cnt.copy_(left)
                _fold(tg, proj, acc, out, cnt, H, kw)

            if fold and check:
                folded()
                mag = 2.0 * A._gat_layer_walk_plain(
                    tg, proj[0].abs(), proj[1], proj[2],
                    negative_slope=kw["negative_slope"])
                fixtures.check_kernel(fixtures.KernelCase(
                    "gat_layer", f"folded walk layer {li}", "bfloat16", out,
                    A._gat_layer_walk_plain(tg, *proj, **kw), terms=terms,
                    scale=mag))
            times[("whole", li)] = ms(
                lambda: A.gat_layer_tiles(tg, x, w, ws, wd, **kw))
            times[("projection", li)] = ms(
                lambda: A.gat_layer_projection(x, w, ws, wd))
            times[("walk", li)] = ms(stages(2))
            times[("epilogue", li)] = ms(stages(4))
            times[("walk+epilogue", li)] = ms(walk_epilogue)
            if fold:
                times[("folded", li)] = ms(folded)
    for li, (bga, h, a_s, ps, pd) in enumerate(panels):
        with torch.inference_mode():
            kern = lambda: D.gat_dense_panel_blocks(  # noqa: E731
                bga, h, bga.values, a_s, ps, pd)
            if check:
                fixtures.check_kernel(fixtures.KernelCase(
                    "gat_dense_panel", f"layer {li}", "bfloat16", kern(),
                    D._gat_dense_panel_reference(bga, h, bga.values, a_s, ps,
                                                 pd), h.shape[1],
                    fixtures.row_terms(bga)))
            times[("K15", li)] = ms(kern)
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default="base",
                    help="comma-separated variants (the module's docstring)")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("layer_variants: needs a CUDA device")
    kept = (_ext.CSRC, _ext.BUILD_DIR, _ext._lib, A._gat_layer_smem,
            A._require_layer, D._dense_attention_smem)
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    names = args.variants.split(",")
    if "x_padded" in names[0].split("+"):
        raise SystemExit("layer_variants: the first variant makes the inputs "
                         "from contiguous x; put x_padded later")
    for name in names:              # patched afresh from the sources
        shutil.rmtree(OUT_DIR / name, ignore_errors=True)
    try:
        _use(names[0])
        t0 = time.perf_counter()
        layers, panels = _inputs(dev)
        print(f"set-up {time.perf_counter() - t0:.1f} s", flush=True)
        for name in names:      # build each, hold it to the plain versions
            _use(name)
            _run(layers, panels, name, check=True)
        runs = {name: [] for name in names}
        for rnd in range(args.rounds):
            for name in (names if rnd % 2 == 0 else names[::-1]):
                _use(name)
                runs[name].append(_run(layers, panels, name, check=False))
    finally:
        (_ext.CSRC, _ext.BUILD_DIR, _ext._lib, A._gat_layer_smem,
         A._require_layer, D._dense_attention_smem) = kept
    for name in names:
        cells = [f"{what}/{li} "
                 f"{statistics.median(r[(what, li)] for r in runs[name]):.4f}"
                 for (what, li) in runs[name][0]]
        print(f"[{name}] ms: " + "  ".join(cells), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
