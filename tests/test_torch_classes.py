"""PyTorch port: tile capacity classes (``graph.MultiTiledGraph``), the
tile-time model, ``auto_hybrid``, bf16 dense values and ``cli.py bench``
against the JAX package.

The same seeded numpy inputs go through both packages.  Builders must give
EQUAL arrays (bfloat16 weights compare as float32).  Kernels: the JAX
package's run in Pallas interpret mode on the CPU, the port's wrappers take
their plain versions.  Tolerance: max |port - jax| <= 1e-5 * max(1,
max |jax|) in float32 (the same terms summed in another order), 2e-2 in
bfloat16, 1e-4 for gradients."""
import json

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu as J  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu import cli as JCLI  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu import graph as JG  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.ops import dense as JD  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.ops import sddmm as JSd  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.ops import spmm as JS  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch as T  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import cli as TCLI  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import graph as TG  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.data import datasets as TDs  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import dense as TD  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import gat as TA  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import sddmm as TSd  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import spmm as TS  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import fixtures  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import roofline  # noqa: E402

CPU = "cpu"     # the port's entry points default to the CUDA card
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GRAD_TOL = 1e-4
GEO = dict(block_rows=64, block_cols=64)


def _np(a):
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return (a.float() if a.dtype == torch.bfloat16 else a).cpu().numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _close(port, ref, tol=TOL["float32"]):
    port, ref = _np(port), np.asarray(_np(ref), np.float32)
    assert port.shape == ref.shape
    bound = tol * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(port - ref).max())
    assert err <= bound, (err, bound)


def _graph(symmetric_norm=True, heavy=True):
    """The edge-case graph plus the class fixture's planted runs, as a JAX
    and a port host graph."""
    s, r, n, _ = fixtures.edge_case_graph(seed=0)
    if heavy:
        rng = np.random.default_rng(7)
        s = np.concatenate([s, 64 + rng.integers(0, 64, fixtures.HEAVY_RUN),
                            rng.integers(0, 64, fixtures.MEDIUM_RUN)])
        r = np.concatenate([r, 192 + rng.integers(0, 64, fixtures.HEAVY_RUN),
                            512 + rng.integers(0, 64, fixtures.MEDIUM_RUN)])
    kw = dict(symmetric_norm=symmetric_norm, edge_pad_multiple=128)
    return J.build_host_graph(s, r, n, **kw), T.build_host_graph(s, r, n,
                                                                 **kw)


def _assert_tiles_equal(tj, tt):
    for k in ("tile_rb", "tile_cb", "src_local", "dst_local", "edge_id",
              "weight", "row_first_tile"):
        np.testing.assert_array_equal(_np(getattr(tj, k)),
                                      _np(getattr(tt, k)), err_msg=k)
    for k in ("block_rows", "block_cols", "tile_edges", "n_node"):
        assert getattr(tj, k) == getattr(tt, k), k


def _assert_classes_equal(mj, mt):
    assert isinstance(mt, TG.MultiTiledGraph)
    assert len(mj.parts) == len(mt.parts)
    for pj, pt in zip(mj.parts, mt.parts):
        _assert_tiles_equal(pj, pt)
    assert (mj.n_tiles, mj.total_slots) == (mt.n_tiles, mt.total_slots)


def _classes(unit_weight=False, classes=fixtures.CLASSES, **kw):
    hj, ht = _graph(symmetric_norm=not unit_weight, **kw)
    return (hj, ht,
            JG.tile_graph_classes(hj, tile_classes=classes,
                                  unit_weight=unit_weight, **GEO),
            TG.tile_graph_classes(ht, tile_classes=classes,
                                  unit_weight=unit_weight, device=CPU, **GEO))


@pytest.mark.parametrize("unit_weight", [False, True])
def test_tile_graph_classes_matches_jax(unit_weight):
    """Same parts as JAX's; every edge in exactly one slot of one class;
    the class that wins no run has no part; unit parts keep bf16 weights
    of exactly 1, as a one-class unit tiling does."""
    hj, ht, mj, mt = _classes(unit_weight)
    _assert_classes_equal(mj, mt)
    assert [p.tile_edges for p in mt.parts] == [32, 128, 512]
    seen = np.concatenate([
        _np(p.edge_id).reshape(-1)[_np(p.src_local).reshape(-1)
                                   < p.block_cols] for p in mt.parts])
    assert len(seen) == ht.n_edge
    assert len(np.unique(seen)) == ht.n_edge
    want = TG.tile_graph(ht, tile_edges=64, unit_weight=unit_weight,
                         device=CPU, **GEO).weight.dtype
    assert all(p.weight.dtype == want for p in mt.parts)
    if unit_weight:
        for p in mt.parts:
            live = _np(p.src_local) < p.block_cols
            assert (_np(p.weight)[live] == 1.0).all()


def test_tile_graph_classes_without_edges_keeps_one_part():
    e = np.zeros(0, np.int32)
    hj = J.build_host_graph(e, e, 300, edge_pad_multiple=128)
    ht = T.build_host_graph(e, e, 300, edge_pad_multiple=128)
    mj = JG.tile_graph_classes(hj, tile_classes=(32, 64), **GEO)
    mt = TG.tile_graph_classes(ht, tile_classes=(32, 64), device=CPU, **GEO)
    _assert_classes_equal(mj, mt)
    assert len(mt.parts) == 1 and mt.parts[0].tile_edges == 64
    y = TS.spmm(mt, torch.ones((300, 8)))
    assert torch.equal(y, torch.zeros_like(y))


@pytest.mark.parametrize("edge_vals", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spmm_classes_matches_jax(edge_vals, dtype):
    """spmm over a class tiling (K1 once per class, edge values through the
    remapped edge ids) against JAX's; equal to one-class tiling's result."""
    hj, ht, mj, mt = _classes()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((ht.n_node, 48)).astype(np.float32)
    ev = rng.standard_normal(ht.e_pad).astype(np.float32) if edge_vals \
        else None
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    yj = JS.spmm(mj, jnp.asarray(x, jdt),
                 None if ev is None else jnp.asarray(ev), interpret=True)
    evt = None if ev is None else torch.tensor(ev)
    yt = TS.spmm(mt, torch.tensor(x).to(tdt), evt)
    _close(yt, yj, TOL[dtype])
    one = TG.tile_graph(ht, tile_edges=64, device=CPU, **GEO)
    _close(yt, TS.spmm(one, torch.tensor(x).to(tdt), evt), TOL[dtype])


@pytest.mark.parametrize("twin", [False, True])
def test_spmm_classes_gradients_match_jax(twin):
    """Gradients in x and edge_vals over a class tiling: the plain
    formulation, or with ``tg_t`` (the transposed graph's classes) dx on
    K1 once per class of the twin."""
    hj, ht, mj, mt = _classes()
    rng = np.random.default_rng(2)
    x = rng.standard_normal((ht.n_node, 16)).astype(np.float32)
    ev = rng.standard_normal(ht.e_pad).astype(np.float32)
    kw_j, kw_t = {}, {}
    if twin:
        htt, perm = TG.transpose_host_graph(ht)
        hjt, perm_j = JG.transpose_host_graph(hj)
        kw_t = dict(tg_t=TG.tile_graph_classes(
            htt, tile_classes=fixtures.CLASSES, device=CPU, **GEO),
            ev_perm_t=torch.as_tensor(perm))
        kw_j = dict(tg_t=JG.tile_graph_classes(
            hjt, tile_classes=fixtures.CLASSES, **GEO),
            ev_perm_t=jnp.asarray(perm_j))
    gj = jax.grad(lambda v, e: jnp.sum(JS.spmm(mj, v, e, interpret=True,
                                               **kw_j) ** 2),
                  argnums=(0, 1))(jnp.asarray(x), jnp.asarray(ev))
    xt = torch.tensor(x, requires_grad=True)
    et = torch.tensor(ev, requires_grad=True)
    (TS.spmm(mt, xt, et, **kw_t) ** 2).sum().backward()
    _close(xt.grad, gj[0], GRAD_TOL)
    _close(et.grad, gj[1], GRAD_TOL)


@pytest.mark.parametrize("H,P", [(4, 8), (2, 5)])
def test_sddmm_classes_match_jax(H, P):
    """sddmm over a class tiling returns the per-class tuple (K11 once per
    class); tiles_to_edges adds the classes' scatters, edges_to_tiles
    gathers per class; sddmm_edges and its gradients match JAX's."""
    hj, ht, mj, mt = _classes()
    rng = np.random.default_rng(3)
    xs, xd = (rng.standard_normal((ht.n_node, H * P)).astype(np.float32)
              for _ in range(2))
    oj = JSd.sddmm(mj, jnp.asarray(xs), jnp.asarray(xd), heads=H,
                   interpret=True)
    ot = TSd.sddmm(mt, torch.tensor(xs), torch.tensor(xd), heads=H)
    assert isinstance(ot, tuple) and len(ot) == len(oj)
    for a, b in zip(ot, oj):
        _close(a, b)
    _close(TSd.tiles_to_edges(mt, ot, ht.e_pad),
           JSd.tiles_to_edges(mj, oj, hj.e_pad))
    ev = rng.standard_normal((ht.e_pad, 3)).astype(np.float32)
    for a, b in zip(TSd.edges_to_tiles(mt, torch.tensor(ev)),
                    JSd.edges_to_tiles(mj, jnp.asarray(ev))):
        np.testing.assert_array_equal(_np(a), _np(b))
    gj_, gt_ = hj.to_device(), ht.to_device(CPU)
    for compute in ("MUL", "ADD"):
        fj = lambda a, b: jnp.sum(JSd.sddmm_edges(  # noqa: E731
            mj, gj_, a, b, compute, interpret=True) ** 2)
        vj, gj = jax.value_and_grad(fj, argnums=(0, 1))(jnp.asarray(xs),
                                                        jnp.asarray(xd))
        a, b = (torch.tensor(v, requires_grad=True) for v in (xs, xd))
        vt = (TSd.sddmm_edges(mt, gt_, a, b, compute) ** 2).sum()
        vt.backward()
        _close(vt, vj)
        _close(a.grad, gj[0], GRAD_TOL)
        _close(b.grad, gj[1], GRAD_TOL)


def _hybrid_pair(unit_weight, **kw):
    hj, ht = _graph(symmetric_norm=not unit_weight)
    args = dict(block_rows=32, block_cols=32, tile_edges=64,
                tile_classes=(32, 64, 128), unit_weight=unit_weight, **kw)
    return (hj, ht, JG.hybrid_graph(hj, **args),
            TG.hybrid_graph(ht, device=CPU, **args))


@pytest.mark.parametrize("min_nnz", [0, 30])
def test_hybrid_graph_class_tail_matches_jax(min_nnz):
    """hybrid_graph(tile_classes=...) tiles the tail with classes, in the
    no-dense branch and the split branch; a grouped tail keeps its
    precedence."""
    hj, ht, yj, yt = _hybrid_pair(False, min_nnz=min_nnz)
    _assert_classes_equal(yj.tiles, yt.tiles)
    assert (yt.dense is None) == (min_nnz == 0)
    if yt.dense is not None:
        np.testing.assert_array_equal(_np(yt.dense.values),
                                      _np(yj.dense.values))
    yg = TG.hybrid_graph(ht, block_rows=32, block_cols=32, tile_edges=64,
                         min_nnz=min_nnz, tile_classes=(32, 64),
                         tail_format="grouped", device=CPU)
    assert isinstance(yg.tiles, TG.GroupedTiledGraph)


def test_spmm_hybrid_class_tail_matches_jax():
    """The class-tail spmm_hybrid forward and gradient in x (full-graph
    formulation, and the kernels over the transposed graph's split) against
    JAX's."""
    hj, ht, yj, yt = _hybrid_pair(False, min_nnz=30)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((ht.n_node, 16)).astype(np.float32)
    gj_, gt_ = hj.to_device(), ht.to_device(CPU)
    fj = lambda v: jnp.sum(JD.spmm_hybrid(yj, gj_, v,  # noqa: E731
                                          interpret=True) ** 2)
    vj, dj = jax.value_and_grad(fj)(jnp.asarray(x))
    htt, _ = TG.transpose_host_graph(ht)
    twin = TG.hybrid_graph(htt, block_rows=32, block_cols=32, tile_edges=64,
                           min_nnz=30, tile_classes=(32, 64, 128),
                           device=CPU)
    for hyb_t in (None, twin):
        xt = torch.tensor(x, requires_grad=True)
        vt = (TD.spmm_hybrid(yt, gt_, xt, hyb_t=hyb_t) ** 2).sum()
        vt.backward()
        _close(vt, vj)
        _close(xt.grad, dj, GRAD_TOL)


@pytest.mark.parametrize("wmode", [False, True])
def test_gat_hybrid_class_tail_matches_jax(wmode):
    """The class-tail gat_hybrid (K3 once per class under one msrc, plus
    K4) forward and gradients (the full-graph formulation, as JAX's class
    tails take) against JAX's."""
    hj, ht, yj, yt = _hybrid_pair(True, min_nnz=40, block_layout="cr",
                                  values_dtype=np.int8)
    assert isinstance(yt.tiles, TG.MultiTiledGraph)
    rng = np.random.default_rng(5)
    n, H, HD = ht.n_node, 4, 16
    h = rng.standard_normal((n, HD)).astype(np.float32)
    w = (rng.standard_normal((HD, H)) / 4).astype(np.float32)
    a_s = rng.standard_normal((n, H)).astype(np.float32)
    a_d = rng.standard_normal((n, H)).astype(np.float32)
    sw = w if wmode else a_s
    gj_, gt_ = hj.to_device(), ht.to_device(CPU)

    def fj(hh, ss, dd):
        kw = dict(w_asrc=ss) if wmode else {}
        return jnp.sum(JD.gat_hybrid(yj, gj_, hh, None if wmode else ss, dd,
                                     interpret=True, **kw) ** 2)

    vj, gj = jax.value_and_grad(fj, argnums=(0, 1, 2))(
        jnp.asarray(h), jnp.asarray(sw), jnp.asarray(a_d))
    ins = [torch.tensor(v, requires_grad=True) for v in (h, sw, a_d)]
    kw = dict(w_asrc=ins[1]) if wmode else {}
    vt = (TD.gat_hybrid(yt, gt_, ins[0], None if wmode else ins[1], ins[2],
                        **kw) ** 2).sum()
    vt.backward()
    _close(vt, vj)
    for a, b in zip(ins, gj):
        _close(a.grad, b, GRAD_TOL)


def test_gat_forward_classes_need_one_shift():
    _, _, _, mt = _classes(True)
    h = torch.zeros((mt.n_node, 8))
    a = torch.zeros((mt.n_node, 2))
    with pytest.raises(ValueError, match="msrc"):
        TA._gat_forward(mt, h, a, a, normalize=False)
    with pytest.raises(ValueError, match="msrc"):
        TA._gat_forward(mt, h, a, a, msrc=a[:1])


@pytest.mark.parametrize("kind,values", [
    ("spmm", None), ("spmm", "float32"), ("spmm", "bfloat16"),
    ("gat", None), ("gat", "bfloat16")])
def test_auto_hybrid_matches_jax(kind, values):
    """auto_hybrid picks the same threshold, tail geometry and capacity as
    JAX's and the split computes the same; bf16 values are JAX's
    ml_dtypes values; with classes the tail is a MultiTiledGraph."""
    hj, ht = _graph()
    vj, vt = {None: (None, None),
              "float32": (np.float32, np.float32),
              "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16)}[values]
    geos = ((64, 64), (96, 64)) if kind == "spmm" else ((128, 64),)
    kw = dict(kind=kind, dense_block=32, heads=4, head_dim=4,
              tail_geometries=geos, dense_budget=1 << 20)
    yj = JD.auto_hybrid(hj, values_dtype=vj, **kw)
    yt = TD.auto_hybrid(ht, values_dtype=vt, device=CPU, **kw)
    _assert_tiles_equal(yj.tiles, yt.tiles)
    assert yt.n_dense_edges == yj.n_dense_edges > 0
    np.testing.assert_array_equal(_np(yt.dense.values), _np(yj.dense.values))
    if values == "bfloat16":
        assert yt.dense.values.dtype == torch.bfloat16
    rng = np.random.default_rng(6)
    n = ht.n_node
    if kind == "spmm":
        x = rng.standard_normal((n, 16)).astype(np.float32)
        deg_in = np.bincount(ht.receivers[: ht.n_edge], minlength=n)
        deg_out = np.bincount(ht.senders[: ht.n_edge], minlength=n)
        rs = (1 / np.sqrt(np.maximum(deg_in, 1))).astype(np.float32)
        cs = (1 / np.sqrt(np.maximum(deg_out, 1))).astype(np.float32)
        sc = {} if values else dict(row_scale=rs, col_scale=cs)
        yjx = JS.spmm(yj.tiles, jnp.asarray(x), interpret=True)
        yjx = yjx + JD.spmm_dense(
            yj.dense, jnp.asarray(x), interpret=True,
            **{k: jnp.asarray(v) for k, v in sc.items()})[: yjx.shape[0]]
        ytx = TS.spmm(yt.tiles, torch.tensor(x))
        ytx = ytx + TD.spmm_dense(
            yt.dense, torch.tensor(x),
            **{k: torch.tensor(v) for k, v in sc.items()})[: ytx.shape[0]]
        _close(ytx, yjx)
        yc = TD.auto_hybrid(ht, values_dtype=vt, device=CPU,
                            tile_classes=(32, 64, 128), **kw)
        assert isinstance(yc.tiles, TG.MultiTiledGraph)
        yct = TS.spmm(yc.tiles, torch.tensor(x)) + TD.spmm_dense(
            yc.dense, torch.tensor(x),
            **{k: torch.tensor(v) for k, v in sc.items()})[: n]
        _close(yct, yjx)
    else:
        h = rng.standard_normal((n, 16)).astype(np.float32)
        a_s, a_d = (rng.standard_normal((n, 4)).astype(np.float32)
                    for _ in range(2))
        oj = JD.gat_hybrid(yj, hj.to_device(), jnp.asarray(h),
                           jnp.asarray(a_s), jnp.asarray(a_d),
                           interpret=True)
        ot = TD.gat_hybrid(yt, ht.to_device(CPU), torch.tensor(h),
                           torch.tensor(a_s), torch.tensor(a_d))
        _close(ot, oj)


def test_hybrid_bf16_values_match_jax():
    """bf16 dense values: the float32 sums rounded once, JAX's ml_dtypes
    values bit for bit, in both layouts; spmm_dense over the 'rc' blocks
    in bf16 against JAX's."""
    hj, ht = _graph()
    x = np.random.default_rng(8).standard_normal((ht.n_node, 24))
    for layout in ("rc", "cr"):
        kw = dict(block_rows=32, block_cols=32, tile_edges=64, min_nnz=30,
                  block_layout=layout)
        yj = JG.hybrid_graph(hj, values_dtype=ml_dtypes.bfloat16, **kw)
        yt = TG.hybrid_graph(ht, values_dtype=torch.bfloat16, device=CPU,
                             **kw)
        assert yt.dense.values.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(yt.dense.values),
                                      _np(yj.dense.values))
        if layout == "rc":
            _close(TD.spmm_dense(yt.dense,
                                 torch.tensor(x, dtype=torch.bfloat16)),
                   JD.spmm_dense(yj.dense, jnp.asarray(x, jnp.bfloat16),
                                 interpret=True), TOL["bfloat16"])


def _runs(kind: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return {"small": rng.integers(1, 140, 5000),
            "big": rng.integers(300, 520, 50000),
            "mixed": np.concatenate([rng.integers(1, 40, 3000),
                                     rng.integers(400, 2000, 300)]),
            "past one call": rng.integers(50, 150, 100000)}[kind]


@pytest.mark.parametrize("kind", ["small", "big", "mixed", "past one call"])
def test_tile_time_model_matches_jax(kind):
    """grid_ramp_ns, tile_time_model_ns and best_tile_capacity equal JAX's
    on seeded run-size distributions, at every geometry the bench tries and
    two feature widths."""
    runs = _runs(kind, 9)
    for tr, tc in TCLI.BENCH_GEOMETRIES:
        for fw in (16, 128):
            assert TG.grid_ramp_ns(len(runs), 1000.0, fw) == \
                JG.grid_ramp_ns(len(runs), 1000.0, fw)
            for et in (128, 512):
                for ramp in (True, False):
                    assert TG.tile_time_model_ns(
                        runs, et, tr, tc, feat_width=fw, include_ramp=ramp) \
                        == JG.tile_time_model_ns(runs, et, tr, tc,
                                                 feat_width=fw,
                                                 include_ramp=ramp)
            assert TG.best_tile_capacity(runs, tr, tc, feat_width=fw) == \
                JG.best_tile_capacity(runs, tr, tc, feat_width=fw)


def test_tile_capacity_model_prefers_the_run_sizes():
    """The JAX package's expectations of the model: small capacities for
    scattered small runs, large ones for concentrated runs, and a per-tile
    surcharge past one call's tiles."""
    assert TG.best_tile_capacity(np.full(5000, 70), 1024, 1024) == 128
    assert TG.best_tile_capacity(np.full(50000, 404), 1024, 1024) >= 384
    t_small = TG.tile_time_model_ns(np.full(1000, 100), 128, 1024, 1024,
                                    include_ramp=False)
    t_big = TG.tile_time_model_ns(np.full(100000, 100), 128, 1024, 1024,
                                  include_ramp=False)
    assert t_big > 100 * t_small


@pytest.mark.parametrize("rows", [32, 64, 100])
def test_run_nnz_hist_and_nnz_histogram_match_jax(rows):
    hj, ht = _graph()
    np.testing.assert_array_equal(TG.run_nnz_hist(ht, rows, 64),
                                  JG.run_nnz_hist(hj, rows, 64))
    a, b = TG.nnz_histogram(ht, rows), JG.nnz_histogram(hj, rows)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def test_build_graph_matches_jax():
    s, r, n, _ = fixtures.edge_case_graph(seed=0)
    gj = J.build_graph(s, r, n, symmetric_norm=True, edge_pad_multiple=128)
    gt = T.build_graph(s, r, n, symmetric_norm=True, edge_pad_multiple=128,
                       device=CPU)
    for k in ("senders", "receivers", "edge_mask", "edge_weight"):
        np.testing.assert_array_equal(_np(getattr(gt, k)),
                                      np.asarray(getattr(gj, k)), err_msg=k)
    assert (gt.n_node, gt.n_edge) == (gj.n_node, gj.n_edge)
    for name in ("MultiTiledGraph", "build_graph", "tile_graph_classes",
                 "nnz_histogram", "auto_hybrid"):
        assert hasattr(T, name) and hasattr(J, name), name


def test_roofline_counts_the_same_work_over_classes():
    """A bound counts the live slots whatever the tiling: the class tiling
    and a one-class tiling of the same edges give the same operations."""
    _, ht, _, mt = _classes()
    one = TG.tile_graph(ht, tile_edges=64, device=CPU, **GEO)
    x = torch.zeros((ht.n_node, 32))
    assert roofline.live_slots(mt) == roofline.live_slots(one) == ht.n_edge
    assert roofline.spmm_tail(mt, x, 4).ops == roofline.spmm_tail(one, x,
                                                                  4).ops
    assert roofline.sddmm_tail(mt, x, x, 4).ops == \
        roofline.sddmm_tail(one, x, x, 4).ops
    assert roofline.gat_tail(mt, x, 4, 2).ops == \
        roofline.gat_tail(one, x, 4, 2).ops
    csr = roofline.csr_of(mt, torch.float32, ht.n_node)
    assert csr.to_dense().sum() == pytest.approx(
        float(ht.edge_weight[: ht.n_edge].sum()), rel=1e-5)


BENCH_ARGS = {
    "batched": ["--batch", "3"],
    "classes": ["--tile-classes", "32,64", "--sparse-block", "64"],
    "default": [],
}


@pytest.mark.parametrize("case", list(BENCH_ARGS))
def test_cli_bench_on_cpu(case, capsys):
    """cli bench on the tiny dataset with --device cpu (host times only):
    the geometry keys as JAX's bench prints them, and the default geometry
    is JAX's pick (the modelled argmin)."""
    common = ["bench", "--dataset", "tiny", "--hidden", "16", "--iters", "2",
              "--target-s", "0", "--json"]
    rc = TCLI.main(common + ["--device", "cpu"] + BENCH_ARGS[case])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["finite"]
    assert out["spmm_host_us"] > 0 and out["sddmm_host_us"] > 0
    assert "spmm_latency_us" not in out      # no device time on the CPU
    rc = JCLI.main(common + BENCH_ARGS[case])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    for k in ("batch", "tile_classes", "sparse_block", "tile_edges"):
        assert out.get(k) == want.get(k), k
    ds = TDs.load_dataset("tiny")
    assert out["n_edge"] == ds.host_graph.n_edge * (
        3 if case == "batched" else 1)


def test_cli_compiled_and_ga_still_exit_2(tmp_path, capsys):
    """``run --compiled`` and ``tune --ga`` exited with status 2 until the
    latency model and the genetic tuner were ported (the name is the old
    check's); both now run on the tiny dataset."""
    rc = TCLI.main(["run", "--compiled", "--dataset", "tiny", "--hidden",
                    "16", "--device", "cpu", "--json"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["finite"] and len(out["schedule"]) == 2
    assert out["modelled_us"] > 0
    rc = TCLI.main(["tune", "--ga", "--dataset", "tiny", "--network", "GCN",
                    "--hidden", "16", "--device", "cpu", "--target-s", "0",
                    "--iters", "1", "--memo", str(tmp_path / "m.csv"),
                    "--json"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["search"] == "genetic"
    assert out["best_latency_us"] > 0 and out["n_trials"] >= 1
