"""PyTorch port, the grouped sparse tail against the JAX package:
``tile_graph_grouped`` and ``hybrid_graph(tail_format="grouped")`` (arrays
equal), the grouped SpMM (K9's plain version) and grouped GAT partials
(K10's), the differentiable ``spmm`` (with and without a transposed
tiling, per-tile and grouped, edge values included), ``lower_schedule``
on ``PATH_GROUPED``, the hybrid wrappers with grouped tails, the port's
``bench.py``, and the default device of the entry points.  JAX runs its
Pallas kernels in interpret mode; inputs are made with numpy from a seed
and handed to both.

Tolerances: float32 max |port - jax| <= 1e-5 * max(1, max |jax|) (the
same terms summed in another order); bfloat16 1e-2 of each row's largest
|jax| (both round the same products to bf16; a product whose f32 value
differs in its last bit between the libraries may round the other way,
2^-8 of itself); gradients 1e-4 * max(1, max |jax|)."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu as J  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu import graph as JG  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler import fusion as JF  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler import schedule as JS  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.ops import dense as JD  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.ops import gat as JA  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.ops import spmm as JSp  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch as T  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import bench as TB  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import graph as TG  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import fusion as TF  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import lower as TL  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import schedule as TS  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models import train as TT  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models import zoo as TZ  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import dense as TD  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import gat as TA  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import spmm as TSp  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import fixtures  # noqa: E402

CPU = "cpu"     # the port's entry points default to the CUDA card
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
GRAD_TOL = 1e-4
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# the bench's two hybrid recipes, shrunk to the edge-case graph: 128-wide
# dense blocks, a grouped tail of 128-wide blocks in groups of 4
SPLITS = {
    "rc_sg16": dict(block_rows=128, block_cols=128, tile_edges=64, min_nnz=64,
                    supergroup=16, values_dtype=np.int8,
                    tail_format="grouped", tail_group=4),
    "cr_unit": dict(block_rows=128, block_cols=128, tile_edges=64, min_nnz=64,
                    unit_weight=True, block_layout="cr", values_dtype=np.int8,
                    tail_format="grouped", tail_group=4),
    "no_dense": dict(block_rows=128, block_cols=128, tile_edges=64, min_nnz=0,
                     tail_format="grouped", tail_group=4),
}
GEO = dict(block_rows=128, block_cols=128, tile_edges=64)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _float_state() -> str:
    """The process state that can change float32 arithmetic, for a
    failure's message (never asserted on)."""
    mk = torch.backends.mkldnn
    return (f"torch.get_float32_matmul_precision() = "
            f"{torch.get_float32_matmul_precision()!r}, "
            f"torch.backends.fp32_precision = "
            f"{torch.backends.fp32_precision!r}, "
            f"torch.backends.mkldnn.matmul.fp32_precision = "
            f"{mk.matmul.fp32_precision!r}, "
            f"torch.backends.mkldnn.fp32_precision = {mk.fp32_precision!r}, "
            f"torch.get_num_threads() = {torch.get_num_threads()}, "
            f"jax.config.jax_default_matmul_precision = "
            f"{jax.config.jax_default_matmul_precision!r}, a float32 "
            f"denormal times 1 in torch = "
            f"{float(torch.tensor([1e-40]) * 1.0):.3g} (0: flushed)")


def _close(port, ref, tol=TOL["float32"], f64=None):
    """max |port - ref| <= tol * max(1, max |ref|).  With ``f64``, the same
    quantity in float64, a failure's message says which side is further
    from it, by how much, and the process's float state."""
    port, ref = _np(port), _np(ref)
    assert port.shape == ref.shape
    bound = tol * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(port - ref).max())
    msg = (err, bound)
    if f64 is not None and not err <= bound:
        e_port, e_ref = (float(np.abs(np.asarray(a, np.float64) - f64).max())
                         for a in (port, ref))
        msg = (f"|port - jax| {err:.3e} > {bound:.3e}; against float64: "
               f"port {e_port:.3e}, jax {e_ref:.3e}, so "
               f"{'the port' if e_port > e_ref else 'JAX'} is off; "
               f"{_float_state()}")
    assert err <= bound, msg


def _close_rows(port, ref, tol):
    """Each row within ``tol`` of its own largest |ref| (rows of zeros stay
    within tol * 1e-6 of the largest row)."""
    port, ref = _np(port), _np(ref)
    assert port.shape == ref.shape
    scale = np.abs(ref).max(axis=1)
    scale = np.maximum(scale, 1e-6 * max(1.0, float(scale.max())))
    share = float((np.abs(port - ref).max(axis=1) / (tol * scale)).max())
    assert share <= 1.0, share


def _assert_grouped_equal(tj, tt):
    for k in ("chunk_grp", "chunk_cb", "src_local", "dst_local", "edge_id",
              "weight"):
        a, b = np.asarray(getattr(tj, k)), getattr(tt, k).numpy()
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=k)
    for k in ("block_rows", "block_cols", "tile_edges", "group", "n_node",
              "n_groups", "n_col_blocks", "weight_all_unit"):
        assert getattr(tj, k) == getattr(tt, k), k
    assert tj.grp_first_chunk_host == tt.grp_first_chunk
    assert (tj.n_chunks, tj.n_tiles, tj.total_slots) == (
        tt.n_chunks, tt.n_tiles, tt.total_slots)


def _graph_case(case):
    """(senders, receivers, n_node, build_host_graph kwargs)."""
    rng = np.random.default_rng(3)
    if case == "empty":
        return np.zeros(0, np.int32), np.zeros(0, np.int32), 40, {}
    if case == "single_edge":
        return np.array([3], np.int32), np.array([30], np.int32), 40, {}
    if case == "empty_groups":
        # receivers only in rows 0-63 and 1984-2047: the stripe groups
        # between own no edge and get a chunk of padding each
        r = np.concatenate([rng.integers(0, 64, 300),
                            rng.integers(1984, 2048, 300)]).astype(np.int32)
        s = rng.integers(0, 2048, 600).astype(np.int32)
        return s, r, 2048, {}
    s = rng.integers(0, 700, 5000).astype(np.int32)
    r = rng.integers(0, 700, 5000).astype(np.int32)
    if case == "zero_weight":
        w = rng.random(5000).astype(np.float32)
        w[::7] = 0.0
        return s, r, 700, dict(edge_weight=w)
    return s, r, 700, dict(add_self_loops=True,
                           symmetric_norm=case == "random_weighted")


@pytest.mark.parametrize("group", [4, 16])
@pytest.mark.parametrize("case", ["random_weighted", "random_unit", "empty",
                                  "single_edge", "empty_groups",
                                  "zero_weight"])
def test_tile_graph_grouped_matches_jax(case, group):
    s, r, n, kw = _graph_case(case)
    hj = J.build_host_graph(s, r, n, **kw)
    ht = TG.build_host_graph(s, r, n, **kw)
    geo = dict(block_rows=32, block_cols=64, tile_edges=32, group=group)
    tj = JG.tile_graph_grouped(hj, **geo)
    tt = TG.tile_graph_grouped(ht, **geo, device=CPU)
    _assert_grouped_equal(tj, tt)
    # weight_all_unit comes from the real edges: weight-0 edges clear it
    assert tt.weight_all_unit == (case in ("random_unit", "empty",
                                           "single_edge", "empty_groups"))
    # the live slots of each sub-tile form a prefix (the kernels' walk
    # stops at the first 32 slots without an edge)
    live = (tt.dst_local < tt.block_rows).numpy()
    assert (np.diff(live.astype(np.int8), axis=-1) <= 0).all()
    if case == "empty_groups":
        has = live.reshape(tt.n_chunks, -1).any(1)
        assert set(range(tt.n_groups)) - set(tt.chunk_grp.numpy()[has])


@pytest.mark.parametrize("recipe", list(SPLITS))
def test_hybrid_graph_grouped_matches_jax(recipe):
    """The bench's 'rc' supergroup-16 recipe (weighted tail slots) and its
    'cr' unit recipe, whose tail holds the 200-copy pair's merged slot of
    73 copies; and the branch without dense blocks."""
    s, r, n, _ = fixtures.edge_case_graph()
    kw = dict(symmetric_norm=recipe == "rc_sg16", edge_pad_multiple=128)
    hj, ht = J.build_host_graph(s, r, n, **kw), TG.build_host_graph(s, r, n,
                                                                    **kw)
    yj = JG.hybrid_graph(hj, **SPLITS[recipe])
    yt = TG.hybrid_graph(ht, **SPLITS[recipe], device=CPU)
    assert isinstance(yt.tiles, TG.GroupedTiledGraph)
    assert (yj.n_dense_edges, yj.n_sparse_edges) == (yt.n_dense_edges,
                                                     yt.n_sparse_edges)
    _assert_grouped_equal(yj.tiles, yt.tiles)
    if recipe == "no_dense":
        assert yt.dense is None and yj.dense is None
        return
    for k in ("blk_rb", "blk_cb", "values", "row_mask"):
        np.testing.assert_array_equal(np.asarray(getattr(yj.dense, k)),
                                      getattr(yt.dense, k).numpy(), err_msg=k)
    assert int(yt.dense.values.max()) == 127
    if recipe == "cr_unit":
        assert float(yt.tiles.weight.max()) == 73.0
        assert not yt.tiles.weight_all_unit


def _grouped_pair(unit: bool, **geo):
    s, r, n, _ = fixtures.edge_case_graph()
    kw = dict(symmetric_norm=not unit, edge_pad_multiple=128)
    hj, ht = J.build_host_graph(s, r, n, **kw), TG.build_host_graph(s, r, n,
                                                                    **kw)
    geo = {**GEO, "group": 4, **geo}
    return (JG.tile_graph_grouped(hj, unit_weight=unit, **geo),
            TG.tile_graph_grouped(ht, unit_weight=unit, **geo, device=CPU),
            hj, ht)


@pytest.mark.parametrize("edge_vals", [False, True])
@pytest.mark.parametrize("unit", [False, True])
@pytest.mark.parametrize("dtn", ["float32", "bfloat16"])
def test_grouped_spmm_matches_jax(dtn, unit, edge_vals):
    """K9's plain version, and the ``spmm`` dispatch, against the TPU
    kernel (``_spmm_grouped_raw``) and JAX's ``_spmm_raw`` dispatch."""
    tj, tt, hj, _ = _grouped_pair(unit)
    assert tt.weight_all_unit == unit
    tdt, jdt = DTYPES[dtn]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((hj.n_node, 40)).astype(np.float32)
    ev = rng.random(hj.e_pad).astype(np.float32) if edge_vals else None
    xj, xt = jnp.asarray(x, jdt), torch.tensor(x, dtype=tdt)
    evj = None if ev is None else jnp.asarray(ev)
    evt = None if ev is None else torch.tensor(ev)
    yj = JSp._spmm_grouped_raw(tj, xj, evj, interpret=True)
    _close(JSp._spmm_raw(tj, xj, evj, interpret=True), yj, 0.0)
    for yt in (TSp._spmm_grouped_reference(tt, xt, evt),
               TSp.spmm(tt, xt, evt)):
        assert yt.dtype == torch.float32
        if dtn == "float32":
            _close(yt, yj)
        else:
            _close_rows(yt, yj, TOL["bfloat16"])


@pytest.mark.parametrize("dtn", ["float32", "bfloat16"])
@pytest.mark.parametrize("weights", ["unit", "multiplicity"])
@pytest.mark.parametrize("H,HD", [(16, 16), (4, 32), (1, 41)])
def test_grouped_gat_partials_match_jax(H, HD, weights, dtn):
    """K10's plain version (through ``_gat_forward``'s grouped dispatch)
    against JAX's ``_gat_forward`` on a grouped tiling: raw [num | den]
    under a given msrc, derive mode.  "multiplicity": the 'cr' hybrid tail,
    whose merged slot weighs 73."""
    s, r, n, _ = fixtures.edge_case_graph()
    hj = J.build_host_graph(s, r, n, edge_pad_multiple=128)
    ht = TG.build_host_graph(s, r, n, edge_pad_multiple=128)
    if weights == "unit":
        tj = JG.tile_graph_grouped(hj, group=4, unit_weight=True, **GEO)
        tt = TG.tile_graph_grouped(ht, group=4, unit_weight=True, **GEO,
                                   device=CPU)
    else:
        tj = JG.hybrid_graph(hj, **SPLITS["cr_unit"]).tiles
        tt = TG.hybrid_graph(ht, **SPLITS["cr_unit"], device=CPU).tiles
        assert float(tt.weight.max()) == 73.0
    tdt, jdt = DTYPES[dtn]
    rng = np.random.default_rng(2)
    h = rng.standard_normal((n, HD)).astype(np.float32)
    w = (rng.standard_normal((HD, H)) / np.sqrt(HD)).astype(np.float32)
    a_d = rng.standard_normal((n, H)).astype(np.float32)
    hr = np.asarray(jnp.asarray(h, jdt).astype(jnp.float32))
    wr = np.asarray(jnp.asarray(w, jdt).astype(jnp.float32))
    msrc = (hr @ wr).max(0, keepdims=True).astype(np.float32)
    want = JA._gat_forward(tj, jnp.asarray(h, jdt), None, jnp.asarray(a_d),
                           w_asrc=jnp.asarray(w, jdt), normalize=False,
                           msrc=jnp.asarray(msrc), interpret=True)
    got = TA._gat_forward(tt, torch.tensor(h, dtype=tdt), None,
                          torch.tensor(a_d), w_asrc=torch.tensor(w, dtype=tdt),
                          normalize=False, msrc=torch.tensor(msrc))
    assert got.shape == (n, HD + H)
    # the same [num | den] in float64 over the live slots, from the rounded
    # inputs: which side a float32 failure is off on
    mask, src, dst = TSp._live_slots(tt, 0, tt.n_chunks)
    src, dst = src.numpy(), dst.numpy()
    m = tt.weight[mask].double().numpy()[:, None]
    a_s = hr.astype(np.float64)[src] @ wr.astype(np.float64)
    a_dd = a_d.astype(np.float64)[dst]
    lk = lambda v: np.where(v >= 0, v, 0.2 * v)  # noqa: E731
    p = m * np.exp(np.minimum(lk(a_s + a_dd) - lk(msrc + a_dd), 60.0))
    f64 = np.zeros((n, HD + H))
    np.add.at(f64, dst, np.concatenate(
        [np.repeat(p, HD // H, axis=1) * hr.astype(np.float64)[src], p], 1))
    for cols in (slice(0, HD), slice(HD, None)):     # num and den apart
        if dtn == "float32":
            _close(got[:, cols], np.asarray(want)[:, cols], f64=f64[:, cols])
        else:
            _close_rows(got[:, cols], np.asarray(want)[:, cols],
                        TOL["bfloat16"])
    with pytest.raises(ValueError, match="hybrid partial"):
        TA._gat_forward(tt, torch.tensor(h), None, torch.tensor(a_d),
                        w_asrc=torch.tensor(w), msrc=torch.tensor(msrc))


@pytest.mark.parametrize("edge_vals", [False, True])
@pytest.mark.parametrize("twin", [False, True])
@pytest.mark.parametrize("tiling", ["tiles", "grouped"])
def test_spmm_grads_match_jax(tiling, twin, edge_vals):
    """dx (and d edge_vals) of ``spmm`` against jax.grad of the JAX
    ``spmm``: with a tiling of the transposed graph dx runs the forward's
    kernel over it (edge values routed through ``ev_perm_t``); without,
    the plain formulation."""
    s, r, n, _ = fixtures.edge_case_graph()
    kw = dict(symmetric_norm=True, edge_pad_multiple=128)
    hj, ht = J.build_host_graph(s, r, n, **kw), TG.build_host_graph(s, r, n,
                                                                    **kw)
    (hj_t, pj), (ht_t, pt) = (JG.transpose_host_graph(hj),
                              TG.transpose_host_graph(ht))
    if tiling == "grouped":
        geo = {**GEO, "group": 4}
        jt_, tt_ = JG.tile_graph_grouped, TG.tile_graph_grouped
    else:
        geo = dict(GEO)
        jt_, tt_ = JG.tile_graph, TG.tile_graph
    tj, tt = jt_(hj, **geo), tt_(ht, **geo, device=CPU)
    tj_t = jt_(hj_t, **geo) if twin else None
    tt_t = tt_(ht_t, **geo, device=CPU) if twin else None
    rng = np.random.default_rng(4)
    x = rng.standard_normal((n, 24)).astype(np.float32)
    gy = rng.standard_normal((n, 24)).astype(np.float32)
    ev = rng.random(hj.e_pad).astype(np.float32)

    def j_loss(xx, ee):
        y = JSp.spmm(tj, xx, ee if edge_vals else None, tg_t=tj_t,
                     ev_perm_t=jnp.asarray(pj) if twin else None,
                     interpret=True)
        return jnp.vdot(y, jnp.asarray(gy))

    dxj, devj = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(x),
                                                 jnp.asarray(ev))
    xt = torch.tensor(x, requires_grad=True)
    evt = torch.tensor(ev, requires_grad=True)
    y = TSp.spmm(tt, xt, evt if edge_vals else None, tg_t=tt_t,
                 ev_perm_t=torch.as_tensor(pt) if twin else None)
    (y * torch.tensor(gy)).sum().backward()
    _close(xt.grad, dxj, GRAD_TOL)
    if edge_vals:
        _close(evt.grad, devj, GRAD_TOL)
    else:
        assert evt.grad is None


@pytest.mark.parametrize("tiling", ["tiles", "grouped"])
def test_spmm_twin_backward_reads_only_the_twin(tiling, monkeypatch):
    """With a transposed tiling and no edge values nothing of the plain
    formulation runs in the backward: it walks the twin's slots (the
    kernel's work) and never the forward tiling's."""
    s, r, n, _ = fixtures.edge_case_graph()
    ht = TG.build_host_graph(s, r, n, symmetric_norm=True)
    build = TG.tile_graph_grouped if tiling == "grouped" else TG.tile_graph
    geo = {**GEO, "group": 4} if tiling == "grouped" else GEO
    tt = build(ht, **geo, device=CPU)
    tt_t = build(TG.transpose_host_graph(ht)[0], **geo, device=CPU)
    walked = []
    real = TSp._live_slots
    monkeypatch.setattr(TSp, "_live_slots", lambda tg, *a: walked.append(
        tg) or real(tg, *a))
    x = torch.randn((n, 8), requires_grad=True)
    y = TSp.spmm(tt, x, tg_t=tt_t)
    assert walked and all(t is tt for t in walked)
    walked.clear()
    y.sum().backward()
    assert walked and all(t is tt_t for t in walked)


@pytest.mark.parametrize("reorder", [False, True])
def test_lower_schedule_grouped_matches_jax(reorder):
    """PATH_GROUPED GCN lowered with build_transpose=True (as
    tests/test_grouped.py:240-270 does for the JAX package): the forward
    and every parameter's gradient against the JAX package's."""
    rng = np.random.default_rng(0)
    s = rng.integers(0, 400, 3000).astype(np.int32)
    r = rng.integers(0, 400, 3000).astype(np.int32)
    kw = dict(add_self_loops=True, symmetric_norm=True)
    hj, ht = J.build_host_graph(s, r, 400, **kw), TG.build_host_graph(
        s, r, 400, **kw)
    gj = J.build_op_graph("GCN", 32, 16, reorder=reorder)
    gt = T.build_op_graph("GCN", 32, 16, reorder=reorder)
    part = TS.aggregation_partition(gt)
    tcg = TS.TileConfig(128, 128, 64, TS.PATH_GROUPED)
    tiles = tuple(tcg if TF.classify_block(gt, b, tcg)[0] == "spmm_grouped"
                  else TS.TileConfig(path=TS.PATH_XLA) for b in part)
    assert any(t.path == TS.PATH_GROUPED for t in tiles)
    sched = TS.Schedule(blocks=part, tiles=tiles)
    pj = J.init_params(gj, jax.random.key(0))
    pt = {k: torch.tensor(np.asarray(v), requires_grad=True)
          for k, v in pj.items()}
    x = rng.standard_normal((400, 32)).astype(np.float32)
    fj = JF.lower_schedule(gj, JS.Schedule.from_key(sched.key()), hj,
                           interpret=True, build_transpose=True)
    fn = TF.lower_schedule(gt, sched, ht, build_transpose=True, device=CPU)
    (plan,) = [p for p in fn.plans if p[0] == "spmm_grouped"]
    assert isinstance(plan[2], TG.GroupedTiledGraph)
    assert isinstance(plan[3], TG.GroupedTiledGraph)    # the twin
    g = ht.to_device(CPU)
    out = fn(pt, g, torch.tensor(x))
    _close(out, fj(pj, hj.to_device(), jnp.asarray(x)))
    want = jax.grad(lambda p: jnp.sum(fj(p, hj.to_device(),
                                         jnp.asarray(x)) ** 2))(pj)
    (out ** 2).sum().backward()
    assert set(want) == set(pt)
    for k, p in pt.items():
        _close(p.grad, want[k], GRAD_TOL)


@pytest.fixture(scope="module")
def sym_graphs():
    """A small community graph, symmetric norm, hubs+labels reorder (the
    smoke's recipe), and its transpose, in both packages."""
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.data.datasets \
        import synthetic_coo
    s, r, labels = synthetic_coo(600, 5000, seed=1, communities=6, p_in=0.8)
    out = {}
    for name, mod in (("jax", JG), ("port", TG)):
        hg = mod.build_host_graph(s, r, 600, add_self_loops=True,
                                  symmetric_norm=True)
        hg, _ = mod.reorder_nodes(hg, "hubs+labels", labels=labels)
        out[name] = (hg, mod.transpose_host_graph(hg)[0])
    return out


def _split(mod, hg, recipe):
    kw = dict(SPLITS[recipe], min_nnz=60)
    hyb = (mod.hybrid_graph(hg, **kw) if mod is JG
           else mod.hybrid_graph(hg, **kw, device=CPU))
    if recipe == "rc_sg16":
        to = jnp.asarray if mod is JG else torch.as_tensor
        rs, cs = mod.separable_weight_scales(hg)
        import dataclasses
        hyb = dataclasses.replace(hyb, row_scale=to(rs), col_scale=to(cs))
    return hyb


def test_spmm_hybrid_grouped_tail_matches_jax(sym_graphs, monkeypatch):
    """spmm_hybrid with grouped tails (K9 + K2 plain versions): the forward
    and dx = Aᵀȳ over the grouped twin against JAX, the twin's gradient
    never touching the full-graph formulation."""
    (hj, hj_t), (ht, ht_t) = sym_graphs["jax"], sym_graphs["port"]
    yj, yj_t = _split(JG, hj, "rc_sg16"), _split(JG, hj_t, "rc_sg16")
    yt, yt_t = _split(TG, ht, "rc_sg16"), _split(TG, ht_t, "rc_sg16")
    assert yt.dense is not None and yt.n_sparse_edges > 0
    rng = np.random.default_rng(5)
    x = rng.standard_normal((600, 24)).astype(np.float32)
    gy = rng.standard_normal((600, 24)).astype(np.float32)
    gj = hj.to_device()
    fwd_j = JD.spmm_hybrid(yj, gj, jnp.asarray(x), interpret=True)
    dj = jax.grad(lambda v: jnp.vdot(JD.spmm_hybrid(
        yj, gj, v, interpret=True, hyb_t=yj_t), jnp.asarray(gy)))(
        jnp.asarray(x))

    def boom(*a, **k):
        raise AssertionError("full-graph backward taken")

    monkeypatch.setattr(TD, "_spmm_ref_g", boom)
    xt = torch.tensor(x, requires_grad=True)
    y = TD.spmm_hybrid(yt, ht.to_device(CPU), xt, hyb_t=yt_t)
    _close(y, fwd_j)
    (y * torch.tensor(gy)).sum().backward()
    _close(xt.grad, dj, GRAD_TOL)


def test_gat_hybrid_grouped_tail_matches_jax(sym_graphs, monkeypatch):
    """gat_hybrid with grouped tails (K10 + K4 plain versions), derive
    mode: the forward against JAX, and the gradient (dh, dw, dad), which
    takes the full-graph route (JAX's kernel_bwd rule: the tail backward
    kernels read per-tile tilings) even with a twin, against jax.grad
    through the JAX package's same route.  Values mode raises: the grouped
    tail derives a_s in-kernel."""
    (hj, hj_t), (ht, ht_t) = sym_graphs["jax"], sym_graphs["port"]
    yj, yj_t = _split(JG, hj, "cr_unit"), _split(JG, hj_t, "cr_unit")
    yt, yt_t = _split(TG, ht, "cr_unit"), _split(TG, ht_t, "cr_unit")
    H, HD = 4, 32
    rng = np.random.default_rng(6)
    h = rng.standard_normal((600, HD)).astype(np.float32)
    w = (rng.standard_normal((HD, H)) * 0.3).astype(np.float32)
    d = rng.standard_normal((600, H)).astype(np.float32)
    wt = rng.standard_normal((HD, 3)).astype(np.float32)
    gj = hj.to_device()

    def j_loss(hh, ww, dd):
        y = JD.gat_hybrid(yj, gj, hh, None, dd, w_asrc=ww, interpret=True,
                          hyb_t=yj_t)
        return jnp.sum(jnp.tanh(y @ wt) ** 2)

    args = (jnp.asarray(h), jnp.asarray(w), jnp.asarray(d))
    fwd_j = JD.gat_hybrid(yj, gj, *args[:1], None, args[2], w_asrc=args[1],
                          interpret=True)
    want = jax.grad(j_loss, argnums=(0, 1, 2))(*args)
    calls = []
    real = TD._gat_reference_g
    monkeypatch.setattr(TD, "_gat_reference_g",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    tv = [torch.tensor(v, requires_grad=True) for v in (h, w, d)]
    y = TD.gat_hybrid(yt, ht.to_device(CPU), tv[0], None, tv[2],
                      w_asrc=tv[1], hyb_t=yt_t)
    _close(y, fwd_j)
    got = torch.autograd.grad((torch.tanh(y @ torch.tensor(wt)) ** 2).sum(),
                              tv)
    assert calls, "the full-graph route was not taken"
    for a, b in zip(got, want):
        _close(a, b, GRAD_TOL)
    with pytest.raises(ValueError, match="hybrid partial"):
        TD.gat_hybrid(yt, None, tv[0], tv[2], tv[2])


def test_bench_prints_the_three_metrics_on_cpu(capsys):
    """The port's bench at a tiny size on the CPU: the root script's three
    metric names and units, each with value null (no device time on the
    CPU), and the grouped tails of both Reddit recipes in the details."""
    lines = [TB.gat_cora_layer3_latency(CPU, repeats=1)]
    hg = TB.reddit_graph(20_000, 3_000)
    lines += [TB.reddit_spmm_throughput(hg, CPU, repeats=1),
              TB.reddit_gat_throughput(hg, CPU, repeats=1)]
    printed = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert printed == lines
    assert [(o["metric"], o["unit"]) for o in printed] == [
        ("gat_cora_layer3_latency", "us"),
        ("reddit_spmm_throughput", "Gedge/s"),
        ("reddit_gat_throughput", "Gedge/s")]
    assert all(o["value"] is None for o in printed)
    assert "'gat'" in printed[0]["detail"]
    assert all("grouped tail" in o["detail"] for o in printed[1:])


def _tiny():
    ds = T.load_dataset("tiny")
    return ds, ds.host_graph


ENTRY_POINTS = {
    "build_model": lambda: TZ.build_model("GCN", 8, 3, hidden=4),
    "Model": lambda: TZ.Model("m", [T.build_op_graph("GCN", 8, 3)]),
    "init_params": lambda: TL.init_params(T.build_op_graph("GCN", 8, 3),
                                          torch.Generator()),
    "params_from_numpy": lambda: TL.params_from_numpy(
        {"w": np.ones((2, 2), np.float32)}),
    "to_device": lambda: _tiny()[1].to_device(),
    "tile_graph": lambda: TG.tile_graph(_tiny()[1]),
    "tile_graph_grouped": lambda: TG.tile_graph_grouped(_tiny()[1]),
    "hybrid_graph": lambda: TG.hybrid_graph(_tiny()[1], min_nnz=8),
    "lower_schedule": lambda: TF.lower_schedule(
        T.build_op_graph("GCN", 8, 3), TS.default_schedule(
            T.build_op_graph("GCN", 8, 3)), _tiny()[1]),
    "make_apply": lambda: TZ.build_model("GCN", 8, 3, device=CPU).make_apply(
        schedules=TS.default_schedule(T.build_op_graph("GCN", 8, 3)),
        host_graph=_tiny()[1]),
    "train_node_classifier": lambda: TT.train_node_classifier(
        _tiny()[0], epochs=1),
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_points_default_to_the_card(monkeypatch, entry):
    """Without ``device`` an entry point means the CUDA card: with none
    present it raises, naming the way to the CPU, instead of falling back
    to it quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[entry]()
    assert TG.resolve_device(CPU) == torch.device("cpu")
