"""PyTorch port, the fused pair aggregation against the JAX package:
``pair_aggregate_raw`` (K13's plain version against the TPU kernel in
interpret mode), the differentiable ``pair_aggregate`` against
``jax.grad``, ``pair_agg_partition``, the ``pair_agg`` kind of
``lower_schedule``, and DGN-2l and PNA-2l served through
``make_apply(schedules=...)``.  Inputs are made with numpy from a seed and
handed to both packages; the port runs on the CPU, where the K13 wrapper
takes its plain version.

The fixture is the edge-case graph of ``utils/fixtures``: rows 512-598
receive no edge (max 0), row ``NEG_ROW`` gets only negative z (its max is
its true negative maximum), receiver 7 takes 200 copies of the pair 5 -> 7
(a hub spanning several 64-slot tiles, whose equal z tie in the max), and
tile 1 is marked dead (it reads column block 0, as the TPU kernel does).

Tolerances: float32 max |port - jax| <= 1e-5 * max(1, max |jax|); bfloat16
within 1e-2 of each row's largest |jax|; gradients 1e-4 * max(1, max
|jax|); counts exact."""
import dataclasses

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
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.data.datasets import synthetic_coo  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.ops import pairagg as JP  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch as T  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import graph as TG  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import fusion as TF  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import schedule as TS  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import pairagg as TP  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import fixtures  # noqa: E402

CPU = "cpu"     # the port's entry points default to the CUDA card
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
GRAD_TOL = 1e-4
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TILE = dict(block_rows=128, block_cols=128, tile_edges=64)
NEG_ROW = fixtures.NEG_ROW
EMPTY_ROWS = slice(512, 599)
HUB = fixtures.HOT_PAIR[1]
# the models' graph and widths, a small Reddit-like community graph
N, E, F_IN, HIDDEN, N_CLASS = 600, 5000, 24, 32, 5
CASES = [("DGN", False), ("PNA", False), ("PNA", True)]


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(port, ref, tol=TOL["float32"]):
    port, ref = _np(port), _np(ref)
    assert port.shape == ref.shape
    bound = tol * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(port - ref).max())
    assert err <= bound, (err, bound)


def _close_rows(port, ref, tol=TOL["bfloat16"]):
    """Each row within ``tol`` of its largest |ref|."""
    port, ref = _np(port), _np(ref)
    assert port.shape == ref.shape
    scale = np.maximum(np.abs(ref).max(axis=1), 1e-6)
    worst = float((np.abs(port - ref).max(axis=1) / scale).max())
    assert worst <= tol, worst


def _tilings(dead: bool = True):
    """(jax tiling, port tiling, jax host graph, port host graph) of the
    edge-case graph; with ``dead`` tile 1 is marked dead in both."""
    s, r, n, _ = fixtures.edge_case_graph()
    hj = J.build_host_graph(s, r, n, edge_pad_multiple=128)
    ht = TG.build_host_graph(s, r, n, edge_pad_multiple=128)
    tj = JG.tile_graph(hj, unit_weight=True, **TILE)
    tt = TG.tile_graph(ht, unit_weight=True, **TILE, device=CPU)
    if dead:
        tt = fixtures._dead_tile(tt)
        tj = dataclasses.replace(tj, tile_cb=jnp.asarray(tt.tile_cb.numpy()))
    return tj, tt, hj, ht


def _operands(n, D, seed):
    """u, v [n, D] float32 with row NEG_ROW of v pushed far below 0, so
    every z of that receiver is negative."""
    rng = np.random.default_rng(seed)
    u, v = (rng.standard_normal((n, D)).astype(np.float32) for _ in range(2))
    v[NEG_ROW] = -50.0 - np.abs(v[NEG_ROW])
    return u, v


def test_fixture_has_its_edge_cases():
    """The rows the other tests rely on are there: empty rows, the hub's
    slots in more than one tile (duplicates of one pair), an all-negative
    receiver with edges, and a dead tile whose slots look live."""
    _, tt, _, ht = _tilings()
    row = (tt.tile_rb.long()[:, None] * tt.block_rows
           + tt.dst_local.long())
    live = tt.dst_local < tt.block_rows
    hub_tiles = int(((row == HUB) & live).any(1).sum())
    assert hub_tiles >= 3, hub_tiles
    rec = ht.receivers[: ht.n_edge]
    assert int((rec == NEG_ROW).sum()) > 0
    assert not np.isin(np.arange(512, 599), rec).any()
    assert int(tt.tile_cb[1]) == -1 and bool(live[1].any())


@pytest.mark.parametrize("dtn", ["float32", "bfloat16"])
@pytest.mark.parametrize("want_max", [True, False])
@pytest.mark.parametrize("sf", [None, "leaky_relu"])
def test_pair_aggregate_raw_matches_jax(sf, want_max, dtn):
    """Sum, max and count against the TPU kernel in interpret mode; empty
    rows report max 0, the all-negative row its negative maximum, and
    ``want_max=False`` returns no max."""
    tj, tt, hj, _ = _tilings()
    tdt, jdt = DTYPES[dtn]
    u, v = _operands(hj.n_node, 41, seed=3 if sf else 4)
    ys_j, ym_j, c_j = JP.pair_aggregate_raw(
        tj, jnp.asarray(u, jdt), jnp.asarray(v, jdt), sf=sf,
        want_max=want_max, interpret=True)
    ys, ym, cnt = TP.pair_aggregate_raw(
        tt, torch.tensor(u, dtype=tdt), torch.tensor(v, dtype=tdt), sf=sf,
        want_max=want_max)
    assert ys.dtype == cnt.dtype == torch.float32
    assert tuple(cnt.shape) == (hj.n_node, 1)
    np.testing.assert_array_equal(_np(cnt), _np(c_j))
    close = _close if dtn == "float32" else _close_rows
    close(ys, ys_j)
    if not want_max:
        assert ym is None
        return
    close(ym, ym_j)
    assert float(ym[EMPTY_ROWS].abs().max()) == 0.0
    assert float(ym[NEG_ROW].max()) < 0.0
    assert int(cnt[NEG_ROW, 0]) > 0


@pytest.mark.parametrize("dtn", ["float32", "bfloat16"])
def test_pair_agg_rounds_terms_to_u_dtype(dtn):
    """The sum adds each z rounded to u's dtype, and the max is of the
    rounded z, as the TPU kernel's; v takes u's dtype first.  Checked on
    the hub row, whose 200 equal z are one value rounded once."""
    _, tt, hj, _ = _tilings(dead=False)
    tdt, _ = DTYPES[dtn]
    u, v = _operands(hj.n_node, 8, seed=5)
    ut = torch.tensor(u, dtype=tdt)
    vt = torch.tensor(v)        # float32: cast to u's dtype
    ys, ym, cnt = TP.pair_aggregate_raw(tt, ut, vt)
    s, r = fixtures.HOT_PAIR
    z = (ut[s].float() + vt.to(tdt)[r].float()).to(tdt).float()
    hub_rows = (torch.tensor(hj.receivers[: hj.n_edge]) == HUB)
    others = torch.tensor(hj.senders[: hj.n_edge])[hub_rows]
    zs = (ut[others.long()].float() + vt.to(tdt)[HUB].float()).to(
        tdt).float()
    assert int(cnt[HUB, 0]) == int(hub_rows.sum())
    _close(ys[HUB], zs.sum(0))
    assert torch.equal(ym[HUB], zs.amax(0))
    assert bool((zs == z).all(1).sum() >= fixtures.HOT_COPIES)


@pytest.mark.parametrize("want_max", [True, False])
@pytest.mark.parametrize("sf", [None, "leaky_relu"])
def test_pair_aggregate_grads_match_jax(sf, want_max):
    """Gradients in u and v against ``jax.grad`` of the JAX custom VJP.
    The hub's 200 copies of one pair give equal z: a tie in the max, whose
    gradient JAX's ``segment_max`` splits evenly over the tied slots."""
    tj, tt, hj, _ = _tilings(dead=False)
    n, D = hj.n_node, 16
    u, v = _operands(n, D, seed=7)
    rng = np.random.default_rng(8)
    gs, gm = (rng.standard_normal((n, D)).astype(np.float32)
              for _ in range(2))

    def j_loss(a, b):
        ys, ym, _ = JP.pair_aggregate(tj, a, b, sf=sf, want_max=want_max,
                                      interpret=True)
        out = jnp.vdot(ys, jnp.asarray(gs))
        return out + jnp.vdot(ym, jnp.asarray(gm)) if want_max else out

    want = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(u), jnp.asarray(v))
    a, b = (torch.tensor(x, requires_grad=True) for x in (u, v))
    ys, ym, cnt = TP.pair_aggregate(tt, a, b, sf=sf, want_max=want_max)
    assert not cnt.requires_grad
    loss = (ys * torch.tensor(gs)).sum()
    if want_max:
        loss = loss + (ym * torch.tensor(gm)).sum()
    loss.backward()
    _close(a.grad, want[0], GRAD_TOL)
    _close(b.grad, want[1], GRAD_TOL)


@pytest.mark.parametrize("net,reorder", CASES)
def test_pair_agg_partition_matches_jax(net, reorder):
    """One block holding the pair chain and its gathers, everything else
    alone, exactly as the JAX package partitions; the block classifies as
    ``pair_agg`` in both packages."""
    gj = J.build_op_graph(net, 16, 8, reorder=reorder)
    gt = T.build_op_graph(net, 16, 8, reorder=reorder)
    pj, pt = JS.pair_agg_partition(gj), TS.pair_agg_partition(gt)
    assert pt is not None and pt == pj
    tc = TS.TileConfig(128, 128, 64)
    kinds = [TF.classify_block(gt, b, tc)[0] for b in pt]
    assert kinds == [JF.classify_block(gj, b, JS.TileConfig(128, 128, 64))[0]
                     for b in pj]
    assert kinds.count("pair_agg") == 1
    assert TS.pair_agg_partition(T.build_op_graph("GCN", 16, 8)) is None
    with pytest.raises(ValueError, match="pair-sum"):
        TF.pair_agg_schedules([T.build_op_graph("GCN", 16, 8)])


@pytest.fixture(scope="module")
def graphs():
    s, r, labels = synthetic_coo(N, E, seed=1, communities=6, p_in=0.8)
    hj = J.build_host_graph(s, r, N, add_self_loops=True)
    hj, _ = J.reorder_nodes(hj, "hubs+labels", labels=labels)
    ht = T.build_host_graph(s, r, N, add_self_loops=True)
    ht, _ = T.reorder_nodes(ht, "hubs+labels", labels=labels)
    return hj, ht


def _schedule(mod, fusion, graph):
    """The pair-agg block on a 128-wide tiling, the rest op by op."""
    part = mod.pair_agg_partition(graph)
    tc = mod.TileConfig(128, 128, 64)
    return mod.Schedule(blocks=part, tiles=tuple(
        tc if fusion.classify_block(graph, b, tc)[0] == "pair_agg"
        else mod.TileConfig(path=mod.PATH_XLA) for b in part))


@pytest.mark.parametrize("net,reorder", CASES)
def test_lower_schedule_pair_agg_kind_matches_jax(graphs, net, reorder):
    """One layer on the ``pair_agg`` kind against JAX's lowering: the
    forward in float32 and bfloat16, every parameter's float32 gradient
    against ``jax.grad``, and the per-op path of the port."""
    hj, ht = graphs
    gj = J.build_op_graph(net, 12, 8, reorder=reorder)
    gt = T.build_op_graph(net, 12, 8, reorder=reorder)
    sj, st = _schedule(JS, JF, gj), _schedule(TS, TF, gt)
    assert sj.key() == st.key()
    assert TF.pair_agg_schedules([gt], tile=TS.TileConfig(128, 128, 64)) \
        == [st]
    pj = J.init_params(gj, jax.random.key(2))
    pt = {k: torch.tensor(np.asarray(v), requires_grad=True)
          for k, v in pj.items()}
    x = np.random.default_rng(3).standard_normal((N, 12)).astype(np.float32)
    fj = JF.lower_schedule(gj, sj, hj, interpret=True)
    fn = TF.lower_schedule(gt, st, ht, device=CPU)
    assert [k for k, _, _, _ in fn.plans].count("pair_agg") == 1
    out = fn(pt, ht.to_device(CPU), torch.tensor(x))
    _close(out, fj(pj, hj.to_device(), jnp.asarray(x)))
    _close(out, T.lower(gt)(pt, ht.to_device(CPU), torch.tensor(x)), 1e-4)
    want = jax.grad(lambda p: jnp.sum(fj(p, hj.to_device(),
                                         jnp.asarray(x)) ** 2))(pj)
    (out ** 2).sum().backward()
    for k, p in pt.items():
        _close(p.grad, want[k], GRAD_TOL)
    ob = TF.lower_schedule(gt, st, ht, torch.bfloat16, device=CPU)(
        pt, ht.to_device(CPU), torch.tensor(x))
    wb = JF.lower_schedule(gj, sj, hj, jnp.bfloat16, interpret=True)(
        pj, hj.to_device(), jnp.asarray(x))
    _close(ob, wb, TOL["bfloat16"])


@pytest.mark.parametrize("dtn", ["float32", "bfloat16"])
@pytest.mark.parametrize("net,reorder", CASES)
def test_two_layer_models_match_jax(graphs, net, reorder, dtn):
    """DGN-2l and PNA-2l (both variants) served through
    ``make_apply(schedules=...)`` with the JAX weights carried over by
    ``params_from_numpy`` (every ``dgn_l*`` / ``pna_l*`` name), against
    the JAX model on the same schedules."""
    hj, ht = graphs
    kw = dict(hidden=HIDDEN, n_layers=2, reorder=reorder)
    jm = J.build_model(net, F_IN, N_CLASS, **kw)
    tm = T.build_model(net, F_IN, N_CLASS, **kw, device=CPU)
    pj = jm.init(jax.random.key(0))
    pt = T.params_from_numpy({k: np.asarray(v) for k, v in pj.items()}, CPU)
    assert set(pt) == set(tm.params) and any(
        k.startswith(net.lower() + "_l1") for k in pt)
    tm.load_params(pt)
    for k, v in pj.items():
        assert torch.equal(tm.params[k].detach(), torch.tensor(np.asarray(v)))
    sj = [_schedule(JS, JF, g) for g in jm.layers]
    st = [_schedule(TS, TF, g) for g in tm.layers]
    assert [a.key() for a in sj] == [b.key() for b in st]
    tdt, jdt = DTYPES[dtn]
    cdt = None if dtn == "float32" else tdt
    cjdt = None if dtn == "float32" else jdt
    x = np.random.default_rng(4).standard_normal((N, F_IN)).astype(
        np.float32)
    fwd = tm.make_apply(cdt, schedules=st, host_graph=ht, device=CPU)
    for fn in fwd.layer_fns:
        assert [k for k, _, _, _ in fn.plans].count("pair_agg") == 1
    TP.pair_agg.launches = 0
    yt = fwd(dict(tm.params), ht.to_device(CPU), torch.from_numpy(x))
    assert TP.pair_agg.launches == 0      # CPU tensors: the plain version
    yj = jm.make_apply(cjdt, schedules=sj, host_graph=hj)(
        pj, hj.to_device(), jnp.asarray(x))
    assert yt.shape == (N, N_CLASS) and bool(torch.isfinite(yt).all())
    _close(yt, yj, TOL[dtn])
