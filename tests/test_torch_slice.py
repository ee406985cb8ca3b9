"""PyTorch port, the slice end to end: GCN-2l (transform-first) and GAT-2l
(4 heads) serving forward on the hybrid path through
``Model.make_apply(schedules=...)``, against the JAX package with the same
weights (``params_from_numpy``), on a small community graph reordered
hubs+labels as the Reddit recipe does.  Also the per-op ``lower()`` path of
all seven families, the schedule partitions, and the CLI.

Tolerance in float32: max |port - jax| <= 1e-5 * max(1, max |jax|)."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu as J  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler import fusion as JF  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler import schedule as JS  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.data.datasets import synthetic_coo  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch as T  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import cli as TCLI  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import graph as TG  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import fusion as TF  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import schedule as TS  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import dense as TDn  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import gat as TA  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import spmm as TSp  # noqa: E402

N, E, F_IN, HIDDEN, N_CLASS = 600, 5000, 24, 32, 5
CPU = "cpu"     # the port's entry points default to the CUDA card
# the slice's geometry shrunk to this graph: tail tiles and dense grid 128
SPMM_TILE = dict(block_rows=128, block_cols=128, tile_edges=128,
                 dense_block=128)
GAT_TILE = dict(block_rows=128, block_cols=256, tile_edges=128,
                dense_block=128)


def _close(port, ref, tol=1e-5):
    port = port.detach().float().cpu().numpy()
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape
    bound = tol * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(port - ref).max())
    assert err <= bound, (err, bound)


@pytest.fixture(scope="module")
def graphs():
    s, r, labels = synthetic_coo(N, E, seed=1, communities=6, p_in=0.8)
    hj = J.build_host_graph(s, r, N, add_self_loops=True, symmetric_norm=True)
    hj, _ = J.reorder_nodes(hj, "hubs+labels", labels=labels)
    ht = T.build_host_graph(s, r, N, add_self_loops=True, symmetric_norm=True)
    ht, _ = T.reorder_nodes(ht, "hubs+labels", labels=labels)
    return hj, ht


def _jax_schedules(model):
    """The JAX package's own recipe (scripts/reddit_train.py:70-101)."""
    out = []
    for g in model.layers:
        if "GCN" in g.name:
            part = JS.aggregation_partition(g)
            tc = JS.TileConfig(path=JS.PATH_HYBRID, **SPMM_TILE)
            want = "spmm_hybrid"
        else:
            part = JS.pattern_partition(g)
            tc = JS.TileConfig(path=JS.PATH_HYBRID, **GAT_TILE)
            want = "gat_hybrid"
        tiles = tuple(tc if JF.classify_block(g, b, tc)[0] == want
                      else JS.TileConfig(path=JS.PATH_XLA) for b in part)
        out.append(JS.Schedule(blocks=part, tiles=tiles))
    return out


def _models(net):
    kw = dict(hidden=HIDDEN, n_layers=2, reorder=(net == "GCN"), heads=4)
    jm = J.build_model(net, F_IN, N_CLASS, **kw)
    tm = T.build_model(net, F_IN, N_CLASS, **kw, device=CPU)
    pj = jm.init(jax.random.key(0))
    pt = T.params_from_numpy({k: np.asarray(v) for k, v in pj.items()}, CPU)
    tm.load_params(pt)
    return jm, tm, pj, pt


@pytest.mark.parametrize("net", ["GCN", "GAT"])
def test_slice_forward_matches_jax(graphs, net):
    hj, ht = graphs
    jm, tm, pj, pt = _models(net)
    sj = _jax_schedules(jm)
    st = TF.hybrid_schedules(
        tm.layers,
        spmm_tile=TS.TileConfig(path=TS.PATH_HYBRID, **SPMM_TILE),
        gat_tile=TS.TileConfig(path=TS.PATH_HYBRID, **GAT_TILE))
    assert [a.key() for a in sj] == [b.key() for b in st]
    x = np.random.default_rng(0).standard_normal((N, F_IN)).astype(
        np.float32)
    fwd = tm.make_apply(schedules=st, host_graph=ht, device=CPU)
    want = "spmm_hybrid" if net == "GCN" else "gat_hybrid"
    for fn in fwd.layer_fns:
        hyb = [d for k, _, d, _ in fn.plans if k == want]
        assert len(hyb) == 1 and hyb[0].dense is not None
        assert hyb[0].n_dense_edges > 0 and hyb[0].n_sparse_edges > 0
    for f in (TSp.spmm_tiles, TDn.spmm_dense_blocks, TA.gat_tiles,
              TDn.gat_dense_blocks):
        f.launches = 0
    yt = fwd(pt, ht.to_device(CPU), torch.from_numpy(x))
    yj = jm.make_apply(schedules=sj, host_graph=hj)(
        pj, hj.to_device(), jnp.asarray(x))
    assert yt.shape == (N, N_CLASS) and bool(torch.isfinite(yt).all())
    _close(yt, yj)
    # CPU tensors take the plain versions: nothing was launched
    assert TSp.spmm_tiles.launches == TDn.gat_dense_blocks.launches == 0
    # the per-op oracle of both packages agrees with the kernel path
    y0t = tm(ht.to_device(CPU), torch.from_numpy(x))
    y0j = jm.make_apply()(pj, hj.to_device(), jnp.asarray(x))
    _close(y0t, y0j)
    _close(yt, np.asarray(y0j), tol=1e-4)


@pytest.mark.parametrize("net", ["GCN", "GAT"])
def test_slice_bf16_close_to_jax(graphs, net):
    """bf16 compute: both packages round the kernel inputs and the same
    products to bf16.  Bound 1e-2 relative: where a library's exp or sum
    order lands a value on the other side of a bf16 rounding boundary, the
    flip (2^-8 of that value) propagates through the second layer."""
    hj, ht = graphs
    jm, tm, pj, pt = _models(net)
    st = TF.hybrid_schedules(
        tm.layers,
        spmm_tile=TS.TileConfig(path=TS.PATH_HYBRID, **SPMM_TILE),
        gat_tile=TS.TileConfig(path=TS.PATH_HYBRID, **GAT_TILE))
    x = np.random.default_rng(1).standard_normal((N, F_IN)).astype(
        np.float32)
    yt = tm.make_apply(torch.bfloat16, schedules=st, host_graph=ht,
                       device=CPU)(
        pt, ht.to_device(CPU), torch.from_numpy(x))
    yj = jm.make_apply(jnp.bfloat16, schedules=_jax_schedules(jm),
                       host_graph=hj)(pj, hj.to_device(), jnp.asarray(x))
    _close(yt, yj, tol=1e-2)


@pytest.mark.parametrize("network", ["GCN", "GAT", "SGC", "GraphSAGE", "GIN",
                                     "DGN", "PNA"])
@pytest.mark.parametrize("reorder", [False, True])
def test_per_op_lower_matches_jax(graphs, network, reorder):
    hj, ht = graphs
    gj = J.build_op_graph(network, 12, 8, heads=2, reorder=reorder)
    gt = T.build_op_graph(network, 12, 8, heads=2, reorder=reorder)
    pj = J.init_params(gj, jax.random.key(1))
    pt = T.params_from_numpy({k: np.asarray(v) for k, v in pj.items()}, CPU)
    x = np.random.default_rng(2).standard_normal((N, 12)).astype(np.float32)
    yj = J.lower(gj)(pj, hj.to_device(), jnp.asarray(x))
    yt = T.lower(gt)(pt, ht.to_device(CPU), torch.from_numpy(x))
    _close(yt, yj)


@pytest.mark.parametrize("network", ["GCN", "GAT", "SGC", "GraphSAGE", "GIN",
                                     "DGN", "PNA"])
def test_partitions_and_classification_match_jax(network):
    for reorder in (False, True):
        gj = J.build_op_graph(network, 16, 8, heads=2, reorder=reorder)
        gt = T.build_op_graph(network, 16, 8, heads=2, reorder=reorder)
        for fn in ("singleton_partition", "aggregation_partition",
                   "pattern_partition", "max_fusion_partition",
                   "pair_agg_partition"):
            pa, pb = getattr(JS, fn)(gj), getattr(TS, fn)(gt)
            assert pa == pb, fn
        assert JS.default_schedule(gj).key() == TS.default_schedule(gt).key()
        for path in TS.PATHS:
            tj = JS.TileConfig(path=path)
            tt = TS.TileConfig(path=path)
            for b in TS.default_schedule(gt).blocks:
                kj, _ = JF.classify_block(gj, b, tj)
                kt, _ = TF.classify_block(gt, b, tt)
                assert kj == kt, (path, b)


def test_unported_kinds_raise(graphs):
    """``make_train_step`` refuses a ``pmean_axis`` that is not a process
    group (data-parallel training and label-propagation clustering are
    ported now); every lowering kind, densefull included, lowers, and a tail
    with tile classes builds."""
    _, ht = graphs
    g = T.build_op_graph("GCN", 8, 8)
    part = TS.aggregation_partition(g)
    sched = TS.Schedule(blocks=part, tiles=tuple(
        TS.TileConfig(path=TS.PATH_DENSEFULL) for _ in part))
    fn = TF.lower_schedule(g, sched, ht, device=CPU)
    assert "spmm_densefull" in [p[0] for p in fn.plans]
    assert TS.Schedule.from_key(sched.key()) == sched
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models import train as TT
    with pytest.raises(TypeError, match="process group"):
        TT.make_train_step(lambda p, g, x: x, pmean_axis="data")
    _, perm = TG.reorder_nodes(ht, "cluster")
    np.testing.assert_array_equal(np.sort(perm), np.arange(ht.n_node))
    hy = TG.hybrid_graph(ht, block_rows=64, block_cols=64, tile_edges=64,
                         min_nnz=8, tile_classes=(32, 64), device=CPU)
    assert isinstance(hy.tiles, TG.MultiTiledGraph)


def test_model_init_is_seeded_glorot():
    a = T.build_model("GAT", 10, 3, hidden=8, device=CPU,
                      generator=torch.Generator().manual_seed(4))
    b = T.build_model("GAT", 10, 3, hidden=8, device=CPU,
                      generator=torch.Generator().manual_seed(4))
    for k, v in a.params.items():
        assert torch.equal(v, b.params[k])
        iw, ow = v.shape
        assert float(v.abs().max()) <= (6.0 / (iw + ow)) ** 0.5
    assert set(a.params) == {n for g in a.layers
                             for n, _, _ in g.param_specs()}


def test_cli_run_on_cpu(tmp_path, capsys):
    spec = {"layers": [
        {"blocks": [list(b) for b in s.blocks],
         "tiles": [list(t.key()) for t in s.tiles]}
        for s in TF.hybrid_schedules(
            T.build_model("GCN", 32, 4, hidden=16, reorder=True,
                          device=CPU).layers,
            spmm_tile=TS.TileConfig(path=TS.PATH_HYBRID, **SPMM_TILE))]}
    path = tmp_path / "sched.json"
    path.write_text(json.dumps(spec))
    rc = TCLI.main(["run", "--dataset", "tiny", "--network", "GCN",
                    "--reorder", "--hidden", "16", "--f32", "--device", "cpu",
                    "--schedule", str(path), "--json"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["finite"] and out["out_shape"] == [200, 4]
    assert "latency_ms_median" not in out    # no device time from a CPU run
    # the compile-only pick: each layer's schedule from the latency model
    rc = TCLI.main(["run", "--dataset", "tiny", "--network", "GCN",
                    "--reorder", "--hidden", "16", "--f32", "--device", "cpu",
                    "--compiled", "--json"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["finite"] and out["out_shape"] == [200, 4]
    assert len(out["schedule"]) == 2 and out["modelled_us"] > 0
