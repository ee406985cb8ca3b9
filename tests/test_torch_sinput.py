"""PyTorch port: the sparse-input first-layer product (``ops/sinput.py``),
``lower_schedule(x_host=...)``, ``make_apply(x_host=...)`` and
``train_node_classifier(sinput=True)`` against the JAX package.

The same seeded numpy inputs go through both packages; the JAX package's
kernels run in Pallas interpret mode, the port's wrappers take their plain
versions on the CPU.  Tolerance: max |port - jax| <= 1e-5 * max(1,
max |jax|) in float32, 2e-2 in bfloat16, 1e-4 for gradients; the feature
graph's arrays must be EQUAL."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu as J  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler import fusion as JF  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler import schedule as JSc  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.models import train as JT  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.ops import sinput as JSI  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch as T  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import fusion as TF  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import schedule as TSc  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models import train as TT  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import sinput as TSI  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import fixtures  # noqa: E402

CPU = "cpu"     # the port's entry points default to the CUDA card
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GRAD_TOL = 1e-4
FG = dict(block=32, tile_edges=64)
TILE = dict(block_rows=32, block_cols=32, tile_edges=64)


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


def _x(n=60, f=90, seed=0):
    """Sparse features with values: Zipf words (frequent ones fill dense
    blocks) times normal values."""
    x = fixtures.zipf_features(n, f, density=0.08, seed=seed)
    return x * np.random.default_rng(seed + 1).standard_normal(
        x.shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(60, 90), (120, 40)])
def test_feature_graph_matches_jax(shape):
    """Both bipartite splits equal JAX's, in the square space of
    max(N, F_in) nodes (more features than nodes, and fewer)."""
    x = _x(*shape)
    assert TSI.density(x) == JSI.density(x) < TSI.SPARSITY_THRESHOLD
    fj = JSI.feature_graph(x, **FG)
    ft = TSI.feature_graph(x, device=CPU, **FG)
    assert (ft.n_node, ft.n_feat, ft.nnz) == (fj.n_node, fj.n_feat, fj.nnz)
    assert ft.nnz == np.count_nonzero(x)
    for a, b in ((ft.fwd, fj.fwd), (ft.bwd, fj.bwd)):
        assert (a.dense is None) == (b.dense is None)
        assert a.dense is not None
        np.testing.assert_array_equal(_np(a.dense.values),
                                      _np(b.dense.values))
        for k in ("tile_rb", "tile_cb", "src_local", "dst_local", "edge_id",
                  "weight"):
            np.testing.assert_array_equal(_np(getattr(a.tiles, k)),
                                          _np(getattr(b.tiles, k)),
                                          err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(60, 90), (120, 40)])
def test_sparse_input_mm_matches_jax(dtype, shape):
    """X @ W over the baked nonzeros and its gradient in W against JAX's
    (and, in float32, against the dense product)."""
    x = _x(*shape)
    rng = np.random.default_rng(2)
    w = rng.standard_normal((shape[1], 16)).astype(np.float32)
    jdt, tdt = ((None, None) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    fj = JSI.feature_graph(x, **FG)
    ft = TSI.feature_graph(x, device=CPU, **FG)
    fn = lambda v: jnp.sum(JSI.sparse_input_mm(  # noqa: E731
        fj, v, compute_dtype=jdt, interpret=True) ** 2)
    vj, gj = jax.value_and_grad(fn)(jnp.asarray(w))
    wt = torch.tensor(w, requires_grad=True)
    y = TSI.sparse_input_mm(ft, wt, compute_dtype=tdt)
    assert y.dtype == torch.float32 and y.shape == (shape[0], 16)
    vt = (y ** 2).sum()
    vt.backward()
    _close(vt, vj, TOL[dtype])
    _close(wt.grad, gj, GRAD_TOL if dtype == "float32" else TOL[dtype])
    if dtype == "float32":
        _close(y, x @ w)


def _gcn_schedule(og):
    s = TSc.default_schedule(og)
    return TSc.Schedule(blocks=s.blocks, tiles=tuple(
        TSc.TileConfig(**TILE) for _ in s.blocks))


def test_lower_schedule_x_host_matches_jax():
    """lower_schedule(x_host=sparse X) runs the MM of X on the sparse-input
    product and matches JAX's lowering and the dense one; a dense X keeps
    the dense MM."""
    s, r, n, _ = fixtures.edge_case_graph(seed=0)
    kw = dict(symmetric_norm=True, edge_pad_multiple=128)
    hj, ht = J.build_host_graph(s, r, n, **kw), T.build_host_graph(s, r, n,
                                                                   **kw)
    xs = _x(n, 24)
    # the reordered GCN layer runs X @ W first (the plain one aggregates X)
    ogj = J.build_op_graph("GCN", 24, 8, reorder=True)
    ogt = T.build_op_graph("GCN", 24, 8, reorder=True)
    pj = J.init_params(ogj, jax.random.key(0))
    pt = T.params_from_numpy({k: np.asarray(v) for k, v in pj.items()}, CPU)
    st = _gcn_schedule(ogt)
    sj = JSc.Schedule.from_key(st.key())
    gj, gt = hj.to_device(), ht.to_device(CPU)
    want = JF.lower_schedule(ogj, sj, hj, interpret=True, x_host=xs)(
        pj, gj, jnp.asarray(xs))
    fwd = TF.lower_schedule(ogt, st, ht, device=CPU, x_host=xs)
    assert fwd.feature_graph is not None
    got = fwd(pt, gt, torch.tensor(xs))
    _close(got, want)
    _close(got, TF.lower_schedule(ogt, st, ht, device=CPU)(
        pt, gt, torch.tensor(xs)))
    dense = np.random.default_rng(3).standard_normal((n, 24)).astype(
        np.float32)
    assert TF.lower_schedule(ogt, st, ht, device=CPU,
                             x_host=dense).feature_graph is None


def test_make_apply_x_host_reaches_the_first_layer_only():
    ds = T.load_dataset("karate")
    m = T.build_model("GCN", ds.x.shape[1], ds.n_class, hidden=16,
                      reorder=True, device=CPU)
    sched = [_gcn_schedule(g) for g in m.layers]
    fwd = m.make_apply(schedules=sched, host_graph=ds.host_graph,
                       device=CPU, x_host=ds.x)
    assert [f.feature_graph is not None for f in fwd.layer_fns] == [True,
                                                                    False]
    g, x = ds.host_graph.to_device(CPU), torch.tensor(ds.x)
    _close(fwd(dict(m.params), g, x), m.make_apply()(dict(m.params), g, x))


@pytest.mark.parametrize("network", ["GCN", "GAT"])
def test_train_sinput_on_karate_matches_jax(network):
    """train_node_classifier(sinput=True) on the karate fixture (X 2.9%
    dense): the loss after 3 AdamW steps and the trained parameters
    against the JAX trainer's, from JAX's initial parameters.  Both models
    read X through an MM first (GCN reordered), so the sparse-input
    product runs."""
    ds = J.load_dataset("karate")
    dt = T.load_dataset("karate")
    assert TSI.density(dt.x) < 0.05
    kw = dict(hidden=16, n_layers=2, heads=2, reorder=network == "GCN")
    jm = J.build_model(network, ds.x.shape[1], ds.n_class, **kw)
    tm = T.build_model(network, ds.x.shape[1], ds.n_class, device=CPU, **kw)
    pj = jm.init(jax.random.key(0))
    tm.load_params(T.params_from_numpy({k: np.asarray(v)
                                        for k, v in pj.items()}, CPU))
    st = [_gcn_schedule(g) for g in tm.layers]
    sj = [JSc.Schedule.from_key(s.key()) for s in st]
    kw.pop("reorder")
    js, jr = JT.train_node_classifier(ds, network, epochs=3, model=jm,
                                      schedules=sj, sinput=True, **kw)
    fwd = tm.make_apply(schedules=st, host_graph=dt.host_graph, device=CPU,
                        x_host=dt.x)
    assert fwd.layer_fns[0].feature_graph is not None
    ts, tr = TT.train_node_classifier(dt, network, epochs=3, model=tm,
                                      schedules=st, sinput=True, device=CPU,
                                      **kw)
    _close(torch.tensor(tr.train_loss), jr.train_loss)
    for k, v in ts.params.items():
        _close(v, js.params[k])
    # and the dense first layer computes the same
    tm2 = T.build_model(network, ds.x.shape[1], ds.n_class, device=CPU,
                        reorder=network == "GCN", **kw)
    tm2.load_params(T.params_from_numpy({k: np.asarray(v)
                                         for k, v in pj.items()}, CPU))
    _, tr2 = TT.train_node_classifier(dt, network, epochs=3, model=tm2,
                                      schedules=st, sinput=False, device=CPU,
                                      **kw)
    _close(torch.tensor(tr2.train_loss), tr.train_loss)


def test_feature_graph_refuses_without_a_device_choice():
    """Like every entry point, the builder defaults to the CUDA card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TSI.feature_graph(_x())
