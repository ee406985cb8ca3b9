"""PyTorch port, the int8-quantized exchanges (``parallel/qcomm.py``) on
the CPU, in one world of four gloo ranks.

Against the exact collectives and the JAX package's ``q8_all_to_all`` /
``q8_all_gather`` over four virtual devices: the quantized all-to-all
(values and its straight-through gradient), the quantized all-gather,
the quantized remote table of the 1-D and the 2 x 2 plans, and one
sharded GCN train step with ``quantize_halo``.

Bounds: JAX's ``tests/test_qcomm.py``: a quantized result within 1% of
max |exact| (+ 1e-6), the quantized all-to-all's gradient within 5%
relative (norm) of the exact one, the quantized step's loss within 5%
(+ 1e-3) of the exact step's.  Where the two packages compute the same
quantization (both exchanges, the 1-D table) the port equals JAX within
1e-5 * max(1, max |jax|).  The 2-D table quantizes once (JAX twice, on
both hops), so each row is held to half a quantization step of its own
max: max |err| <= max |row| / 254 (+ 1e-6)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import shard_map  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as JP  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu as J  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu import parallel as JPar  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.parallel import qcomm as JQ  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch as T  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.parallel import qcomm as TQ  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.parallel.launch import launch  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils.shard_cases import run_cases  # noqa: E402

CPU = "cpu"
D, H, F, K = 4, 4, 32, 6
TOL = 1e-5


def _close(port, ref, tol=TOL):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = float(np.abs(port - ref).max())
    assert err <= tol * max(1.0, float(np.abs(ref).max())), err


def _within_q8(quant, exact):
    err = float(np.abs(np.asarray(quant) - np.asarray(exact)).max())
    assert err <= 0.01 * float(np.abs(exact).max()) + 1e-6, err


def _inputs():
    rng = np.random.default_rng(0)
    a2a = rng.normal(size=(D * D, H, F)).astype(np.float32)
    gather = rng.normal(size=(D * K, F)).astype(np.float32)
    return a2a, gather


def _tiny():
    ds = T.load_dataset("tiny")
    model = T.build_model("GCN", ds.x.shape[1], ds.n_class, hidden=32,
                          n_layers=2, device=CPU,
                          generator=torch.Generator().manual_seed(0))
    params = {k: v.detach().numpy() for k, v in model.params.items()}
    return ds, model, params


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    a2a, gather = _inputs()
    ds, model, params = _tiny()
    x = ds.x.astype(np.float32)
    step = dict(kind="train_step", layers=model.layers, graph=ds.host_graph,
                params=params, x=x, y=ds.y, mask=ds.train_mask, steps=1)
    cases = [
        dict(name="a2a", kind="exchange", op="a2a",
             x=a2a.reshape(D * D * H, F)),
        dict(name="gather", kind="exchange", op="gather", x=gather),
        dict(name="table", kind="remote_table", graph=ds.host_graph, x=x),
        dict(name="table2d", kind="remote_table", graph=ds.host_graph, x=x,
             mesh2d=(2, 2)),
        dict(step, name="step"),
        dict(step, name="step/quantized", quantize=True),
    ]
    res = launch(run_cases, D, backend="gloo", args=(cases,), device=CPU,
                 threads=1, tmp_dir=str(tmp_path_factory.mktemp("world")))
    return res, dict(a2a=a2a, gather=gather, ds=ds, params=params, x=x)


def _mesh():
    return Mesh(np.array(jax.devices()[:D]), ("graph",))


def _jax_a2a(x, fn):
    return np.asarray(shard_map(fn, mesh=_mesh(), in_specs=JP("graph"),
                                out_specs=JP("graph"), check_vma=False)(x))


def test_q8_all_to_all_matches_jax_and_exact(world):
    res, inp = world
    x = inp["a2a"]
    exact = np.concatenate([r["a2a"]["exact"] for r in res])
    quant = np.concatenate([r["a2a"]["quant"] for r in res])
    _close(exact, _jax_a2a(x, lambda v: jax.lax.all_to_all(
        v, "graph", 0, 0)))
    _close(quant, _jax_a2a(x, lambda v: JQ.q8_all_to_all(v, "graph")))
    _within_q8(quant, exact)


def test_q8_all_to_all_gradient_is_straight_through(world):
    res, _ = world
    gq = np.concatenate([r["a2a"]["quant_grad"] for r in res])
    ge = np.concatenate([r["a2a"]["exact_grad"] for r in res])
    assert np.linalg.norm(gq) > 0
    assert np.linalg.norm(gq - ge) / np.linalg.norm(ge) < 0.05


def test_q8_all_gather_matches_jax_and_exact(world):
    res, inp = world
    x = inp["gather"]

    def run(fn):
        return np.asarray(shard_map(fn, mesh=_mesh(), in_specs=JP("graph"),
                                    out_specs=JP(None), check_vma=False)(x))

    for r in res:            # every rank holds the whole gather
        _close(r["gather"]["exact"].reshape(-1, F), x)
        _close(r["gather"]["quant"].reshape(-1, F), run(
            lambda v: JQ.q8_all_gather(v, "graph").reshape(-1, F)))
        _within_q8(r["gather"]["quant"], r["gather"]["exact"])


def test_quantized_remote_table_1d(world):
    """The 1-D table, exact against JAX's and quantized within the bound;
    quantized as JAX's (one quantization a hop in both packages)."""
    res, inp = world
    hg = J.load_dataset("tiny").host_graph
    part_h = JPar.partition_graph(hg, D)
    mesh = _mesh()
    xj = jnp.asarray(JPar.pad_nodes(inp["x"], part_h))

    def run(quant):
        def local(sh, xl):
            return JPar.remote_table(xl, sh, "graph", quantize=quant)
        return np.asarray(shard_map(
            local, mesh=mesh, in_specs=(JP("graph"), JP("graph", None)),
            out_specs=JP("graph"), check_vma=False)(
                JPar.shard_part(part_h, mesh), xj))

    rows = res[0]["table"]["exact"].shape[0]
    exact_j, quant_j = run(False), run(True)
    for d, r in enumerate(res):
        _close(r["table"]["exact"], exact_j[d * rows:(d + 1) * rows])
        _close(r["table"]["quant"], quant_j[d * rows:(d + 1) * rows])
        _within_q8(r["table"]["quant"], r["table"]["exact"])


def test_quantized_remote_table_2d_quantizes_once(world):
    """The 2 x 2 table: exact against JAX's remote_table_2d; quantized
    within half a quantization step of each row's max (one quantization
    on the two-hop inter-host path; JAX rounds twice)."""
    res, inp = world
    hg = J.load_dataset("tiny").host_graph
    part_h = JPar.partition_graph_2d(hg, 2, 2)
    axes = ("host", "chip")
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), axes)

    def local(sh, xl):
        return JPar.remote_table_2d(xl, sh, "host", "chip")

    exact_j = np.asarray(shard_map(
        local, mesh=mesh, in_specs=(JP(axes), JP(axes, None)),
        out_specs=JP(axes), check_vma=False)(
            JPar.shard_part(part_h, mesh, axis=axes),
            jnp.asarray(JPar.pad_nodes(inp["x"], part_h))))
    rows = res[0]["table2d"]["exact"].shape[0]
    for d, r in enumerate(res):
        exact, quant = r["table2d"]["exact"], r["table2d"]["quant"]
        _close(exact, exact_j[d * rows:(d + 1) * rows])
        bound = np.abs(exact).max(1) / 254.0 + 1e-6
        assert (np.abs(quant - exact).max(1) <= bound).all()
        _within_q8(quant, exact)


def test_quantized_halo_train_step(world):
    """One sharded GCN step: the exact loss equals JAX's sharded step's;
    the quantized loss is finite, equals JAX's quantized loss and lies
    within 5% of the exact one."""
    import optax
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.models.train import TrainState
    from jax.sharding import NamedSharding
    res, inp = world
    ds = J.load_dataset("tiny")
    model = J.build_model("GCN", ds.x.shape[1], ds.n_class, hidden=32,
                          n_layers=2)
    part_h = JPar.partition_graph(ds.host_graph, D)
    mesh = _mesh()
    part = JPar.shard_part(part_h, mesh)
    sh1 = NamedSharding(mesh, JP("graph"))
    sh2 = NamedSharding(mesh, JP("graph", None))
    x = jax.device_put(jnp.asarray(JPar.pad_nodes(ds.x, part_h)), sh2)
    y = jax.device_put(jnp.asarray(JPar.pad_nodes(ds.y, part_h)), sh1)
    m = jax.device_put(jnp.asarray(JPar.pad_nodes(ds.train_mask, part_h)),
                       sh1)
    tx = optax.adam(1e-2)
    jl = {}
    for quant in (False, True):
        # the step donates its state: fresh parameters for each
        params = {k: jnp.asarray(v) for k, v in inp["params"].items()}
        step = JPar.make_sharded_train_step(model.layers, mesh, tx,
                                            quantize_halo=quant)
        st = TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
        jl[quant] = float(step(st, part, x, y, m)[1])
    for r in res:
        exact = r["step"]["losses"][0]
        quant = r["step/quantized"]["losses"][0]
        _close([exact], [jl[False]])
        _close([quant], [jl[True]])
        assert np.isfinite(quant)
        assert abs(quant - exact) < 0.05 * abs(exact) + 1e-3


def test_quantize_rounds_as_jax():
    rng = np.random.default_rng(1)
    v = rng.normal(size=(64, 40)).astype(np.float32) * 3
    v[0] = 0.0
    qt, st = TQ._quantize(torch.from_numpy(v))
    qj, sj = JQ._quantize(jnp.asarray(v))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    _close(TQ._dequantize(qt, st, torch.float32).numpy(),
           np.asarray(JQ._dequantize(qj, sj, jnp.float32)))
