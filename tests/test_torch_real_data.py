"""PyTorch port: the real-graph fixtures (Zachary's karate club and the
handwritten-digits 8-NN graph) from the port's own ``data/fixtures/``.

The files equal the JAX package's byte for byte and load from the port's
path; ``load_dataset`` gives JAX's arrays; GCN trained as JAX's
tests/test_real_data.py:20-41 trains it (hidden 16 / 64, 120 epochs, lr
1e-2) reaches JAX's test-accuracy bars (0.9 / 0.93); GCN-2l and GAT-2l
forwards with JAX's parameters carried across equal JAX's per-op forward
within 1e-5 * max(1, max |jax|) in float32 (the port's per-op path), and
within 1e-4 on the hybrid schedules (the kernels' plain versions)."""
import filecmp
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu as J  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.data import datasets as JD  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch as T  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import fusion as TF  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.data import datasets as TD  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models.train import train_node_classifier  # noqa: E402

CPU = "cpu"
# name: (hidden width, JAX's test-accuracy bar)
FIXTURES = {"karate": (16, 0.9), "digits": (64, 0.93)}
PORT_PKG = "gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch"


def _close(port, ref, tol):
    port = port.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape
    bound = tol * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(port - ref).max())
    assert err <= bound, (err, bound)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_is_the_ports_own_copy(name):
    port_dir = os.path.realpath(TD.FIXTURES_DIR)
    assert os.path.basename(os.path.dirname(os.path.dirname(port_dir))) \
        == PORT_PKG
    jax_dir = os.path.join(os.path.dirname(os.path.realpath(JD.__file__)),
                           "fixtures")
    assert jax_dir != port_dir
    path = os.path.join(port_dir, f"{name}.npz")
    assert filecmp.cmp(path, os.path.join(jax_dir, f"{name}.npz"),
                       shallow=False)


def test_port_code_names_no_jax_path():
    """No source of the port names the JAX package's directory in code
    (the package docstring names it once, as its origin)."""
    root = os.path.dirname(os.path.realpath(T.__file__))
    jax_pkg = PORT_PKG[: -len("_torch")]
    for dirpath, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(dirpath, f)) as fh:
                for line in fh:
                    code = line.split("#")[0]
                    if f'"{jax_pkg}"' in code or f"'{jax_pkg}'" in code:
                        pytest.fail(f"{f}: {line.strip()}")


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_load_dataset_equals_jax(name):
    dj, dt = J.load_dataset(name), T.load_dataset(name)
    assert not dj.synthetic and not dt.synthetic
    assert dt.name == dj.name and dt.n_class == dj.n_class
    for k in ("x", "y", "train_mask", "val_mask", "test_mask"):
        a, b = getattr(dt, k), getattr(dj, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    gj, gt = vars(dj.host_graph), vars(dt.host_graph)
    assert gt.keys() == gj.keys()
    for k in gj:
        assert np.array_equal(np.asarray(gt[k]), np.asarray(gj[k])), k


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_gcn_reaches_jax_accuracy_bar(name):
    hidden, bar = FIXTURES[name]
    ds = T.load_dataset(name)
    _, res = train_node_classifier(ds, "GCN", hidden=hidden, epochs=120,
                                   lr=1e-2, device=CPU)
    assert res.test_acc >= bar, res
    assert res.train_loss < np.log(ds.n_class)


@pytest.mark.parametrize("net", ["GCN", "GAT"])
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_forward_with_jax_parameters(name, net):
    hidden, _ = FIXTURES[name]
    dj, dt = J.load_dataset(name), T.load_dataset(name)
    kw = dict(hidden=hidden, n_layers=2, reorder=net == "GCN", heads=4)
    jm = J.build_model(net, dj.x.shape[1], dj.n_class, **kw)
    tm = T.build_model(net, dt.x.shape[1], dt.n_class, **kw, device=CPU)
    pj = jm.init(jax.random.key(0))
    pt = T.params_from_numpy({k: np.asarray(v) for k, v in pj.items()}, CPU)
    yj = jm.make_apply()(pj, dj.host_graph.to_device(), jnp.asarray(dj.x))
    g = dt.host_graph.to_device(CPU)
    x = torch.from_numpy(dt.x)
    _close(tm.make_apply()(pt, g, x), yj, 1e-5)
    fwd = tm.make_apply(schedules=TF.hybrid_schedules(tm.layers),
                        host_graph=dt.host_graph, device=CPU)
    _close(fwd(pt, g, x), yj, 1e-4)


@pytest.mark.parametrize("net", ["GCN", "GAT"])
def test_shared_tile_cache(net):
    """``make_apply(tile_cache=)``: a second lowering of the same schedules
    on the same graph (another dtype) builds nothing new and takes the
    first one's splits and twins; its answers equal a fresh lowering's."""
    ds = T.load_dataset("digits")
    hg, g = ds.host_graph, ds.host_graph.to_device(CPU)
    x = torch.from_numpy(ds.x)
    tm = T.build_model(net, ds.x.shape[1], ds.n_class, hidden=64,
                       n_layers=2, reorder=net == "GCN", heads=4,
                       device=CPU)
    params = dict(tm.params)
    sched = TF.hybrid_schedules(tm.layers)
    cache = {}
    kw = dict(schedules=sched, host_graph=hg, device=CPU,
              build_transpose=True)
    first = tm.make_apply(torch.bfloat16, tile_cache=cache, **kw)
    sizes = {k: len(v) for k, v in cache.items() if isinstance(v, dict)}
    # a split and its twin a distinct layer key: GCN's two layers share
    # one, GAT's differ in heads
    assert sizes["hybrids"] == {"GCN": 2, "GAT": 4}[net]
    assert "transpose" in cache
    shared = tm.make_apply(None, tile_cache=cache, **kw)
    assert {k: len(v) for k, v in cache.items()
            if isinstance(v, dict)} == sizes
    for fa, fb in zip(first.layer_fns, shared.layer_fns):
        for pa, pb in zip(fa.plans, fb.plans):
            assert pa[2] is pb[2]
    fresh = tm.make_apply(None, **kw)
    with torch.no_grad():
        assert torch.equal(shared(params, g, x), fresh(params, g, x))
