"""PyTorch port, the per-op path in float32 against float64 on a sparse
bag-of-words input, beside the JAX package's per-op path.

GCN-2l (602 -> 128 -> 41, transform first, as the smoke's) on a seeded
community graph with self loops, symmetric norm and the hubs+labels
reorder; X a seeded 602-word Zipf bag of words at the smoke's sparse-input
density (``fixtures.zipf_features(..., density=0.0127, seed=12)``: 0.0114
after merging repeats); the reference is the same two layers in float64
numpy.  Both packages' float32 per-op answers sit the same distance from
it (sum-order noise of float32 sums), so the float32 gap the card shows
at the smoke's size is no fault of the port's per-op path.

Bounds: each package within 1e-5 of max |float64| (float32 sums of up
to a few thousand terms); the port's error at most 1.5 times JAX's plus
1e-7 (the two sum in different orders)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu as J  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.data.datasets import synthetic_coo  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.graph import reorder_nodes as j_reorder  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch as T  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils.fixtures import zipf_features  # noqa: E402

CPU = "cpu"
F_IN, HIDDEN, N_CLASS = 602, 128, 41


def _f64_reference(hg, X, params):
    """The two GCN layers (y = A (h W)) in float64 numpy."""
    s = hg.senders[: hg.n_edge]
    r = hg.receivers[: hg.n_edge]
    w = hg.edge_weight[: hg.n_edge].astype(np.float64)[:, None]
    h = X.astype(np.float64)
    for layer in range(2):
        h = h @ params[f"gcn_l{layer}_w"].astype(np.float64)
        out = np.zeros_like(h)
        np.add.at(out, r, w * h[s])
        h = out
    return h


@pytest.mark.parametrize("n,e,communities", [(3000, 60000, 20),
                                             (1200, 30000, 4)])
def test_per_op_float32_error_matches_jax(n, e, communities):
    s, r, labels = synthetic_coo(n, e, seed=1, communities=communities,
                                 p_in=0.7)
    kw = dict(add_self_loops=True, symmetric_norm=True)
    hj, _ = j_reorder(J.build_host_graph(s, r, n, **kw), "hubs+labels",
                      labels=labels)
    ht, _ = T.reorder_nodes(T.build_host_graph(s, r, n, **kw),
                            "hubs+labels", labels=labels)
    X = zipf_features(n, F_IN, density=0.0127, seed=12)
    assert 0.010 < float((X != 0).mean()) < 0.013
    jm = J.build_model("GCN", F_IN, N_CLASS, hidden=HIDDEN, n_layers=2,
                       reorder=True)
    params = {k: np.asarray(v) for k, v in jm.init(jax.random.key(0)).items()}
    yj = np.asarray(jm.make_apply()(
        {k: jnp.asarray(v) for k, v in params.items()}, hj.to_device(),
        jnp.asarray(X)))
    tm = T.build_model("GCN", F_IN, N_CLASS, hidden=HIDDEN, n_layers=2,
                       reorder=True, device=CPU)
    yt = tm.make_apply()(T.params_from_numpy(params, CPU),
                         ht.to_device(CPU), torch.from_numpy(X)).numpy()
    ref = _f64_reference(ht, X, params)
    scale = float(np.abs(ref).max())
    err_j = float(np.abs(yj - ref).max()) / scale
    err_t = float(np.abs(yt - ref).max()) / scale
    assert err_j <= 1e-5 and err_t <= 1e-5, (err_j, err_t)
    assert err_t <= 1.5 * err_j + 1e-7, (err_t, err_j)
