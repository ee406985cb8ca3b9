"""PyTorch port: the dense-adjacency oracle (``models/dense_oracle.py``).

Every family's op graph, lowered op by op by the port (float32, on the
CPU), must match the port's numpy oracle at the JAX package's
``tests/test_ir_models.py`` tolerances (1e-4), and the port's oracle must
equal the JAX package's on the same inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from gta_graph_tensor_acclelrator_for_general_gnn_tpu.models import dense_oracle as JO  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch as T  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler.lower import (  # noqa: E402
    init_params, lower)
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models import dense_oracle as O  # noqa: E402

from conftest import small_graph  # noqa: E402

CPU = "cpu"
N, F, OUT = 50, 24, 16
TOL = dict(rtol=1e-4, atol=1e-4)


def _setup(rng, network, reorder=False, symmetric_norm=False, **kw):
    senders, receivers = small_graph(rng, n=N, e=300)
    g = T.build_graph(senders, receivers, N, symmetric_norm=symmetric_norm,
                      edge_pad_multiple=64, device=CPU)
    graph_def = T.build_op_graph(network, F, OUT, reorder=reorder, **kw)
    params = init_params(graph_def, torch.Generator().manual_seed(0),
                         device=CPU)
    x = rng.normal(size=(N, F)).astype(np.float32)
    out = lower(graph_def)(params, g, torch.tensor(x)).numpy()
    s = g.senders[: g.n_edge].numpy()
    r = g.receivers[: g.n_edge].numpy()
    ew = g.edge_weight[: g.n_edge].numpy()
    A_w, A_cnt = O.dense_mats(s, r, ew, N)
    jw, jc = JO.dense_mats(s, r, ew, N)
    np.testing.assert_array_equal(A_w, jw)
    np.testing.assert_array_equal(A_cnt, jc)
    np_params = {k: v.double().numpy() for k, v in params.items()}
    return out, np_params, x.astype(np.float64), A_w, A_cnt


CASES = [
    ("GCN", dict(reorder=False, symmetric_norm=True), "gcn", "A_w",
     dict(reorder=False)),
    ("GCN", dict(reorder=True, symmetric_norm=True), "gcn", "A_w",
     dict(reorder=True)),
    ("SGC", dict(symmetric_norm=True), "sgc", "A_w", {}),
    ("GraphSAGE", {}, "graphsage", "A_cnt", {}),
    ("GIN", {}, "gin", "A_cnt", {}),
    ("GAT", dict(reorder=False, heads=4), "gat", "A_cnt", dict(heads=4)),
    ("GAT", dict(reorder=True, heads=4), "gat", "A_cnt", dict(heads=4)),
    ("DGN", {}, "dgn", "A_cnt", {}),
    ("PNA", dict(reorder=False), "pna", "A_cnt", {}),
    ("PNA", dict(reorder=True), "pna", "A_cnt", {}),
]


@pytest.mark.parametrize("network,setup,fn,mat,kw", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_zoo_matches_the_oracle(rng, network, setup, fn, mat, kw):
    out, p, x, A_w, A_cnt = _setup(rng, network, **setup)
    A = A_w if mat == "A_w" else A_cnt
    exp = getattr(O, fn)(p, x, A, **kw)
    np.testing.assert_allclose(out, exp, **TOL)
    np.testing.assert_array_equal(exp, getattr(JO, fn)(p, x, A, **kw))


def test_gat_variants_agree(rng):
    """The original and the transformed GAT are one computation."""
    out1, *_ = _setup(rng, "GAT", False, heads=4)
    out2, *_ = _setup(np.random.default_rng(0), "GAT", True, heads=4)
    np.testing.assert_allclose(out1, out2, **TOL)
