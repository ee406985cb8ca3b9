"""PyTorch port: block-diagonal batching (``data/batching.py``,
``graph.batch_host_graph`` / ``pad_batch_features``) against the JAX
package.  Builders must give EQUAL arrays; the batched SpMM (K1's plain
version) and the mean readout are held to JAX's within 1e-5 * max(1,
max |jax|) in float32."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu as J  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu import graph as JG  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.data import batching as JB  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.ops import spmm as JS  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch as T  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import graph as TG  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.data import batching as TB  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import spmm as TS  # noqa: E402

CPU = "cpu"     # the port's entry points default to the CUDA card


def _close(port, ref, tol=1e-5):
    port = port.detach().cpu().numpy()
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape
    bound = tol * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(port - ref).max())
    assert err <= bound, (err, bound)


def _assert_host_equal(a, b):
    for k in ("senders", "receivers", "edge_mask", "edge_weight"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)
    assert (a.n_node, a.n_edge) == (b.n_node, b.n_edge)


def _graphs(pkg, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(3):
        n, e = 40 + 8 * i, 150 + 30 * i
        s = rng.integers(0, n, e).astype(np.int32)
        r = rng.integers(0, n, e).astype(np.int32)
        out.append(pkg.build_host_graph(s, r, n, symmetric_norm=True,
                                        edge_pad_multiple=128))
    return out


def test_batch_graphs_and_features_match_jax():
    gj, gt = _graphs(J), _graphs(T)
    bj, idj = JB.batch_graphs(gj, edge_pad_multiple=128)
    bt, idt = TB.batch_graphs(gt, edge_pad_multiple=128)
    _assert_host_equal(bj, bt)
    assert idt.dtype == idj.dtype
    np.testing.assert_array_equal(idt, idj)
    rng = np.random.default_rng(1)
    xs = [rng.standard_normal((g.n_node, 8)).astype(np.float32) for g in gt]
    np.testing.assert_array_equal(TB.batch_features(xs),
                                  JB.batch_features(xs))


def test_batched_spmm_matches_per_graph():
    """One tiling of the batch serves every graph: each graph's rows equal
    JAX's SpMM over that graph alone."""
    gt, gj = _graphs(T), _graphs(J)
    rng = np.random.default_rng(2)
    xs = [rng.standard_normal((g.n_node, 24)).astype(np.float32) for g in gt]
    bat, _ = TB.batch_graphs(gt, edge_pad_multiple=128)
    tg = TG.tile_graph(bat, block_rows=32, block_cols=32, tile_edges=64,
                       device=CPU)
    yb = TS.spmm(tg, torch.tensor(TB.batch_features(xs)))
    off = 0
    for g, x in zip(gj, xs):
        t1 = JG.tile_graph(g, block_rows=32, block_cols=32, tile_edges=64)
        _close(yb[off:off + g.n_node],
               JS.spmm(t1, jnp.asarray(x), interpret=True))
        off += g.n_node


@pytest.mark.parametrize("n_graphs", [2, 4])
def test_readout_mean_matches_jax(n_graphs):
    """Two segment sums on the caller's device; a graph without nodes reads
    0, as JAX's does."""
    gt = _graphs(T)[:2]
    bat, gid = TB.batch_graphs(gt, edge_pad_multiple=128)
    h = np.random.default_rng(3).standard_normal(
        (bat.n_node, 8)).astype(np.float32)
    out = TB.readout_mean(torch.tensor(h), torch.tensor(gid), n_graphs)
    _close(out, JB.readout_mean(jnp.asarray(h), jnp.asarray(gid), n_graphs))
    _close(out[0], h[: gt[0].n_node].mean(0))


@pytest.mark.parametrize("stride", [None, 64])
def test_batch_host_graph_and_features_match_jax(stride):
    gj, gt = _graphs(J)[0], _graphs(T)[0]
    bj = JG.batch_host_graph(gj, 4, copy_stride=stride)
    bt = TG.batch_host_graph(gt, 4, copy_stride=stride)
    _assert_host_equal(bj, bt)
    assert bt.n_node == 4 * (stride or 1024)
    x = np.random.default_rng(4).standard_normal((4, gt.n_node, 8)).astype(
        np.float32)
    np.testing.assert_array_equal(
        TG.pad_batch_features(x, 4, gt.n_node, stride),
        JG.pad_batch_features(x, 4, gj.n_node, stride))
