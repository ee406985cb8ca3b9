"""PyTorch port: host builders, schedules and IR against the JAX package.

The same numpy inputs go through both packages' builders; the arrays that
come out must be EQUAL (bfloat16 weights compare as float32: 0 and 1 are
exact in both)."""
import ast
import dataclasses
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import gta_graph_tensor_acclelrator_for_general_gnn_tpu as J  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu import graph as JG  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.data import datasets as JD  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch as T  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import graph as TG  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.data import datasets as TD  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import fixtures  # noqa: E402

PORT_DIR = pathlib.Path(T.__file__).parent
CPU = "cpu"     # the port's entry points default to the CUDA card


def _np(a):
    """numpy view of a JAX array or a torch tensor (bf16 -> f32)."""
    if isinstance(a, torch.Tensor):
        a = a.float() if a.dtype == torch.bfloat16 else a
        return a.cpu().numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _host_pair(symmetric_norm=True, self_loops=False, pad=128):
    s, r, n, _ = fixtures.edge_case_graph(seed=0)
    kw = dict(symmetric_norm=symmetric_norm, add_self_loops=self_loops,
              edge_pad_multiple=pad)
    return (J.build_host_graph(s, r, n, **kw),
            T.build_host_graph(s, r, n, **kw))


def _assert_host_equal(hj, ht):
    for k in ("senders", "receivers", "edge_mask", "edge_weight"):
        a, b = getattr(hj, k), getattr(ht, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert (hj.n_node, hj.n_edge) == (ht.n_node, ht.n_edge)


def _assert_tiles_equal(tj, tt):
    for k in ("tile_rb", "tile_cb", "src_local", "dst_local", "edge_id",
              "weight", "row_first_tile"):
        np.testing.assert_array_equal(_np(getattr(tj, k)),
                                      _np(getattr(tt, k)), err_msg=k)
    for k in ("block_rows", "block_cols", "tile_edges", "n_node",
              "n_row_blocks", "n_col_blocks"):
        assert getattr(tj, k) == getattr(tt, k), k
    assert tt.src_local.dtype == torch.int16
    assert tt.dst_local.dtype == torch.int16


@pytest.mark.parametrize("symmetric_norm,self_loops",
                         [(False, False), (True, False), (True, True)])
def test_build_host_graph_matches_jax(symmetric_norm, self_loops):
    hj, ht = _host_pair(symmetric_norm, self_loops)
    _assert_host_equal(hj, ht)
    g = ht.to_device(CPU)
    assert g.senders.dtype == torch.int64 and g.e_pad == hj.e_pad


@pytest.mark.parametrize("method", ["degree", "labels", "hubs+labels"])
def test_reorder_nodes_matches_jax(method):
    s, r, labels = JD.synthetic_coo(500, 4000, seed=3, communities=5)
    hj = J.build_host_graph(s, r, 500, add_self_loops=True,
                            symmetric_norm=True)
    ht = T.build_host_graph(s, r, 500, add_self_loops=True,
                            symmetric_norm=True)
    lab = None if method == "degree" else labels
    gj, pj = J.reorder_nodes(hj, method, labels=lab)
    gt, pt = T.reorder_nodes(ht, method, labels=lab)
    np.testing.assert_array_equal(pj, pt)
    _assert_host_equal(gj, gt)


@pytest.mark.parametrize("unit_weight", [False, True])
def test_tile_graph_matches_jax(unit_weight):
    hj, ht = _host_pair()
    tj = J.tile_graph(hj, block_rows=128, block_cols=128, tile_edges=128,
                      unit_weight=unit_weight)
    tt = T.tile_graph(ht, block_rows=128, block_cols=128, tile_edges=128,
                      unit_weight=unit_weight, device=CPU)
    _assert_tiles_equal(tj, tt)
    assert tt.weight.dtype == (torch.bfloat16 if unit_weight
                               else torch.float32)


def test_block_nnz_and_scales_match_jax():
    hj, ht = _host_pair()
    np.testing.assert_array_equal(JG.block_nnz(hj, 128, 256),
                                  TG.block_nnz(ht, 128, 256))
    sj, st = JG.separable_weight_scales(hj), TG.separable_weight_scales(ht)
    for a, b in zip(sj, st):
        np.testing.assert_array_equal(a, b)
    hj2, ht2 = _host_pair(symmetric_norm=False)
    assert JG.separable_weight_scales(
        dataclasses.replace(hj2, edge_weight=hj2.edge_weight * 2)) is None
    assert TG.separable_weight_scales(
        dataclasses.replace(ht2, edge_weight=ht2.edge_weight * 2)) is None


@pytest.mark.parametrize("case", ["rc_int8_sg16_weighted", "cr_int8_unit",
                                  "rc_f32_weighted"])
def test_hybrid_graph_matches_jax(case):
    hj, ht = _host_pair()
    kw = dict(block_rows=128, block_cols=128, tile_edges=128, min_nnz=64,
              sparse_block_rows=256, sparse_block_cols=128)
    if case == "rc_int8_sg16_weighted":
        kw.update(values_dtype=np.int8, supergroup=16)
    elif case == "cr_int8_unit":
        kw.update(values_dtype=np.int8, unit_weight=True, block_layout="cr")
    yj = JG.hybrid_graph(hj, **kw)
    yt = TG.hybrid_graph(ht, **kw, device=CPU)
    assert (yj.n_dense_edges, yj.n_sparse_edges) == (yt.n_dense_edges,
                                                     yt.n_sparse_edges)
    assert yt.n_dense_edges > 0 and yt.n_sparse_edges > 0
    for k in ("blk_rb", "blk_cb", "values", "row_mask"):
        a, b = _np(getattr(yj.dense, k)), _np(getattr(yt.dense, k))
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    _assert_tiles_equal(yj.tiles, yt.tiles)
    if "int8" in case:
        # the 200-copy pair: 127 in the dense count, the rest merged into
        # one tail slot that carries the excess
        assert int(yt.dense.values.max()) == 127
        assert float(yt.tiles.weight.float().max()) >= 73 * (
            1.0 if case == "cr_int8_unit" else float(hj.edge_weight.min()))
    # segments: runs of at most DENSE_SEGMENT blocks of one row block that
    # cover every block once
    bg = yt.dense
    order, rb = bg.row_blocks.numpy(), bg.blk_rb.numpy()
    assert sorted(order.tolist()) == list(range(bg.n_blocks))
    seg = bg.segments.numpy()
    assert (seg[:, 2] - seg[:, 1] <= TG.DENSE_SEGMENT).all()
    assert (seg[:, 2] > seg[:, 1]).all()
    covered = np.concatenate([np.arange(a, b) for _, a, b in seg])
    np.testing.assert_array_equal(covered, np.arange(bg.n_blocks))
    for r_, a, b in seg:
        assert (rb[order[a:b]] == r_).all()


def test_hybrid_graph_without_dense_blocks():
    hj, ht = _host_pair()
    yj = JG.hybrid_graph(hj, block_rows=128, block_cols=128, tile_edges=128,
                         min_nnz=0)
    yt = TG.hybrid_graph(ht, block_rows=128, block_cols=128, tile_edges=128,
                         min_nnz=0, device=CPU)
    assert yt.dense is None and yj.dense is None
    _assert_tiles_equal(yj.tiles, yt.tiles)


def test_unported_builder_options_raise():
    _, ht = _host_pair()
    with pytest.raises(NotImplementedError):
        TG.hybrid_graph(ht, min_nnz=64, tile_classes=(64, 128), device=CPU)
    with pytest.raises(NotImplementedError):
        TG.reorder_nodes(ht, "cluster")


@pytest.mark.parametrize("communities", [0, 7])
def test_synthetic_coo_matches_jax(communities):
    a = JD.synthetic_coo(400, 3000, seed=5, communities=communities)
    b = TD.synthetic_coo(400, 3000, seed=5, communities=communities)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", ["tiny", "karate"])
def test_load_dataset_matches_jax(name):
    dj, dt = JD.load_dataset(name), TD.load_dataset(name)
    assert dj.synthetic == dt.synthetic and dj.n_class == dt.n_class
    for k in ("x", "y", "train_mask", "val_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(dj, k), getattr(dt, k))
    _assert_host_equal(dj.host_graph, dt.host_graph)


def test_port_never_imports_jax():
    """No module of the port imports jax or the JAX package."""
    bad = []
    for path in PORT_DIR.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for nm in names:
                root = nm.split(".")[0]
                if root in ("jax", "jaxlib", "gta_graph_tensor_acclelrator_"
                            "for_general_gnn_tpu"):
                    bad.append(f"{path.relative_to(PORT_DIR)}: {nm}")
    assert not bad, bad
    assert (PORT_DIR / "ir.py").read_text() == (
        PORT_DIR.parent / "gta_graph_tensor_acclelrator_for_general_gnn_tpu"
        / "ir.py").read_text()
