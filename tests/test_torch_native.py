"""PyTorch port, the native host library (``native/``) and label
propagation: the port's native sort, degrees and tiling against numpy
and the JAX package, its epoch sampler against the JAX package's
(the same C++ sources), ``cluster_labels`` and ``reorder_nodes("cluster")``
against JAX's (native against native, numpy against numpy: the two
sweeps differ by design), the planted-communities checks of the JAX
package's ``tests/test_native.py``, and the visible fallback when the
library cannot build.

Tolerance: every array exactly.  A test that needs the compiled library
skips only where no ``g++`` is found."""
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import gta_graph_tensor_acclelrator_for_general_gnn_tpu as J  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu import graph as JG  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu import native as JN  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.data.datasets import synthetic_coo  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch as T  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import graph as TG  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import native as TN  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.data.sampling import NeighborSampler  # noqa: E402

from conftest import small_graph  # noqa: E402

CPU = "cpu"     # the port's entry points default to the CUDA card
TILE_FIELDS = ("tile_rb", "tile_cb", "src_local", "dst_local", "edge_id",
               "weight", "row_first_tile")


@pytest.fixture
def have_native():
    """The port's library (skips only where no g++ is found; a library
    that does not build or fails its self-test where g++ exists fails)."""
    if shutil.which(TN.CXX) is None:
        pytest.skip(f"{TN.CXX} not found")
    assert TN.HAVE_NATIVE, TN.BUILD_ERROR
    assert TN.BUILD_ERROR is None


@pytest.fixture
def jax_native():
    if not JN.HAVE_NATIVE:
        pytest.skip("the JAX package's native library is unavailable")


def test_sort_and_degrees_match_numpy(rng, have_native):
    r = rng.integers(0, 500, size=4000).astype(np.int32)
    np.testing.assert_array_equal(TN.sort_by_receiver_native(r, 500),
                                  np.argsort(r, kind="stable"))
    s = rng.integers(0, 500, size=4000).astype(np.int32)
    out_deg, in_deg = TN.degrees_native(s, r, 500)
    np.testing.assert_array_equal(in_deg, np.bincount(r, minlength=500))
    np.testing.assert_array_equal(out_deg, np.bincount(s, minlength=500))
    with pytest.raises(ValueError, match="out of range"):
        TN.degrees_native(s, r, 300)


@pytest.mark.parametrize("self_loops,norm", [(False, False), (True, True)])
def test_build_host_graph_native_equals_numpy(rng, have_native, monkeypatch,
                                             self_loops, norm):
    s, r = small_graph(rng, n=300, e=3000, multi_edges=True)
    kw = dict(add_self_loops=self_loops, symmetric_norm=norm)
    nat = T.build_host_graph(s, r, 300, **kw)
    monkeypatch.setattr(TN, "HAVE_NATIVE", False)
    ref = T.build_host_graph(s, r, 300, **kw)
    jax = J.build_host_graph(s, r, 300, **kw)
    for f in ("senders", "receivers", "edge_mask", "edge_weight"):
        np.testing.assert_array_equal(getattr(nat, f), getattr(ref, f), f)
        np.testing.assert_array_equal(getattr(nat, f), getattr(jax, f), f)


@pytest.mark.parametrize("geo", [(64, 64, 128), (128, 32, 16), (32, 128, 64)])
def test_native_tiling_identical_to_numpy_and_jax(rng, have_native,
                                                  monkeypatch, geo):
    """Native and numpy tilings equal array for array, and both equal the
    JAX package's tile_graph (row blocks without an edge included)."""
    s, r = small_graph(rng, n=300, e=2500, multi_edges=True)
    keep = (r < 64) | (r >= 192)          # empty row blocks in the middle
    hg = T.build_host_graph(s[keep], r[keep], 300, add_self_loops=False,
                            symmetric_norm=True)
    jhg = J.build_host_graph(s[keep], r[keep], 300, add_self_loops=False,
                             symmetric_norm=True)
    br, bc, et = geo
    kw = dict(block_rows=br, block_cols=bc, tile_edges=et)
    nat = TG.tile_graph(hg, device=CPU, **kw)
    jt = JG.tile_graph(jhg, **kw)
    monkeypatch.setattr(TN, "HAVE_NATIVE", False)
    ref = TG.tile_graph(hg, device=CPU, **kw)
    for f in TILE_FIELDS:
        a = getattr(nat, f).float().numpy()
        np.testing.assert_array_equal(a, getattr(ref, f).float().numpy(), f)
        np.testing.assert_array_equal(a, np.asarray(getattr(jt, f),
                                                    np.float32), f)


def _epoch_inputs(rng, n=400, e=6000, fanouts=(4, 3), batch=32, seed=1):
    s, r = small_graph(rng, n=n, e=e, multi_edges=True)
    hg = T.build_host_graph(s, r, n)
    sam = NeighborSampler(hg, list(fanouts), batch_size=batch, seed=seed)
    seeds = rng.permutation(rng.choice(n, 4 * batch, replace=False)).astype(
        np.int32)
    return hg, sam, seeds


def test_sample_epoch_native_equals_jax_and_repeats(rng, have_native,
                                                    jax_native):
    """The port's and the JAX package's epoch samplers give the same
    arrays for one seed; two calls of the port's give the same arrays."""
    hg, sam, seeds = _epoch_inputs(rng)
    args = (sam.row_ptr, sam.senders, seeds, [4, 3], 32, sam.cap_nodes,
            sam.e_pad, 7)
    a = TN.sample_epoch_native(*args)
    b = TN.sample_epoch_native(*args)
    j = JN.sample_epoch_native(*args)
    assert set(a) == set(j)
    for key in a:
        np.testing.assert_array_equal(a[key], j[key], err_msg=key)
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    c = TN.sample_epoch_native(*args[:-1], 8)
    assert not np.array_equal(a["senders"], c["senders"])
    with pytest.raises(ValueError, match="whole batches"):
        TN.sample_epoch_native(sam.row_ptr, sam.senders, seeds[:40], [4, 3],
                               32, sam.cap_nodes, sam.e_pad, 7)


def test_native_epoch_sampler_structure(rng, have_native):
    """Each batch of the native epoch has the numpy pipeline's invariants
    (JAX test_native.py:48): seeds lead, a real-edge prefix sorted by
    receiver, one self loop per slot, padding on the dump row, every
    non-loop edge a real edge."""
    hg, sam, seeds = _epoch_inputs(rng)
    out = TN.sample_epoch_native(sam.row_ptr, sam.senders, seeds, [4, 3], 32,
                                 sam.cap_nodes, sam.e_pad, 7)
    assert out["senders"].shape == (4, sam.e_pad)
    edge_set = set(zip(hg.senders[: hg.n_edge].tolist(),
                       hg.receivers[: hg.n_edge].tolist()))
    for b in range(4):
        ids = out["ids"][b]
        src, dst = out["senders"][b], out["receivers"][b]
        m, w = out["mask"][b], out["weight"][b]
        np.testing.assert_array_equal(ids[:32], seeds[b * 32:(b + 1) * 32])
        assert out["seed"][b][:32].all() and not out["seed"][b][32:].any()
        k = int(m.sum())
        assert m[:k].all() and not m[k:].any()
        np.testing.assert_array_equal(w, m.astype(np.float32))
        assert (src[k:] == sam.cap_nodes).all()
        assert (dst[k:] == sam.cap_nodes).all()
        assert (np.diff(dst[:k]) >= 0).all()
        loops = src[:k] == dst[:k]
        assert loops.sum() >= sam.cap_nodes
        nz = ~loops
        gs_, gd_ = ids[src[:k][nz]], ids[dst[:k][nz]]
        assert (gs_ >= 0).all() and (gd_ >= 0).all()
        for a, c in zip(gs_.tolist(), gd_.tolist()):
            assert (a, c) in edge_set


def _planted(n, e, k, seed):
    s, r, com = synthetic_coo(n, e, seed=seed, communities=k, p_in=0.7)
    return T.build_host_graph(s, r, n), J.build_host_graph(s, r, n), com


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_cluster_labels_equal_jax(path, monkeypatch):
    """Native against native, numpy against numpy: the port's labels are
    JAX's, and so is reorder_nodes("cluster")'s permutation and graph."""
    if path == "native":
        if shutil.which(TN.CXX) is None or not JN.HAVE_NATIVE:
            pytest.skip("no native library")
        assert TN.HAVE_NATIVE, TN.BUILD_ERROR
    else:
        monkeypatch.setattr(TN, "HAVE_NATIVE", False)
        monkeypatch.setattr(JN, "HAVE_NATIVE", False)
    thg, jhg, _ = _planted(1024, 20_000, 6, seed=3)
    lab = TG.cluster_labels(thg)
    np.testing.assert_array_equal(lab, JG.cluster_labels(jhg))
    assert lab.dtype == np.int32 and lab.min() == 0
    np.testing.assert_array_equal(TG.cluster_labels(thg, max_iter=3, seed=5),
                                  JG.cluster_labels(jhg, max_iter=3, seed=5))
    tg2, tperm = TG.reorder_nodes(thg, "cluster")
    jg2, jperm = JG.reorder_nodes(jhg, "cluster")
    np.testing.assert_array_equal(tperm, jperm)
    for f in ("senders", "receivers", "edge_mask", "edge_weight"):
        np.testing.assert_array_equal(getattr(tg2, f), getattr(jg2, f), f)


def _partition_match(found, truth, k):
    """Every found label maps to exactly one planted community and the
    mapping is a bijection (perfect recovery up to relabelling)."""
    if found.max() + 1 != k:
        return False
    for lab in range(k):
        if np.count_nonzero(np.bincount(truth[found == lab],
                                        minlength=k)) != 1:
            return False
    return True


def test_label_prop_recovers_planted_communities(have_native):
    thg, _, com = _planted(2048, 80_000, 8, seed=11)
    assert _partition_match(TG.cluster_labels(thg), com, 8)


def test_label_prop_numpy_fallback_recovers():
    thg, _, com = _planted(1024, 30_000, 8, seed=5)
    s = thg.senders[: thg.n_edge].astype(np.int64)
    r = thg.receivers[: thg.n_edge].astype(np.int64)
    keep = s != r
    u = np.concatenate([s[keep], r[keep]])
    v = np.concatenate([r[keep], s[keep]])
    order = np.argsort(u, kind="stable")
    rp = np.concatenate([[0], np.cumsum(np.bincount(u, minlength=1024))])
    lab = TG._label_prop_numpy(rp.astype(np.int64), v[order].astype(np.int32),
                               1024, 20)
    _, lab = np.unique(lab, return_inverse=True)
    assert _partition_match(lab, com, 8)


def test_cluster_reorder_matches_ground_truth_density():
    """The label-free 'cluster' reorder earns (almost) the dense fraction
    that the planted labels earn on the hybrid split."""
    thg, _, com = _planted(4096, 300_000, 4, seed=7)

    def dense_frac(method, **kw):
        g2, perm = TG.reorder_nodes(thg, method, **kw)
        assert sorted(perm.tolist()) == list(range(thg.n_node))
        h = TG.hybrid_graph(g2, block_rows=256, block_cols=256,
                            tile_edges=512, min_nnz=3277, device=CPU)
        return h.n_dense_edges / max(h.n_dense_edges + h.n_sparse_edges, 1)

    truth = dense_frac("hubs+labels", labels=com)
    found = dense_frac("cluster")
    assert truth > 0.3, truth
    assert found >= 0.9 * truth, (found, truth)


def test_cluster_labels_exported():
    assert T.cluster_labels is TG.cluster_labels


def test_missing_compiler_falls_back_visibly():
    """Without a compiler the library is absent, HAVE_NATIVE is False,
    BUILD_ERROR says why, and the builders take numpy (same arrays)."""
    code = """
import numpy as np
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import native, graph
native.CXX = "gta-no-such-compiler"
hg = graph.build_host_graph(np.array([1, 2, 0], np.int32),
                            np.array([0, 0, 2], np.int32), 3,
                            symmetric_norm=True)
print(native.HAVE_NATIVE, native.tile_edges_native([0], [0], [1.0], 1, 1,
      4, 4, 4, 1), hg.receivers[:3].tolist())
print(native.BUILD_ERROR)
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    first, second = res.stdout.splitlines()[:2]
    assert first == "False None [0, 0, 2]"
    assert "gta-no-such-compiler not found" in second


def test_cli_node_reorder_cluster(capsys):
    """``cli run --node-reorder cluster`` relabels by label propagation and
    serves the reordered graph."""
    import json

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import cli as TCLI
    rc = TCLI.main(["run", "--dataset", "tiny", "--network", "GCN",
                    "--hidden", "16", "--f32", "--device", "cpu",
                    "--node-reorder", "cluster", "--json"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["finite"] and out["out_shape"] == [200, 4]
    assert out["node_reorder"] == "cluster"
