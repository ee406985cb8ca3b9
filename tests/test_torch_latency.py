"""PyTorch port: the latency model (``compiler/latency.py``) against the JAX
package's.

The port's model has one code path and takes its constants as an
argument; its defaults are the fit on the card.  Built from the JAX
package's constants (its ``LatencyConstants()``, the tile-time model's
defaults, and the literals of its ``block_ns``), it must return the JAX
model's numbers: every op's, block's and candidate schedule's modelled time
within 1e-9 relative (the same terms summed in another order), for every
candidate of the seven families on two seeded graphs (one whose hybrid
splits hold dense blocks, one of cora's size), and the same compile-only
pick on a palette both feasibility rules admit whole."""
import csv
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import gta_graph_tensor_acclelrator_for_general_gnn_tpu as J  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu import graph as JG  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler import latency as JL  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler import schedule as JS  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.tune import search as JT  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch as T  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import graph as TG  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import fusion as TF  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import latency as TL  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.data import datasets as TDs  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.tune import search as TT  # noqa: E402

CPU = "cpu"
REL = 1e-9
# (network, heads): GAT at 2 and 4 heads
FAMILIES = [("GCN", 1), ("GAT", 2), ("GAT", 4), ("SGC", 1),
            ("GraphSAGE", 1), ("GIN", 1), ("DGN", 1), ("PNA", 1)]


def jax_constants() -> TL.LatencyConstants:
    """The JAX model's constants as the port's: its LatencyConstants and
    module constants, the tile-time model's keyword defaults, and the
    literals its ``block_ns``, ``stream_ns`` and tile model write in their
    bodies (the port's graph.py keeps those as keyword defaults, held to
    JAX's function by ``test_torch_classes``)."""
    jc = JL.LatencyConstants()
    jtile = inspect.signature(JG.tile_time_model_ns).parameters
    ttile = inspect.signature(TG.tile_time_model_ns).parameters
    tramp = inspect.signature(TG.grid_ramp_ns).parameters
    return TL.LatencyConstants(
        hbm_gbps=jc.hbm_gbps,
        mxu_tflops_bf16=jc.mxu_tflops_bf16,
        mxu_tflops_f32=jc.mxu_tflops_f32,
        dense_tflops_bf16=jc.mxu_tflops_bf16,
        dense_tflops_f32=jc.mxu_tflops_f32,
        xla_take_row_ns=jc.xla_take_row_ns,
        xla_segment_row_ns=jc.xla_segment_row_ns,
        xla_take_byte_ns=0.0,
        xla_segment_byte_ns=0.0,
        xla_lane_width=128,
        xla_value_bytes=0,
        xla_op_const_ns=jc.xla_op_const_ns,
        xla_resident_bytes=JL.XLA_TABLE_RESIDENT_BYTES,
        xla_nonresident_factor=JL.XLA_NONRESIDENT_FACTOR,
        tile_panel_gbps=ttile["panel_gbps"].default,
        tile_grid_const_ns=jtile["grid_const_ns"].default,
        tile_slot_ns=jtile["slot_ns"].default,
        tile_surcharge_ns=ttile["surcharge_ns"].default,
        tile_edge_ns=0.0,
        tile_edge_byte_ns=0.0,
        ramp_run_ns=tramp["run_ns"].default,
        ramp_tile_ns=tramp["tile_ns"].default,
        kernel_call_ns=0.0,
        dense_block_const_ns=jc.dense_block_const_ns,
        gat_pass_factor=jc.gat_pass_factor,
        gat_dense_factor=jc.gat_pass_factor,
        gat_cell_ns=0.0,
        layer_kernel_factor=jc.layer_kernel_factor,
        pair_sum_factor=2.6,
        pair_max_factor=1.8,
        pair_other_factor=2.2,
        stream_row_factor=1.5,
        stream_chunk_ns=jc.stream_chunk_ns,
        gat_stream_factor=jc.gat_pass_factor,
        gat_stream_chunk_ns=0.0,
        grouped_chunk_ns=jc.grouped_chunk_ns,
        grouped_weighted_ns=jc.grouped_weighted_ns,
        grouped_tflops_bf16=jc.mxu_tflops_bf16,
        grouped_tflops_f32=jc.mxu_tflops_f32,
        grouped_sub_ns=0.0,
    )


JAXC = jax_constants()


def _host_graphs(name):
    """(JAX host graph, port host graph) of one seeded COO."""
    if name == "dense":
        # planted communities, reordered by community: 256^2 blocks dense
        # enough for both hybrid kinds' thresholds
        s, r, com = TDs.synthetic_coo(6000, 160_000, seed=3, communities=24,
                                      p_in=0.9)
        order = np.argsort(com, kind="stable")
        inv = np.empty_like(order)
        inv[order] = np.arange(len(order))
        s, r, n = inv[s], inv[r], 6000
    else:
        n, e, _, _ = TDs.DATASET_STATS["cora"]
        s, r = TDs.synthetic_coo(n, e, seed=1)
    kw = dict(add_self_loops=True, symmetric_norm=True)
    return (J.build_host_graph(s, r, n, **kw),
            TG.build_host_graph(s, r, n, **kw))


@pytest.fixture(scope="module", params=["dense", "cora"])
def graphs(request):
    hj, ht = _host_graphs(request.param)
    return request.param, hj, ht, JL.GraphCost(hj), TL.GraphCost(ht, JAXC)


def _close(port, ref):
    assert abs(port - ref) <= REL * max(abs(ref), 1e-30), (port, ref)


def test_dense_graph_has_dense_blocks():
    """The dense fixture exercises the dense-block terms of both hybrid
    kinds (a graph without dense blocks would price only the tails)."""
    _, ht = _host_graphs("dense")
    cost = TL.GraphCost(ht, JAXC)
    for kind, kw in (("spmm", {}), ("gat", dict(heads=4, head_dim=16))):
        thr = cost.threshold(kind, 256, 256, **kw)
        assert cost._dense_count(256, 256, thr)[0] > 0, kind


@pytest.mark.parametrize("network,heads", FAMILIES,
                         ids=[f"{n}-{h}" for n, h in FAMILIES])
def test_model_equals_jax_on_every_candidate(graphs, network, heads):
    _, hj, ht, cj, ct = graphs
    gj = J.build_op_graph(network, 64, 16, heads=heads)
    gt = T.build_op_graph(network, 64, 16, heads=heads)
    for op_j, op_t in zip(gj.ops, gt.ops):
        for db in (2, 4):
            _close(TL.xla_op_ns(op_t, gt, ct.stats, db, JAXC),
                   JL.xla_op_ns(op_j, gj, cj.stats, db))
    cands_j = JT._candidate_schedules(gj, 64, JT.TILE_PALETTE)
    cands_t = TT._candidate_schedules(gt, 64, TT.TILE_PALETTE)
    assert [c.key() for c in cands_t] == [c.key() for c in cands_j]
    kinds = set()
    for sj, st in zip(cands_j, cands_t):
        for bj, tj, bt, tt in zip(sj.blocks, sj.tiles, st.blocks, st.tiles):
            kinds.add(TF.classify_block(gt, bt, tt)[0])
            _close(TL.block_ns(gt, bt, tt, ct, 2),
                   JL.block_ns(gj, bj, tj, cj, 2))
        for db in (2, 4):
            _close(TL.schedule_ns(gt, st, ct, db),
                   JL.schedule_ns(gj, sj, cj, db))
    assert "xla" in kinds and len(kinds) > 1


def _both_feasible_palette(gj, gt, fw):
    """The palette entries under which every candidate passes both the JAX
    package's VMEM rule and the port's shared-memory rule."""
    out = []
    for tj, tt in zip(JT.TILE_PALETTE, TT.TILE_PALETTE):
        cj = JT._candidate_schedules(gj, 64, [tj])
        ct = TT._candidate_schedules(gt, 64, [tt])
        if all(not (tc.path == JS.PATH_ONEHOT
                    and not JS.tile_is_feasible(tc, fw))
               for c in cj for tc in c.tiles) and all(
                TT.schedule_is_feasible(gt, c, 2) for c in ct):
            out.append((tj, tt))
    return [p[0] for p in out], [p[1] for p in out]


@pytest.mark.parametrize("network,heads", FAMILIES,
                         ids=[f"{n}-{h}" for n, h in FAMILIES])
def test_pick_equals_jax(graphs, network, heads):
    _, hj, ht, _, ct = graphs
    gj = J.build_op_graph(network, 64, 16, heads=heads)
    gt = T.build_op_graph(network, 64, 16, heads=heads)
    pj, pt = _both_feasible_palette(gj, gt, 64)
    assert len(pt) >= len(TT.TILE_PALETTE) - 2
    sj, tj = JL.min_latency_schedule(gj, hj, feat_width=64, tile_palette=pj)
    st, tt = TL.min_latency_schedule(gt, ht, tile_palette=pt, cost=ct)
    assert st.key() == sj.key()
    _close(tt, tj)
    priced = TL.priced_candidates(gt, ht, tile_palette=pt, cost=ct)
    assert min(t for _, t in priced) == tt
    assert any(not any(tc.kernel for tc in s.tiles) for s, _ in priced)


def test_default_constants_are_the_cards():
    """The defaults are not the TPU's: the per-op rows are priced by bytes
    at float32 values, the tile model by live edges."""
    d = TL.DEFAULT
    assert d.xla_value_bytes == 4 and d.tile_edge_byte_ns > 0
    assert d.tile_slot_ns == 0.0 and d != JAXC
    _, ht = _host_graphs("cora")
    g = T.build_op_graph("GCN", 64, 16)
    s, t = TL.min_latency_schedule(g, ht)
    assert t > 0 and np.isfinite(t) and TT.schedule_is_feasible(g, s, 2)


def test_spearman_and_rank_check(tmp_path):
    assert TL.spearman_rank([1, 2, 3], [10, 20, 30]) == pytest.approx(1.0)
    assert TL.spearman_rank([1, 2, 3], [30, 20, 10]) == pytest.approx(-1.0)
    assert TL.spearman_rank([1, 2, 3], [4, 9, 1]) == JL.spearman_rank(
        [1, 2, 3], [4, 9, 1])
    hj, ht = _host_graphs("cora")
    gj = J.build_op_graph("GCN", 64, 16)
    gt = T.build_op_graph("GCN", 64, 16)
    cands = TT._candidate_schedules(gt, 64, TT.TILE_PALETTE)[:8]
    memo = tmp_path / "memo.csv"
    rng = np.random.default_rng(0)
    with open(memo, "w", newline="") as f:
        w = csv.writer(f)
        for c in cands:
            w.writerow([f"v{TF.KERNEL_VERSION}|{gt.name}|{c.key()}",
                        float(rng.uniform(1e-4, 1e-3))])
        w.writerow([f"v{TF.KERNEL_VERSION - 1}|{gt.name}|{cands[0].key()}",
                    1.0])                       # an older version's row
    rt = TL.rank_check(str(memo), gt.name, gt, ht, constants=JAXC)
    rj = JL.rank_check(str(memo), gj.name, gj, hj,
                       version=TF.KERNEL_VERSION)
    assert len(rt["rows"]) == len(cands) == len(rj["rows"])
    for a, b in zip(rt["rows"], rj["rows"]):
        assert a[0] == b[0] and a[2] == b[2]
        _close(a[1], b[1])
    assert rt["spearman"] == pytest.approx(rj["spearman"])
    assert rt["argmin_regret"] == pytest.approx(rj["argmin_regret"])
    assert TL.rank_check(str(memo), "other", gt, ht) is None
    assert TL.rank_check(str(tmp_path / "none.csv"), gt.name, gt, ht) is None


def test_rank_stats():
    r = TL.rank_stats([4.0, 5.0, 30.0], [1.0, 0.5, 9.0])
    assert r["argmin_regret"] == pytest.approx(1.25)
    assert r["spearman"] == pytest.approx(0.5)


def test_as_host_reads_a_device_graph_back():
    _, ht = _host_graphs("cora")
    back = TG._as_host(ht.to_device(CPU))
    assert TG._as_host(ht) is ht
    for k in ("senders", "receivers", "edge_mask", "edge_weight"):
        np.testing.assert_array_equal(getattr(back, k), getattr(ht, k))
        assert getattr(back, k).dtype == getattr(ht, k).dtype
    assert (back.n_node, back.n_edge) == (ht.n_node, ht.n_edge)
