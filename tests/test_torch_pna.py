"""PyTorch port: PNA as published (``"PNA-4x3"``: mean, min, max and std,
each under the degree scalers identity, amplification and attenuation)
against the benchmark's plain reference ``gnnbench/reference/pna.py``.

On the CPU at a small size (300 nodes, hidden 16, seeded random weights
from the benchmark's own generator): the per-op path and the hybrid path
(``fusion.hybrid_schedules``: the pair chain on the ``pair_agg`` kind,
K13's plain version) in float32 and bfloat16; float32 gradients of every
weight through K13's backward twin against autograd of the reference; the
scalers and delta by hand on a 5-node graph; a row whose only edge is its
self loop, whose std is sqrt(1e-5); the new computes through ``ir_io``;
and ``hybrid_schedules`` left as it was for GCN and GAT.

Tolerances, over the largest |reference|: float32 1e-4 (sums in another
order, and the std's difference of moments amplifies their rounding where
a row's variance is small); bfloat16 against the reference rounded where
the program rounds (u, v, the messages, the aggregates, x and the weights)
2e-3 (a rounding that falls the other way), against the float32 reference
3e-2 (bf16 operands)."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from gnnbench import inputs  # noqa: E402
from gnnbench.reference import common  # noqa: E402
from gnnbench.reference import pna as RP  # noqa: E402

from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import graph as TG  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import ir  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import ir_io as TI  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import fusion as TF  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import schedule as TS  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler.lower import (  # noqa: E402
    concat_features, init_params, lower)
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models.builders import (  # noqa: E402
    build_op_graph)
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models.zoo import build_model  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import pairagg as PA  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import primitives as P  # noqa: E402

CPU = "cpu"
N, E, F, HID, C = 300, 3000, 12, 16, 5
CFG = dict(features=F, hidden=HID, classes=C, layers=2)
TOL = {"float32": 1e-4, "bf16_rounded": 2e-3, "bfloat16": 3e-2}
SEED = 2 ** 31 + 23


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _coo(seed=0, n=N, e=E):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e)
    r = np.concatenate([rng.integers(0, n, e - e // 10),
                        rng.choice([3, 7], e // 10)])      # two hubs
    keep = s != r
    return s[keep].astype(np.int32), r[keep].astype(np.int32)


def _graphs(s, r, n=N):
    """(port host graph, reference graph) of one COO, node order kept."""
    hg = TG.build_host_graph(s, r, n, add_self_loops=True,
                             symmetric_norm=True)
    rg = common.prepare_graph(torch.as_tensor(s), torch.as_tensor(r),
                              torch.zeros(n, dtype=torch.long), n)
    return hg, rg


def _model(reorder=True):
    m = build_model("PNA-4x3", F, C, hidden=HID, n_layers=2,
                    reorder=reorder, device=CPU)
    w = inputs.make_weights(RP.param_specs(CFG), SEED, torch.device(CPU))
    m.load_params(w)
    return m, w


def _close(got, want, tol):
    got, want = got.detach().float(), want.detach().float()
    assert got.shape == want.shape
    err = float((got - want).abs().max())
    bound = tol * float(want.abs().max())
    assert err <= bound, (err, bound)


@pytest.fixture(scope="module")
def case():
    s, r = _coo()
    hg, rg = _graphs(s, r)
    x = torch.randn((N, F), generator=torch.Generator().manual_seed(1))
    return hg, rg, x


@pytest.mark.parametrize("reorder", [True, False])
def test_parameters_are_the_references(reorder):
    """The model's weights have the reference's names and shapes, which
    ``gnnbench/program.py``'s ``Program.load`` checks."""
    m = build_model("PNA-4x3", F, C, hidden=HID, n_layers=2,
                    reorder=reorder, device=CPU)
    assert {k: tuple(v.shape) for k, v in m.params.items()} == {
        k: (i, o) for k, i, o in RP.param_specs(CFG)}
    with pytest.raises(ValueError, match="unknown network"):
        build_model("PNA-5x3", F, C, device=CPU)


def test_hybrid_path_puts_the_chain_on_the_pair_kind():
    """Each layer: one ``pair_agg`` block holding the two scatters, the
    message and the four gathers; the plan asks K13 for min and sum of
    squares; every other op alone, op by op."""
    m, _ = _model()
    for g, sched in zip(m.layers, TF.hybrid_schedules(m.layers)):
        kinds = [TF.classify_block(g, b, tc)[0]
                 for b, tc in zip(sched.blocks, sched.tiles)]
        assert kinds.count("pair_agg") == 1
        assert set(kinds) == {"pair_agg", "xla"}
        block = sched.blocks[kinds.index("pair_agg")]
        assert block == (2, 3, 4, 5, 6, 7, 8)
        plan = TF.classify_block(g, block, sched.tiles[kinds.index(
            "pair_agg")])[1]
        assert plan.want_min_sq and set(plan.gathers) == {
            ir.MEAN, ir.MIN, ir.MAX, ir.STD}
        assert plan.sf is None


@pytest.mark.parametrize("reorder", [True, False])
def test_float32_paths_match_reference(case, reorder):
    """The per-op path and the hybrid path against the reference's
    published equations, in float32."""
    hg, rg, x = case
    m, w = _model(reorder)
    g = hg.to_device(CPU)
    with torch.no_grad():
        want = RP.forward(w, rg, x)
        per_op = m.make_apply()(dict(m.params), g, x)
        hyb = m.make_apply(schedules=TF.hybrid_schedules(m.layers),
                           host_graph=hg, device=CPU)(dict(m.params), g, x)
    _close(per_op, want, TOL["float32"])
    _close(hyb, want, TOL["float32"])


def test_bfloat16_paths_match_reference(case):
    """In bfloat16 the hybrid path is the reference rounded where the
    program rounds; both paths stay near the float32 reference."""
    hg, rg, x = case
    m, w = _model()
    g = hg.to_device(CPU)
    with torch.inference_mode():
        hyb = m.make_apply(torch.bfloat16,
                           schedules=TF.hybrid_schedules(m.layers),
                           host_graph=hg, device=CPU)(dict(m.params), g, x)
        per_op = m.make_apply(torch.bfloat16)(dict(m.params), g, x)
        want = RP.forward(w, rg, x)
        rounded = RP.forward(w, rg, x, _bf16)
    _close(hyb, rounded, TOL["bf16_rounded"])
    _close(hyb, want, TOL["bfloat16"])
    _close(per_op, want, TOL["bfloat16"])
    # the control's float8 is farther than bf16
    err = float((RP.forward(w, rg, x, common.fp8_round) - want).abs().max())
    assert err > 3 * float((hyb - want).abs().max())


def test_float32_gradients_match_reference(case):
    """Every weight's float32 gradient through the hybrid path (K13's
    backward twin: min and max ties split evenly, as the reference's
    ``scatter_reduce``) against autograd of the reference."""
    hg, rg, x = case
    m, w = _model()
    g = hg.to_device(CPU)
    gy = torch.randn((N, C), generator=torch.Generator().manual_seed(2))
    params = dict(m.params)
    out = m.make_apply(schedules=TF.hybrid_schedules(m.layers),
                       host_graph=hg, device=CPU)(params, g, x)
    got = torch.autograd.grad((out * gy).sum(), list(params.values()))
    ref = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    want = torch.autograd.grad((RP.forward(ref, rg, x) * gy).sum(),
                               [ref[k] for k in params])
    for k, a, b in zip(params, got, want):
        assert float(b.abs().max()) > 0, k
        _close(a, b, TOL["float32"])


def test_reference_blocks_equal_one_pass(case):
    """The reference's aggregation in blocks of edges equals one pass."""
    hg, rg, x = case
    u, v = torch.randn((2, N, HID), generator=torch.Generator().manual_seed(3))
    whole = RP.aggregate(u, v, rg, block=10 ** 9)
    assert torch.allclose(RP.aggregate(u, v, rg, block=97), whole,
                          rtol=1e-6, atol=1e-6)


# 0->1, 1->2, 2->0, 3->1, 4->3 with self loops: in-degrees 2 3 2 2 1
S5, R5, DEG5 = [0, 1, 2, 3, 4], [1, 2, 0, 1, 3], [2, 3, 2, 2, 1]


def _five():
    return _graphs(np.array(S5, np.int32), np.array(R5, np.int32), n=5)


def test_degree_scalers_by_hand():
    """delta = mean log(d+1); amplification log(d+1)/delta, attenuation
    delta/log(d+1), on the per-op path, the lowered path (computed once at
    lowering from the host graph) and the reference."""
    hg, rg = _five()
    logs = [math.log(d + 1) for d in DEG5]
    delta = sum(logs) / 5
    amp = torch.tensor([v / delta for v in logs])[:, None]
    att = torch.tensor([delta / v for v in logs])[:, None]
    g = hg.to_device(CPU)
    assert P.in_degree(g).tolist() == DEG5
    sc = P.degree_scalers(P.in_degree(g))
    assert torch.allclose(sc["amplification"], amp, rtol=1e-6)
    assert torch.allclose(sc["attenuation"], att, rtol=1e-6)
    r_amp, r_att = RP.degree_scalers(rg)
    assert torch.allclose(r_amp, amp, rtol=1e-6)
    assert torch.allclose(r_att, att, rtol=1e-6)
    graph = ir.OpGraph("scalers", [
        ir.Op(0, ir.APPLY_NODE, ir.SCALER, "R", [ir.X_INPUT], 2,
              {"scaler": "amplification"}),
        ir.Op(1, ir.APPLY_NODE, ir.SCALER, "R", [ir.X_INPUT], 2,
              {"scaler": "attenuation"})], in_width=2)
    ones = torch.ones((5, 2))
    per_op = lower(graph)({}, g, ones)
    sched = TS.Schedule(blocks=((0,), (1,)),
                        tiles=(TS.TileConfig(path=TS.PATH_XLA),) * 2)
    lowered = TF.lower_schedule(graph, sched, hg, device=CPU)({}, g, ones)
    for out in (per_op, lowered):
        assert torch.allclose(out[0], amp.expand(5, 2), rtol=1e-6)
        assert torch.allclose(out[1], att.expand(5, 2), rtol=1e-6)


def _aggregates_graph():
    """u, v, their pair chain and the four gathers, every gather an
    output."""
    g = build_op_graph("PNA-4x3", 3, 2, hidden=4, reorder=True)
    ops = [op for op in g.ops if op.op_id <= 8]
    return ir.OpGraph("aggregates", ops, in_width=3, outputs=[5, 6, 7, 8])


def test_degree_one_row_std_is_sqrt_eps():
    """Node 4's only incoming edge is its self loop: mean = min = max = its
    message, std = sqrt(1e-5) exactly, on the per-op path, the pair_agg
    kind and the reference; and the per-op gathers by hand."""
    hg, rg = _five()
    graph = _aggregates_graph()
    params = init_params(graph, torch.Generator().manual_seed(4), device=CPU)
    x = torch.randn((5, 3), generator=torch.Generator().manual_seed(5))
    g = hg.to_device(CPU)
    per_op = lower(graph)(params, g, x)
    sched = TF.hybrid_schedules([graph])[0]
    fused = TF.lower_schedule(graph, sched, hg, device=CPU)(params, g, x)
    assert [k for k, *_ in TF.lower_schedule(
        graph, sched, hg, device=CPU).plans].count("pair_agg") == 1
    u = x @ params["pna4_l0_wsrc"]
    v = x @ params["pna4_l0_wdst"]
    ref = RP.aggregate(u, v, rg)
    eps = torch.sqrt(torch.tensor(ir.STD_EPS))
    m4 = u[4] + v[4]
    for out in (per_op, fused):
        assert torch.equal(out[8][4], eps.expand(4))
        for oid in (5, 6, 7):
            assert torch.allclose(out[oid][4], m4, rtol=1e-6, atol=1e-7)
    assert torch.equal(ref[4, 12:], eps.expand(4))
    # by hand on node 1 (edges from 0, 3 and its loop)
    m = torch.stack([u[s] + v[1] for s in (0, 3, 1)])
    mean = m.mean(0)
    std = torch.sqrt(torch.relu((m * m).mean(0) - mean * mean) + 1e-5)
    for out in (per_op, fused):
        _close(out[5][1], mean, 1e-6)
        _close(out[6][1], m.min(0).values, 1e-6)
        _close(out[7][1], m.max(0).values, 1e-6)
        _close(out[8][1], std, 1e-5)
    _close(ref[1], torch.cat([mean, m.min(0).values, m.max(0).values, std]),
           1e-5)


def test_ir_io_round_trips_the_new_computes(case):
    """MIN, STD, SCALER and the MM of several inputs through the
    reference's YAML schema: the same ops, and the same per-op output."""
    hg, _, x = case
    m, _ = _model()
    g = hg.to_device(CPU)
    for og in m.layers:
        back = TI.from_yaml(TI.to_yaml(og, n_node=N, n_edge=E),
                            name=og.name, in_width=og.in_width)
        assert [(o.op_id, o.kind, o.compute, o.order, list(o.inputs),
                 o.out_width, o.extra) for o in back.ops] == [
            (o.op_id, o.kind, o.compute, o.order, list(o.inputs),
             o.out_width, o.extra) for o in og.ops]
    og = m.layers[0]
    back = TI.from_yaml(TI.to_yaml(og, n_node=N, n_edge=E), name=og.name)
    params = dict(m.params)
    with torch.no_grad():
        assert torch.equal(lower(back)(params, g, x), lower(og)(params, g, x))


def _old_hybrid(layers, spmm_tile, gat_tile):
    """What ``hybrid_schedules`` built before pair chains had a kind."""
    out = []
    for graph in layers:
        part, tc, want = TS.pattern_partition(graph), gat_tile, "gat_hybrid"
        if part is None:
            part = TS.aggregation_partition(graph)
            tc, want = spmm_tile, "spmm_hybrid"
        tiles = tuple(tc if TF.classify_block(graph, b, tc)[0] == want
                      else TS.TileConfig(path=TS.PATH_XLA) for b in part)
        out.append(TS.Schedule(blocks=part, tiles=tiles))
    return out


@pytest.mark.parametrize("reorder", [False, True])
@pytest.mark.parametrize("net", ["GCN", "GAT"])
def test_hybrid_schedules_unchanged_for_gcn_and_gat(net, reorder):
    """GCN and GAT layers get the blocks and tiles they always got; DGN,
    the reference zoo's PNA and the published PNA each get exactly one
    ``pair_agg`` block a layer."""
    spmm = TS.TileConfig(1024, 1024, 512, TS.PATH_HYBRID, dense_block=256)
    gat = TS.TileConfig(512, 1024, 512, TS.PATH_HYBRID, dense_block=256)
    m = build_model(net, 602, 41, hidden=128, n_layers=2, reorder=reorder,
                    device=CPU)
    new = TF.hybrid_schedules(m.layers)
    assert [s.key() for s in new] == [
        s.key() for s in _old_hybrid(m.layers, spmm, gat)]
    assert all("pair_agg" not in [TF.classify_block(g, b, t)[0]
                                  for b, t in zip(s.blocks, s.tiles)]
               for g, s in zip(m.layers, new))
    for other in ("DGN", "PNA", "PNA-4x3"):
        mo = build_model(other, 602, 41, hidden=128, n_layers=2,
                         reorder=reorder, device=CPU)
        for g, s in zip(mo.layers, TF.hybrid_schedules(mo.layers)):
            kinds = [TF.classify_block(g, b, t)[0]
                     for b, t in zip(s.blocks, s.tiles)]
            assert kinds.count("pair_agg") == 1, (other, kinds)
            assert s.tiles[kinds.index("pair_agg")] == TF.PAIR_TILE


def test_concat_reads_adjacent_slices_without_a_copy():
    """An MM of several inputs reads adjacent column slices of one tensor
    as one view where no gradient is recorded, and copies otherwise; the
    four aggregates of K13's final layout, split as the ``pair_agg`` block
    splits them, are read as that one tensor."""
    a = torch.randn((6, 8))
    with torch.inference_mode():
        b = a.clone()
        parts = b.split(2, dim=1)
        got = concat_features(parts)
        assert got.data_ptr() == b.data_ptr() and torch.equal(got, b)
        swapped = concat_features([parts[1], parts[0]])
        assert swapped.data_ptr() != b.data_ptr()
        assert torch.equal(swapped, torch.cat([parts[1], parts[0]], 1))
    leaf = a.clone().requires_grad_(True)
    got = concat_features(leaf.split(2, dim=1))
    assert torch.equal(got, a)
    got.sum().backward()
    assert torch.equal(leaf.grad, torch.ones_like(a))
    hg, _ = _five()
    tg = TG.tile_graph(hg, block_rows=TF.PAIR_TILE.block_rows,
                       block_cols=TF.PAIR_TILE.block_cols,
                       tile_edges=TF.PAIR_TILE.tile_edges, unit_weight=True,
                       device=CPU)
    u, v = torch.randn((2, 5, 4), generator=torch.Generator().manual_seed(7))
    with torch.inference_mode():
        y, _ = PA.pair_aggregate(tg, u, v, want_min_sq=True,
                                 layout=(ir.MEAN, ir.MIN, ir.MAX, ir.STD))
        got = concat_features(y.split(4, 1))
        assert got.data_ptr() == y.data_ptr() and torch.equal(got, y)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("net", ["PNA", "PNA-4x3"])
def test_pair_block_outputs_are_the_moments_formulas(case, net, dtype):
    """The ``pair_agg`` block's gathers, bit for bit, from K13's plain
    version on the block's own u and v: the sum-and-max instantiation of
    the reference zoo's PNA (sum, max, and the mean sum / max(count, 1))
    as before, and the published PNA's final layout (mean, min, max and
    std = sqrt(relu(sq / c - mean^2) + 1e-5))."""
    hg, _, x = case
    full = build_op_graph(net, F, HID, hidden=HID, reorder=True)
    gathers = [op.op_id for op in full.ops if op.kind == ir.GATHER]
    graph = ir.OpGraph("aggregates", [op for op in full.ops
                                      if op.op_id <= max(gathers)],
                       in_width=F, outputs=[0, 1, *gathers])
    params = init_params(graph, torch.Generator().manual_seed(6), device=CPU)
    sched = TF.hybrid_schedules([graph])[0]
    fn = TF.lower_schedule(graph, sched, hg, dtype, device=CPU)
    with torch.inference_mode():
        out = fn(params, hg.to_device(CPU), x)
    (tg, sf), = [(d, TF.classify_block(graph, b, t)[1].sf)
                 for (k, b, d, _), t in zip(fn.plans, sched.tiles)
                 if k == "pair_agg"]
    dt = dtype or torch.float32
    s, mx, c, mn, sq = PA._pair_agg_reference(
        tg, out[0].to(dt), out[1].to(dt), sf=sf, want_min_sq=True)
    c = c.clamp(min=1.0)
    mean = s / c
    want = {ir.ADD: s, ir.MAX: mx, ir.MEAN: mean, ir.MIN: mn,
            ir.STD: torch.sqrt(torch.relu(sq / c - mean * mean)
                               + ir.STD_EPS)}
    for oid in gathers:
        assert torch.equal(out[oid], want[graph.by_id[oid].compute]), oid


def test_degree_scalers_span_once_a_model(case):
    """Lowering records ``lower.degree_scalers`` once for the layers that
    share a tile cache (a model's); the work
    list of K13 and its launches exist only on the card (the CPU takes
    the plain version), so no ``lower.pair_work`` span or ``pair_agg.k13``
    count here, nor its final layout's ``pair_agg.layout`` and
    ``pair_agg.cut_rows``."""
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import spans
    hg, _, x = case
    m, _ = _model()
    spans.take()
    with spans.recording():
        fn = m.make_apply(torch.bfloat16,
                          schedules=TF.hybrid_schedules(m.layers),
                          host_graph=hg, device=CPU)
        with torch.inference_mode():
            fn(dict(m.params), hg.to_device(CPU), x)
    got = spans.take()["spans"]
    names = [s["name"] for s in got]
    assert names.count("lower.degree_scalers") == 1
    assert names.count("block.pair_agg") == 2
    assert "lower.pair_work" not in names
    assert not any(k in s["counters"] for s in got for k in (
        "pair_agg.k13", "pair_agg.layout", "pair_agg.cut_rows"))
