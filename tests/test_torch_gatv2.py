"""PyTorch port: GATv2 (``"GATv2"``: dynamic attention, Brody, Alon and
Yahav, arXiv:2105.14491) against the benchmark's plain reference
``gnnbench/reference/gatv2.py``.

On the CPU at a small size (300 nodes with two hubs whose rows the work
list cuts, hidden 16, seeded random weights from the benchmark's own
generator): the parameters' names and shapes; ``hybrid_schedules``
putting the chain on the ``gatv2`` kind and leaving the other families'
kinds as they were; the per-op path and the hybrid path (K17's plain
version) in float32 and bfloat16; float32 gradients of every weight
through K17's backward twin against autograd of the reference; K17's
plain version, chunk by chunk with the cut rows merged, against one pass;
the head dot through ``ir_io``; the block's span once per layer.

Tolerances, over the largest |reference|: float32 1e-5 (sums in another
order); bfloat16 against the reference rounded where the program rounds
(x, the weights, u and v) 2e-3 (a rounding that falls the other way and
moves a score), against the float32 reference 3e-2 (bf16 operands);
gradients 1e-4 (the twin's float32 sums in another order, through the
softmax's quotient)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from gnnbench import inputs  # noqa: E402
from gnnbench.reference import common  # noqa: E402
from gnnbench.reference import gatv2 as RV  # noqa: E402

from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import graph as TG  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import ir_io as TI  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import fusion as TF  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import schedule as TS  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler.lower import (  # noqa: E402
    init_params, lower)
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models.builders import (  # noqa: E402
    build_op_graph)
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models.zoo import build_model  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import gatv2 as GV  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import primitives as P  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import spans as SP  # noqa: E402

CPU = "cpu"
N, E, F, HID, C, HEADS = 300, 3000, 12, 16, 5, 4
CFG = dict(features=F, hidden=HID, classes=C, layers=2, heads=HEADS)
TOL = {"float32": 1e-5, "bf16_rounded": 2e-3, "bfloat16": 3e-2,
       "grad": 1e-4}
SEED = 2 ** 31 + 27
CHAIN = (2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14)


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


def _model(heads=HEADS):
    cfg = dict(CFG, heads=heads)
    m = build_model("GATv2", F, C, hidden=HID, n_layers=2, heads=heads,
                    reorder=True, device=CPU)
    w = inputs.make_weights(RV.param_specs(cfg), SEED, torch.device(CPU))
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


def _hybrid(m, hg, dtype=None):
    return m.make_apply(dtype, schedules=TF.hybrid_schedules(m.layers),
                        host_graph=hg, device=CPU)


@pytest.mark.parametrize("reorder", [True, False])
def test_parameters_are_the_references(reorder):
    """The model's weights have the reference's names and shapes, which
    ``gnnbench/program.py``'s ``Program.load`` checks: W_l and W_r [F, H
    C], the attention vectors [H, C]; ``reorder`` builds the same layer."""
    m = build_model("GATv2", F, C, hidden=HID, n_layers=2, heads=HEADS,
                    reorder=reorder, device=CPU)
    assert {k: tuple(v.shape) for k, v in m.params.items()} == {
        k: (i, o) for k, i, o in RV.param_specs(CFG)}
    assert m.params["gatv2_l0_att"].shape == (HEADS, HID // HEADS)
    assert m.params["gatv2_l1_att"].shape == (1, C)
    with pytest.raises(ValueError, match="unknown network"):
        build_model("GATv3", F, C, device=CPU)


def test_param_specs_list_the_attention_vectors_after_the_products():
    g = build_op_graph("GATv2", 12, 16, heads=4, layer_tag="l3")
    assert g.param_specs() == [("gatv2_l3_wl", 12, 16),
                               ("gatv2_l3_wr", 12, 16),
                               ("gatv2_l3_att", 4, 4)]
    p = init_params(g, torch.Generator().manual_seed(0), device=CPU)
    lim = (6.0 / (4 + 4)) ** 0.5
    assert p["gatv2_l3_att"].shape == (4, 4)
    assert float(p["gatv2_l3_att"].abs().max()) <= lim


def test_head_dot_by_hand():
    """HEAD_DOT: each head's C features of an edge row times its row of
    the attention vectors, summed."""
    e = torch.arange(12, dtype=torch.float32).view(2, 6)
    att = torch.tensor([[1.0, -1.0, 2.0], [0.5, 0.0, 3.0]])
    want = torch.tensor([[0 - 1 + 4, 1.5 + 0 + 15],
                         [6 - 7 + 16, 4.5 + 0 + 33]])
    assert torch.equal(P.head_dot(e, att), want)


@pytest.mark.parametrize("heads", [4, 2])
def test_hybrid_path_puts_the_chain_on_the_gatv2_kind(heads):
    """Each layer: one ``gatv2`` block holding the chain from the scatters
    of u and v to the division on nodes, on ``PAIR_TILE``; the products
    and the ELU op by op."""
    m, _ = _model(heads)
    for i, (g, sched) in enumerate(zip(m.layers,
                                       TF.hybrid_schedules(m.layers))):
        kinds = [TF.classify_block(g, b, tc)[0]
                 for b, tc in zip(sched.blocks, sched.tiles)]
        assert kinds == ["xla", "xla", "gatv2", "xla"]
        assert sched.blocks[2] == CHAIN
        assert sched.tiles[2] == TF.PAIR_TILE
        plan = TF.classify_block(g, CHAIN, TF.PAIR_TILE)[1]
        h = 1 if i == 1 else heads
        assert (plan.u_op, plan.v_op, plan.heads, plan.out_op) == (0, 1, h,
                                                                   14)
        assert plan.att == f"gatv2_l{i}_att" and plan.slope == 0.2
        assert TS.partition_is_legal_with_patterns(g, sched.blocks)
        # off the onehot path, and as a part of the chain, the block runs
        # op by op
        hyb = TS.TileConfig(512, 1024, 512, TS.PATH_HYBRID, dense_block=256)
        assert TF.classify_block(g, CHAIN, hyb)[0] == "xla"
        assert TF.classify_block(g, CHAIN[:-1], TF.PAIR_TILE)[0] == "xla"


@pytest.mark.parametrize("net", ["GCN", "GAT", "PNA", "PNA-4x3"])
def test_other_families_keep_their_kinds(net):
    """``hybrid_schedules`` of GCN, GAT, PNA and PNA-4x3 holds no
    ``gatv2`` block: each layer keeps its kind, and no other family's
    graph has a GATv2 chain."""
    want = {"GCN": "spmm_hybrid", "GAT": "gat_hybrid", "PNA": "pair_agg",
            "PNA-4x3": "pair_agg"}[net]
    m = build_model(net, F, C, hidden=HID, n_layers=2, heads=2,
                    reorder=True, device=CPU)
    for g, sched in zip(m.layers, TF.hybrid_schedules(m.layers)):
        assert GV.find_gatv2_chain(g) is None
        assert TS.gatv2_partition(g) is None
        kinds = [TF.classify_block(g, b, tc)[0]
                 for b, tc in zip(sched.blocks, sched.tiles)]
        assert kinds.count(want) >= 1
        assert set(kinds) <= {want, "xla"}


def test_float32_paths_match_reference(case):
    """The per-op path, the hybrid path and a schedule that leaves the
    chain op by op against the reference's published equations, in
    float32."""
    hg, rg, x = case
    m, w = _model()
    g = hg.to_device(CPU)
    xla = [TS.Schedule(blocks=s.blocks,
                       tiles=tuple(TS.TileConfig(path=TS.PATH_XLA)
                                   for _ in s.blocks))
           for s in TF.hybrid_schedules(m.layers)]
    with torch.no_grad():
        want = RV.forward(w, rg, x)
        per_op = m.make_apply()(dict(m.params), g, x)
        hyb = _hybrid(m, hg)(dict(m.params), g, x)
        fallback = m.make_apply(schedules=xla, host_graph=hg,
                                device=CPU)(dict(m.params), g, x)
    for got in (per_op, hyb, fallback):
        _close(got, want, TOL["float32"])


def test_bfloat16_paths_match_reference(case):
    """In bfloat16 the hybrid path is the reference rounded where the
    program rounds; both paths stay near the float32 reference, and the
    control's float8 is farther."""
    hg, rg, x = case
    m, w = _model()
    g = hg.to_device(CPU)
    with torch.inference_mode():
        hyb = _hybrid(m, hg, torch.bfloat16)(dict(m.params), g, x)
        per_op = m.make_apply(torch.bfloat16)(dict(m.params), g, x)
        want = RV.forward(w, rg, x)
        rounded = RV.forward(w, rg, x, _bf16)
        fp8 = RV.forward(w, rg, x, common.fp8_round)
    assert hyb.dtype == torch.float32
    _close(hyb, rounded, TOL["bf16_rounded"])
    _close(hyb, want, TOL["bfloat16"])
    _close(per_op, want, TOL["bfloat16"])
    err = float((fp8 - want).abs().max())
    assert err > 3 * float((hyb - want).abs().max())


def test_float32_gradients_match_reference(case):
    """Every weight's float32 gradient through the hybrid path (K17's
    backward twin) against autograd of the reference."""
    hg, rg, x = case
    m, w = _model()
    g = hg.to_device(CPU)
    gy = torch.randn((N, C), generator=torch.Generator().manual_seed(2))
    params = dict(m.params)
    out = _hybrid(m, hg)(params, g, x)
    got = torch.autograd.grad((out * gy).sum(), list(params.values()))
    ref = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    want = torch.autograd.grad((RV.forward(ref, rg, x) * gy).sum(),
                               [ref[k] for k in params])
    for k, a, b in zip(params, got, want):
        assert float(b.abs().max()) > 0, k
        _close(a, b, TOL["grad"])


def _tiling(hg):
    m, _ = _model()
    fn = _hybrid(m, hg).layer_fns[0]
    (tg,) = [p[2] for p in fn.plans if p[0] == "gatv2"]
    return tg


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hc", [(4, 32), (1, 41), (2, 8)])
def test_plain_version_equals_one_pass_with_cut_rows(case, dtype, hc):
    """K17's plain version (each chunk's partial, the cut rows' partials
    merged under the row's max) against the one-pass segment softmax of
    its twin on the same rounded inputs: the two hubs' rows are cut into
    several chunks; every other row is one chunk."""
    hg, _, _ = case
    tg = _tiling(hg)
    H, Cw = hc
    gen = torch.Generator().manual_seed(4)
    u, v = (torch.randn((N, H * Cw), generator=gen).to(dtype)
            for _ in range(2))
    att = torch.randn((H, Cw), generator=gen)
    work = GV.gatv2_work(tg, N)
    assert work.pair.split_rows.tolist() == [3, 7]
    assert work.n_parts == int(work.part_ptr[-1]) == int(
        (work.pair.chunk_row < 0).sum())
    got = GV.gatv2_attn(tg, u, v, att)
    one = GV._gatv2_twin(tg, u, v, att, slope=0.2)
    _close(got, one, 2e-6)
    mag = GV._gatv2_attn_reference(tg, u, v, att, magnitude=True)
    assert bool((mag >= got.abs() - 1e-6).all())


def test_work_list_partials_follow_the_cut_rows(case):
    """Each cut row's chunks are its partial rows, in chunk order; a chunk
    of an uncut row has none."""
    hg, _, _ = case
    tg = _tiling(hg)
    work = GV.gatv2_work(tg, N)
    row = work.pair.chunk_row.long()
    cut = row < 0
    assert (work.part_of[~cut] == -1).all()
    assert work.part_of[cut].tolist() == list(range(int(cut.sum())))
    for s, r in enumerate(work.pair.split_rows.tolist()):
        mine = torch.nonzero(row == -r - 1).reshape(-1)
        p0, p1 = work.part_ptr[s].item(), work.part_ptr[s + 1].item()
        assert work.part_of[mine].tolist() == list(range(p0, p1))


def test_kernel_shapes():
    """K17's lanes hold 1, 2 or 4 features as H*C is up to 32, 64 or 128;
    several heads need each head on a power of two of lanes."""
    assert GV._kernel_vec(4, 32) == 4
    assert GV._kernel_vec(1, 41) == 2
    assert GV._kernel_vec(2, 8) == 1
    assert GV._kernel_vec(8, 16) == 4
    for bad in ((3, 40), (1, 130), (4, 6)):
        with pytest.raises(ValueError, match="K17"):
            GV._kernel_vec(*bad)


def test_head_dot_through_ir_io():
    """The GATv2 layer's YAML reads back to the same graph: the HEAD_DOT
    compute and its [H, C] weight survive."""
    g = build_op_graph("GATv2", 12, 16, heads=4)
    back = TI.from_yaml(TI.to_yaml(g, n_node=10, n_edge=40), name=g.name)
    assert [(o.op_id, o.kind, o.compute, o.order, o.inputs, o.out_width,
             o.extra) for o in back.ops] == [
        (o.op_id, o.kind, o.compute, o.order, o.inputs, o.out_width,
         o.extra) for o in g.ops]
    assert back.param_specs() == g.param_specs()
    assert GV.find_gatv2_chain(back) is not None


def test_per_op_lowering_of_one_layer_matches_the_reference(case):
    """One layer lowered op by op (``compiler/lower.lower``) is the
    reference's layer, then ELU."""
    hg, rg, x = case
    g = build_op_graph("GATv2", F, HID, heads=HEADS, layer_tag="l0",
                       final_sf="elu")
    p = init_params(g, torch.Generator().manual_seed(5), device=CPU)
    with torch.no_grad():
        got = lower(g)(p, hg.to_device(CPU), x)
        want = torch.nn.functional.elu(RV.layer(x, p, 0, rg))
    _close(got, want, TOL["float32"])


def test_block_span_once_per_layer(case):
    """A request records ``block.gatv2`` once per layer, inside its
    layer's span; on the CPU no kernel launches, so the K17 counters are
    absent."""
    hg, _, x = case
    m, _ = _model()
    fwd = _hybrid(m, hg, torch.bfloat16)
    g = hg.to_device(CPU)
    SP.take()
    with SP.recording(), torch.inference_mode():
        fwd(dict(m.params), g, x)
    rec = SP.take()["spans"]
    blocks = [s for s in rec if s["name"] == "block.gatv2"]
    layers = {s["id"]: s["name"] for s in rec
              if s["name"].startswith("model.layer")}
    assert [layers[b["parent"]] for b in blocks] == ["model.layer0",
                                                     "model.layer1"]
    assert all("gatv2.k17" not in b["counters"] for b in blocks)
