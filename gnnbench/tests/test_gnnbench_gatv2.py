"""The GATv2 cell's own pieces: the plain reference worked by hand on a
5-node graph and blocked as one pass, the work counts by hand and from
sizes alone, the two K17 readers, and the cell at a size a CPU test can
hold (its own tiny configuration): a sound run is correct, an altered
answer and the float8 control are not."""
import math

import numpy as np
import pytest
import torch

from gnnbench import calibrate, check, faults, run, spec, trace
from gnnbench.reference import common, gatv2
from gnnbench.work import Op, gcn, totals
from gnnbench.work import gatv2 as work_gatv2

CPU = torch.device("cpu")
SEED = 2 ** 31 + 29
# at this size, from its own readings on the CPU (six seeds): served
# logits 0.0030-0.0087 of the float32 reference's largest, the float8
# control 0.079-0.124
TINY_LIMITS = {"logit_gap": 0.03}

# 0->1, 1->2, 2->0, 3->1, 4->3; communities {0, 1} and {2, 3, 4}
S, R, COM, N = [0, 1, 2, 3, 4], [1, 2, 0, 1, 3], [0, 0, 1, 1, 1], 5


def tiny_cell() -> spec.Cell:
    """``gatv2_e11m_serve`` on a 900-node graph of the same generator."""
    cell = spec.cell("gatv2_e11m_serve")
    cfg = dict(cell.config, nodes=900, features=24, hidden=16, classes=5,
               edges=9000, split=[500, 100, 300],
               graph=dict(cell.config["graph"], communities=9))
    return spec.Cell(name=cell.name, config=cfg,
                     mix=dict(cell.mix, trace_units=3), chips=1,
                     end_to_end=cell.end_to_end, per_layer=cell.per_layer,
                     limits=TINY_LIMITS)


def test_tiny_limits_compare_the_cells_numbers():
    assert set(TINY_LIMITS) == set(spec.cell("gatv2_e11m_serve").limits)


def test_configuration_is_gat2s_widths():
    """The configuration runs GATv2 at the GAT-2l cell's widths, heads,
    graph, split and dtype, transform first."""
    v2 = spec.cell("gatv2_e11m_serve").config
    v1 = spec.cell("gat2_e11m_serve").config
    for k in ("nodes", "features", "hidden", "classes", "layers", "heads",
              "edges", "split", "dtype", "graph", "reorder_nodes"):
        assert v2[k] == v1[k], k
    assert (v2["network"], v2["family"]) == ("GATv2", "gatv2")
    assert v2["transform_first"] and v2["reduced"] == ["edges"]


def test_forward_by_hand():
    """Two layers worked out edge by edge in float64: u = x W_l, v = x W_r,
    per head the score a . leaky_relu(u_j + v_i) over the edges and self
    loops, its softmax, the weighted sum of u_j; ELU between."""
    g = common.prepare_graph(torch.tensor(S, dtype=torch.int32),
                             torch.tensor(R, dtype=torch.int32),
                             torch.tensor(COM), N)
    edges = list(zip(S, R)) + [(v, v) for v in range(N)]
    cfg = dict(features=3, hidden=4, classes=2, layers=2, heads=2)
    rng = np.random.default_rng(0)
    p = {k: rng.standard_normal((i, o))
         for k, i, o in gatv2.param_specs(cfg)}
    assert p["gatv2_l0_att"].shape == (2, 2)
    assert p["gatv2_l1_att"].shape == (1, 2)
    x = rng.standard_normal((N, 3))

    def layer(h, i):
        u, v = h @ p[f"gatv2_l{i}_wl"], h @ p[f"gatv2_l{i}_wr"]
        att = p[f"gatv2_l{i}_att"]
        H, C = att.shape
        out = np.zeros((N, H * C))
        for r in range(N):
            js = [s for s, rr in edges if rr == r]
            for k in range(H):
                cols = slice(k * C, (k + 1) * C)
                e = []
                for j in js:
                    z = u[j, cols] + v[r, cols]
                    e.append(att[k] @ np.where(z >= 0, z, 0.2 * z))
                a = np.exp(np.array(e) - max(e))
                a /= a.sum()
                out[r, cols] = sum(w * u[j, cols] for w, j in zip(a, js))
        return out

    h = layer(x, 0)
    want = layer(np.where(h > 0, h, np.expm1(h)), 1)
    got = gatv2.forward({k: torch.tensor(v, dtype=torch.float32)
                         for k, v in p.items()}, g,
                        torch.tensor(x, dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_blocked_attention_equals_one_pass():
    rng = np.random.default_rng(1)
    n, e = 200, 3000
    s, r = rng.integers(0, n, e), rng.integers(0, n, e)
    keep = s != r
    g = common.prepare_graph(torch.as_tensor(s[keep]),
                             torch.as_tensor(r[keep]),
                             torch.zeros(n, dtype=torch.long), n)
    u, v = (torch.tensor(rng.standard_normal((n, 8)), dtype=torch.float32)
            for _ in range(2))
    att = torch.tensor(rng.standard_normal((2, 4)), dtype=torch.float32)
    whole = gatv2.attention(u, v, att, g, block=10 ** 9)
    for block in (1, 113, 1024):
        torch.testing.assert_close(gatv2.attention(u, v, att, g,
                                                   block=block),
                                   whole, rtol=1e-6, atol=1e-6)


CFG = dict(features=6, hidden=8, classes=3, layers=2, heads=2,
           dtype="bfloat16")


def test_work_counts_by_hand():
    ops = {o.name: o for o in work_gatv2.forward_ops(CFG, 5, 12)}
    assert list(ops) == ["mm0", "attn0", "mm1", "attn1"]
    # x [W_l | W_r]: x float32 in, u and v out in bf16
    assert ops["mm0"] == Op("mm0", 2 * 5 * 6 * 16,
                            5 * 6 * 4 + 6 * 16 * 4 + 2 * 5 * 8 * 2)
    # per edge 6 a feature and 4 a head, per node the division and the
    # ELU; u and v, the attention vectors and the CSR (no weights) in,
    # the output out in bf16
    csr = 4 * 12 + 4 * 6
    assert ops["attn0"] == Op("attn0", 12 * (6 * 8 + 4 * 2) + 5 * 8 * 2,
                              2 * 5 * 8 * 2 + 8 * 4 + csr + 5 * 8 * 2)
    # the last layer: one head, a bf16 input, float32 logits, no ELU
    assert ops["mm1"] == Op("mm1", 2 * 5 * 8 * 6,
                            5 * 8 * 2 + 8 * 6 * 4 + 2 * 5 * 3 * 2)
    assert ops["attn1"] == Op("attn1", 12 * (6 * 3 + 4 * 1) + 5 * 3,
                              2 * 5 * 3 * 2 + 3 * 4 + csr + 5 * 3 * 4)
    assert work_gatv2.LAST_FORWARD_OPS == list(ops.values())


def test_work_counts_depend_on_sizes_alone():
    a = work_gatv2.step_ops(CFG, 5, 12)
    b = work_gatv2.step_ops(dict(CFG, graph={"seed": 9}, network="GATv2"),
                            5, 12)
    assert a == b
    names = [o.name for o in a]
    assert names[-1] == "adamw" and "mm0_bwd_x" not in names
    n_params = sum(i * o for _, i, o in gatv2.param_specs(CFG))
    assert a[-1].flops == 12 * n_params
    assert work_gatv2.forward_ops(CFG, 10, 12) != work_gatv2.forward_ops(
        CFG, 5, 12)


def _record(ops, device_ops, units=2):
    t = totals(ops)
    return {"work": {**t, "peak_flops": 989e12},
            "trace": {"units": units, "device_ops": device_ops,
                      "busy_s": 1.0, "n_device_events": 1}}


def test_gatv2_readers():
    """``gatv2_ms`` sums the trace's K17 entries (the walk and its
    finishing kernel) per forward; ``gatv2_roofline_pct`` is the attn ops'
    least time over it, None on a record whose work is not the last GATv2
    count (a GCN record) or whose trace holds no K17, and raises above
    100."""
    ms = spec.reader("gatv2_ms.serve")
    share = spec.reader("gatv2_roofline_pct.serve")
    n, e = 232965, 11659712
    cfg = dict(CFG, features=602, hidden=128, classes=41, heads=4)
    ops = work_gatv2.forward_ops(cfg, n, e)
    k17 = [["void (anonymous namespace)::gatv2_attn_kernel<...>", 2.9e-3],
           ["(anonymous namespace)::gatv2_finish_kernel(...)", 0.1e-3],
           ["dense_xw_kernel", 1e-3]]
    rec = _record(ops, k17)
    assert ms(rec) == pytest.approx(1.5)
    least = sum(max(o.flops / 989e12, o.bytes / 3.35e12) for o in ops
                if o.name.startswith("attn"))
    assert share(rec) == pytest.approx(100 * least / 1.5e-3)
    assert 0 < share(rec) < 100
    assert ms(_record(ops, k17[2:])) is None
    # a full list of the heaviest ops without the finishing kernel may
    # have dropped it: no reading; a shorter list holds every op, so the
    # walk alone is the whole of K17 there
    walk = k17[:1] + k17[2:]
    assert ms(_record(ops, walk)) == pytest.approx(1.45)
    full = walk + [[f"op{i}", 1e-6] for i in range(trace.TOP - len(walk))]
    assert ms(_record(ops, full)) is None
    assert share(_record(ops, full)) is None
    assert ms(_record(ops, k17 + full[2:-1])) == pytest.approx(1.5)
    assert share(_record(ops, k17[2:])) is None
    assert ms({"work": rec["work"], "trace": None}) is None
    gcn_rec = _record(gcn.forward_ops(cfg, n, e), k17)
    assert share(gcn_rec) is None
    with pytest.raises(ValueError, match="gatv2 roofline"):
        share(_record(ops, [["gatv2_attn_kernel", 2 * least * 1e-3]], 2000))


def _run(program_cls=run.Program):
    return run.run_cell(tiny_cell(), SEED, 0.2, False, CPU, 0.0,
                        program_cls)


def test_sound_run_is_correct():
    result, lines = _run()
    assert result["correct"] and result["failed"] == 0, lines
    assert result["attempted"] > 0


def test_altered_answer_is_not_correct():
    result, lines = _run(faults.FAULTS["altered_answer"])
    assert not result["correct"] and result["failed"] >= 1, lines


def test_control_is_not_correct():
    cell = tiny_cell()
    r = run.Run(cell, SEED, CPU)
    r.set_up_program()
    rg = calibrate.verify.reference_graph(cell.config, CPU)
    numbers = calibrate.control_numbers(r, SEED, rg)
    correct, failed, _ = check.judge(numbers, cell.limits)
    assert not correct and failed >= 1, numbers
    assert math.isfinite(numbers["logit_gap"])


def test_traced_run_reads_what_the_cpu_can():
    """On the CPU no device events: the K17 readers return nothing and
    the line holds the harness's own timers."""
    cell = tiny_cell()
    result, _ = run.run_cell(cell, SEED, 0.2, True, CPU, 0.0)
    assert set(result["metrics"]) == {"graph_s", "lower_s", "mfu_pct.serve"}


@pytest.mark.gpu
def test_tiny_cell_on_the_card():
    """On the card (marker ``gpu``; skips here): the tiny cell on K17 and
    K16 comes out correct, and its traced window reads K17's time and
    roofline share."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result, lines = run.run_cell(tiny_cell(), SEED, 0.5, True,
                                 torch.device("cuda", 0), 0.0)
    assert result["correct"], lines
    assert result["device"]["busy_s"] > 0
    assert result["metrics"]["gatv2_ms.serve"]["value"] > 0
    assert 0 < result["metrics"]["gatv2_roofline_pct.serve"]["value"] <= 100
