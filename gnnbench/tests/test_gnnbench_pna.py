"""The PNA cell's own pieces: the plain reference worked by hand on a
5-node graph and blocked as one pass, the work counts by hand, the two
K13 readers, and the cell at a size a CPU test can hold (its own tiny
configuration): a sound run is correct, an altered answer and the float8
control are not."""
import math

import numpy as np
import pytest
import torch

from gnnbench import calibrate, check, faults, run, spec
from gnnbench.reference import common, pna
from gnnbench.work import Op, gcn, totals
from gnnbench.work import pna as work_pna

CPU = torch.device("cpu")
SEED = 2 ** 31 + 29
# at this size, from its own readings on the CPU (six seeds): served
# logits 0.0040-0.0073 of the float32 reference's largest, the float8
# control 0.073-0.121, an altered answer 1.15
TINY_LIMITS = {"logit_gap": 0.03}

# 0->1, 1->2, 2->0, 3->1, 4->3; communities {0, 1} and {2, 3, 4}
S, R, COM, N = [0, 1, 2, 3, 4], [1, 2, 0, 1, 3], [0, 0, 1, 1, 1], 5


def tiny_cell() -> spec.Cell:
    """``pna2_e11m_serve`` on a 900-node graph of the same generator."""
    cell = spec.cell("pna2_e11m_serve")
    cfg = dict(cell.config, nodes=900, features=24, hidden=16, classes=5,
               edges=9000, split=[500, 100, 300],
               graph=dict(cell.config["graph"], communities=9))
    return spec.Cell(name=cell.name, config=cfg,
                     mix=dict(cell.mix, trace_units=3), chips=1,
                     end_to_end=cell.end_to_end, per_layer=cell.per_layer,
                     limits=TINY_LIMITS)


def test_tiny_limits_compare_the_cells_numbers():
    assert set(TINY_LIMITS) == set(spec.cell("pna2_e11m_serve").limits)


def test_forward_by_hand():
    """Two layers worked out edge by edge in float64: messages x_r W_dst +
    x_s W_src over the edges and self loops, the four aggregators, the
    scalers from the in-degrees, the post-transform, ReLU between."""
    g = common.prepare_graph(torch.tensor(S, dtype=torch.int32),
                             torch.tensor(R, dtype=torch.int32),
                             torch.tensor(COM), N)
    edges = list(zip(S, R)) + [(v, v) for v in range(N)]
    cfg = dict(features=3, hidden=2, classes=2, layers=2)
    rng = np.random.default_rng(0)
    p = {k: rng.standard_normal((i, o)) for k, i, o in pna.param_specs(cfg)}
    x = rng.standard_normal((N, 3))
    deg = np.array([sum(1 for _, r in edges if r == v) for v in range(N)])
    assert deg.tolist() == [2, 3, 2, 2, 1]
    logd = np.log(deg + 1.0)
    amp, att = logd / logd.mean(), logd.mean() / logd

    def layer(h, i):
        w = {k: p[f"pna4_l{i}_{k}"] for k in pna.WEIGHTS}
        a = np.zeros((N, 8))
        for r in range(N):
            m = np.array([h[r] @ w["wdst"] + h[s] @ w["wsrc"]
                          for s, rr in edges if rr == r])
            mean = m.mean(0)
            std = np.sqrt(np.maximum((m * m).mean(0) - mean ** 2, 0) + 1e-5)
            a[r] = np.concatenate([mean, m.min(0), m.max(0), std])
        return (h @ w["wx"] + a @ w["wid"] + amp[:, None] * (a @ w["wamp"])
                + att[:, None] * (a @ w["watt"]))

    want = layer(np.maximum(layer(x, 0), 0), 1)
    got = pna.forward({k: torch.tensor(v, dtype=torch.float32)
                       for k, v in p.items()}, g,
                      torch.tensor(x, dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_blocked_aggregation_equals_one_pass():
    rng = np.random.default_rng(1)
    n, e = 200, 3000
    s, r = rng.integers(0, n, e), rng.integers(0, n, e)
    keep = s != r
    g = common.prepare_graph(torch.as_tensor(s[keep]),
                             torch.as_tensor(r[keep]),
                             torch.zeros(n, dtype=torch.long), n)
    u, v = (torch.tensor(rng.standard_normal((n, 8)), dtype=torch.float32)
            for _ in range(2))
    whole = pna.aggregate(u, v, g, block=10 ** 9)
    for block in (1, 113, 1024):
        torch.testing.assert_close(pna.aggregate(u, v, g, block=block),
                                   whole, rtol=1e-6, atol=1e-6)


CFG = dict(features=6, hidden=4, classes=3, layers=2, dtype="bfloat16")


def test_work_counts_by_hand():
    ops = {o.name: o for o in work_pna.forward_ops(CFG, 5, 12)}
    assert list(ops) == ["mm0", "pair0", "post0", "mm1", "pair1", "post1"]
    # x [W_src | W_dst | W_x]: u, v in bf16, x W_x in float32
    assert ops["mm0"] == Op("mm0", 2 * 5 * 6 * (8 + 4),
                            5 * 6 * 4 + 6 * 12 * 4 + 2 * 5 * 4 * 2
                            + 5 * 4 * 4)
    # u and v once, the CSR (no weights), four float32 aggregates out
    csr = 4 * 12 + 4 * 6
    assert ops["pair0"] == Op("pair0", 6 * 12 * 4 + 8 * 5 * 4,
                              2 * 5 * 4 * 2 + csr + 4 * 5 * 4 * 4)
    assert ops["post0"] == Op("post0", 2 * 5 * 12 * 4 * 4 + 5 * 4 * 6,
                              4 * 5 * 4 * 4 + 5 * 4 * 4 + 2 * 5 * 4
                              + 12 * 4 * 4 * 4 + 5 * 4 * 2)
    # the last layer reads a bf16 input and writes float32 logits, no ReLU
    assert ops["mm1"].bytes == (5 * 4 * 2 + 4 * 11 * 4 + 2 * 5 * 4 * 2
                                + 5 * 3 * 4)
    assert ops["post1"] == Op("post1", 2 * 5 * 12 * 4 * 3 + 5 * 3 * 5,
                              4 * 5 * 4 * 4 + 5 * 3 * 4 + 2 * 5 * 4
                              + 12 * 4 * 3 * 4 + 5 * 3 * 4)
    assert work_pna.LAST_FORWARD_OPS == list(ops.values())


def test_work_counts_depend_on_sizes_alone():
    a = work_pna.step_ops(CFG, 5, 12)
    b = work_pna.step_ops(dict(CFG, graph={"seed": 9}, network="PNA-4x3"),
                          5, 12)
    assert a == b
    names = [o.name for o in a]
    assert names[-1] == "adamw" and "mm0_bwd_x" not in names
    n_params = sum(i * o for _, i, o in pna.param_specs(CFG))
    assert a[-1].flops == 12 * n_params


def _record(ops, device_ops, units=2):
    t = totals(ops)
    return {"work": {**t, "peak_flops": 989e12},
            "trace": {"units": units, "device_ops": device_ops,
                      "busy_s": 1.0, "n_device_events": 1}}


def test_pair_readers():
    """``pair_ms`` sums the trace's K13 entries per forward;
    ``pair_roofline_pct`` is the pair ops' least time over it, None on a
    record whose work is not the last PNA count (a GCN record) or whose
    trace holds no K13, and raises above 100."""
    ms = spec.reader("pair_ms.serve")
    share = spec.reader("pair_roofline_pct.serve")
    n, e = 232965, 11659712
    cfg = dict(CFG, features=602, hidden=128, classes=41)
    ops = work_pna.forward_ops(cfg, n, e)
    k13 = [["void (anonymous namespace)::pair_agg_kernel<...>", 2e-3],
           ["dense_xw_kernel", 1e-3]]
    rec = _record(ops, k13)
    assert ms(rec) == pytest.approx(1.0)
    least = sum(max(o.flops / 989e12, o.bytes / 3.35e12) for o in ops
                if o.name.startswith("pair"))
    assert share(rec) == pytest.approx(100 * least / 1e-3)
    assert 0 < share(rec) < 100
    assert ms(_record(ops, k13[1:])) is None
    assert share(_record(ops, k13[1:])) is None
    gcn_rec = _record(gcn.forward_ops(cfg, n, e), k13)
    assert share(gcn_rec) is None
    assert share({"work": gcn_rec["work"], "trace": None}) is None
    with pytest.raises(ValueError, match="pair roofline"):
        share(_record(ops, [["pair_agg_kernel", 2 * least * 1e-3]], 2000))


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
    """On the CPU no device events: the K13 readers return nothing and
    the line holds the harness's own timers."""
    cell = tiny_cell()
    result, _ = run.run_cell(cell, SEED, 0.2, True, CPU, 0.0)
    assert set(result["metrics"]) == {"graph_s", "lower_s", "mfu_pct.serve"}


@pytest.mark.gpu
def test_tiny_cell_on_the_card():
    """On the card (marker ``gpu``; skips here): the tiny cell on K13 and
    K16 comes out correct, and its traced window reads K13's time and
    roofline share."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result, lines = run.run_cell(tiny_cell(), SEED, 0.5, True,
                                 torch.device("cuda", 0), 0.0)
    assert result["correct"], lines
    assert result["device"]["busy_s"] > 0
    assert result["metrics"]["pair_ms.serve"]["value"] > 0
    assert 0 < result["metrics"]["pair_roofline_pct.serve"]["value"] <= 100
