"""The work counts against hand counts on a tiny GCN and GAT, and the
least time of the peak table."""
import pytest

from gnnbench import peaks
from gnnbench.work import Op, gat, gcn, totals

CFG = dict(features=6, hidden=4, classes=3, layers=2, heads=2,
           dtype="bfloat16")
N, E = 5, 12


def _by_name(ops):
    return {o.name: o for o in ops}


def test_gcn_forward_by_hand():
    ops = _by_name(gcn.forward_ops(CFG, N, E))
    assert list(ops) == ["mm0", "agg0", "mm1", "agg1"]
    # x W: 2 N F O; x read as float32, W float32, h in bf16
    assert ops["mm0"] == Op("mm0", 2 * 5 * 6 * 4, 5 * 6 * 4 + 6 * 4 * 4
                            + 5 * 4 * 2)
    csr = 4 * 12 + 4 * 6 + 4 * 12     # columns, row pointers, weights
    assert ops["agg0"] == Op("agg0", 2 * 12 * 4, 5 * 4 * 2 + csr + 5 * 4 * 2)
    assert ops["mm1"] == Op("mm1", 2 * 5 * 4 * 3, 5 * 4 * 2 + 4 * 3 * 4
                            + 5 * 3 * 2)
    # the logits come back as float32
    assert ops["agg1"] == Op("agg1", 2 * 12 * 3, 5 * 3 * 2 + csr + 5 * 3 * 4)


def test_gcn_step_by_hand():
    ops = _by_name(gcn.step_ops(CFG, N, E))
    assert list(ops) == ["mm0", "agg0", "mm1", "agg1", "loss", "agg1_bwd",
                         "mm1_bwd_w", "mm1_bwd_x", "agg0_bwd", "mm0_bwd_w",
                         "adamw"]
    assert ops["loss"] == Op("loss", 5 * 5 * 3, 4 * 5 * 3 + 4 * 5 + 5
                             + 4 * 5 * 3)
    assert ops["mm0_bwd_w"].flops == 2 * 5 * 6 * 4
    assert ops["mm1_bwd_x"].bytes == 5 * 3 * 2 + 4 * 3 * 4 + 5 * 4 * 2
    n_params = 6 * 4 + 4 * 3
    assert ops["adamw"] == Op("adamw", 12 * n_params, 28 * n_params)


def test_gat_forward_by_hand():
    ops = _by_name(gat.forward_ops(CFG, N, E))
    assert list(ops) == ["mm0", "proj0", "attn0", "mm1", "proj1", "attn1"]
    csr = 4 * 12 + 4 * 6
    # layer 0: 2 heads of 2; per edge 6 H scalar ops and 2 HD for the sum
    assert ops["proj0"] == Op("proj0", 4 * 5 * 4 * 2, 5 * 4 * 2
                              + 2 * 4 * 2 * 4 + 2 * 5 * 2 * 4)
    assert ops["attn0"] == Op("attn0", 12 * (6 * 2 + 2 * 4) + 5 * 4 * 2,
                              5 * 4 * 2 + 2 * 5 * 2 * 4 + csr + 5 * 4 * 2)
    # last layer: one head, no ELU, float32 logits
    assert ops["attn1"] == Op("attn1", 12 * (6 + 2 * 3) + 5 * 3,
                              5 * 3 * 2 + 2 * 5 * 4 + csr + 5 * 3 * 4)


def test_gat_step_counts_every_parameter_once():
    ops = _by_name(gat.step_ops(CFG, N, E))
    n_params = (6 * 4 + 2 * 4 * 2) + (4 * 3 + 2 * 3 * 1)
    assert ops["adamw"].flops == 12 * n_params
    assert "mm0_bwd_x" not in ops and "mm1_bwd_x" in ops
    assert ops["attn1_bwd"].flops == 12 * (9 + 4 * 3) + 2 * 5 * 3


def test_totals_and_least_time():
    ops = [Op("a", 989e12, 1.0), Op("b", 1.0, 3.35e12)]
    assert totals(ops) == {"flops": 989e12 + 1.0, "bytes": 3.35e12 + 1.0}
    assert peaks.least_seconds(ops, "bfloat16") == pytest.approx(2.0)
    assert peaks.least_seconds([Op("c", 67e12, 0.0)], "float32") == 1.0


def test_counts_do_not_depend_on_anything_but_sizes():
    a = gcn.step_ops(CFG, N, E)
    b = gcn.step_ops(dict(CFG, graph={"seed": 9}, network="GCN"), N, E)
    assert a == b
