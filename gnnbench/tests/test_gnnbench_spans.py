"""The port's spans in a traced window (``spans.py``) on a hand-built
Chrome trace: device ops go to the span that queued them by correlation
id, also from autograd's thread; the stall leaves out the gap between
units; the step's phases cover its busy time.  The span metrics on a
record, and ``spanrun.py`` on the tiny cells on the CPU."""
import pytest
import torch

from gnnbench import spanrun, spans, spec, trace
from gnnbench.tests.tiny import tiny_cell

MAIN, AUTOGRAD = 11, 22


def _ann(name, ts, dur, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "tid": tid}


def _launch(ts, corr, tid=MAIN):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 1, "tid": tid, "args": {"correlation": corr}}


def _kernel(name, ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "tid": 7, "args": {"correlation": corr}}


# two steps.  Step 1 (0-100): the forward's block queues A (10-20); the
# backward's bwd span on autograd's thread queues B (50-60), then that
# thread, outside any span, queues C (62-70); the optimizer queues D
# (90-95) under PyTorch's own annotation.  Step 2 (100-200) queues E
# (150-160) in its forward.  Device idle: 0-10, 20-50, 60-62, 70-90 in
# step 1, 95-150 between the steps.
TRACE = {"traceEvents": [
    _ann("train.step", 0, 100), _ann("train.forward", 0, 30),
    _ann("model.forward", 1, 28), _ann("block.spmm_hybrid", 2, 18),
    _ann("train.backward", 30, 50),
    _ann("bwd.spmm_hybrid", 40, 20, tid=AUTOGRAD),
    _ann("train.optimizer", 80, 15),
    _ann("Optimizer.step#AdamW.step", 81, 13),
    _ann("train.step", 100, 100), _ann("train.forward", 100, 70),
    _ann("model.forward", 101, 68),
    _launch(5, 1), _kernel("void gta::spmm_tiles_kernel<x>()", 10, 10, 1),
    _launch(45, 2, AUTOGRAD),
    _kernel("void gta::spmm_tiles_kernel<x>()", 50, 10, 2),
    _launch(65, 3, AUTOGRAD),
    _kernel("sm90_xmma_gemm_bf16bf16", 62, 8, 3),
    _launch(85, 4), _kernel("void at::native::elementwise<4>()", 90, 5, 4),
    _launch(120, 5), _kernel("void gta::spmm_tiles_kernel<x>()", 150, 10, 5),
]}


def test_ops_go_to_the_span_that_queued_them():
    a = spans.attribute(TRACE)
    assert a["units"] == 2 and a["unit_names"] == ["train.step"]
    assert a["device_s"] == pytest.approx(43e-6)
    assert a["in_unit_s"] == pytest.approx(43e-6)
    rows = a["rows"]
    # A under the block; B under the bwd span; C, queued on autograd's
    # thread outside any span, under the main thread's train.backward
    assert rows["block.spmm_hybrid"]["kernel"] == pytest.approx(10e-6)
    assert rows["bwd.spmm_hybrid"]["kernel"] == pytest.approx(10e-6)
    assert rows["bwd.spmm_hybrid"]["gemm"] == 0.0
    assert rows["train.backward"]["kernel"] == pytest.approx(10e-6)
    assert rows["train.backward"]["gemm"] == pytest.approx(8e-6)
    assert rows["train.optimizer"]["glue"] == pytest.approx(5e-6)
    assert rows["train.step"]["kernel"] == pytest.approx(30e-6)
    assert "Optimizer.step#AdamW.step" not in rows
    assert rows["train.step"]["count"] == 2
    assert rows["train.step"]["host_s"] == pytest.approx(200e-6)
    assert rows["train.forward"]["self_s"] == pytest.approx(
        (30 - 28 + 70 - 68) * 1e-6)


def test_phases_cover_the_busy_time():
    a = spans.attribute(TRACE)
    ph = a["phase_s"]
    assert ph == pytest.approx({"train.forward": 20e-6,
                                "train.backward": 18e-6,
                                "train.optimizer": 5e-6})
    assert sum(ph.values()) == pytest.approx(a["busy_s"])
    assert a["busy_s"] == pytest.approx(
        trace.summarize(TRACE)["busy_s"])


def test_stall_leaves_out_the_gap_between_units():
    a = spans.attribute(TRACE)
    # step 1: 10-95 holds 33 us of ops, 52 idle; step 2: one op, none;
    # the 55 us between the steps is not a stall
    assert a["stall_s"] == pytest.approx(52e-6)
    rec = {"span_trace": a}
    assert spec.reader("stall_ms.train")(rec) == pytest.approx(26e-3)
    assert spec.reader("fwd_ms.train")(rec) == pytest.approx(10e-3)
    assert spec.reader("bwd_ms.train")(rec) == pytest.approx(9e-3)
    assert spec.reader("opt_ms.train")(rec) == pytest.approx(2.5e-3)


def test_idle_gaps_by_the_main_threads_span():
    a = spans.attribute(TRACE)
    # 20-50 (mid 35) and 60-62 (61) in train.backward, 70-90 (80) in
    # train.optimizer, 95-150 (122.5) in step 2's model.forward
    assert a["idle_s"] == pytest.approx({"train.backward": 32e-6,
                                         "train.optimizer": 20e-6,
                                         "model.forward": 55e-6})


def test_no_unit_span_reads_nothing():
    t = {"traceEvents": [_ann("lower.split", 0, 5), _launch(1, 1),
                         _kernel("k", 2, 3, 1)]}
    assert spans.attribute(t) is None
    for name in ("stall_ms.serve", "fwd_ms.train", "split_s",
                 "dispatch_ms.serve", "tail_fill_pct"):
        assert spec.reader(name)({"span_trace": None}) is None


def _sp(name, sid, parent, start, end, unit=None, **counters):
    return {"name": name, "id": sid, "parent": parent, "unit": unit,
            "start_ns": start, "end_ns": end, "tid": MAIN,
            "counters": counters}


SETUP = [
    _sp("graph.build_host_graph", 2, 1, 10, 40),
    _sp("graph.reorder_nodes", 1, None, 0, 50),
    _sp("lower.transpose", 4, 3, 100, 200),
    _sp("lower.split", 5, 3, 200, 1200, dense_edges=30, tail_edges=30,
        tail_slots=40),
    _sp("lower.split", 6, 3, 1200, 1700, dense_edges=0, tail_edges=10,
        tail_slots=40),
    _sp("lower.layer", 3, None, 100, 1800),
    _sp("train.adamw_init", 7, None, 2000, 2500),
]


def test_span_metrics_on_a_record():
    rec = {"spans": {"setup": {"spans": SETUP, "counters": {}},
                     "window": {"spans": [
                         _sp("model.forward", 9, None, 0, 3_000_000, 9),
                         _sp("model.layer0", 10, 9, 1, 2, 9),
                         _sp("model.forward", 11, None, 0, 1_000_000, 11)],
                         "counters": {}}}}
    read = {n: spec.reader(n)(rec) for n in (
        "split_s", "transpose_s", "optimizer_init_s", "tail_fill_pct",
        "dispatch_ms.serve")}
    assert read == pytest.approx({
        "split_s": 1500e-9, "transpose_s": 100e-9,
        "optimizer_init_s": 500e-9, "tail_fill_pct": 50.0,
        "dispatch_ms.serve": 2.0})
    assert all(spec.reader(n)({"spans": None}) is None
               for n in read)


def test_setup_rows_count_a_nested_name_once():
    rows = spans.setup_rows(SETUP + [
        _sp("graph.build_host_graph", 8, None, 60, 70)])
    g = rows["graph.build_host_graph"]
    assert g["count"] == 2 and g["s"] == pytest.approx(40e-9)
    assert rows["graph.reorder_nodes"]["self_s"] == pytest.approx(20e-9)
    assert rows["lower.split"]["counters"] == {
        "dense_edges": 30, "tail_edges": 40, "tail_slots": 80}
    assert rows["lower.layer"]["self_s"] == pytest.approx(100e-9)
    lines = spans.tables(rows, spans.attribute(TRACE))
    assert lines[0].startswith("set-up spans")
    assert any(ln.startswith("  train.backward |") for ln in lines)


@pytest.mark.parametrize("loop", ["serve", "train"])
def test_spanrun_on_the_tiny_cells(loop):
    cell = tiny_cell("gat", loop)
    result, lines = spanrun.run_cell(cell, 2 ** 31 + 11, 0.2,
                                     torch.device("cpu"), 0.0)
    want = {"split_s", "tail_fill_pct", f"dispatch_ms.{loop}"}
    if loop == "train":
        want |= {"transpose_s", "optimizer_init_s"}
    # the CPU has no device events: the device-trace metrics read nothing
    assert set(result["metrics"]) == want
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert result["units"] == result["trace_units"] == 3
    assert result["in_unit_pct"] is None
    assert any("lower.split" in ln for ln in lines)
