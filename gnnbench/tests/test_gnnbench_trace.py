"""Busy time, idle share, the glue / matrix-product / kernel split and
the idle gaps by host activity, on a synthetic Chrome trace; and the
per-layer readers on the record they read."""
import gzip
import json

import pytest

from gnnbench import spec, trace


def _ev(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


# device work 0-10, 5-15 (overlap), 20-30, 40-45: busy 30 us of a 45 us
# span; the host is in aten::copy_ over 15-20 and in cudaLaunchKernel
# inside aten::mm over 30-40
TRACE = {"traceEvents": [
    _ev("void gta::spmm_tiles_kernel<float>(int const*)", 0, 10),
    _ev("void at::native::vectorized_elementwise_kernel<4>(int)", 5, 10),
    _ev("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n", 20, 10),
    _ev("Memcpy DtoD (Device -> Device)", 40, 5, cat="gpu_memcpy"),
    _ev("aten::copy_", 14, 7, cat="cpu_op"),
    _ev("aten::mm", 28, 14, cat="cpu_op"),
    _ev("cudaLaunchKernel", 31, 8, cat="cuda_runtime"),
    _ev("ProfilerStep", 0, 100, cat="user_annotation"),
    {"ph": "i", "cat": "kernel", "name": "instant", "ts": 3},
]}


def test_busy_is_the_union_of_device_intervals():
    assert trace.busy_us([(0, 10), (5, 15), (20, 30)]) == 25
    assert trace.busy_us([]) == 0
    assert trace.merged([(5, 15), (0, 10), (20, 30)]) == [(0, 15), (20, 30)]


def test_classification_by_library_names():
    cls = [trace.classify(e) for e in trace.device_events(TRACE)]
    assert cls == ["kernel", "glue", "gemm", "glue"]
    assert trace.classify({"name": "void cutlass::Kernel2<cutlass_80_simt_"
                                   "sgemm_128x128_8x4_nn_align1>(x)"}) == "gemm"
    assert trace.classify({"name": "nvjet_hsh_128x256_64x4_2x1_v_bz_coopA"
                                   "_NTN"}) == "gemm"
    assert trace.classify({"name": "void cunn_ClassNLLCriterion_update"
                                   "Output_kernel<float>()"}) == "glue"
    # a kernel of the port keeps its class whatever it is called
    for name in ("void gta::gat_bwd_tail_kernel<x>(int)",
                 "void (anonymous namespace)::gat_dense_wgmma_kernel<>()",
                 "renamed_anything"):
        assert trace.classify({"name": name, "cat": "kernel"}) == "kernel"


def test_summary_busy_classes_and_gaps():
    s = trace.summarize(TRACE)
    assert s["busy_s"] == pytest.approx(30e-6)
    assert s["n_device_events"] == 4
    assert s["by_class"] == pytest.approx({"kernel": 10e-6, "glue": 15e-6,
                                           "gemm": 10e-6})
    assert s["device_ops"][0][1] == pytest.approx(10e-6)
    gaps = dict(s["idle_gaps"])
    # the innermost host event over each gap's middle names it
    assert gaps == pytest.approx({"aten::copy_": 5e-6,
                                  "cudaLaunchKernel": 10e-6})


def test_gap_with_no_host_event():
    t = {"traceEvents": [_ev("k", 0, 1), _ev("k", 5, 1)]}
    assert dict(trace.summarize(t)["idle_gaps"]) == pytest.approx(
        {"host: no traced op": 4e-6})


def test_load_reads_json_and_gzip(tmp_path):
    (tmp_path / "a.json").write_text(json.dumps(TRACE))
    with gzip.open(tmp_path / "b.json.gz", "wt") as f:
        json.dump(TRACE, f)
    assert trace.load(tmp_path / "a.json") == trace.load(
        tmp_path / "b.json.gz") == TRACE


def _record(**over):
    rec = {"units": 100, "wall_s": 1.0, "timers": {"graph_s": 2.5,
                                                    "lower_s": 7.0},
           "work": {"flops": 1e12, "least_s": 1e-4, "peak_flops": 1e15},
           "trace": {"busy_s": 0.09, "window_s": 0.1, "units": 10,
                     "n_device_events": 4,
                     "by_class": {"glue": 0.02, "gemm": 0.03,
                                  "kernel": 0.04}}}
    rec.update(over)
    return rec


def test_readers_on_a_record():
    rec = _record()
    read = {n: spec.reader(n)(rec) for n in (
        "graph_s", "lower_s", "glue_ms.serve", "kernel_ms.train",
        "idle_pct.serve", "roofline_pct.train", "mfu_pct.serve")}
    assert read == pytest.approx({
        "graph_s": 2.5, "lower_s": 7.0, "glue_ms.serve": 2.0,
        "kernel_ms.train": 4.0, "idle_pct.serve": 10.0,
        "roofline_pct.train": 100 * 1e-4 / 9e-3,
        "mfu_pct.serve": 100 * 1e12 / 1e-2 / 1e15})


def test_readers_find_nothing_without_a_trace():
    for n in ("glue_ms.serve", "kernel_ms.serve", "idle_pct.serve",
              "roofline_pct.serve"):
        assert spec.reader(n)(_record(trace=None)) is None


def test_shares_above_100_raise():
    with pytest.raises(ValueError):
        spec.reader("roofline_pct.serve")(
            _record(work={"flops": 1.0, "least_s": 1.0, "peak_flops": 1.0}))
    with pytest.raises(ValueError):
        spec.reader("mfu_pct.train")(
            _record(work={"flops": 1e16, "least_s": 0.0, "peak_flops": 1e15}))
