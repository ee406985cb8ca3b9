"""The result's last line: its keys, their order, the numbers compared
beside their limits as the last lines of standard error; and no result
without a card or without the port."""
import json
import shutil
import subprocess
import sys

import pytest
import torch

from gnnbench import run, spec
from gnnbench.tests.tiny import tiny_cell

CPU = torch.device("cpu")


@pytest.mark.parametrize("loop", ["serve", "train"])
@pytest.mark.parametrize("traced", [False, True])
def test_last_line_format(loop, traced):
    cell = tiny_cell("gcn", loop)
    result, lines = run.run_cell(cell, 2 ** 31 + 3, 0.2, traced, CPU, 0.0)
    line = json.dumps(result)
    back = json.loads(line)
    assert list(back)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(back)
    assert isinstance(back["correct"], bool)
    assert set(back["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    want = {m["name"]: m["unit"] for m in (cell.per_layer if traced
                                           else cell.end_to_end)}
    for name, m in back["metrics"].items():
        assert set(m) == {"value", "unit"} and m["unit"] == want[name]
        assert isinstance(m["value"], float)
    if traced:
        # the CPU has no device events: those readers return nothing
        assert set(back["metrics"]) == {"graph_s", "lower_s",
                                        f"mfu_pct.{loop}"}
        assert {"busy_s", "window_s"} <= set(back["device"])
        assert set(back["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(back["metrics"]) == set(want)
    tail = lines[-len(cell.limits):]
    for (name, c), text in zip(back["checks"].items(), tail):
        assert c["limit"] == cell.limits[name]
        assert text == f"{name} {c['value']!r} limit {c['limit']!r}"


def test_no_result_without_a_card():
    res = subprocess.run([sys.executable, "gnnbench/run.py", "--workload",
                          "gcn2_e11m_serve", "--seed", "3000000007",
                          "--seconds", "1", "--trace", "0"], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=120)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert res.returncode == 2 and res.stdout == ""


def test_no_result_with_only_the_benchmark(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "gnnbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run([sys.executable, "gnnbench/run.py", "--workload",
                          "gat2_e11m_train", "--seed", "3000000009",
                          "--seconds", "1", "--trace", "1"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and res.stdout == ""


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlike_pkg", sys)
    monkeypatch.setitem(sys.modules, run.FORBIDDEN[-1] + "_torch_x", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, run.FORBIDDEN[-1] + ".graph", sys)
    assert run.forbidden_modules() == [run.FORBIDDEN[-1]]
