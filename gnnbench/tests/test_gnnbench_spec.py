"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name: configuration, mix, limits, metric readers, work counts
and reference."""
import json
import re

import pytest

from gnnbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (spec.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert BENCH["paths"] == ["gnnbench"]
    assert len(BENCH["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert (spec.ROOT / BENCH["command"][1]).is_file()


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("gnnbench/")
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"])
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        names.append(w["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                         "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        names.append(m["name"])
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                         "source", "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
        names.append(m["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads"):
        got = [x["name"] for x in BENCH[group]]
        assert len(got) == len(set(got))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    assert [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]


def test_every_config_used_and_pairs_unique():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_reduced_keys_are_in_the_config_and_no_width():
    for c in BENCH["configs"]:
        cfg = spec.read_json(spec.ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        for k in c["reduced"]:
            assert k in cfg and k in cfg["published"]
            assert not k.endswith(("_dim", "_rank")) and k not in (
                "hidden", "features", "classes", "heads")


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = spec.cell(name)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(spec.reader(m["name"]))
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    fam = cell.config["family"]
    assert hasattr(spec.family("work", fam), "step_ops")
    assert hasattr(spec.family("reference", fam), "forward")
    assert cell.mix["loop"] in ("serve", "train")


def test_per_layer_workloads_report_what_they_move():
    for m in BENCH["per_layer"]:
        for w in m["workloads"]:
            assert w in CELLS
            assert m["moves"] in {e["name"] for e in spec.cell(w).end_to_end}


def test_reader_falls_back_to_the_base_name():
    read = spec.reader("glue_ms.some_later_mix")
    assert read.__module__ == "gnnbench_metric_glue_ms"
    assert read({"trace": None}) is None
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_metric.serve")


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        spec.cell("no_such_cell")


def test_config_files_are_json_objects():
    for c in BENCH["configs"]:
        assert isinstance(json.loads((spec.ROOT / c["file"]).read_text()),
                          dict)
