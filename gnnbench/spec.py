"""Finding a cell's files by name.

``BENCHMARK.json`` at the root of the checkout lists the cells; a cell's
configuration is the file its configuration entry names, its traffic mix
``mixes/<traffic>.json``, its correctness limits ``limits/<cell>.json``,
and each per-layer metric a reader ``metrics/<metric>.py``, or
``metrics/<base>.py`` for a metric named ``<base>.<suffix>``.  A family's
work counts and plain reference are ``work/<family>.py`` and
``reference/<family>.py``.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict
    mix: Dict
    chips: int
    end_to_end: List[Dict]      # the metric entries this cell reports
    per_layer: List[Dict]
    limits: Dict[str, float]


def read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(path: Optional[Path] = None) -> Dict:
    return read_json(path or ROOT / "BENCHMARK.json")


def _reports(metric: Dict, cell: str, e2e_of_cell: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:             # per-layer: every cell of its metric
        return metric["moves"] in e2e_of_cell
    return True


def cell(name: str, bench: Optional[Dict] = None) -> Cell:
    bench = bench if bench is not None else load_benchmark()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, [])]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, name, names)]
    return Cell(name=name, config=read_json(ROOT / conf["file"]),
                mix=read_json(HERE / "mixes" / f"{w['traffic']}.json"),
                chips=int(w["chips"]), end_to_end=e2e, per_layer=per_layer,
                limits=read_json(HERE / "limits" / f"{name}.json"))


def _load_file(path: Path, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str) -> Callable[[Dict], Optional[float]]:
    """The ``read(record)`` of a per-layer metric's own file."""
    for stem in (metric, metric.split(".")[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            name = "gnnbench_metric_" + stem.replace(".", "_")
            return _load_file(path, name).read
    raise FileNotFoundError(f"no reader for metric {metric!r} under "
                            f"{HERE / 'metrics'}")


def family(kind: str, name: str):
    """``work/<name>.py`` or ``reference/<name>.py`` as a module."""
    return importlib.import_module(f"gnnbench.{kind}.{name}")
