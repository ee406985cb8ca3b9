"""The device trace of a run, read from a ``torch.profiler`` Chrome trace.

The interval arithmetic and the event reading are copied from the port's
``utils/profile.py`` (``busy_us``, ``device_events``, ``trace_events``) and
frozen here, so that a change there cannot move the yardstick.  Device
time is split three ways by library name patterns alone, so that renaming
a kernel of the port cannot move it from one class to another:

- ``glue``: PyTorch's own kernels (ATen: elementwise, copies, casts,
  reductions, indexing, the loss, the optimizer) and memcpy / memset;
- ``gemm``: matrix products of the vendor libraries (cuBLAS, cuBLASLt,
  CUTLASS);
- ``kernel``: everything else, the port's hand-written kernels.
"""
from __future__ import annotations

import collections
import gzip
import json
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
GLUE_PREFIXES = ("void at::", "at::", "Memcpy", "Memset")
GLUE_PARTS = ("at_cuda_detail", "cunn_", "cub::", "at::native")
GEMM_PARTS = ("gemm", "gemv", "xmma", "nvjet", "cutlass", "cublas")
TOP = 10


def busy_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    busy, cur = 0.0, None
    for a, b in sorted(intervals):
        if cur is None or a > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy


def merged(intervals: Iterable[Tuple[float, float]]
           ) -> List[Tuple[float, float]]:
    """The union of ``(start, end)`` intervals as disjoint sorted ones."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def load(path) -> Dict:
    p = Path(path)
    opener = gzip.open if p.name.endswith(".gz") else open
    with opener(p, "rt") as f:
        return json.load(f)


def device_events(trace: Dict) -> List[Dict]:
    """The device-side events of a chrome trace (kernels, copies, sets)."""
    return [e for e in trace["traceEvents"]
            if e.get("cat") in DEVICE_CATS and "dur" in e]


def host_events(trace: Dict) -> List[Dict]:
    return [e for e in trace["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") in HOST_CATS
            and "dur" in e]


def classify(ev: Dict) -> str:
    """``glue``, ``gemm`` or ``kernel`` for one device event."""
    name = ev.get("name", "")
    if ev.get("cat") in ("gpu_memcpy", "gpu_memset"):
        return "glue"
    if name.startswith(GLUE_PREFIXES) or any(p in name for p in GLUE_PARTS):
        return "glue"
    low = name.lower()
    if any(p in low for p in GEMM_PARTS):
        return "gemm"
    return "kernel"


def _label_gaps(gaps: List[Tuple[float, float]], host: List[Dict]
                ) -> Dict[str, float]:
    """Microseconds of device idle per label: the innermost host event
    (the shortest) that covers a gap's midpoint, else ``host: no traced
    op``."""
    spans = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in host),
                   key=lambda t: t[0])
    out: Dict[str, float] = collections.defaultdict(float)
    active: List[Tuple[float, float, str]] = []
    i = 0
    for a, b in sorted(gaps):           # one sweep: midpoints ascend
        mid = 0.5 * (a + b)
        while i < len(spans) and spans[i][0] <= mid:
            active.append(spans[i])
            i += 1
        active = [sp for sp in active if sp[1] >= mid]
        best = min(active, key=lambda sp: sp[1] - sp[0], default=None)
        out[best[2] if best else "host: no traced op"] += b - a
    return out


def summarize(trace: Dict) -> Dict:
    """Device busy time (union of the device intervals), device time per
    class and per name, and the idle gaps between device work by what the
    host was doing, all in seconds."""
    dev = device_events(trace)
    iv = [(e["ts"], e["ts"] + e["dur"]) for e in dev]
    by_class: Dict[str, float] = {"glue": 0.0, "gemm": 0.0, "kernel": 0.0}
    by_name: Dict[str, float] = collections.defaultdict(float)
    for e in dev:
        by_class[classify(e)] += e["dur"] / 1e6
        by_name[e["name"]] += e["dur"] / 1e6
    u = merged(iv)
    gaps = [(u[i][1], u[i + 1][0]) for i in range(len(u) - 1)]
    labelled = _label_gaps(gaps, host_events(trace))
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    top_gaps = sorted(((k, v / 1e6) for k, v in labelled.items()),
                      key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy_us(iv) / 1e6, "n_device_events": len(dev),
            "by_class": by_class,
            "device_ops": [[k, v] for k, v in top_ops],
            "idle_gaps": [[k, v] for k, v in top_gaps]}
