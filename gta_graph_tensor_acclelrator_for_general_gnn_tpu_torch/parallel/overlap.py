"""Communication / compute overlap, read from a profiler trace.

Counterpart of the JAX package's ``parallel/overlap.py``.  JAX reads
XLA's scheduled HLO (which instructions sit between an async
collective's start and done) and sets TPU compiler options; neither has
a torch twin.  Here overlap is read from what ran: a ``torch.profiler``
trace of a sharded step (``export_chrome_trace``'s JSON):

  * communication windows: gloo's ranges on the host (``gloo:*``, the
    collective's run on gloo's thread) and NCCL's kernels on the device;
  * compute: the device kernels that are not NCCL's;
  * per window, its span and the compute that ran inside it.

:func:`overlap_compiler_options` returns None: no option set to pass.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple, Union


def overlap_compiler_options() -> Optional[Dict[str, str]]:
    """None: PyTorch has no compiler option set for overlap (JAX returns
    its TPU option set on a TPU and None elsewhere)."""
    return None


def _is_comm(ev: dict) -> bool:
    name = ev.get("name", "")
    if name.startswith("gloo:"):
        return True
    return ev.get("cat") == "kernel" and "nccl" in name.lower()


def _is_compute(ev: dict) -> bool:
    return ev.get("cat") == "kernel" and "nccl" not in ev.get(
        "name", "").lower()


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _covered(merged: List[Tuple[float, float]], a: float, b: float) -> float:
    """Length of [a, b] inside the disjoint sorted intervals ``merged``."""
    return sum(max(0.0, min(b, y) - max(a, x)) for x, y in merged)


def overlap_report(trace: Union[str, dict]) -> dict:
    """Overlap of a traced run: ``trace`` is a chrome-trace dict or the
    path of one.  Returns ``{"pairs": [...], "n_windows", "window_us",
    "hidden_us"}``: per communication window its name, start and span
    (us) and the device compute inside it (us, the union of the compute
    kernels' intervals within the window); ``window_us`` is the union of
    all windows, ``hidden_us`` the compute inside that union.
    ``scaling.overlap_fraction`` divides the two."""
    if isinstance(trace, str):
        with open(trace) as f:
            trace = json.load(f)
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    comm = [e for e in events if _is_comm(e)]
    compute = _union([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                      for e in events if _is_compute(e)])
    pairs = []
    for e in sorted(comm, key=lambda e: float(e["ts"])):
        a = float(e["ts"])
        b = a + float(e["dur"])
        pairs.append({"collective": e["name"], "start_us": a,
                      "window_us": b - a,
                      "hidden_us": _covered(compute, a, b)})
    windows = _union([(p["start_us"], p["start_us"] + p["window_us"])
                      for p in pairs])
    return {
        "pairs": pairs,
        "n_windows": len(pairs),
        "window_us": sum(b - a for a, b in windows),
        "hidden_us": sum(_covered(compute, a, b) for a, b in windows),
    }
