"""The port's spans in a traced window: which span queued each device op.

While the port records (``utils/spans`` of the port) under a profiler,
each of its spans lands in the Chrome trace as a ``user_annotation``
event of the span's name, on the launching thread.  This module reads
only the trace (and, for the set-up table, the recorder's span dicts,
plain data) and imports nothing from the port.

- A port span is an annotation whose name starts with one of
  ``PORT_PREFIXES`` (PyTorch's own annotations, such as the optimizer's
  ``Optimizer.step#...``, are not).
- Each device event (kernel, copy, set) goes to the innermost port span
  open on the launching thread when the runtime or driver call that
  queued it ran (joined by correlation id); on a thread with no port
  span open then (autograd's device thread outside a ``bwd.*`` span),
  to the innermost port span open on the main thread, whose
  ``train.backward`` waits for that thread.
- A unit is one outermost ``model.forward`` or ``train.step`` span (one
  request or one step); the main thread is the one that opens them.

Device time is classed as ``trace.classify`` classes it.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence, Tuple

from gnnbench import trace

PORT_PREFIXES = ("graph.", "lower.", "model.", "block.", "bwd.", "train.")
UNIT_NAMES = ("model.forward", "train.step")
PHASES = ("train.forward", "train.backward", "train.optimizer")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NO_SPAN = "(no port span)"


class _Ann:
    __slots__ = ("name", "start", "end", "tid", "parent", "unit")

    def __init__(self, e: Dict):
        self.name = e["name"]
        self.start = float(e["ts"])
        self.end = self.start + float(e["dur"])
        self.tid = e.get("tid")
        self.parent: Optional[_Ann] = None
        self.unit: Optional[_Ann] = None

    def chain(self) -> List["_Ann"]:
        out, a = [], self
        while a is not None:
            out.append(a)
            a = a.parent
        return out


def _nest(anns: List[_Ann]) -> Dict:
    """Set each annotation's parent among those of its own thread; returns
    the annotations by thread."""
    by_tid: Dict = collections.defaultdict(list)
    for a in anns:
        by_tid[a.tid].append(a)
    for group in by_tid.values():
        group.sort(key=lambda a: (a.start, -a.end))
        stack: List[_Ann] = []
        for a in group:
            while stack and stack[-1].end < a.end:
                stack.pop()
            a.parent = stack[-1] if stack else None
            stack.append(a)
    return by_tid


def _innermost(anns: Sequence[_Ann], times: Sequence[float]
               ) -> List[Optional[_Ann]]:
    """For each time, the open annotation of ``anns`` that started last
    (the innermost where they nest), or None."""
    order = sorted(range(len(times)), key=lambda i: times[i])
    spans = sorted(anns, key=lambda a: a.start)
    out: List[Optional[_Ann]] = [None] * len(times)
    active: List[_Ann] = []
    j = 0
    for i in order:
        t = times[i]
        while j < len(spans) and spans[j].start <= t:
            active.append(spans[j])
            j += 1
        active = [a for a in active if a.end >= t]
        if active:
            out[i] = max(active, key=lambda a: a.start)
    return out


def _union_s(iv: List[Tuple[float, float]]) -> float:
    return trace.busy_us(iv) / 1e6


def attribute(tr: Dict) -> Dict:
    """The traced window by port span: units, each device op's span and
    unit, per-name tables, the step's phases, stalls and idle gaps.  All
    times in seconds; ``None`` where the trace holds no unit span."""
    events = tr["traceEvents"]
    anns = [_Ann(e) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and "dur" in e and e.get("name", "").startswith(PORT_PREFIXES)]
    by_tid = _nest(anns)
    tids = collections.Counter(a.tid for a in anns
                               if a.name in UNIT_NAMES)
    if not tids:
        return None
    main = tids.most_common(1)[0][0]
    mains = by_tid[main]
    orphans = [a for a in anns if a.parent is None and a.tid != main]
    for a, p in zip(orphans, _innermost(mains, [a.start for a in orphans])):
        a.parent = p
    for a in anns:
        outer = [c for c in a.chain() if c.name in UNIT_NAMES]
        a.unit = outer[-1] if outer else None
    units = [a for a in anns if a.unit is a]

    launches = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (e.get("tid"),
                                                  float(e["ts"]))
    dev = trace.device_events(tr)
    ivs = [(e["ts"], e["ts"] + e["dur"]) for e in dev]
    owner: List[Optional[_Ann]] = [None] * len(dev)
    queries: Dict = collections.defaultdict(list)
    for i, e in enumerate(dev):
        at = launches.get(e.get("args", {}).get("correlation"))
        if at is not None:
            queries[at[0]].append((i, at[1]))
    fallback = []
    for tid, qs in queries.items():
        found = _innermost(by_tid.get(tid, []), [t for _, t in qs])
        for (i, t), a in zip(qs, found):
            if a is None and tid != main:
                fallback.append((i, t))
            owner[i] = a
    for (i, _), a in zip(fallback,
                         _innermost(mains, [t for _, t in fallback])):
        owner[i] = a

    n = len(units)
    total_dev = sum(e["dur"] for e in dev) / 1e6
    in_unit = sum(e["dur"] for e, a in zip(dev, owner)
                  if a is not None and a.unit is not None) / 1e6

    # per name: count, host and self time, device time by class (inclusive)
    rows: Dict[str, Dict] = {}

    def row(name):
        return rows.setdefault(name, {"count": 0, "host_s": 0.0,
                                      "self_s": 0.0, "glue": 0.0,
                                      "gemm": 0.0, "kernel": 0.0})
    child_s: Dict[int, float] = collections.defaultdict(float)
    for a in anns:
        if a.parent is not None:
            child_s[id(a.parent)] += a.end - a.start
    for a in anns:
        r = row(a.name)
        r["count"] += 1
        if not any(c.name == a.name for c in a.chain()[1:]):
            r["host_s"] += (a.end - a.start) / 1e6
        r["self_s"] += max(0.0, a.end - a.start - child_s[id(a)]) / 1e6
    for e, a in zip(dev, owner):
        if a is None:
            continue
        cls = trace.classify(e)
        for name in {c.name for c in a.chain()}:
            row(name)[cls] += e["dur"] / 1e6

    # per unit: its device ops' stall, and the step's phases
    unit_iv: Dict[int, List] = collections.defaultdict(list)
    phase_iv: Dict[str, List] = collections.defaultdict(list)
    for iv, a in zip(ivs, owner):
        if a is None or a.unit is None:
            continue
        unit_iv[id(a.unit)].append(iv)
        for name in {c.name for c in a.chain()} & set(PHASES):
            phase_iv[name].append(iv)
    stall = 0.0
    for iv in unit_iv.values():
        lo, hi = min(a for a, _ in iv), max(b for _, b in iv)
        stall += (hi - lo) / 1e6 - _union_s(iv)

    # the window's idle gaps by the innermost port span of the main thread
    u = trace.merged(ivs)
    gaps = [(u[i][1], u[i + 1][0]) for i in range(len(u) - 1)]
    labels = _innermost(mains, [0.5 * (a + b) for a, b in gaps])
    idle: Dict[str, float] = collections.defaultdict(float)
    for (a, b), lab in zip(gaps, labels):
        idle[lab.name if lab is not None else NO_SPAN] += (b - a) / 1e6

    return {"units": n, "unit_names": sorted({a.name for a in units}),
            "device_s": total_dev, "in_unit_s": in_unit,
            "busy_s": _union_s(ivs),
            "stall_s": stall,
            "phase_s": {p: _union_s(phase_iv[p]) for p in PHASES
                        if phase_iv[p]},
            "rows": rows,
            "idle_s": dict(sorted(idle.items(), key=lambda kv: -kv[1]))}


def setup_rows(spans: Sequence[Dict]) -> Dict[str, Dict]:
    """The recorder's spans (``take()["spans"]`` of the port) by name:
    count, seconds (spans inside one of the same name not counted twice),
    self seconds and summed counters."""
    by_id = {s["id"]: s for s in spans}
    kids: Dict[int, float] = collections.defaultdict(float)
    for s in spans:
        if s["parent"] is not None:
            kids[s["parent"]] += (s["end_ns"] - s["start_ns"]) / 1e9
    rows: Dict[str, Dict] = {}
    for s in spans:
        r = rows.setdefault(s["name"], {"count": 0, "s": 0.0,
                                        "self_s": 0.0, "counters": {}})
        r["count"] += 1
        dur = (s["end_ns"] - s["start_ns"]) / 1e9
        p, nested = by_id.get(s["parent"]), False
        while p is not None:
            nested = nested or p["name"] == s["name"]
            p = by_id.get(p["parent"])
        if not nested:
            r["s"] += dur
        r["self_s"] += max(0.0, dur - kids[s["id"]])
        for k, v in s["counters"].items():
            r["counters"][k] = r["counters"].get(k, 0) + v
    return rows


def tables(setup: Dict[str, Dict], att: Optional[Dict]) -> List[str]:
    """The tables an operator reads: set-up by span, the traced window by
    span (per unit), and the window's idle gaps by port span."""
    out = ["set-up spans: name | count | s | self s | counters"]
    for name, r in sorted(setup.items(), key=lambda kv: -kv[1]["s"]):
        cnt = " ".join(f"{k}={v}" for k, v in sorted(r["counters"].items()))
        out.append(f"  {name} | {r['count']} | {r['s']:.4f} | "
                   f"{r['self_s']:.4f} | {cnt}")
    if not att:
        return out + ["traced window: no unit span"]
    n = att["units"]
    out.append(f"traced window, {n} units ({', '.join(att['unit_names'])})"
               ", per unit: name | count | host ms | self ms | device ms "
               "glue / gemm / kernel")
    for name, r in sorted(att["rows"].items(),
                          key=lambda kv: -kv[1]["host_s"]):
        out.append(f"  {name} | {r['count'] / n:g} | "
                   f"{r['host_s'] / n * 1e3:.4f} | "
                   f"{r['self_s'] / n * 1e3:.4f} | "
                   f"{r['glue'] / n * 1e3:.4f} / {r['gemm'] / n * 1e3:.4f}"
                   f" / {r['kernel'] / n * 1e3:.4f}")
    idle = sum(att["idle_s"].values())
    out.append(f"idle gaps by port span on the main thread, per unit "
               f"({idle / n * 1e3:.4f} ms): span | ms | share of idle")
    for name, v in att["idle_s"].items():
        out.append(f"  {name} | {v / n * 1e3:.4f} | "
                   f"{100 * v / idle if idle else 0.0:.1f}%")
    return out


def recorded(record: Dict, part: str, name: str) -> List[Dict]:
    """The spans named ``name`` that the port recorded in ``part`` of a
    run (``setup`` or ``window``); empty where it recorded none."""
    got = (record.get("spans") or {}).get(part) or {}
    return [s for s in got.get("spans", ()) if s["name"] == name]


def seconds(spans: Sequence[Dict]) -> Optional[float]:
    """Summed seconds of ``spans``, None for none."""
    if not spans:
        return None
    return sum(s["end_ns"] - s["start_ns"] for s in spans) / 1e9
