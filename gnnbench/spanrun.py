"""One cell with the port's spans recorded: the span tables and the
metrics read from the spans.

    python3 gnnbench/spanrun.py --workload <cell> --seed <n> [--seconds <s>]

Runs the cell as ``run.py --trace 1`` does (``run.Run``: the same
set-up, window and traced window) with the port's span recorder on from
before the kernel library loads to the end of the warm-up, off in the
window, and on again in the traced window, whose Chrome trace
``spans.py`` reads.  Standard error gets the tables (set-up by span; the
traced window by span, per request or step; the window's idle gaps by
the port span open on the main thread); the last line of standard
output is one JSON object: each metric of ``METRICS`` that found
something to read, ``units`` (unit spans found in the traced window),
``trace_units`` and ``in_unit_pct`` (the share of device time queued
inside a unit span).  No correctness check: ``run.py`` makes it.

``METRICS`` are read by ``metrics/<name>.py`` from the record
``run.py`` builds plus ``spans`` (the recorder's ``setup`` and ``window``
spans) and ``span_trace`` (``spans.attribute`` of the traced window).
Needs one CUDA card; exits 2 without.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from gnnbench import spans, spec, trace  # noqa: E402
from gnnbench.program import Program  # noqa: E402
from gnnbench.run import Run, sync  # noqa: E402

# (metric, unit, loop or None for both)
METRICS = (("split_s", "s", None), ("transpose_s", "s", "train"),
           ("optimizer_init_s", "s", "train"), ("tail_fill_pct", "%", None),
           ("dispatch_ms.serve", "ms", "serve"),
           ("dispatch_ms.train", "ms", "train"),
           ("stall_ms.serve", "ms", "serve"),
           ("stall_ms.train", "ms", "train"), ("fwd_ms.train", "ms", "train"),
           ("bwd_ms.train", "ms", "train"), ("opt_ms.train", "ms", "train"))


class SpanProgram(Program):
    """The port, with its span recorder switched from the harness."""

    _rec = None

    def record(self, on: bool) -> None:
        """Switch the port's span recorder on or off."""
        from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import spans as port_spans
        if on and self._rec is None:
            self._rec = port_spans.recording()
            self._rec.__enter__()
        elif not on and self._rec is not None:
            self._rec.__exit__(None, None, None)
            self._rec = None

    @staticmethod
    def take_spans() -> dict:
        """The spans and counters recorded since the last call."""
        from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import spans as port_spans
        return port_spans.take()


class SpanRun(Run):
    """``run.Run`` with the recorder on in set-up and the traced window."""

    def __init__(self, cell: spec.Cell, seed: int, device):
        super().__init__(cell, seed, device, SpanProgram)
        self.spans = {}
        self.span_trace = None

    def set_up(self) -> None:
        self.prog.record(True)
        try:
            super().set_up()
        finally:
            self.prog.record(False)
        self.spans["setup"] = self.prog.take_spans()

    def traced(self) -> dict:
        """``Run.traced`` with the recorder on; the loaded trace also goes
        to ``spans.attribute``."""
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        units = self.mix["trace_units"]
        prof = profile(activities=acts)
        sync(self.device)
        self.prog.record(True)
        prof.start()
        try:
            a = time.perf_counter()
            if self.train:
                state = self.state
                for _ in range(units):
                    state, _ = self.prog.step(state, *self.feed)
                sync(self.device)
            else:
                with torch.inference_mode():
                    for i in range(units):
                        self.prog.serve(self.params,
                                        self.pool[i % len(self.pool)])
                        sync(self.device)
            b = time.perf_counter()
        finally:
            prof.stop()
            self.prog.record(False)
        self.spans["window"] = self.prog.take_spans()
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            tr = trace.load(path)
        self.span_trace = spans.attribute(tr)
        summary = trace.summarize(tr)
        summary.update(window_s=b - a, units=units)
        return summary


def run_cell(cell: spec.Cell, seed: int, seconds: float, device,
             t0: float):
    """Set-up, window and traced window of ``cell``: returns (result,
    lines for standard error)."""
    run = SpanRun(cell, seed, device)
    run.set_up()
    run.window(seconds)
    setup_s = run.t_start - t0
    summary = run.traced()
    loop = run.mix["loop"]
    record = {"loop": loop, "units": run.units, "wall_s": run.wall_s,
              "timers": dict(run.prog.timers), "trace": summary,
              "spans": run.spans, "span_trace": run.span_trace}
    metrics = {}
    for name, unit, only in METRICS:
        if only not in (None, loop):
            continue
        v = spec.reader(name)(record)
        if v is not None:
            metrics[name] = {"value": v, "unit": unit}
    att = run.span_trace or {}
    result = {"cell": cell.name, "seed": seed, "metrics": metrics,
              "setup_s": setup_s, "timers": record["timers"],
              "units": att.get("units", 0),
              "trace_units": run.mix["trace_units"],
              "in_unit_pct": (100.0 * att["in_unit_s"] / att["device_s"]
                              if att.get("device_s") else None),
              "busy_ms": summary["busy_s"] / summary["units"] * 1e3}
    lines = spans.tables(spans.setup_rows(run.spans["setup"]["spans"]),
                         run.span_trace)
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("gnnbench: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result, lines = run_cell(cell, args.seed, args.seconds,
                             torch.device("cuda", 0), T0)
    sys.stderr.write("\n".join(lines) + "\n")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
