"""Run one cell of the benchmark and print its result as one JSON line.

    python3 gnnbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

In order: the cell's files are found by name (``spec.py``) and the inputs
made on the card from the seed (``inputs.py``); the port is set up as its
users set it up (``program.py``) and warmed up on the cell's own shapes;
the window runs for ``--seconds``; with ``--trace 1`` a short traced
window follows; then, with the program's state freed, the plain reference
checks what the window produced (``verify.py``, ``check.py``), and the
last line of standard output is the result.

``serve`` mixes: a closed loop with one request in flight, each request
one full-graph forward under ``torch.inference_mode()`` on a feature
matrix of a pool made at set-up, timed from its start to the synchronise
that ends it.  ``train`` mixes: back-to-back full-batch steps, one
synchronise closing the window.  Needs one CUDA card; exits 2 without.
"""
import time

T0 = time.perf_counter()     # set-up is timed from the start of the process

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from gnnbench import check, inputs, peaks, spec, trace, verify  # noqa: E402
from gnnbench.program import Program  # noqa: E402
from gnnbench.work import totals  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax",
             "gta_graph_tensor_acclelrator_for_general_gnn_tpu")
GIB = 2 ** 30


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (whole names: the port's own name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Run:
    """One cell on one device: set-up, window, trace, check."""

    def __init__(self, cell: spec.Cell, seed: int, device,
                 program_cls=Program):
        self.cell, self.seed = cell, int(seed)
        self.device = torch.device(device)
        self.cfg, self.mix = cell.config, cell.mix
        self.train = self.mix["loop"] == "train"
        self.prog = program_cls(self.cfg, self.device, self.train)

    # -- set-up ------------------------------------------------------------

    def set_up(self) -> None:
        self.set_up_program()
        self.set_up_inputs()

    def set_up_program(self) -> None:
        """The port's set-up on the configuration's graph."""
        cfg, dev, prog = self.cfg, self.device, self.prog
        prog.build_library()
        t0 = time.perf_counter()
        s, r, com = inputs.make_graph(cfg, dev)
        sync(dev)
        prog.timers["make_graph_s"] = time.perf_counter() - t0
        self.perm = prog.build_graph(s, r, com)
        del s, r, com
        prog.lower()
        self.n_edge = prog.g.n_edge

    def set_up_inputs(self) -> None:
        """The seed's weights and inputs, handed to the program, and the
        warm-up on the cell's own shapes."""
        cfg, dev, prog, perm = self.cfg, self.device, self.prog, self.perm
        t0 = time.perf_counter()
        self.weights = verify.weights(cfg, self.seed, dev)
        prog.load(self.weights)
        if self.train:
            x = inputs.make_features(cfg, self.seed, 0, dev)
            y = inputs.make_labels(cfg, self.seed, x)
            mask = inputs.make_train_mask(cfg, self.seed, dev)
            self.feed = (x.index_select(0, perm), y.index_select(0, perm),
                         mask.index_select(0, perm))
            del x, y, mask
            sync(dev)
            t1 = time.perf_counter()
            self.state = prog.new_state()
            self._tracked_steps()
        else:
            self.pool = []
            for j in range(self.mix["pool"]):
                x = inputs.make_features(cfg, self.seed, j, dev)
                self.pool.append(x.index_select(0, perm))
                del x
            sync(dev)
            t1 = time.perf_counter()
            self.params = prog.params()
            with torch.inference_mode():
                for i in range(self.mix["warmup"]):
                    prog.serve(self.params, self.pool[i % len(self.pool)])
        sync(dev)
        prog.timers["inputs_s"] = t1 - t0
        prog.timers["warmup_s"] = time.perf_counter() - t1

    def _tracked_steps(self) -> None:
        """The first steps, through the window's own call and feed; the
        reference follows them."""
        losses, grad = [], None
        for t in range(1, self.mix["tracked_steps"] + 1):
            t0 = time.perf_counter()
            self.state, loss = self.prog.step(self.state, *self.feed)
            losses.append(float(loss))
            self.prog.timers[f"step{t}_s"] = time.perf_counter() - t0
            if t == 1:
                grad = self.prog.first_gradient(self.state)
        delta = {k: (p.detach() - self.weights[k]).clone()
                 for k, p in self.state.params.items()}
        self.tracked = {"losses": losses, "grad": grad, "delta": delta}
        for _ in range(self.mix["warmup"] - self.mix["tracked_steps"]):
            self.state, _ = self.prog.step(self.state, *self.feed)

    # -- the window ----------------------------------------------------------

    def window(self, seconds: float) -> None:
        (self._train_window if self.train else self._serve_window)(seconds)

    def _serve_window(self, seconds: float) -> None:
        rng = random.Random(inputs.sub_seed(self.seed, "sample"))
        k, samples, lat = self.mix["samples"], [], []
        pool, params, serve = self.pool, self.params, self.prog.serve
        with torch.inference_mode():
            self.t_start = time.perf_counter()
            deadline = self.t_start + seconds
            i = 0
            while True:
                j = i % len(pool)
                a = time.perf_counter()
                y = serve(params, pool[j])
                sync(self.device)
                b = time.perf_counter()
                lat.append(b - a)
                if len(samples) < k:
                    samples.append((j, y))
                else:
                    at = rng.randrange(i + 1)
                    if at < k:
                        samples[at] = (j, y)
                i += 1
                if b >= deadline:
                    break
        self.units, self.wall_s, self.latencies = i, b - self.t_start, lat
        self.samples = samples

    def _train_window(self, seconds: float) -> None:
        step, feed = self.prog.step, self.feed
        state = self.state
        self.t_start = time.perf_counter()
        deadline = self.t_start + seconds
        n = 0
        while True:
            state, _ = step(state, *feed)
            n += 1
            if time.perf_counter() >= deadline:
                break
        sync(self.device)
        self.units, self.wall_s = n, time.perf_counter() - self.t_start
        self.state = state

    def traced(self) -> dict:
        """A short window of ``trace_units`` requests or steps under
        ``torch.profiler``; the Chrome trace is read from a temporary
        directory (under ``TMPDIR``) and deleted."""
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        units = self.mix["trace_units"]
        prof = profile(activities=acts)
        sync(self.device)
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
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            summary = trace.summarize(trace.load(path))
        summary.update(window_s=b - a, units=units)
        return summary

    # -- the check -----------------------------------------------------------

    def free_inputs(self) -> None:
        for k in ("pool", "params", "state", "feed"):
            self.__dict__.pop(k, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def free_program(self) -> None:
        self.free_inputs()
        self.prog.free()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def numbers(self) -> dict:
        if self.train:
            return verify.train_numbers(self.cfg, self.seed, self.tracked,
                                        self.device)
        return verify.serve_numbers(self.cfg, self.seed, self.samples,
                                    self.device)


def card_line(device) -> str:
    if device.type != "cuda":
        return "cpu"
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return res.stdout.strip().splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(device)


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device, t0: float, program_cls=Program):
    """Everything of a run but the look for a card and the printing:
    returns (result, lines for standard error)."""
    start_s = time.perf_counter() - t0
    run = Run(cell, seed, device, program_cls)
    run.set_up()
    run.prog.timers["start_s"] = start_s
    run.window(seconds)
    setup_s = run.t_start - t0
    dev = run.device
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    summary = run.traced() if traced else None
    card = card_line(dev)
    work = spec.family("work", run.cfg["family"])
    ops = (work.step_ops if run.train else work.forward_ops)(
        run.cfg, run.cfg["nodes"], run.n_edge)
    record = {"loop": run.mix["loop"], "units": run.units,
              "wall_s": run.wall_s, "timers": dict(run.prog.timers),
              "work": {**totals(ops),
                       "least_s": peaks.least_seconds(ops, run.cfg["dtype"]),
                       "peak_flops": peaks.FLOPS[run.cfg["dtype"]]},
              "trace": summary}
    e2e = {"setup_s": setup_s, "peak_mem_gib": peak / GIB}
    if run.train:
        e2e["step_ms"] = run.wall_s / run.units * 1e3
    else:
        e2e["forward_ms"] = run.wall_s / run.units * 1e3
        lat = sorted(run.latencies)     # nearest rank: 95% at or below
        e2e["forward_p95_ms"] = lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
    run.free_program()
    numbers = run.numbers()
    correct, failed, checks = check.judge(numbers, cell.limits)
    if traced:
        metrics = {}
        for m in cell.per_layer:
            v = spec.reader(m["name"])(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(run.units),
              "failed": int(failed), "metrics": metrics,
              "device": device_info, "card": card}
    if summary is not None:
        device_info.update(busy_s=summary["busy_s"],
                           window_s=summary["window_s"])
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = checks
    info = [f"card: {card}; cell {cell.name}, seed {seed}, "
            f"{run.units} {'steps' if run.train else 'requests'} in "
            f"{run.wall_s!r} s; set-up {setup_s!r} s {run.prog.timers}; "
            f"edges {run.n_edge}"]
    return result, info + check.lines(checks, numbers)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("gnnbench: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"gnnbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result, lines = run_cell(cell, args.seed, args.seconds,
                             bool(args.trace), torch.device("cuda", 0), T0)
    bad = forbidden_modules()
    if bad:
        print(f"gnnbench: JAX modules loaded in the run: {bad}",
              file=sys.stderr)
        return 3
    sys.stderr.write("\n".join(lines) + "\n")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
