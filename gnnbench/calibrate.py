"""The readings that a cell's correctness limits are set from, in one
process on the card at the cell's own size (the graph and the lowering
are built once; every seed makes its own weights and inputs):

- the program, sound, over ``--seeds`` seeds: each a set-up of the seed's
  inputs, a window of ``--seconds`` (serving) or the tracked steps
  (training), and the same numbers a run compares;
- the control over ``--controls`` seeds: the plain reference put in the
  program's place and computed in float8 (e4m3, one scale per tensor)
  against the float32 reference;
- each fault of ``faults.py`` that the cell can have, planted in the
  program, over ``--faults`` seeds.

    python3 gnnbench/calibrate.py --workload <cell> --base-seed <n> [--seeds 12 --controls 3 --faults 3 --seconds 1 --out file.json]

Prints one JSON object: every reading, and per number the largest sound
reading (``lower``), the smallest control reading and each fault's
smallest.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from gnnbench import check, faults, inputs, spec, verify  # noqa: E402
from gnnbench.reference import common  # noqa: E402
from gnnbench.run import Run, sync  # noqa: E402


def say(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f} s] {msg}", file=sys.stderr,
          flush=True)


def program_numbers(run: Run, seed: int, seconds: float, rg) -> dict:
    run.seed = seed
    run.set_up_inputs()
    if run.train:
        ref = verify.train_reference(run.cfg, seed,
                                     len(run.tracked["losses"]), run.device,
                                     rg)
        out = {**check.train_numbers(run.tracked, ref),
               **check.leaf_readings(run.tracked, ref)}
    else:
        run.window(seconds)
        out = verify.serve_numbers(run.cfg, seed, run.samples, run.device,
                                   rg)
        out["requests"] = run.units
    run.free_inputs()
    return out


def control_numbers(run: Run, seed: int, rg) -> dict:
    cfg, dev = run.cfg, run.device
    if run.train:
        steps = run.mix["tracked_steps"]
        low = verify.train_reference(cfg, seed, steps, dev, rg, "fp8")
        ref = verify.train_reference(cfg, seed, steps, dev, rg)
        return {**check.train_numbers(low, ref),
                **check.leaf_readings(low, ref)}
    ref = spec.family("reference", cfg["family"])
    w = verify.weights(cfg, seed, dev)
    samples = []
    with torch.no_grad():
        for j in range(run.mix["samples"]):
            x = inputs.make_features(cfg, seed, j, dev)
            y = ref.forward(w, rg, x, common.ROUNDING["fp8"])[rg.perm]
            samples.append((j, y))
    return verify.serve_numbers(cfg, seed, samples, dev, rg)


def summarize(readings: dict) -> dict:
    out = {}
    for kind, rows in readings.items():
        for row in rows:
            for k, v in row.items():
                if k in ("seed", "requests"):
                    continue
                entry = out.setdefault(k, {})
                if kind == "program":
                    entry["lower"] = max(entry.get("lower", 0.0), v)
                else:
                    entry[kind] = min(entry.get(kind, float("inf")), v)
    return out


def calibrate(cell: spec.Cell, base_seed: int, n_seeds: int,
              n_controls: int, n_faults: int, seconds: float, device
              ) -> dict:
    """Every reading: {"program": [...], "control": [...], <fault>: [...]},
    one dict per seed."""
    run = Run(cell, base_seed, device)
    run.set_up_program()
    rg = verify.reference_graph(run.cfg, run.device)
    sync(run.device)
    say(f"set up {cell.name}: {run.prog.timers}, edges {run.n_edge}")
    seeds = [base_seed + i for i in range(n_seeds)]
    readings = {"program": [], "control": []}
    for s in seeds:
        r = dict(seed=s, **program_numbers(run, s, seconds, rg))
        readings["program"].append(r)
        say(f"program {r}")
    for s in seeds[:n_controls]:
        r = dict(seed=s, **control_numbers(run, s, rg))
        readings["control"].append(r)
        say(f"control {r}")
    sound = type(run.prog)
    for name in (faults.TRAIN_FAULTS if run.train else faults.SERVE_FAULTS):
        run.prog.__class__ = faults.FAULTS[name]
        readings[name] = []
        for s in seeds[:n_faults]:
            r = dict(seed=s, **program_numbers(run, s, seconds, rg))
            readings[name].append(r)
            say(f"{name} {r}")
        run.prog.__class__ = sound
    return readings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--base-seed", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.cell(args.workload)
    readings = calibrate(cell, args.base_seed, args.seeds, args.controls,
                         args.faults, args.seconds, torch.device("cuda", 0))
    result = {"workload": cell.name, "card": torch.cuda.get_device_name(0),
              "readings": readings, "summary": summarize(readings)}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1) + "\n")
    print(json.dumps(result["summary"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
