"""The numbers that decide ``correct``, and the judgement against limits.

Serving: for a sample of the window's requests, drawn from the seed, the
widest gap between a served logit and the reference's, over the
reference's largest logit magnitude (``logit_gap``).

Training: over the first steps, each step's loss against the reference's
(``loss_gap``, relative), and by the worst leaf the gap between the
program's and the reference's norm of the first gradient (``grad_gap``)
and of each parameter's change after the tracked steps (``delta_gap``),
each over the reference's norm of that leaf or of the median leaf,
whichever is larger.  Leaves whose reference gradient is under a
thousandth of the median leaf's are left out of ``delta_gap``: AdamW moves
them by round-off alone.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, List, Mapping, Tuple

import torch

QUIET_LEAF = 1e-3


def _finite(v: float) -> float:
    return v if math.isfinite(v) else math.inf


def logit_gap(y: torch.Tensor, ref: torch.Tensor) -> float:
    y = y.float()
    if not bool(torch.isfinite(y).all()):
        return math.inf
    return _finite(float((y - ref).abs().max()) / float(ref.abs().max()))


def _norms(leaves: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in leaves.items()}


def leaf_gaps(prog: Mapping[str, torch.Tensor],
              ref: Mapping[str, torch.Tensor],
              keep: Iterable[str]) -> Dict[str, float]:
    """Per leaf: | ||prog|| - ||ref|| | over the larger of ||ref|| and the
    median leaf's ||ref||."""
    pn, rn = _norms(prog), _norms(ref)
    keep = list(keep)
    med = statistics.median(rn[k] for k in keep)
    return {k: _finite(abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30))
            for k in keep}


def leaf_diff(prog: Mapping[str, torch.Tensor],
              ref: Mapping[str, torch.Tensor]) -> float:
    """The worst leaf's ||prog - ref|| over the larger of ||ref|| and the
    median leaf's ||ref||."""
    rn = _norms(ref)
    med = statistics.median(rn.values())
    return _finite(max(float((prog[k].double() - ref[k].double()).norm())
                       / max(rn[k], med, 1e-30) for k in rn))


def leaf_gap(prog: Mapping[str, torch.Tensor],
             ref: Mapping[str, torch.Tensor],
             keep: Iterable[str]) -> float:
    """The worst leaf's gap."""
    return max(leaf_gaps(prog, ref, keep).values())


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``prog`` and ``ref``: {"losses": [...], "grad": {leaf: tensor},
    "delta": {leaf: tensor}}."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                   ref["losses"]))
    gnorm = _norms(ref["grad"])
    med = statistics.median(gnorm.values())
    moving = [k for k, v in gnorm.items() if v >= QUIET_LEAF * med]
    return {"loss_gap": _finite(loss),
            "grad_gap": leaf_gap(prog["grad"], ref["grad"], gnorm),
            "grad_diff": leaf_diff(prog["grad"], ref["grad"]),
            "delta_gap": leaf_gap(prog["delta"], ref["delta"], moving)}


def leaf_readings(prog: Dict, ref: Dict) -> Dict[str, float]:
    """Every leaf's ``grad_gap`` and ``delta_gap``, and their medians over
    the leaves: what ``calibrate.py`` reads to find which leaf a worst
    leaf's gap comes from."""
    out = {}
    for what in ("grad", "delta"):
        gaps = leaf_gaps(prog[what], ref[what], ref[what])
        out.update({f"{what}_gap.{k}": v for k, v in gaps.items()})
        out[f"{what}_gap.median"] = statistics.median(gaps.values())
    return out


def judge(numbers: Dict[str, float], limits: Mapping[str, float]
          ) -> Tuple[bool, int, Dict[str, Dict[str, float]]]:
    """(correct, how many compared numbers failed, {name: {value, limit}})
    over the numbers that have a limit."""
    checks = {k: {"value": numbers[k], "limit": float(limits[k])}
              for k in limits}
    failed = sum(1 for c in checks.values()
                 if not c["value"] <= c["limit"])
    return failed == 0, failed, checks


def lines(checks: Dict[str, Dict[str, float]],
          readings: Dict[str, float]) -> List[str]:
    """One line per number, those compared last, beside their limit."""
    return ([f"{k} {v!r} (not compared)" for k, v in readings.items()
             if k not in checks]
            + [f"{k} {c['value']!r} limit {c['limit']!r}"
               for k, c in checks.items()])
