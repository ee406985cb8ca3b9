"""Cells at a size a CPU test can hold: the configurations' families and
mixes on a 900-node graph of the same generator, with limits of this
size's own."""
from __future__ import annotations

import json

from gnnbench import spec

CONFIG = {"gcn": "gcn2_reddit_e11m", "gat": "gat2_reddit_e11m"}
# limits at this size, from its own readings on the CPU (six seeds: the
# port's plain versions in bf16 against the float32 reference, and the
# float8 control): served logits 0.0056 (GCN) and 0.0075 (GAT), control
# 0.074 and 0.085; losses 4.3e-5 and 1.7e-4, control 2.2e-4 and 1.0e-3;
# first-gradient norms 0.0021 and 0.0088, control 0.0098 and 0.034, half
# a batch 0.18 and 0.055; first-gradient differences 0.0051 and 0.023,
# control 0.059 and 0.082, half a batch 0.63 and 0.32; parameter changes
# 0.0035 and 0.012, a state left unchanged 1.0
TINY_LIMITS = {("gcn", "serve"): {"logit_gap": 0.03},
               ("gat", "serve"): {"logit_gap": 0.03},
               ("gcn", "train"): {"loss_gap": 1e-4, "grad_gap": 0.005,
                                  "grad_diff": 0.02, "delta_gap": 0.2},
               ("gat", "train"): {"loss_gap": 4e-4, "grad_gap": 0.02,
                                  "grad_diff": 0.045, "delta_gap": 0.2}}


def tiny_config(family: str) -> dict:
    cfg = spec.read_json(spec.HERE / "configs" / f"{CONFIG[family]}.json")
    cfg.update(nodes=900, features=24, hidden=16, classes=5, edges=9000,
               split=[500, 100, 300],
               graph=dict(cfg["graph"], communities=9))
    return cfg


def tiny_cell(family: str, loop: str) -> spec.Cell:
    """The benchmark's cell of ``family`` and ``loop`` cut to the tiny
    configuration: its metrics as BENCHMARK.json has them, its limits
    this size's."""
    name = f"{family}2_e11m_{loop}"
    cell = spec.cell(name)
    mix = dict(cell.mix, trace_units=3)
    return spec.Cell(name=name, config=tiny_config(family), mix=mix,
                     chips=1, end_to_end=cell.end_to_end,
                     per_layer=cell.per_layer,
                     limits=TINY_LIMITS[(family, loop)])


def last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])
