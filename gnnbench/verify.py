"""The reference's side of a run: it makes the inputs again from the
seed, works out the graph, the normalisation and the permutation itself,
and computes what the program should have produced.  Runs after the
window, once the program's state is freed."""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from . import check, inputs, spec
from .reference import common


def reference_graph(cfg: Dict, device) -> common.RefGraph:
    s, r, com = inputs.make_graph(cfg, device)
    return common.prepare_graph(s, r, com, cfg["nodes"])


def weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    ref = spec.family("reference", cfg["family"])
    return inputs.make_weights(ref.param_specs(cfg), seed, device)


def serve_numbers(cfg: Dict, seed: int,
                  samples: List[Tuple[int, torch.Tensor]], device,
                  rg: common.RefGraph = None) -> Dict[str, float]:
    """``samples``: (pool index, served logits in the program's node
    order) of the requests checked."""
    ref = spec.family("reference", cfg["family"])
    rg = rg if rg is not None else reference_graph(cfg, device)
    w = weights(cfg, seed, device)
    gap = 0.0
    with torch.no_grad():
        for j, y in samples:
            x = inputs.make_features(cfg, seed, j, device)
            want = ref.forward(w, rg, x)
            gap = max(gap, check.logit_gap(y, want[rg.perm]))
            del x, want
    return {"logit_gap": gap}


def train_reference(cfg: Dict, seed: int, steps: int, device,
                    rg: common.RefGraph = None, rounding: str = "float32"
                    ) -> Dict:
    ref = spec.family("reference", cfg["family"])
    rg = rg if rg is not None else reference_graph(cfg, device)
    x = inputs.make_features(cfg, seed, 0, device)
    y = inputs.make_labels(cfg, seed, x)
    mask = inputs.make_train_mask(cfg, seed, device)
    return common.train_steps(ref.forward, weights(cfg, seed, device), rg,
                              x, y, mask, cfg["optimizer"], steps,
                              common.ROUNDING[rounding])


def train_numbers(cfg: Dict, seed: int, prog: Dict, device,
                  rg: common.RefGraph = None) -> Dict[str, float]:
    ref = train_reference(cfg, seed, len(prog["losses"]), device, rg)
    return check.train_numbers(prog, ref)
