"""Checkpoint and resume of a training state.

Counterpart of the JAX package's ``utils/checkpoint.py`` (orbax): here a
directory holds one ``step_<n>.pt`` file per saved step, written with
``torch.save`` from :meth:`TrainState.state_dict` (parameters, optimizer
moments, step) and read back with ``torch.load(weights_only=True)``, which
loads tensors and plain containers only.
"""
from __future__ import annotations

import os
import re
from typing import Optional

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


def _path(path: str, step: int) -> str:
    return os.path.join(os.path.abspath(path), f"step_{step}.pt")


def latest_step(path: str) -> Optional[int]:
    """The highest step saved under ``path``, or None."""
    if not os.path.isdir(path):
        return None
    steps = [int(m.group(1)) for m in map(_NAME.match, os.listdir(path)) if m]
    return max(steps) if steps else None


def save_state(path: str, state, step: Optional[int] = None) -> int:
    """Save a :class:`~..models.train.TrainState` under ``path``; returns
    the step saved (``state.step`` by default)."""
    s = int(step if step is not None else state.step)
    os.makedirs(path, exist_ok=True)
    tmp = _path(path, s) + ".tmp"
    torch.save(state.state_dict(), tmp)
    os.replace(tmp, _path(path, s))
    return s


def restore_state(path: str, template, step: Optional[int] = None):
    """Load a saved step (the latest by default) into ``template``, a
    freshly built TrainState of the same model and optimizer, and return
    it."""
    s = step if step is not None else latest_step(path)
    if s is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    sd = torch.load(_path(path, s), map_location="cpu", weights_only=True)
    template.load_state_dict(sd)
    return template
