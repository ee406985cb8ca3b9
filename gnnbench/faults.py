"""Faults planted under the timed path, each a program that a sound check
has to find not correct: a step that leaves its state unchanged, a step
that leaves half of the batch out and takes the mean over the rest, and a
request whose answer is altered where it is produced.  Used by the tests
(at a small size on the CPU) and by ``calibrate.py`` (on the card, at the
cell's own size).  One card, so no exchange between cards can be left
out."""
from __future__ import annotations

import torch

from .program import Program


class UnchangedState(Program):
    """The forward and the loss run; no backward, no update."""

    def step(self, state, x, y, mask):
        from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models import train as TT
        with torch.no_grad():
            loss = TT.masked_cross_entropy(
                self.apply(dict(state.params), self.g, x), y, mask)
        return state, loss


class HalfBatch(Program):
    """Every second training node left out of the loss, whose mean is
    taken over the rest."""

    def step(self, state, x, y, mask):
        keep = torch.cumsum(mask.long(), 0) % 2 == 1
        return super().step(state, x, y, mask & keep)


class AlteredAnswer(Program):
    """Node 0's logits rotated by one class in every request."""

    def serve(self, params, x):
        y = super().serve(params, x).clone()
        y[0] = torch.roll(y[0], 1)
        return y


FAULTS = {"unchanged_state": UnchangedState, "half_batch": HalfBatch,
          "altered_answer": AlteredAnswer}
TRAIN_FAULTS = ("unchanged_state", "half_batch")
SERVE_FAULTS = ("altered_answer",)
