"""Training: full-batch node classification.

Counterpart of the JAX package's ``models/train.py``: masked
cross-entropy over the training nodes, AdamW with decoupled weight decay
(``optax.adamw`` there, ``torch.optim.AdamW`` here: the same update, bias
correction included), one train step built around ``apply(params, g, x)``,
and an epoch loop reporting loss, accuracies and, on a CUDA device, the
epoch time from CUDA events.  Gradients through schedules run the kernels'
backward when the model was lowered with ``build_transpose=True``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as tF
from torch.utils.checkpoint import checkpoint

from ..data.datasets import Dataset
from ..graph import GraphTensor, resolve_device
from .zoo import Model, build_model


@dataclasses.dataclass
class TrainState:
    """Parameters (updated in place by the optimizer), the optimizer that
    owns their moments, and the number of steps taken."""
    params: Mapping[str, torch.Tensor]
    optimizer: torch.optim.Optimizer
    step: int = 0

    def state_dict(self) -> Dict:
        return {"params": {k: v.detach().clone()
                           for k, v in self.params.items()},
                "optimizer": self.optimizer.state_dict(),
                "step": self.step}

    def load_state_dict(self, sd: Mapping) -> None:
        with torch.no_grad():
            for k, v in sd["params"].items():
                self.params[k].copy_(v)
        self.optimizer.load_state_dict(sd["optimizer"])
        self.step = int(sd["step"])


def adamw(params: Mapping[str, torch.Tensor], lr: float,
          weight_decay: float = 5e-4) -> torch.optim.AdamW:
    """``optax.adamw(lr, weight_decay=...)`` with optax's defaults (betas
    0.9 / 0.999, eps 1e-8 outside the square root)."""
    return torch.optim.AdamW(list(params.values()), lr=lr,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over the masked nodes, in float32."""
    nll = tF.cross_entropy(logits.float(), labels.long(), reduction="none")
    m = mask.float()
    return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)


def accuracy(logits: torch.Tensor, labels: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    m = mask.float()
    hit = (logits.argmax(dim=-1) == labels.long()).float()
    return (hit * m).sum() / torch.clamp(m.sum(), min=1.0)


def make_train_step(apply: Callable, *, remat: bool = False,
                    pmean_axis: Optional[str] = None):
    """Build ``step(state, g, x, y, mask) -> (state, loss)``: one forward,
    backward and optimizer update of ``state.params`` in place.

    ``remat=True`` recomputes the forward in the backward
    (``torch.utils.checkpoint``), trading work for activation memory.
    ``pmean_axis`` (data-parallel gradient averaging) is not ported yet."""
    if pmean_axis is not None:
        raise NotImplementedError(
            "data-parallel training (pmean_axis) is not ported yet: "
            "ROADMAP.md Queue 1 item 12")

    def step(state: TrainState, g: GraphTensor, x: torch.Tensor,
             y: torch.Tensor, mask: torch.Tensor):
        state.optimizer.zero_grad(set_to_none=True)
        params = dict(state.params)
        if remat:
            logits = checkpoint(apply, params, g, x, use_reentrant=False)
        else:
            logits = apply(params, g, x)
        loss = masked_cross_entropy(logits, y, mask)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, loss.detach()

    return step


@dataclasses.dataclass
class FitResult:
    train_loss: float
    train_acc: float
    val_acc: float
    test_acc: float
    epochs: int
    # steady-state per-epoch time from CUDA events, and edges per second
    # from it; None where the run had no CUDA device
    epoch_time_s: Optional[float]
    edges_per_s: Optional[float]


def train_node_classifier(
    ds: Dataset,
    network: str = "GCN",
    *,
    hidden: int = 128,
    n_layers: int = 2,
    heads: int = 4,
    epochs: int = 100,
    lr: float = 1e-2,
    weight_decay: float = 5e-4,
    compute_dtype=None,
    seed: int = 0,
    remat: bool = False,
    model: Optional[Model] = None,
    schedules=None,
    build_transpose: bool = False,
    verbose: bool = False,
    device=None,
) -> Tuple[TrainState, FitResult]:
    """Full-batch training of ``network`` on ``ds`` (one step per epoch);
    returns the final state and metrics.  ``schedules`` route layers
    through the kernels; ``build_transpose`` (with schedules) also splits
    the transposed graph so that the gradients run the kernel backward
    instead of autograd of the full-graph formulation.  ``device`` defaults
    to the CUDA card.  The JAX trainer's
    ``sinput`` (a sparse-input first-layer product) is not ported yet
    (ROADMAP.md Queue 1 item 9): the first layer's dense product computes
    the same values."""
    dev = resolve_device(device)
    model = model or build_model(
        network, ds.x.shape[1], ds.n_class, hidden=hidden,
        n_layers=n_layers, heads=heads,
        generator=torch.Generator().manual_seed(seed), device=dev)
    apply = model.make_apply(compute_dtype, schedules=schedules,
                             host_graph=ds.host_graph if schedules else None,
                             device=dev, build_transpose=build_transpose)
    state = TrainState(model.params,
                       adamw(model.params, lr, weight_decay))
    step = make_train_step(apply, remat=remat)

    g = ds.host_graph.to_device(dev)
    x = torch.as_tensor(ds.x, device=dev)
    y = torch.as_tensor(ds.y, device=dev).long()
    masks = [torch.as_tensor(m, device=dev)
             for m in (ds.train_mask, ds.val_mask, ds.test_mask)]

    state, loss = step(state, g, x, y, masks[0])      # warm-up, untimed
    timer = None
    if dev.type == "cuda":
        timer = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        timer[0].record()
    for e in range(1, epochs):
        state, loss = step(state, g, x, y, masks[0])
        if verbose and e % 20 == 0:
            print(f"epoch {e}: loss {float(loss):.4f}")
    epoch_s = edges_s = None
    if timer is not None and epochs > 1:
        timer[1].record()
        timer[1].synchronize()
        epoch_s = timer[0].elapsed_time(timer[1]) / 1e3 / (epochs - 1)
        edges_s = ds.host_graph.n_edge / epoch_s if epoch_s > 0 else 0.0

    with torch.no_grad():
        logits = apply(dict(state.params), g, x)
        accs = [float(accuracy(logits, y, m)) for m in masks]
    res = FitResult(train_loss=float(loss), train_acc=accs[0],
                    val_acc=accs[1], test_acc=accs[2], epochs=epochs,
                    epoch_time_s=epoch_s, edges_per_s=edges_s)
    return state, res
