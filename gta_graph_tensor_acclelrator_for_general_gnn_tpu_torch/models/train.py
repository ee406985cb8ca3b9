"""Training: full-batch and neighbour-sampled node classification.

Counterpart of the JAX package's ``models/train.py``: masked
cross-entropy over the training nodes, AdamW with decoupled weight decay
(``optax.adamw`` there, ``torch.optim.AdamW`` here: the same update, bias
correction included), one train step built around ``apply(params, g, x)``,
and epoch loops reporting loss, accuracies and, on a CUDA device, the
epoch time.  Gradients through schedules run the kernels' backward when
the model was lowered with ``build_transpose=True``.

Sampled training (:func:`train_sampled`, :func:`train_sampled_scan`)
runs the per-op path on fixed-shape batches of ``data/sampling.py``.
Where the JAX package scans a whole epoch in one dispatch, the port
captures the train step once in a CUDA graph and replays it per batch
(:class:`EpochRunner`).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as tF
from torch.utils.checkpoint import checkpoint

from ..data.datasets import Dataset
from ..graph import GraphTensor, resolve_device
from ..utils.spans import span
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
          weight_decay: float = 5e-4, *,
          capturable: bool = False) -> torch.optim.AdamW:
    """``optax.adamw(lr, weight_decay=...)`` with optax's defaults (betas
    0.9 / 0.999, eps 1e-8 outside the square root).  ``capturable`` keeps
    the step count and bias correction on the device, so that the update
    can be captured in a CUDA graph."""
    with span("train.adamw_init"):
        return torch.optim.AdamW(list(params.values()), lr=lr,
                                 betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=weight_decay,
                                 capturable=capturable)


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


def _process_group(group, what: str):
    """``group`` when it is a ``torch.distributed`` process group, else a
    TypeError naming ``what``."""
    import torch.distributed as dist
    if not isinstance(group, dist.ProcessGroup):
        raise TypeError(f"{what} takes a torch.distributed process group "
                        f"(e.g. dist.group.WORLD), not {group!r}")
    return group


def make_train_step(apply: Callable, *, remat: bool = False,
                    pmean_axis=None):
    """Build ``step(state, g, x, y, mask) -> (state, loss)``: one forward,
    backward and optimizer update of ``state.params`` in place.
    ``step.update(state, g, x, y, mask) -> loss`` is the same work without
    counting ``state.step``: it queues device work only (no host sync), so
    a CUDA graph can capture it.

    ``remat=True`` recomputes the forward in the backward
    (``torch.utils.checkpoint``), trading work for activation memory.
    ``pmean_axis``: a process group (where JAX names a mesh axis) over
    which the step is data-parallel: the gradients and the reported loss
    are averaged over the group before the update, so every rank applies
    the same update."""
    group = (None if pmean_axis is None
             else _process_group(pmean_axis, "pmean_axis"))

    def update(state: TrainState, g: GraphTensor, x: torch.Tensor,
               y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        with span("train.step"):
            # set_to_none queues no device work; the gradients are cleared
            # here, before the forward, so they stay readable after a step
            state.optimizer.zero_grad(set_to_none=True)
            params = dict(state.params)
            with span("train.forward"):
                if remat:
                    logits = checkpoint(apply, params, g, x,
                                        use_reentrant=False)
                else:
                    logits = apply(params, g, x)
                loss = masked_cross_entropy(logits, y, mask)
            with span("train.backward"):
                loss.backward()
                loss = loss.detach()
                if group is not None:
                    from ..parallel.qcomm import all_reduce_, group_size
                    inv = 1.0 / group_size(group)
                    for p in params.values():
                        if p.grad is None:
                            p.grad = torch.zeros_like(p)
                        all_reduce_(p.grad, group).mul_(inv)
                    loss = all_reduce_(loss.reshape(1).clone(), group)[0] * inv
            with span("train.optimizer"):
                state.optimizer.step()
        return loss

    def step(state: TrainState, g: GraphTensor, x: torch.Tensor,
             y: torch.Tensor, mask: torch.Tensor):
        loss = update(state, g, x, y, mask)
        state.step += 1
        return state, loss

    step.update = update
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
    sinput: bool = True,
    build_transpose: bool = False,
    verbose: bool = False,
    device=None,
) -> Tuple[TrainState, FitResult]:
    """Full-batch training of ``network`` on ``ds`` (one step per epoch);
    returns the final state and metrics.  ``schedules`` route layers
    through the kernels; ``sinput`` (with schedules) runs the first
    layer's MM of X on the sparse-input product over X's nonzeros when X
    is below half density (the features are fixed for the run, so baking
    them is sound); ``build_transpose`` (with schedules) also splits
    the transposed graph so that the gradients run the kernel backward
    instead of autograd of the full-graph formulation.  ``device`` defaults
    to the CUDA card."""
    dev = resolve_device(device)
    model = model or build_model(
        network, ds.x.shape[1], ds.n_class, hidden=hidden,
        n_layers=n_layers, heads=heads,
        generator=torch.Generator().manual_seed(seed), device=dev)
    apply = model.make_apply(compute_dtype, schedules=schedules,
                             host_graph=ds.host_graph if schedules else None,
                             x_host=ds.x if (schedules and sinput) else None,
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


# ---------------------------------------------------------------------------
# Neighbour-sampled training

# the index arrays of a sampled batch: int32 on the host, int64 on the device
_INDEX_KEYS = ("senders", "receivers", "ids")
# eager steps before EpochRunner captures: AdamW's state exists after the
# first, and PyTorch's CUDA-graph recipe warms up on a side stream
CAPTURE_WARMUP = 3


def gather_rows(xfull: torch.Tensor, yfull: torch.Tensor, ids: torch.Tensor):
    """Rows of the full features and labels for a batch's node ids,
    zeros where ``ids < 0`` (padding slots), gathered on the device."""
    valid = ids >= 0
    rows = ids.clamp(min=0)
    xb = torch.where(valid[:, None], xfull.index_select(0, rows),
                     xfull.new_zeros(()))
    yb = torch.where(valid, yfull.index_select(0, rows), yfull.new_zeros(()))
    return xb, yb


def make_sampled_update(apply: Callable, state: TrainState, cap_nodes: int,
                        e_pad: int, xfull: Optional[torch.Tensor] = None,
                        yfull: Optional[torch.Tensor] = None,
                        pmean_axis=None):
    """``update(b) -> loss``: one train step of ``state`` on one sampled
    batch ``b`` (a dict of device tensors: ``senders``, ``receivers``
    (int64), ``mask``, ``weight``, ``seed`` and either ``x`` and ``y`` or
    ``ids``, whose rows it gathers from ``xfull`` and ``yfull``).  The
    subgraph's ``n_edge`` is pinned to ``e_pad``; the update queues device
    work only, so :class:`EpochRunner` can capture it.  ``pmean_axis``: a
    process group to average the gradients and loss over
    (:func:`make_train_step`)."""
    base = make_train_step(apply, pmean_axis=pmean_axis).update

    def update(b: Mapping[str, torch.Tensor]) -> torch.Tensor:
        g = GraphTensor(senders=b["senders"], receivers=b["receivers"],
                        edge_mask=b["mask"], edge_weight=b["weight"],
                        n_node=cap_nodes, n_edge=e_pad)
        if "x" in b:
            xb, yb = b["x"], b["y"]
        else:
            xb, yb = gather_rows(xfull, yfull, b["ids"])
        return base(state, g, xb, yb, b["seed"])

    return update


def batch_to_device(arrays: Mapping, device) -> Dict[str, torch.Tensor]:
    """Host batch arrays (numpy, or CPU tensors; one batch, or a stacked
    epoch) on ``device``: one copy per array, from pinned host memory with
    ``non_blocking`` on a CUDA device, on the current stream; the index
    arrays (``senders``, ``receivers``, ``ids``) travel as int32 and widen
    to int64 there."""
    dev = torch.device(device)
    out = {}
    for k, a in arrays.items():
        t = a if torch.is_tensor(a) else torch.from_numpy(
            np.ascontiguousarray(a))
        if dev.type == "cuda":
            if not t.is_pinned():
                t = t.pin_memory()
            t = t.to(dev, non_blocking=True)
        if k in _INDEX_KEYS:
            t = t.long()
        out[k] = t
    return out


class EpochRunner:
    """Runs a sampled ``update`` (:func:`make_sampled_update`) over the
    batches of a stacked epoch on the device.

    ``capture=True`` (a CUDA device): the first ``CAPTURE_WARMUP``
    batches that the runner sees run eagerly on a side stream (they are
    training steps of the run, not repeats); then the update is captured
    once in a
    ``torch.cuda.CUDAGraph`` over static input buffers, and every batch
    from there on is a device-to-device copy into those buffers and one
    replay.  A failed capture raises; nothing falls back to the eager loop
    on the card.  ``capture=False``: the same update in a plain loop (the
    CPU, and the eager yardstick on the card).  The optimizer must be
    capturable (:func:`adamw`) for a capture."""

    def __init__(self, update: Callable, *, capture: bool):
        self.update = update
        self.capture = capture
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.static: Optional[Dict[str, torch.Tensor]] = None
        self.static_loss: Optional[torch.Tensor] = None
        self.eager_steps = 0
        self.replays = 0

    def step(self, b: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """One train step on batch ``b``; the loss as a device tensor (in
        capture mode the graph's output, overwritten by the next step)."""
        if not self.capture:
            self.eager_steps += 1
            return self.update(b)
        if self.static is None:
            self.static = {k: torch.empty_like(v) for k, v in b.items()}
        for k, v in b.items():
            self.static[k].copy_(v)
        if self.graph is None:
            if self.eager_steps < CAPTURE_WARMUP:
                cur = torch.cuda.current_stream()
                side = torch.cuda.Stream()
                side.wait_stream(cur)
                with torch.cuda.stream(side):
                    loss = self.update(self.static)
                cur.wait_stream(side)
                loss.record_stream(cur)
                self.eager_steps += 1
                return loss
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self.static_loss = self.update(self.static)
            self.graph = graph
        self.graph.replay()
        self.replays += 1
        return self.static_loss

    def run(self, stacked: Mapping[str, torch.Tensor], n_steps: int,
            losses: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Train on batches 0..n_steps-1 of ``stacked`` (each array [S,
        ...] on the device); each step's loss goes to ``losses[i]`` when
        given.  Returns the last loss, a device tensor."""
        loss = None
        for i in range(n_steps):
            loss = self.step({k: v[i] for k, v in stacked.items()})
            if losses is not None:
                losses[i].copy_(loss)
        return loss.clone()


def _optimizer_tensors(state: TrainState):
    return [v for p in state.params.values()
            for v in state.optimizer.state.get(p, {}).values()
            if torch.is_tensor(v)]


def snapshot(state: TrainState):
    """Copies of the parameters and the optimizer's state tensors."""
    return [t.detach().clone() for t in (*state.params.values(),
                                         *_optimizer_tensors(state))]


def restore(state: TrainState, snap) -> None:
    """Copy ``snap`` (:func:`snapshot`) back in place, into the same
    tensors, which a captured CUDA graph keeps reading."""
    with torch.no_grad():
        for t, s in zip((*state.params.values(),
                         *_optimizer_tensors(state)), snap, strict=True):
            t.copy_(s)


def device_epoch_seconds(runner: EpochRunner, state: TrainState,
                         stacked: Mapping[str, torch.Tensor],
                         n_steps: int) -> float:
    """Device seconds of one epoch of ``runner``'s steps over ``stacked``:
    the slope between one and three epochs run back to back, timed with
    CUDA events, the least of two rounds; every constant overhead
    cancels.  The steps train, so the parameters and optimizer state are
    snapshotted first and restored after: ``state`` leaves as it came."""
    if next(iter(stacked.values())).device.type != "cuda":
        raise ValueError("device_epoch_seconds needs a CUDA device")
    snap = snapshot(state)

    def epochs_ms(k: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(k):
            runner.run(stacked, n_steps)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    best = float("inf")
    for _ in range(2):
        t1 = epochs_ms(1)
        t3 = epochs_ms(3)
        best = min(best, (t3 - t1) / 2 / 1e3)
    restore(state, snap)
    return max(best, 0.0)


def _prefetched(it: Iterator, depth: int) -> Iterator:
    """Iterate ``it`` in a daemon thread ``depth`` items ahead of the
    consumer; the producer's exception is raised in the consumer, and the
    thread stops when the consumer does."""
    if depth <= 0:
        yield from it
        return
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def produce():
        try:
            for item in it:
                if not put(item):
                    return
            put(end)
        except Exception as ex:  # surface in the consumer, never end the
            put(ex)              # epoch early in silence

    th = threading.Thread(target=produce, daemon=True)
    th.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        th.join()


def _sampled_model(ds: Dataset, network: str, hidden: int, fanouts,
                   seed: int, dev, model: Optional[Model]) -> Model:
    return model or build_model(
        network, ds.x.shape[1], ds.n_class, hidden=hidden,
        n_layers=len(fanouts),
        generator=torch.Generator().manual_seed(seed), device=dev)


def train_sampled(
    ds: Dataset,
    *,
    fanouts=(10, 10),
    batch_size: int = 256,
    epochs: int = 3,
    hidden: int = 128,
    lr: float = 1e-2,
    compute_dtype=None,
    seed: int = 0,
    network: str = "GraphSAGE",
    device_features: Optional[bool] = None,
    prefetch: int = 2,
    eval_full: Optional[bool] = None,
    steps_per_epoch: Optional[int] = None,
    model: Optional[Model] = None,
    device=None,
) -> Tuple[TrainState, FitResult]:
    """Minibatch training with neighbour sampling, one dispatch per step.

    Every batch has the same static shapes, so one train step serves the
    run; the host's work per step is the numpy sampler, run by a
    ``prefetch``-deep producer thread ahead of the device.  The thread
    makes host arrays only (pinned on a CUDA device); the consumer copies
    them to the device on its own stream with ``non_blocking``.

    ``device_features``: keep the full features and labels on the device
    and gather each batch's rows there (only the batch's index and edge
    arrays cross to the device per step); default on above 32 MB of x.
    ``eval_full``: the final full-graph accuracy pass; default on for
    graphs of at most 4M edges.  ``steps_per_epoch`` caps each epoch.
    ``model``: a :class:`Model` whose parameters the caller loaded (else
    one is built from ``seed``).  ``device`` defaults to the CUDA card.

    The first step is untimed; ``epoch_time_s`` is the rest's CUDA-event
    time per epoch (None without a CUDA device), ``edges_per_s`` is
    ``steps_per_epoch * cap_edges / epoch_time_s``."""
    from ..data.sampling import NeighborSampler, gather_features

    dev = resolve_device(device)
    if device_features is None:
        device_features = ds.x.nbytes > 32 * 2**20
    if eval_full is None:
        eval_full = ds.host_graph.n_edge <= 4_000_000

    model = _sampled_model(ds, network, hidden, fanouts, seed, dev, model)
    apply = model.make_apply(compute_dtype)
    state = TrainState(model.params, adamw(model.params, lr, 5e-4))
    sampler = NeighborSampler(ds.host_graph, fanouts, batch_size, seed=seed)
    xfull = yfull = None
    if device_features or eval_full:
        xfull = torch.as_tensor(ds.x, device=dev)
        yfull = torch.as_tensor(ds.y.astype(np.int64), device=dev)
    update = make_sampled_update(apply, state, sampler.cap_nodes,
                                 sampler.e_pad, xfull, yfull)
    train_nodes = np.flatnonzero(ds.train_mask)
    pin = dev.type == "cuda"

    def host_batches():
        for _ in range(epochs):
            n = 0
            for batch in sampler.epoch(train_nodes):
                g = batch.graph
                b = dict(senders=g.senders, receivers=g.receivers,
                         mask=g.edge_mask, weight=g.edge_weight,
                         seed=batch.seed_mask)
                if device_features:
                    b["ids"] = batch.node_ids.astype(np.int32)
                else:
                    valid = batch.node_ids >= 0
                    yb = np.zeros(batch.cap_nodes, np.int64)
                    yb[valid] = ds.y[batch.node_ids[valid]]
                    b["x"] = gather_features(ds.x, batch)
                    b["y"] = yb
                if pin:
                    b = {k: torch.from_numpy(np.ascontiguousarray(v))
                         .pin_memory() for k, v in b.items()}
                yield b
                n += 1
                if steps_per_epoch and n >= steps_per_epoch:
                    break

    n_steps = 0
    loss = None
    timer = None
    for b in _prefetched(host_batches(), prefetch):
        loss = update(batch_to_device(b, dev))
        state.step += 1
        n_steps += 1
        if n_steps == 1 and dev.type == "cuda":
            timer = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            timer[0].record()
    if loss is None:
        raise ValueError(f"no full batch of {batch_size} in the train split")
    steps_ep = max(n_steps // max(epochs, 1), 1)
    epoch_s = edges_s = None
    if timer is not None and n_steps > 1:
        timer[1].record()
        timer[1].synchronize()
        epoch_s = (timer[0].elapsed_time(timer[1]) / 1e3
                   / ((n_steps - 1) / steps_ep))
        edges_s = steps_ep * sampler.cap_edges / epoch_s
    accs = [float("nan")] * 3
    if eval_full:
        g = ds.host_graph.to_device(dev)
        with torch.no_grad():
            logits = apply(dict(state.params), g, xfull)
            accs = [float(accuracy(logits, yfull, torch.as_tensor(m,
                                                                  device=dev)))
                    for m in (ds.train_mask, ds.val_mask, ds.test_mask)]
    res = FitResult(train_loss=float(loss), train_acc=accs[0],
                    val_acc=accs[1], test_acc=accs[2], epochs=epochs,
                    epoch_time_s=epoch_s, edges_per_s=edges_s)
    return state, res


def train_sampled_scan(
    ds: Dataset,
    *,
    fanouts=(10, 10),
    batch_size: int = 512,
    epochs: int = 3,
    hidden: int = 128,
    lr: float = 1e-2,
    compute_dtype=None,
    seed: int = 0,
    network: str = "GraphSAGE",
    steps_per_epoch: Optional[int] = None,
    measure_device_epoch: bool = False,
    mesh=None,
    dp_axis: str = "data",
    model: Optional[Model] = None,
    device=None,
) -> Tuple[TrainState, FitResult, dict]:
    """Sampled training with one host-to-device copy per array and epoch
    and, on a CUDA device, one captured CUDA graph replayed per batch.

    The host samples a whole epoch into stacked [S, ...] arrays (the
    native parallel sampler, ``native.sample_epoch_native``; the numpy
    sampler where the native library is absent), one copy per array ships
    them, and :class:`EpochRunner` trains through them: on the card it
    captures the step after ``CAPTURE_WARMUP`` eager batches of the first
    epoch and replays it; on the CPU it runs the same step in a loop.
    Features
    and labels stay on the device; each step gathers its rows there.  The
    first epoch (warm-up and capture) trains but is not timed.

    Returns ``(state, FitResult, breakdown)``: ``sample_s`` and
    ``h2d_dispatch_s`` are the host seconds per timed epoch spent sampling
    and copying plus dispatching, ``steps_per_epoch``, ``sampler``
    (``"native"`` or ``"numpy"``), ``epoch_losses`` (each epoch's mean
    step loss, read after the timing) and, with ``measure_device_epoch`` (a
    CUDA device only), ``device_epoch_s`` (:func:`device_epoch_seconds`
    over the first epoch's batches; the state is restored after).
    ``epoch_time_s`` is host wall time per timed epoch, ending in a sync.

    ``mesh``: a process group (where JAX names a mesh and its
    ``dp_axis``, which the port ignores) over which training is
    synchronously data-parallel: every rank samples the same epoch,
    global step i feeds rank d its batch i * D + d, and the step averages
    the gradients and the loss over the group before the update
    (:func:`make_train_step`'s ``pmean_axis``).  The epoch is cut to a
    multiple of D batches; fewer than D batches raise.  On a CUDA device
    the all-reduce is captured in the CUDA graph with the step, which
    needs NCCL: a gloo group there raises (gloo's collectives run on the
    host and cannot be captured).  ``steps_per_epoch`` in the breakdown
    counts the epoch's batches over the group."""
    from .. import native
    from ..data.sampling import NeighborSampler

    group = None if mesh is None else _process_group(mesh, "mesh")
    dev = resolve_device(device)
    n_dp, me = 1, 0
    if group is not None:
        import torch.distributed as dist
        if dev.type == "cuda" and dist.get_backend(group) != "nccl":
            raise ValueError(
                "train_sampled_scan(mesh=...) on a CUDA device captures the "
                "step, its all-reduce included, in a CUDA graph; a "
                f"{dist.get_backend(group)} group's collectives cannot be "
                "captured: use an NCCL group (one card per rank), or the CPU")
        n_dp = dist.get_world_size(group)
        me = dist.get_group_rank(group, dist.get_rank())
    if measure_device_epoch and dev.type != "cuda":
        raise ValueError("measure_device_epoch needs a CUDA device")
    model = _sampled_model(ds, network, hidden, fanouts, seed, dev, model)
    apply = model.make_apply(compute_dtype)
    state = TrainState(model.params, adamw(model.params, lr, 5e-4,
                                           capturable=dev.type == "cuda"))
    sampler = NeighborSampler(ds.host_graph, fanouts, batch_size, seed=seed)
    train_nodes = np.flatnonzero(ds.train_mask)
    if len(train_nodes) < batch_size:
        raise ValueError(
            f"batch_size={batch_size} exceeds the train split "
            f"({len(train_nodes)} nodes): no full batch can be sampled")
    cap_n, e_pad = sampler.cap_nodes, sampler.e_pad
    xfull = torch.as_tensor(ds.x, device=dev)
    yfull = torch.as_tensor(ds.y.astype(np.int64), device=dev)
    epoch_counter = [0]
    used = set()

    def stack_epoch():
        """One epoch sampled on the host: the stacked numpy arrays and
        the number of batches, through the native sampler where it built
        (the JAX package's RNG calls, in its order), else numpy."""
        n_steps = len(train_nodes) // batch_size
        if steps_per_epoch:
            n_steps = min(n_steps, steps_per_epoch)
        if native.HAVE_NATIVE:
            perm = sampler.rng.permutation(train_nodes)
            epoch_counter[0] += 1
            stacked = native.sample_epoch_native(
                sampler.row_ptr, sampler.senders,
                perm[: n_steps * batch_size], fanouts, batch_size, cap_n,
                e_pad, seed * 1_000_003 + epoch_counter[0])
            if stacked is not None:
                used.add("native")
                return stacked, n_steps
        gs = []
        for batch in sampler.epoch(train_nodes):
            gs.append(batch)
            if steps_per_epoch and len(gs) >= steps_per_epoch:
                break
        used.add("numpy")
        return dict(
            senders=np.stack([b.graph.senders for b in gs]),
            receivers=np.stack([b.graph.receivers for b in gs]),
            mask=np.stack([b.graph.edge_mask for b in gs]),
            weight=np.stack([b.graph.edge_weight for b in gs]),
            ids=np.stack([b.node_ids.astype(np.int32) for b in gs]),
            seed=np.stack([b.seed_mask for b in gs]),
        ), len(gs)

    runner = EpochRunner(
        make_sampled_update(apply, state, cap_n, e_pad, xfull, yfull,
                            pmean_axis=group),
        capture=dev.type == "cuda")
    epoch_losses = []            # per epoch, the steps' losses (device)

    def run_epoch(stacked, n):
        epoch_losses.append(torch.zeros(n, device=dev))
        loss = runner.run(stacked, n, epoch_losses[-1])
        state.step += n
        return loss

    first_np, n_steps = stack_epoch()
    if n_steps < n_dp:
        raise ValueError(
            f"data parallelism over {n_dp} ranks needs at least {n_dp} "
            f"batches an epoch, got {n_steps} (shrink batch_size or the "
            "group)")
    n_steps = n_steps // n_dp * n_dp

    def own(stacked):
        """This rank's batches of a stacked epoch: me, me + D, ..."""
        return {k: v[me:n_steps:n_dp] for k, v in stacked.items()}

    n_own = n_steps // n_dp
    first = batch_to_device(own(first_np), dev)
    del first_np
    loss = run_epoch(first, n_own)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    sample_s, h2d_s = [], []
    t_all = time.perf_counter()
    for _ in range(max(epochs - 1, 0)):
        t0 = time.perf_counter()
        stacked, _ = stack_epoch()
        sample_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        loss = run_epoch(batch_to_device(own(stacked), dev), n_own)
        h2d_s.append(time.perf_counter() - t0)
    train_loss = float(loss)          # waits for the device queue
    total = time.perf_counter() - t_all
    dt = total / (epochs - 1) if epochs > 1 else None

    breakdown = dict(
        sample_s=float(np.mean(sample_s)) if sample_s else 0.0,
        h2d_dispatch_s=float(np.mean(h2d_s)) if h2d_s else 0.0,
        steps_per_epoch=n_steps,
        sampler="native" if used == {"native"} else "numpy",
        epoch_losses=[float(v.mean()) for v in epoch_losses],
    )
    if measure_device_epoch:
        breakdown["device_epoch_s"] = device_epoch_seconds(
            runner, state, first, n_own)
    res = FitResult(
        train_loss=train_loss, train_acc=float("nan"),
        val_acc=float("nan"), test_acc=float("nan"), epochs=epochs,
        epoch_time_s=dt,
        edges_per_s=n_steps * sampler.cap_edges / dt if dt else None)
    return state, res, breakdown
