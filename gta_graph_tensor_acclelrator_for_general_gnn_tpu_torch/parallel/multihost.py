"""Multi-node start-up and the full-batch distributed trainer.

Counterpart of the JAX package's ``parallel/multihost.py``.  Each process
(one per card) calls :func:`init_multihost`, which joins the process group
of ``torch.distributed``; then :func:`train_multihost` builds the
hierarchical partition (``parallel/mesh2d.py``: the intra-node halo over
NVLink, the deduplicated inter-node exchange over the NICs), puts the
calling rank's shard on its card and steps the sharded train step.  One
process on its own is a world of one.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple


def init_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
) -> Tuple[int, int]:
    """Join the default process group (idempotent) and return ``(rank,
    world)``.

    With ``coordinator_address`` (host:port) the rendezvous is
    ``tcp://`` there, with ``num_processes`` and ``process_id``; without
    it, ``env://`` from ``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` /
    ``WORLD_SIZE`` when they are set (torchrun sets them).  With neither
    the process is a world of one (an in-memory store: nothing on
    disk).  ``backend``: default NCCL where CUDA is available, else
    gloo."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if coordinator_address:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes "
                             "and process_id")
        dist.init_process_group(backend,
                                init_method=f"tcp://{coordinator_address}",
                                world_size=int(num_processes),
                                rank=int(process_id))
    elif all(k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT",
                                       "RANK", "WORLD_SIZE")):
        dist.init_process_group(backend, init_method="env://")
    else:
        if num_processes not in (None, 1):
            raise ValueError(f"{num_processes} processes need a coordinator "
                             "address or the env:// variables")
        dist.init_process_group(backend, store=dist.HashStore(),
                                world_size=1, rank=0)
    return dist.get_rank(), dist.get_world_size()


def train_multihost(
    ds,
    network: str = "GCN",
    *,
    hidden: int = 128,
    n_layers: int = 2,
    heads: int = 4,
    epochs: int = 20,
    lr: float = 1e-2,
    compute_dtype=None,
    seed: int = 0,
    mesh=None,
    verbose: bool = False,
    device=None,
) -> Tuple[float, List[float]]:
    """Full-batch distributed training over a (nodes x cards) mesh; every
    rank of the default group calls it with the same arguments.

    ``mesh``: a :class:`~.mesh2d.Mesh2D`; by default nodes x cards from
    ``LOCAL_WORLD_SIZE`` (cards a node; the whole world when unset).
    ``device``: the rank's device (default its card,
    ``launch.rank_device``).  Adam at ``lr`` (AdamW without weight decay,
    as JAX's ``optax.adam``), parameters from ``seed`` on every rank.
    Returns ``(final_loss, losses)``, one loss per epoch (JAX keeps only
    the last and returns the state in place of the list)."""
    import torch
    import torch.distributed as dist

    from ..models.train import TrainState, adamw
    from ..models.zoo import build_model
    from .dist import make_sharded_train_step, shard_rows
    from .launch import rank_device
    from .mesh2d import make_mesh2d, partition_graph_2d

    if epochs < 1:
        raise ValueError(f"epochs={epochs}: train_multihost needs at least "
                         "one epoch to report a loss")
    if not dist.is_initialized():
        raise RuntimeError("train_multihost runs on every rank of an "
                           "initialized process group: call "
                           "init_multihost (or launch a world) first")
    rank, world = dist.get_rank(), dist.get_world_size()
    if mesh is None:
        dc = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        mesh = make_mesh2d(world // dc, dc)
    dev = rank_device(rank, device)

    model = build_model(network, ds.x.shape[1], ds.n_class, hidden=hidden,
                        n_layers=n_layers, heads=heads,
                        generator=torch.Generator().manual_seed(seed),
                        device=dev)
    part = partition_graph_2d(ds.host_graph, mesh.d_host, mesh.d_chip)
    sh = part.shard(rank, dev)
    x = torch.as_tensor(shard_rows(ds.x, part, rank), device=dev)
    y = torch.as_tensor(shard_rows(ds.y, part, rank), device=dev)
    m = torch.as_tensor(shard_rows(ds.train_mask, part, rank), device=dev)

    state = TrainState(model.params, adamw(model.params, lr,
                                           weight_decay=0.0))
    step = make_sharded_train_step(model.layers, mesh,
                                   compute_dtype=compute_dtype)
    losses = []
    for e in range(epochs):
        state, loss = step(state, sh, x, y, m)
        losses.append(float(loss))
        if verbose and rank == 0 and e % 5 == 0:
            print(f"epoch {e}: loss {losses[-1]:.4f}", flush=True)
    return losses[-1], losses
