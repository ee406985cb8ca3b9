"""Start a world of ranks on this machine: the port's counterpart of JAX's
virtual device mesh and of ``jax.distributed``.

:func:`launch` spawns ``world`` processes (``torch.multiprocessing``,
start method ``spawn``), joins them into one process group with an
explicit ``backend`` through a ``file://`` rendezvous in a fresh
temporary directory (no TCP port is picked, so concurrent worlds cannot
collide), gives each rank its device, runs ``fn(rank_ctx, *args)`` there
and returns every rank's result, in rank order.

The backend is an argument and nothing switches it: ``"nccl"`` needs one
card per rank and raises when the world is larger than the cards there
are; ``"gloo"`` runs any number of ranks, on the CPU or on shared cards,
its collectives on the host (``parallel/qcomm.py`` stages CUDA tensors
through pinned host memory).  ``fn`` is pickled by name, so it must live
in an importable module.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
from typing import Any, Callable, List, Optional, Sequence

import torch

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class RankContext:
    """What a rank function receives: its rank, the world size and its
    device."""

    rank: int
    world: int
    device: torch.device


def rank_device(rank: int, device=None) -> torch.device:
    """``cuda:{rank % device_count}``, or ``device`` when given (as
    ``"cpu"``)."""
    if device is not None:
        return torch.device(device)
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device for the ranks; pass device='cpu' "
                           "to run them on the CPU")
    return torch.device("cuda", rank % n)


def check_backend(backend: str, world: int, device=None) -> None:
    """Raise where ``backend`` cannot run ``world`` ranks here: an unknown
    name, or NCCL with more ranks than cards (NCCL refuses two ranks of
    one communicator on one device) or on the CPU."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if backend == "nccl":
        if device is not None and torch.device(device).type != "cuda":
            raise ValueError("the nccl backend runs on CUDA devices only")
        n = torch.cuda.device_count()
        if world > n:
            raise ValueError(
                f"nccl needs one card per rank: world {world} > "
                f"{n} CUDA devices; run more ranks on gloo")


def _rank_main(rank: int, world: int, backend: str, init: str, device,
               threads: Optional[int], out_dir: str, fn: Callable,
               args: Sequence[Any]) -> None:
    import torch.distributed as dist
    if threads:
        torch.set_num_threads(threads)
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = dict(device_id=dev) if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world, **kw)
    try:
        result = fn(RankContext(rank, world, dev), *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, world: int, *, backend: str, args: Sequence = (),
           device=None, threads: Optional[int] = None,
           tmp_dir: Optional[str] = None) -> List[Any]:
    """Run ``fn(RankContext, *args)`` on ``world`` spawned ranks joined
    over ``backend``; returns the ranks' results (``torch.save``-able),
    rank 0 first, tensors on the CPU.  ``device``: None gives rank r
    ``cuda:{r % count}``; ``"cpu"`` keeps every rank on the CPU.
    ``threads``: each rank's ``torch.set_num_threads``.  ``tmp_dir``: where
    the fresh directory of the rendezvous file and the results is made
    (default the system's).  A rank's exception is raised here, with its
    traceback."""
    import torch.multiprocessing as mp
    check_backend(backend, world, device)
    tmp = tempfile.mkdtemp(prefix="gta_world_", dir=tmp_dir)
    try:
        init = "file://" + os.path.join(tmp, "rendezvous")
        mp.start_processes(_rank_main, nprocs=world, join=True,
                           start_method="spawn",
                           args=(world, backend, init, device, threads, tmp,
                                 fn, tuple(args)))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
