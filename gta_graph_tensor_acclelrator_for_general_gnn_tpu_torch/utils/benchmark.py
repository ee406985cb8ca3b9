"""Device timing with CUDA events.

Replaces the JAX package's ``time_layer_device`` (an on-device loop slope
made for a remote TPU).  Here PyTorch returns before the card finishes, so
a call is bracketed by two CUDA events on the current stream, after warm-up
calls, and the median over repeats is reported.  A device time comes only
from a CUDA device: on any other device this raises.
"""
from __future__ import annotations

import statistics
from typing import Callable, List

import torch


def cuda_time_ms(fn: Callable[[], object], *, device="cuda", warmup: int = 2,
                 repeats: int = 10) -> List[float]:
    """Milliseconds of each of ``repeats`` calls of ``fn()``, measured
    between CUDA events."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"device timing needs a CUDA device, got {dev}")
    with torch.cuda.device(dev):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize(dev)
        times = []
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    return times


def median_ms(fn: Callable[[], object], **kw) -> float:
    """Median of :func:`cuda_time_ms`."""
    return float(statistics.median(cuda_time_ms(fn, **kw)))
