"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit) and the least time
the chip could take for a list of ops."""
from __future__ import annotations

from typing import Iterable

# dense FLOP/s by compute dtype; float32 outside the tensor cores
FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def least_seconds(ops: Iterable, dtype: str) -> float:
    """Sum over the ops of the larger of FLOPs at the dtype's peak and
    bytes at the memory's peak."""
    return float(sum(max(o.flops / FLOPS[dtype], o.bytes / HBM_BYTES_PER_S)
                     for o in ops))
