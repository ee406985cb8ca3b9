"""Build and load the hand-written Hopper kernels under ``csrc/``.

Each ``csrc/*.cu`` source compiles for ``sm_90a`` in its own ``nvcc``
process, all started together (one ``nvcc`` over every source compiles
them one after another: the build would take the sum of the sources'
times instead of the slowest one's), and one more call links them into a
shared library with a plain C interface, loaded with ``ctypes``.  Tensors
pass as ``data_ptr()`` integers and launches go to PyTorch's current
stream.  Every entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on a non-zero code.

No source includes PyTorch's headers, which keeps the build at seconds
instead of minutes; that build time counts against every run that starts
from a clean checkout.  The library is built at first use into
``build/torch_kernels/`` at the repository root, named by a hash of the
sources, so an edited kernel is rebuilt and never loaded stale.  Nothing
here runs at import time: modules import cleanly where no ``nvcc`` exists.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo"]
LINK_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-shared"]

_lib = None
build_seconds = None   # wall seconds of the build this process ran, if any
build_log = ""         # nvcc's output of that build (ptxas register report)

VP, I32, I64, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float

# (name, argtypes) of every C entry point; all return int (a cudaError_t)
_SIGNATURES = {
    "gta_spmm_tiles": [VP, VP, VP, VP, VP, I32, VP, I32, VP,
                       I32, I32, I32, I32, I32, I64, I64, VP],
    "gta_spmm_dense_blocks": [VP, VP, VP, VP, I32, VP, I32, VP,
                              I32, I32, I32, I32, I32, I32, I64, I64, I64,
                              VP],
    "gta_gat_tiles": [VP, VP, VP, VP, VP, I32, VP, I32, VP, VP, VP, VP, VP,
                      VP, VP, I32, I32, I32, I32, I32, I32, I64, I64, I64, F32,
                      VP],
    "gta_gat_dense_blocks": [VP, VP, VP, VP, I32, I32, VP, I32, VP, I64, VP,
                             VP, VP, VP, I32, I32, I32, I32, I32, I32, I64,
                             I64, I64, I64, F32, VP],
    "gta_gat_bwd_tiles_dad": [VP, VP, VP, VP, VP, I32, VP, VP, I32, VP, VP,
                              VP, I32, I32, I32, I32, I32, I32, I64, F32,
                              VP],
    "gta_gat_bwd_tiles_src": [VP, VP, VP, VP, VP, I32, VP, VP, I32, VP, VP,
                              VP, I32, I32, I32, I32, I32, I32, I64, F32,
                              VP],
    "gta_gat_dense_bwd_dad": [VP, VP, VP, VP, I32, VP, VP, I32, VP, VP, VP,
                              I32, I32, I32, I32, I32, I32, I64, VP, VP, I64,
                              I64, F32, VP],
    "gta_gat_dense_bwd_src": [VP, VP, VP, VP, I32, VP, VP, I32, VP, VP, VP,
                              I32, I32, I32, I32, I32, I32, I64, VP, VP, I64,
                              I64, F32, VP],
    "gta_spmm_grouped": [VP, VP, VP, VP, VP, VP, VP, I32, VP, I32, I32, I32,
                         I32, I32, I32, I64, I64, VP],
    "gta_gat_grouped": [VP, VP, VP, VP, VP, VP, VP, I32, VP, VP, VP, VP, VP,
                        VP, I32, I32, I32, I32, I32, I32, I32, I64, I64, I64,
                        F32, VP],
    "gta_sddmm_tiles": [VP, VP, VP, VP, VP, VP, I32, VP, I32, I32, I32, I32,
                        I32, I32, I64, I64, VP],
    "gta_sddmm_grouped": [VP, VP, VP, VP, VP, VP, VP, I32, VP, I32, I32, I32,
                          I32, I32, I32, I32, I32, I64, I64, VP],
    "gta_pair_agg": [VP, VP, VP, VP, VP, I32, VP, VP, VP, VP, VP, I32, I32,
                     I64, I32, F32, I32, F32, VP],
    "gta_pair_agg_finish": [VP, I64, VP, VP, VP, I64, I32, F32, VP],
    "gta_gatv2_attn": [VP, VP, VP, VP, VP, VP, I32, VP, VP, VP, VP, VP, I32,
                       I32, I32, F32, VP],
    "gta_gatv2_attn_finish": [VP, VP, VP, VP, VP, VP, I64, I32, I32, VP],
    "gta_gat_layer": [VP, VP, VP, VP, VP, VP, VP, VP, I32, VP, I64, VP, VP,
                      VP, VP, VP, I32, I32, I32, I32, I64, I32, I32, I32, I32,
                      F32, I32, I64, VP],
    "gta_gat_dense_panel": [VP, VP, VP, VP, I32, I32, VP, I32, VP, I64, VP,
                            VP, VP, VP, I32, I32, I32, I32, I32, I32, I64,
                            I64, I64, I64, I64, I64, VP],
    "gta_dense_xw": [VP, I64, I32, VP, I64, I32, VP, I64, VP, I64, I64, I32,
                     I32, I32, I64, VP],
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cands.append(shutil.which("nvcc") or "")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the Hopper kernels need the CUDA "
                       "toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _build(so: Path, cu) -> str:
    """Compile every source to an object file, all ``nvcc`` processes at
    once, then link them into ``so``; returns the compilers' output."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{p.stem}.o" for p in cu]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-Xptxas=-v", "-c", "-o", str(o), str(p)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for p, o in zip(cu, objs)]
        logs, failed = [], []
        for p, proc in zip(cu, procs):
            out, _ = proc.communicate()
            logs.append(f"== {p.name}\n{out}")
            if proc.returncode != 0:
                failed.append(p.name)
        log = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        part = Path(tmp) / so.name
        res = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(part),
                              *map(str, objs)],
                             capture_output=True, text=True)
        log += res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{log}")
        os.replace(part, so)
    return log


def library() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    cu, cuh = _sources()
    h = hashlib.sha1()
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    so = BUILD_DIR / f"libgta_torch_kernels_{h.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        build_log = _build(so, cu)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.gta_error_string.argtypes = [ctypes.c_int]
    lib.gta_error_string.restype = ctypes.c_char_p
    for name in ("gta_sddmm_tiles_walk", "gta_sddmm_grouped_walk"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib.gta_error_string(rc).decode() if _lib else str(rc)
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, device: torch.device,
            dtypes, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous ``ndim``-d tensor of one of
    ``dtypes`` on ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of "
                        f"{dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-d, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
