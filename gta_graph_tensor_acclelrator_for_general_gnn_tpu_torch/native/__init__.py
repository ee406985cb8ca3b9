"""ctypes loader for the native host library (``tiler.cpp``,
``sampler.cpp``, ``cluster.cpp``).

Counterpart of the JAX package's ``native/__init__.py``, with its ctypes
signatures, its id validation and its self-test.  The library is built at
first use, never at import: one ``g++`` call with the JAX Makefile's flags
(``-O3 -march=native -fPIC -std=c++17 -shared ... -lpthread``) into
``build/native/`` at the repository root, named by a hash of the sources,
the flags and the compiler's predefined macros under ``-march=native``
(so a library built for another CPU is never loaded).  No ``.so`` is
committed.

Every entry point returns None when the library is unavailable, and the
callers (``graph.build_host_graph``, ``graph.tile_graph``,
``graph.cluster_labels``, ``models/train.train_sampled_scan``) then take
their numpy formulations, which are also the parity oracle.  The choice
is visible: ``HAVE_NATIVE`` says whether the library built and passed its
self-test, ``BUILD_ERROR`` why not (None when it did); both resolve on
first access.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

SRC_DIR = Path(__file__).resolve().parent
SOURCES = ("tiler.cpp", "sampler.cpp", "cluster.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX = "g++"
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall"]

build_seconds: Optional[float] = None   # wall seconds of this process's build

_lock = threading.Lock()
_lib = None
_error: Optional[str] = None
_resolved = False


def _target_macros(cxx: str) -> bytes:
    """The compiler's predefined macros under ``-march=native``: the ISA
    extensions a ``-march=native`` build may use on this host."""
    res = subprocess.run([cxx, "-march=native", "-E", "-dM", "-x", "c++",
                          os.devnull], capture_output=True, timeout=60)
    return res.stdout


def _build(so: Path, cxx: str) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        part = Path(tmp) / so.name
        res = subprocess.run(
            [cxx, *CXXFLAGS, "-shared", "-o", str(part),
             *(str(SRC_DIR / s) for s in SOURCES), "-lpthread"],
            capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"{cxx} failed ({res.returncode}):\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(part, so)


def _open(so: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.gta_block_count.argtypes = [
        i32p, i32p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, i64p]
    lib.gta_block_count.restype = None
    lib.gta_tile_fill.argtypes = [
        i32p, i32p, f32p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i64p, i64p, i32p, i32p, i32p, f32p]
    lib.gta_tile_fill.restype = None
    lib.gta_sort_by_receiver.argtypes = [
        i32p, ctypes.c_int64, ctypes.c_int32, i64p, i64p]
    lib.gta_sort_by_receiver.restype = None
    lib.gta_degrees.argtypes = [i32p, i32p, ctypes.c_int64, f64p, f64p]
    lib.gta_degrees.restype = None
    lib.gta_label_prop.argtypes = [
        i64p, i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_uint64, i32p]
    lib.gta_label_prop.restype = ctypes.c_int32
    lib.gta_sample_epoch.argtypes = [
        i64p, i32p, ctypes.c_int64,                     # row_ptr, senders, n
        i32p, ctypes.c_int32, ctypes.c_int32,           # seeds, batch, S
        i32p, ctypes.c_int32,                           # fanouts, n_hops
        ctypes.c_int32, ctypes.c_int64, ctypes.c_uint64,  # cap_n, e_pad, seed
        i32p, i32p, u8p, f32p, i32p, u8p]               # outputs
    lib.gta_sample_epoch.restype = None
    return lib


def _load():
    """The library, built and self-tested on first use, or None (the
    reason is in ``BUILD_ERROR``)."""
    global _lib, _error, _resolved, build_seconds
    with _lock:
        if _resolved:
            return _lib
        try:
            cxx = shutil.which(CXX)
            if cxx is None:
                raise RuntimeError(f"{CXX} not found: the native host "
                                   "library needs a C++ compiler")
            h = hashlib.sha1()
            for s in SOURCES:
                h.update(s.encode())
                h.update((SRC_DIR / s).read_bytes())
            h.update(" ".join(CXXFLAGS).encode())
            h.update(_target_macros(cxx))
            so = BUILD_DIR / f"libgta_native_{h.hexdigest()[:16]}.so"
            if not so.exists():
                t0 = time.perf_counter()
                _build(so, cxx)
                build_seconds = time.perf_counter() - t0
            _lib = _open(so)
            if not _self_test(_lib):
                _lib = None
                raise RuntimeError(f"{so.name} failed its self-test against "
                                   "the numpy formulations")
        except (OSError, RuntimeError, subprocess.SubprocessError) as ex:
            _lib = None
            _error = f"{type(ex).__name__}: {ex}"
        _resolved = True
        globals().update(HAVE_NATIVE=_lib is not None, BUILD_ERROR=_error)
        return _lib


def __getattr__(name: str):
    if name in ("HAVE_NATIVE", "BUILD_ERROR"):
        _load()
        return globals()[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _self_test(lib) -> bool:
    """Native outputs must match the numpy formulations on a tiny graph
    before the library is trusted."""
    r = np.array([2, 0, 1, 0, 2], np.int32)
    s = np.array([1, 2, 0, 0, 1], np.int32)
    counts = np.zeros(5, np.int64)
    order = np.zeros(5, np.int64)
    lib.gta_sort_by_receiver(r, 5, 3, counts, order)
    if list(r[order]) != sorted(r.tolist()):
        return False
    out_deg = np.zeros(3, np.float64)
    in_deg = np.zeros(3, np.float64)
    lib.gta_degrees(s, r, 5, out_deg, in_deg)
    return bool(np.array_equal(out_deg, [2., 2., 1.])
                and np.array_equal(in_deg, [2., 1., 2.]))


def _validate_ids(n_node, *arrays):
    """Reject out-of-range node ids before they reach raw C pointers (a
    malformed id corrupts heap memory there; numpy would only mis-answer)."""
    for a in arrays:
        if len(a) and (a.min() < 0 or a.max() >= n_node):
            raise ValueError(
                f"node id out of range [0, {n_node}): "
                f"min={a.min()}, max={a.max()}")


def tile_edges_native(senders, receivers, weight, n_row_blocks, n_col_blocks,
                      block_rows, block_cols, tile_edges, e_pad):
    """Native two-pass tiling.  Returns (tile_rb, tile_cb, src_l, dst_l,
    eid, w) for the data tiles (row-block sorted), or None if unavailable.
    Output matches the numpy path exactly (stable within-block edge order).
    """
    lib = _load()
    B = n_row_blocks * n_col_blocks
    if lib is None or B > (1 << 26):
        return None
    _validate_ids(n_row_blocks * block_rows, np.asarray(receivers))
    _validate_ids(n_col_blocks * block_cols, np.asarray(senders))
    ne = len(senders)
    senders = np.ascontiguousarray(senders, np.int32)
    receivers = np.ascontiguousarray(receivers, np.int32)
    weight = np.ascontiguousarray(weight, np.float32)
    nnz = np.zeros(B, np.int64)
    lib.gta_block_count(senders, receivers, ne, n_col_blocks,
                        block_rows, block_cols, nnz)
    tiles_per_block = -(-nnz // tile_edges)
    base = np.concatenate([[0], np.cumsum(tiles_per_block)[:-1]])
    T = int(tiles_per_block.sum())
    src_l = np.full(T * tile_edges, block_cols, np.int32)
    dst_l = np.full(T * tile_edges, block_rows, np.int32)
    eid = np.full(T * tile_edges, max(e_pad - 1, 0), np.int32)
    w = np.zeros(T * tile_edges, np.float32)
    cursor = np.zeros(B, np.int64)
    lib.gta_tile_fill(senders, receivers, weight, ne, n_col_blocks,
                      block_rows, block_cols, tile_edges,
                      np.ascontiguousarray(base, np.int64), cursor,
                      src_l, dst_l, eid, w)
    nonempty = np.flatnonzero(tiles_per_block)
    tile_rb = np.repeat((nonempty // n_col_blocks).astype(np.int32),
                        tiles_per_block[nonempty])
    tile_cb = np.repeat((nonempty % n_col_blocks).astype(np.int32),
                        tiles_per_block[nonempty])
    shape = (T, tile_edges)
    return (tile_rb, tile_cb, src_l.reshape(shape), dst_l.reshape(shape),
            eid.reshape(shape), w.reshape(shape))


def sort_by_receiver_native(receivers, n_node, _checked=True):
    """Stable counting-sort permutation by receiver, or None."""
    lib = _load()
    if lib is None:
        return None
    receivers = np.ascontiguousarray(receivers, np.int32)
    if _checked:
        _validate_ids(n_node + 1, receivers)  # n_node = dump row is legal
    ne = len(receivers)
    counts = np.zeros(n_node + 2, np.int64)
    order = np.zeros(ne, np.int64)
    lib.gta_sort_by_receiver(receivers, ne, n_node, counts, order)
    return order


def degrees_native(senders, receivers, n_node, _checked=True):
    """(out-degree, in-degree) as float64, or None."""
    lib = _load()
    if lib is None:
        return None
    senders = np.ascontiguousarray(senders, np.int32)
    receivers = np.ascontiguousarray(receivers, np.int32)
    if _checked:
        _validate_ids(n_node, senders)
        _validate_ids(n_node, receivers)
    out_deg = np.zeros(n_node, np.float64)
    in_deg = np.zeros(n_node, np.float64)
    lib.gta_degrees(senders, receivers, len(senders), out_deg, in_deg)
    return out_deg, in_deg


def label_prop_native(row_ptr, nbrs, n_node, max_iter=20, seed=0):
    """Async label-propagation over a symmetrized CSR (see cluster.cpp).
    Returns int32 labels (representative node ids, uncompacted) or None."""
    lib = _load()
    if lib is None:
        return None
    row_ptr = np.ascontiguousarray(row_ptr, np.int64)
    nbrs = np.ascontiguousarray(nbrs, np.int32)
    _validate_ids(n_node, nbrs)
    if len(row_ptr) != n_node + 1 or row_ptr[-1] != len(nbrs):
        raise ValueError(f"row_ptr of length {len(row_ptr)} ending at "
                         f"{row_ptr[-1] if len(row_ptr) else None} is not "
                         f"a CSR of {n_node} nodes over {len(nbrs)} entries")
    labels = np.empty(n_node, np.int32)
    lib.gta_label_prop(row_ptr, nbrs, n_node, int(max_iter),
                       seed & (2**64 - 1), labels)
    return labels


def sample_epoch_native(row_ptr, senders, seeds, fanouts, batch,
                        cap_nodes, e_pad, seed):
    """Parallel native epoch sampler (see sampler.cpp).

    ``seeds`` is [S * batch] global ids; returns the stacked batch dict the
    train step consumes (``models/train.train_sampled_scan``), or None
    when native code is unavailable.  Per-batch RNG is deterministic in
    (seed, batch index), independent of the thread schedule.  Local ids
    are seeds first, then first-seen order (the numpy sampler's are
    sorted), so compare native with native and numpy with numpy."""
    lib = _load()
    if lib is None:
        return None
    n_node = len(row_ptr) - 1
    seeds = np.ascontiguousarray(seeds, np.int32)
    _validate_ids(n_node, seeds)
    S = len(seeds) // batch
    if S * batch != len(seeds):
        raise ValueError(f"{len(seeds)} seeds are not whole batches of "
                         f"{batch}")
    row_ptr = np.ascontiguousarray(row_ptr, np.int64)
    senders = np.ascontiguousarray(senders, np.int32)
    fan = np.ascontiguousarray(fanouts, np.int32)
    out_src = np.empty((S, e_pad), np.int32)
    out_dst = np.empty((S, e_pad), np.int32)
    out_mask = np.empty((S, e_pad), np.uint8)
    out_w = np.empty((S, e_pad), np.float32)
    out_ids = np.empty((S, cap_nodes), np.int32)
    out_seed = np.empty((S, cap_nodes), np.uint8)
    lib.gta_sample_epoch(
        row_ptr, senders, n_node, seeds, batch, S, fan, len(fan),
        cap_nodes, e_pad, seed & (2**64 - 1),
        out_src, out_dst, out_mask, out_w, out_ids, out_seed)
    return dict(
        senders=out_src, receivers=out_dst, mask=out_mask.astype(bool),
        weight=out_w, ids=out_ids, seed=out_seed.astype(bool))
