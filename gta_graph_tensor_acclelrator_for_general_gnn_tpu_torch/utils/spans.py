"""Spans and counters at the port's layer boundaries, kept in memory.

- :func:`span` ``(name)``: a context manager around one piece of work;
  :func:`spanned` ``(name)`` the same around every call of a function.
- :func:`count` ``(name, value)``: adds ``value`` to a counter of the
  innermost open span.
- :func:`recording`: a context manager that switches recording on for
  its block (nested blocks restore what they found).
- :func:`take`: the recorded spans and counters, which it clears.

Recording is off unless a :func:`recording` block is open.  Off,
:func:`span` checks one module flag and returns a shared object whose
``__enter__`` and ``__exit__`` do nothing: no clock read, no allocation,
no device synchronisation.  On, each span is kept as a dict: ``name``,
``start_ns`` and ``end_ns`` by ``time.time_ns()``, ``tid`` (the thread's
native id, as a profiler trace names it), ``id``, ``parent`` (the id of
the span it lies in, or None), ``unit`` (the id of the outermost
``model.forward`` or ``train.step`` it lies in: one request or one
training step, or None) and ``counters``.  A span opened on a thread that
has no open span of its own (autograd's device thread, where custom
Functions run ``backward``) takes the open ``train.backward`` span as its
parent.

While a ``torch.profiler`` capture runs, each recorded span is also a
``torch.profiler.record_function`` range, so it lands in the Chrome trace
as a ``user_annotation`` event of the same name.  ``time.time_ns()`` is
the trace's clock: an event's ``ts`` (microseconds) times 1e3 plus the
trace's ``baseTimeNanoseconds`` reads the same wall-clock nanoseconds.
``utils/profile.trace`` records for its block.

Imports nothing from the port, so that every module of it can import
this one.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch

UNIT_NAMES = ("model.forward", "train.step")
ADOPTING = "train.backward"   # parent of spans on a thread with none open

_on = False
_spans: List[Dict] = []
_counters: Dict[str, float] = {}   # counts made outside any span
_ids = itertools.count(1)
_local = threading.local()
_adopter: Optional[Dict] = None    # the open ADOPTING span


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_OFF = _Off()


def _stack() -> List[Dict]:
    """This thread's open spans; its native id is read once, beside them
    (``get_native_id`` is a system call)."""
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
        _local.tid = threading.get_native_id()
    return st


class _Span:
    __slots__ = ("name", "rec", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _adopter
        name, st = self.name, _stack()
        parent = st[-1] if st else _adopter
        sid = next(_ids)
        unit = parent["unit"] if parent is not None else None
        if unit is None and name in UNIT_NAMES:
            unit = sid
        self.rec = {"name": name, "start_ns": 0, "end_ns": 0,
                    "tid": _local.tid, "id": sid,
                    "parent": None if parent is None else parent["id"],
                    "unit": unit, "counters": {}}
        if name == ADOPTING:
            _adopter = self.rec
        st.append(self.rec)
        self.rf = (torch.profiler.record_function(name)
                   if torch.autograd.profiler._is_profiler_enabled else None)
        if self.rf is not None:
            self.rf.__enter__()
        self.rec["start_ns"] = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        global _adopter
        self.rec["end_ns"] = time.time_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        st = _stack()
        if st and st[-1] is self.rec:
            st.pop()
        if _adopter is self.rec:
            _adopter = None
        _spans.append(self.rec)
        return False


def span(name: str):
    """A context manager recording ``name`` around its block (when
    recording is on)."""
    if not _on:
        return _OFF
    return _Span(name)


def spanned(name: str):
    """Decorator: every call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, value) -> None:
    """Add ``value`` to counter ``name`` of the innermost open span of this
    thread (outside any span: to the counters :func:`take` returns
    apart)."""
    if not _on:
        return
    st = _stack()
    c = st[-1]["counters"] if st else _counters
    c[name] = c.get(name, 0) + value


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record spans and counters inside the block."""
    global _on
    was, _on = _on, True
    try:
        yield
    finally:
        _on = was


def take() -> Dict:
    """``{"spans": [...], "counters": {...}}``: the spans closed since the
    last call, in the order they closed, and the counts made outside any
    span; both are cleared."""
    global _spans, _counters
    out = {"spans": _spans, "counters": _counters}
    _spans, _counters = [], {}
    return out
