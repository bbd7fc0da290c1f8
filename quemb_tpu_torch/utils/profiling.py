"""Profiling: the program's tracer, function timers and device traces.

JAX counterpart: ``quemb_tpu/utils/profiling.py``.  The reference profiles
with a FunctionTimer registry (shared/helper.py:130, applied to the BE
driver hot paths) and prints [TIMER] tables; here the same registry
(utils/helper.py ``timer``) wraps ``BE.initialize``, ``oneshot`` and
``optimize``.  ``device_trace`` records a ``torch.profiler`` trace (CPU
activity, and CUDA activity when a card is present) and writes it as a
Chrome trace, which TensorBoard and ``chrome://tracing`` read, where the
JAX module records a ``jax.profiler`` trace.

The tracer, always on, records the stages of a BE job where they run:

- :class:`span` (a context manager and a decorator) times a stage on the
  clock that ``torch.profiler``'s kineto events carry (Unix-epoch
  nanoseconds) and notes its parent, the innermost span open on the same
  thread.  While a profiler records, it also opens
  ``record_function("quemb." + name)``, so that the stage sits on the
  device trace's timeline.
- :func:`count` adds to a counter of the innermost open span and to a
  process-wide total (:func:`total`).
- A trace is one ``BE``: ``fragmentate`` (a root of its own, whose trace
  passes to the first ``BE`` built from its result), the constructor and
  every solve run on it.  A span opened with no span open starts a trace,
  unless it is given one.  Spans opened on the fragment mesh's shard
  threads attach to the caller's span (:func:`attached`).
- :func:`traces` gives the newest :data:`KEEP` traces, finished spans
  only, read-only.

The spans of a job: ``fragmentate``; ``construct`` with ``mean_field``
(``core`` with a frozen core), ``localize`` (``iao`` for IAO+PAO) and
``BE.initialize`` (``schmidt``, ``eri`` with ``cd_factor`` where the
in-core route takes the host Cholesky factor, ``fragment_init``);
``BE.optimize`` or ``BE.oneshot`` with ``jacobian`` and ``eval``, each
``eval`` with the stages ``inputs``, ``scf``, ``mo_transform``,
``ccsd``, ``rdm``, ``energy`` and ``error``.  Counters: ``iters`` (loop
trips of the fragment SCF and of the CCSD), ``lanes`` and
``lane_iters`` (CCSD lanes and their summed iteration counts), ``large``
(the lanes of a CCSD bucket wider than the batched width: on a card, the
fragments that the plan solves one to a bucket), ``orbs`` and
``pad_orbs`` (the other buckets' true widths, summed over their lanes,
and the pad orbitals that fill them to the bucket's width), ``syncs``
(each place where the host waits for the device: a read or copy between
host and device, and each ``eigh``, which reads its error flags back on
a card), ``eri.direct`` and ``eri.cd`` (on ``eri``: the fragments the
in-core route transformed from the dense AO ERI and from the Cholesky
factor) and ``screened_df.launches`` (the screened-DF kernel).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import OrderedDict, defaultdict
from contextlib import contextmanager
from functools import wraps
from pathlib import Path
from types import MappingProxyType
from typing import Mapping, NamedTuple

import torch

from quemb_tpu_torch.utils.helper import timer

__all__ = ["KEEP", "SpanRecord", "Trace", "attached", "count", "current",
           "device_trace", "print_timings", "span", "timer",
           "total", "traces"]

#: traces the recorder keeps, the newest: a few MB of spans, and more
#: than the jobs of a minute of one-shot octane BE2 on a card (~400)
KEEP = 2048

_OFFSET_NS = time.time_ns() - time.perf_counter_ns()


def _now_ns() -> int:
    """Unix-epoch nanoseconds, on a monotonic clock: the time base of
    ``torch.profiler``'s kineto events."""
    return time.perf_counter_ns() + _OFFSET_NS


class SpanRecord(NamedTuple):
    """A finished span."""

    name: str
    trace: int
    id: int
    parent: int | None
    start_ns: int
    end_ns: int
    counters: Mapping[str, int]

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class Trace(NamedTuple):
    """The finished spans of one trace, in the order they finished."""

    id: int
    spans: tuple[SpanRecord, ...]


_LOCK = threading.Lock()
_TRACES: OrderedDict[int, list[SpanRecord]] = OrderedDict()
_TOTALS: dict[str, int] = defaultdict(int)
_IDS = itertools.count(1)
_LOCAL = threading.local()


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


def _new_trace() -> int:
    with _LOCK:
        tid = next(_IDS)
        _TRACES[tid] = []
        while len(_TRACES) > KEEP:
            _TRACES.popitem(last=False)
    return tid


class span:
    """Time a stage: ``with span("scf"):`` or ``@span("eval")``.

    Its parent is the innermost span open on this thread; with none open
    it is a root of ``trace``, or of a new trace.  ``seconds`` is its
    length once it has closed."""

    __slots__ = ("name", "trace", "id", "parent", "start_ns", "end_ns",
                 "counters", "_given", "_rf")

    def __init__(self, name: str, trace: int | None = None):
        self.name = name
        self._given = trace

    def __enter__(self) -> span:
        stack = _stack()
        if stack:
            self.trace, self.parent = stack[-1].trace, stack[-1].id
        else:
            self.parent = None
            self.trace = (self._given if self._given is not None
                          else _new_trace())
        self.id = next(_IDS)
        self.counters = {}
        stack.append(self)
        self.start_ns = _now_ns()
        self._rf = None
        if torch.autograd.profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function("quemb." + self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = _now_ns()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        else:
            stack.remove(self)
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        rec = SpanRecord(self.name, self.trace, self.id, self.parent,
                         self.start_ns, self.end_ns,
                         MappingProxyType(self.counters))
        with _LOCK:
            spans = _TRACES.get(self.trace)
            if spans is not None:
                spans.append(rec)

    def __call__(self, fn):
        name, trace = self.name, self._given

        @wraps(fn)
        def inner(*args, **kwargs):
            with span(name, trace):
                return fn(*args, **kwargs)

        return inner

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the innermost open span on this
    thread, if any, and to its process-wide total."""
    stack = _stack()
    with _LOCK:
        _TOTALS[name] += n
        if stack:
            c = stack[-1].counters
            c[name] = c.get(name, 0) + n


def total(name: str) -> int:
    """The process-wide total of counter ``name``."""
    return _TOTALS.get(name, 0)


def current() -> span | None:
    """The innermost span open on this thread."""
    stack = _stack()
    return stack[-1] if stack else None


@contextmanager
def attached(parent: span | None):
    """Spans and counts on this thread go under ``parent``, a span open on
    another thread (:func:`current` there), while inside."""
    if parent is None:
        yield
        return
    stack = _stack()
    stack.append(parent)
    try:
        yield
    finally:
        stack.remove(parent)


def traces() -> tuple[Trace, ...]:
    """The newest :data:`KEEP` traces, oldest first."""
    with _LOCK:
        return tuple(Trace(tid, tuple(spans))
                     for tid, spans in _TRACES.items())


@contextmanager
def device_trace(logdir: str):
    """Capture a ``torch.profiler`` trace around a code region into
    ``logdir/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(logdir / "trace.json"))


def print_timings(n: int = 12) -> None:
    """Print the accumulated per-function wall-time table."""
    timer.print_top(n)
