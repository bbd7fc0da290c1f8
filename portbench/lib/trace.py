"""What a traced run records, read by the per-layer metrics.

Spans and counts come from wrappers that the harness puts, in a traced
run only, around calls into the program's layers (host clock, over the
window's jobs).  Device activity comes from ``torch.profiler`` over two
more jobs after the window.  The first is profiled for device activity
alone, which adds little to the host's time: its kernel and copy
intervals against the job's host wall give the busy and idle time and
the launches (:class:`Timeline`).  The second records host ops too, with
their shapes and dtypes, which slows the host several times over: it
gives each op's device time and what the host did in each gap
(:class:`Profile`), never the idle share.
"""

from __future__ import annotations

import importlib
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

#: the record_function label of a profiled job
JOB = "portbench.job"


@dataclass
class Spans:
    """Host-clock durations and call counts of wrapped program calls."""

    durations: dict[str, list[float]] = field(
        default_factory=lambda: defaultdict(list))
    counts: dict[str, int] = field(default_factory=lambda: defaultdict(int))

    @contextmanager
    def wrapped(self, targets: dict[str, str]):
        """Wrap ``module:attr`` for each span name while inside."""
        saved = []
        for name, target in targets.items():
            mod_name, attr = target.split(":")
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, attr)
            setattr(mod, attr, self._wrap(name, orig))
            saved.append((mod, attr, orig))
        try:
            yield self
        finally:
            for mod, attr, orig in saved:
                setattr(mod, attr, orig)

    def _wrap(self, name, fn):
        def inner(*args, **kwargs):
            with torch.profiler.record_function(f"portbench.{name}"):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    self.durations[name].append(time.perf_counter() - t0)
                    self.counts[name] += 1
        return inner


@dataclass
class Profile:
    """Device activity and host ops over a profiled job, in microseconds
    of the profiler's clock."""

    ops: list                                   # host op events
    busy_us: float                              # kernels, copies, memsets
    gaps: list[tuple[float, float]]
    dtypes: dict                                # GEMM operand dtypes


def _device_type(evt):
    return getattr(evt, "device_type", None)


def device_time_us(evt) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


@dataclass
class Timeline:
    """Device activity over profiled jobs whose host wall is known, in
    microseconds: every kernel, copy and memset of a job runs inside its
    wall, which ends in a host read."""

    jobs: int
    window_us: float
    kernels: list[tuple[str, float, float]]
    busy_us: float


def timeline(prof, jobs: int, wall_s: float) -> Timeline | None:
    """A :class:`Timeline` of a finished profile of device activity alone
    over ``jobs`` jobs that took ``wall_s`` on the host, or None when it
    holds no device activity.  Read from the profiler's raw events, which
    is quicker than its FunctionEvents over some 100k kernels."""
    cuda = torch.autograd.DeviceType.CUDA
    dev = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda or e.is_user_annotation():
            continue
        a = e.start_ns() * 1e-3
        dev.append((e.name(), a, a + e.duration_ns() * 1e-3))
    if not dev:
        return None
    kernels = [d for d in dev if not d[0].startswith(("Memcpy", "Memset"))]
    busy = _merge([(a, b) for _, a, b in dev])
    return Timeline(jobs=jobs, window_us=wall_s * 1e6, kernels=kernels,
                    busy_us=sum(b - a for a, b in busy))


def parse(prof) -> Profile | None:
    """A :class:`Profile` of a finished ``torch.profiler.profile``, or
    None when it holds no profiled job or no device activity."""
    events = list(prof.events())
    cuda = torch.autograd.DeviceType.CUDA
    # a job's range shows on the host and, as an annotation, on the device:
    # the host's is the job
    jobs = [e for e in events if e.name == JOB and _device_type(e) != cuda]
    if not jobs:
        return None
    w0 = min(e.time_range.start for e in jobs)
    w1 = max(e.time_range.end for e in jobs)
    # record_function ranges also show on the device's timeline: they are
    # annotations, not work
    dev = [e for e in events if _device_type(e) == cuda
           and not getattr(e, "is_user_annotation", False)
           and not e.name.startswith("portbench.")
           and e.time_range.end > w0 and e.time_range.start < w1]
    if not dev:
        return None
    busy = _merge([(max(e.time_range.start, w0), min(e.time_range.end, w1))
                   for e in dev])
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    thread = jobs[0].thread
    ops = [e for e in events if _device_type(e) != cuda
           and e.thread == thread and e.time_range.end > w0
           and e.time_range.start < w1]
    return Profile(ops=ops, busy_us=sum(b - a for a, b in busy), gaps=gaps,
                   dtypes=_gemm_dtypes(prof))


#: the host ops whose operand dtypes a metric reads
GEMMS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm")


def _gemm_dtypes(prof) -> dict:
    """Operand dtypes of the GEMM ops, keyed by (name, start in us from
    the trace's start), read from the profiler's raw events (the
    FunctionEvents of some torch versions do not carry them)."""
    kr = prof.profiler.kineto_results
    t0 = kr.trace_start_ns()
    return {(e.name(), round((e.start_ns() - t0) / 1000, 3)): list(e.dtypes())
            for e in kr.events() if e.name() in GEMMS}


def op_dtypes(p: Profile, e) -> list:
    """Operand dtypes of host op ``e``, or [] when the trace lacks them."""
    d = getattr(e, "input_dtypes", None)
    if d:
        return list(d)
    return p.dtypes.get((e.name, round(e.time_range.start, 3)), [])


def device_ops(p: Timeline, top: int = 10) -> list[list]:
    """The device operations that took most time: [name, seconds]."""
    tot: dict[str, float] = defaultdict(float)
    for name, a, b in p.kernels:
        tot[name[:160]] += b - a
    return [[k, v * 1e-6] for k, v in
            sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(p: Profile, top: int = 10) -> list[list]:
    """Idle device time by what the host was doing in the middle of each
    gap: the harness span and the innermost host op there,
    [name, seconds].  One sweep: host ops on one thread nest, so the
    stack of ops open at a time is the chain that holds it."""
    ops = sorted(p.ops, key=lambda e: (e.time_range.start,
                                       -e.time_range.end))
    tot: dict[str, float] = defaultdict(float)
    stack, i = [], 0
    for a, b in sorted(p.gaps):
        mid = 0.5 * (a + b)
        while i < len(ops) and ops[i].time_range.start <= mid:
            while stack and stack[-1].time_range.end < ops[i].time_range.start:
                stack.pop()
            stack.append(ops[i])
            i += 1
        while stack and stack[-1].time_range.end < mid:
            stack.pop()
        open_ = [e for e in stack if e.time_range.end >= mid]
        inner = next((e.name for e in reversed(open_)
                      if not e.name.startswith("portbench.")), "python")
        span = next((e.name[len("portbench."):] for e in reversed(open_)
                     if e.name.startswith("portbench.") and e.name != JOB),
                    "host")
        tot[f"{span}/{inner}"[:160]] += b - a
    return [[k, v * 1e-6] for k, v in
            sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


@dataclass
class TraceData:
    """What the per-layer metric readers read."""

    jobs: int                       # jobs the spans were recorded over
    job_s: float                    # the window's length over its jobs
    construct_s: list[float]        # the BE constructor's wall, per job
    spans: Spans
    timeline: Timeline | None       # the job profiled for device activity
    profile: Profile | None         # the job profiled with host ops
    peak_mem_bytes: int
