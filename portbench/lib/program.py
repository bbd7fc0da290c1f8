"""The program's own spans and counters, as the per-layer metrics read
them: the tracer of ``quemb_tpu_torch.utils.profiling``, which records
each job (``fragmentate``, ``BE`` and its solve) as one trace on the
clock of the profiler's events.

The window's jobs are the last ``t.jobs`` traces whose spans all end
before the first kernel of the job profiled after the window
(``t.timeline``).  A reader finds nothing, and returns None, without a
device timeline, without the tracer (a program that predates it), or
with fewer such traces than jobs.
"""

from __future__ import annotations


def window_traces(t) -> list | None:
    """The window's traces, oldest first, or None."""
    p = t.timeline
    if p is None or not p.kernels or not t.jobs:
        return None
    from quemb_tpu_torch.utils import profiling

    traces = getattr(profiling, "traces", None)
    if traces is None:
        return None
    first_ns = min(a for _, a, _ in p.kernels) * 1e3    # us -> ns
    done = [tr for tr in traces()
            if tr.spans and max(s.end_ns for s in tr.spans) < first_ns]
    if len(done) < t.jobs:
        return None
    return done[-t.jobs:]


def spans(traces, name: str) -> list:
    return [s for tr in traces for s in tr.spans if s.name == name]


def per_eval(t, name: str, counter: str | None = None) -> float | None:
    """The summed wall (s) of the ``name`` spans of the window, or their
    summed ``counter``, over the number of ``eval`` spans; None where no
    such span, or no span with that counter, was found."""
    traces = window_traces(t)
    if traces is None:
        return None
    n_eval = len(spans(traces, "eval"))
    found = spans(traces, name)
    if counter is not None:
        found = [s for s in found if counter in s.counters]
    if not n_eval or not found:
        return None
    if counter is None:
        return sum(s.seconds for s in found) / n_eval
    return sum(s.counters[counter] for s in found) / n_eval


def under(traces, name: str) -> list:
    """Every span of ``traces`` that lies in a ``name`` span, that span
    included."""
    out = []
    for tr in traces:
        byid = {s.id: s for s in tr.spans}
        for s in tr.spans:
            a = s
            while a is not None and a.name != name:
                a = byid.get(a.parent)
            if a is not None:
                out.append(s)
    return out
