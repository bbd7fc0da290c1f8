"""Mean wall per job of the program's ``eri`` spans that count the
in-core route they took (``eri.direct`` or ``eri.cd``): construction's
fragment-ERI stage, the host Cholesky factor included where it runs."""

from portbench.lib.program import spans, window_traces


def read(t):
    traces = window_traces(t)
    if traces is None:
        return None
    found = [s for s in spans(traces, "eri")
             if {"eri.direct", "eri.cd"} & set(s.counters)]
    if not found:
        return None
    return sum(s.seconds for s in found) / len(traces)
