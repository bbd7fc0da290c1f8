"""Mean wall per job of the program's ``cd_factor`` span: the pivoted
Cholesky factor of the AO ERI on the host, inside construction's
fragment-ERI stage (the in-core route on a card)."""

from portbench.lib.program import spans, window_traces


def read(t):
    traces = window_traces(t)
    if traces is None:
        return None
    found = spans(traces, "cd_factor")
    if not found:
        return None
    return sum(s.seconds for s in found) / len(traces)
