"""Mean wall per job of the program's ``iao`` span: the IAO+PAO
localization inside construction's ``localize`` (cross overlaps, IAOs,
PAOs, their order by atom, the core's removal and the virtual SVD)."""

from portbench.lib.program import spans, window_traces


def read(t):
    traces = window_traces(t)
    if traces is None:
        return None
    found = spans(traces, "iao")
    if not found:
        return None
    return sum(s.seconds for s in found) / len(traces)
