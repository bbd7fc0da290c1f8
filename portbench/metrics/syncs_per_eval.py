"""Host syncs per objective evaluation: the ``syncs`` counters of every
span inside the program's ``eval`` spans (each read or copy between
host and device, and each eigh, which reads its error flags back)."""

from portbench.lib.program import spans, under, window_traces


def read(t):
    traces = window_traces(t)
    if traces is None:
        return None
    n_eval = len(spans(traces, "eval"))
    found = [s for s in under(traces, "eval") if "syncs" in s.counters]
    if not n_eval or not found:
        return None
    return sum(s.counters["syncs"] for s in found) / n_eval
