"""Share of the fragment solves that took the large-fragment path, one
fragment at a time, in percent: 100 x the ``large`` counters over the
``lanes`` counters of the window's ``ccsd`` spans.  ``lanes`` counts
every fragment solved on either path; a program that counts ``large``
also counts ``orbs`` on the batched path, so a window with neither
reads nothing and one with ``orbs`` alone reads 0."""

from portbench.lib.program import spans, window_traces


def read(t):
    traces = window_traces(t)
    if traces is None:
        return None
    found = [s for s in spans(traces, "ccsd") if "lanes" in s.counters]
    if not any("large" in s.counters or "orbs" in s.counters
               for s in found):
        return None
    lanes = sum(s.counters["lanes"] for s in found)
    return 100.0 * sum(s.counters.get("large", 0) for s in found) / lanes
