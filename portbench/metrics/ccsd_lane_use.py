"""Share of the batched CCSD's lane-steps that moved a lane still
iterating, in percent: 100 x the lanes' summed iteration counts over
loop trips x lanes, summed over the program's ``ccsd`` spans.  A
batched loop computes every lane until the last one stops."""

from portbench.lib.program import spans, window_traces


def read(t):
    traces = window_traces(t)
    if traces is None:
        return None
    found = [s for s in spans(traces, "ccsd")
             if {"iters", "lanes", "lane_iters"} <= set(s.counters)]
    steps = sum(s.counters["iters"] * s.counters["lanes"] for s in found)
    if not steps:
        return None
    return 100.0 * sum(s.counters["lane_iters"] for s in found) / steps
