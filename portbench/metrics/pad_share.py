"""Share of the batched CCSD's orbitals that are pads, in percent: 100 x
the ``pad_orbs`` counters over the ``orbs`` and ``pad_orbs`` counters of
the window's ``ccsd`` spans.  A bucket of fragments of unequal width is
padded to its widest; the pads are computed and thrown away."""

from portbench.lib.program import spans, window_traces


def read(t):
    traces = window_traces(t)
    if traces is None:
        return None
    found = [s for s in spans(traces, "ccsd")
             if {"orbs", "pad_orbs"} <= set(s.counters)]
    orbs = sum(s.counters["orbs"] for s in found)
    pads = sum(s.counters["pad_orbs"] for s in found)
    if not orbs + pads:
        return None
    return 100.0 * pads / (orbs + pads)
