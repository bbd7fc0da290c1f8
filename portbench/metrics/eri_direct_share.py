"""Share of the fragments whose ERIs the in-core route transformed from
the dense AO ERI on the device, in percent: 100 x the ``eri.direct``
counters over the ``eri.direct`` and ``eri.cd`` counters of the window's
``eri`` spans.  The rest came from the host pivoted-Cholesky factor.  A
program that counts neither reads nothing."""

from portbench.lib.program import spans, window_traces


def read(t):
    traces = window_traces(t)
    if traces is None:
        return None
    found = spans(traces, "eri")
    direct = sum(s.counters.get("eri.direct", 0) for s in found)
    cd = sum(s.counters.get("eri.cd", 0) for s in found)
    if not direct + cd:
        return None
    return 100.0 * direct / (direct + cd)
