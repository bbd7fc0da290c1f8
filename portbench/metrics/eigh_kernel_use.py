"""Share of the matrices that the objective's eigh solved by the batched
Jacobi kernel, in percent: 100 x the ``eigh.kernel`` counters over the
``eigh.kernel`` and ``eigh.library`` counters of every span inside the
program's ``eval`` spans.  A program without those counters (one that
predates the kernel) reads nothing."""

from portbench.lib.program import under, window_traces


def read(t):
    traces = window_traces(t)
    if traces is None:
        return None
    found = under(traces, "eval")
    kernel = sum(s.counters.get("eigh.kernel", 0) for s in found)
    library = sum(s.counters.get("eigh.library", 0) for s in found)
    if not kernel + library:
        return None
    return 100.0 * kernel / (kernel + library)
