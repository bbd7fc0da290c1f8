"""Share of the CCSD stage's wall in which the device ran none of its
work, in percent: 100 x (1 - D / ``ccsd_s``).  D is the device time of
the outermost ``quemb.ccsd`` ranges of the job profiled with host ops,
per ``quemb.eval`` range there; the wall is the unprofiled window's
(``ccsd_s``), as for ``device_idle_share``."""

from portbench.lib.program import per_eval
from portbench.lib.trace import device_time_us


def read(t):
    p = t.profile
    wall = per_eval(t, "ccsd")
    if p is None or not wall:
        return None
    ccsd = sorted((e for e in p.ops if e.name == "quemb.ccsd"),
                  key=lambda e: e.time_range.start)
    n_eval = sum(e.name == "quemb.eval" for e in p.ops)
    outer, end = [], float("-inf")
    for e in ccsd:
        if e.time_range.start >= end:
            outer.append(e)
            end = e.time_range.end
    if not outer or not n_eval:
        return None
    d_s = sum(device_time_us(e) for e in outer) * 1e-6 / n_eval
    return 100.0 * (1.0 - d_s / wall)
