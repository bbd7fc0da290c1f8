"""Kernel launches per job: the job profiled for device activity alone."""


def read(t):
    p = t.timeline
    if p is None or not p.jobs:
        return None
    return len(p.kernels) / p.jobs
