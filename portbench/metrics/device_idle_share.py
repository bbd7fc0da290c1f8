"""Share of a job's wall in which no kernel, copy or memset ran on the
device, in percent: one minus the device's busy time per job, from the
job profiled for device activity alone, over the window's length per
job.  The kernels of a profiled job run as long as those of any other,
but even that profiler stretches the host's part of a job by a quarter
to a half, so the wall is the unprofiled window's."""


def read(t):
    p = t.timeline
    if p is None or not p.jobs or not t.job_s:
        return None
    return 100.0 * (1.0 - p.busy_us * 1e-6 / p.jobs / t.job_s)
