"""Share of the device's busy time spent in the kernels of
``torch.linalg.eigh`` (the profiler's device time of each outermost
``aten::linalg_eigh``), in percent."""

from portbench.lib.trace import device_time_us


def read(t):
    p = t.profile
    if p is None or p.busy_us <= 0:
        return None
    us = sum(device_time_us(e) for e in p.ops if e.name == "aten::linalg_eigh")
    if us <= 0:
        return None
    return 100.0 * us / p.busy_us
