"""Profiling helpers: function-level timers + device traces.

JAX counterpart: ``quemb_tpu/utils/profiling.py``.  The reference profiles
with a FunctionTimer registry (shared/helper.py:130, applied to the BE
driver hot paths) and prints [TIMER] tables; here the same registry
(utils/helper.py ``timer``) wraps ``BE.initialize``, ``oneshot`` and
``optimize``.  ``device_trace`` records a ``torch.profiler`` trace (CPU
activity, and CUDA activity when a card is present) and writes it as a
Chrome trace, which TensorBoard and ``chrome://tracing`` read, where the
JAX module records a ``jax.profiler`` trace.
"""

from __future__ import annotations

from contextlib import contextmanager
from pathlib import Path

import torch

from quemb_tpu_torch.utils.helper import timer

__all__ = ["device_trace", "print_timings", "timer"]


@contextmanager
def device_trace(logdir: str):
    """Capture a ``torch.profiler`` trace around a code region into
    ``logdir/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(logdir / "trace.json"))


def print_timings(n: int = 12) -> None:
    """Print the accumulated per-function wall-time table."""
    timer.print_top(n)
