"""The function timer registry.

JAX counterpart: ``quemb_tpu/utils/helper.py`` (reference
``shared/helper.py``): of it the port keeps what its modules call, the
FunctionTimer registry and its ``@timeit`` decorator.  ``ensure``,
``Timer`` and the index helpers are called by no module of either
package, and ``host_init_context`` routed JAX's initialization to the
host backend, where the port runs on the caller's device.
"""

from __future__ import annotations

import time
from collections import defaultdict
from functools import wraps


class FunctionTimer:
    """Accumulates wall time + call counts per decorated function."""

    def __init__(self):
        self.times: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    def timeit(self, f):
        @wraps(f)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return f(*args, **kwargs)
            finally:
                self.times[f.__qualname__] += time.perf_counter() - t0
                self.counts[f.__qualname__] += 1

        return wrapper

    def print_top(self, n: int = 10) -> None:
        rows = sorted(self.times.items(), key=lambda kv: -kv[1])[:n]
        width = max((len(k) for k, _ in rows), default=10)
        print(f"{'function':<{width}}  {'calls':>6}  {'total s':>10}")
        for k, v in rows:
            print(f"{k:<{width}}  {self.counts[k]:>6}  {v:>10.3f}")


timer = FunctionTimer()
