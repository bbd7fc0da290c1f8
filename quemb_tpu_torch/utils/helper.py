"""The function timer registry.

JAX counterpart: ``quemb_tpu/utils/helper.py`` (reference
``shared/helper.py``): of it the port keeps what its modules call, the
FunctionTimer registry and its ``@timeit`` decorator.  ``ensure``,
``Timer`` and the index helpers are called by no module of either
package, and ``host_init_context`` routed JAX's initialization to the
host backend, where the port runs on the caller's device.
"""

from __future__ import annotations

from collections import defaultdict
from functools import wraps


class FunctionTimer:
    """Accumulates wall time + call counts per decorated function."""

    def __init__(self):
        self.times: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    def timeit(self, f):
        """Time each call of ``f`` as a tracer span named by its qualname
        (:mod:`quemb_tpu_torch.utils.profiling`); a method of an object
        that carries a ``trace_id`` records into that trace."""
        # profiling imports this module for ``timer``
        from quemb_tpu_torch.utils.profiling import span  # noqa: PLC0415

        name = f.__qualname__

        @wraps(f)
        def wrapper(*args, **kwargs):
            sp = span(name, getattr(args[0], "trace_id", None)
                      if args else None)
            try:
                with sp:
                    return f(*args, **kwargs)
            finally:
                self.times[name] += sp.seconds
                self.counts[name] += 1

        return wrapper

    def print_top(self, n: int = 10) -> None:
        rows = sorted(self.times.items(), key=lambda kv: -kv[1])[:n]
        width = max((len(k) for k, _ in rows), default=10)
        print(f"{'function':<{width}}  {'calls':>6}  {'total s':>10}")
        for k, v in rows:
            print(f"{k:<{width}}  {self.counts[k]:>6}  {v:>10.3f}")


timer = FunctionTimer()
