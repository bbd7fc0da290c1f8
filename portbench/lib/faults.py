"""Faults that a cell can have, planted in the program: the tests see
each one judged not correct, and ``calibrate.py`` reads the numbers that
each gives on the card.

    with planted("step_unchanged"):
        ...
"""

from __future__ import annotations

from contextlib import contextmanager


def _step_unchanged():
    """Every quasi-Newton step leaves the potential as it was."""
    from quemb_tpu_torch.matching import optqn

    return [(optqn.QNSolver, "step", lambda self, **kw: None)]


def _half_batch():
    """The energy of a bucket of fragments from its first half alone,
    scaled to the whole."""
    from quemb_tpu_torch.solvers import dispatch

    orig = dispatch._solve_bucket

    def half(frs, solver, eeval, *args, **kwargs):
        e = orig(frs, solver, eeval, *args, **kwargs)
        if not eeval:
            return e
        kept = frs[: max(1, len(frs) // 2)]
        return [sum(fr.ebe for fr in kept) * len(frs) / len(kept), 0.0, 0.0]

    return [(dispatch, "_solve_bucket", half)]


def _altered_answer():
    """One fragment's one-electron energy row off by 1e-6 Ha."""
    from quemb_tpu_torch.solvers import dispatch

    orig = dispatch._center_rows

    def altered(*args):
        e1, e2, ec = orig(*args)
        e1 = e1.clone()
        e1[0] += 1e-6
        return e1, e2, ec

    return [(dispatch, "_center_rows", altered)]


FAULTS = {"step_unchanged": _step_unchanged, "half_batch": _half_batch,
          "altered_answer": _altered_answer}


@contextmanager
def planted(name: str):
    swaps = FAULTS[name]()
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in swaps]
    for obj, attr, new in swaps:
        setattr(obj, attr, new)
    try:
        yield
    finally:
        for obj, attr, old in saved:
            setattr(obj, attr, old)
