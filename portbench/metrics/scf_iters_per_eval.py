"""Loop trips of the fragment SCF (the ``iters`` counter of the
program's ``scf`` spans) per objective evaluation."""

from portbench.lib.program import per_eval


def read(t):
    return per_eval(t, "scf", "iters")
