"""Loop trips of the CCSD amplitude iteration (the ``iters`` counter of
the program's ``ccsd`` spans) per objective evaluation."""

from portbench.lib.program import per_eval


def read(t):
    return per_eval(t, "ccsd", "iters")
