"""Summed wall of the program's ``ccsd`` spans (block build, amplitude
loop and the host read of its last steps) per objective evaluation."""

from portbench.lib.program import per_eval


def read(t):
    return per_eval(t, "ccsd")
