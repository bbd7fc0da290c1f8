"""Summed wall of the program's ``scf`` spans (the fragment SCF of a
bucket, or of one fragment on the large path, with its final eigh) per
objective evaluation (``eval`` span)."""

from portbench.lib.program import per_eval


def read(t):
    return per_eval(t, "scf")
