"""Objective evaluations per job: calls of
``quemb_tpu_torch.matching.beopt.be_func`` over the window's jobs."""


def read(t):
    n = t.spans.counts.get("eval")
    if not n or not t.jobs:
        return None
    return n / t.jobs
