"""Mean wall of one objective evaluation (span around
``quemb_tpu_torch.matching.beopt.be_func``, which ends in host reads of
the fragments' 1-RDMs)."""


def read(t):
    d = t.spans.durations.get("eval")
    if not d:
        return None
    return sum(d) / len(d)
