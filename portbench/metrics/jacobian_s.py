"""Wall of ``get_be_error_jacobian`` per job (span around the call into
``quemb_tpu_torch.api``; it returns a host array)."""


def read(t):
    d = t.spans.durations.get("jacobian")
    if not d or not t.jobs:
        return None
    return sum(d) / t.jobs
