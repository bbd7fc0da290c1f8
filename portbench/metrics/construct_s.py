"""Mean wall of the ``BE(...)`` constructor per job (host clock around
the call in the harness): localization, Schmidt, the fragment ERI
transform and the fragment SCFs at zero potential."""


def read(t):
    if not t.construct_s:
        return None
    return sum(t.construct_s) / len(t.construct_s)
