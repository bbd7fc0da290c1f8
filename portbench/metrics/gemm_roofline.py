"""The float64 GEMMs' share of their roofline, in percent.

For each ``aten::mm``, ``bmm``, ``addmm`` and ``baddbmm`` on float64
operands in the profiled jobs: the least time the H100 SXM could take,
the larger of its FLOP over 67 TFLOP/s (FP64 tensor core, data sheet)
and its bytes over 3.35 TB/s (each input and the output counted once),
summed, over the summed device time of those ops.
"""

from math import prod

from portbench.lib.trace import GEMMS, device_time_us, op_dtypes

PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
#: operands before the two factors, per GEMM op
_OPS = dict(zip(GEMMS, (0, 0, 1, 1)))


def bound_s(name: str, shapes) -> float:
    """Least seconds for one call: ``shapes`` are its input shapes."""
    skip = _OPS[name]
    a, b = shapes[skip], shapes[skip + 1]
    batch = prod(a[:-2])
    m, k, n = a[-2], a[-1], b[-1]
    flops = 2.0 * batch * m * n * k
    elems = prod(a) + prod(b) + batch * m * n
    if skip:
        elems += prod(shapes[0])
    return max(flops / PEAK_FLOPS, 8.0 * elems / PEAK_BYTES)


def read(t):
    p = t.profile
    if p is None:
        return None
    least = spent = 0.0
    for e in p.ops:
        if e.name not in _OPS:
            continue
        dtypes = op_dtypes(p, e)
        shapes = getattr(e, "input_shapes", None) or []
        used = [d for d, s in zip(dtypes, shapes) if s]
        if not used or any(d != "double" for d in used):
            continue
        us = device_time_us(e)
        if us <= 0:
            continue
        least += bound_s(e.name, [s for s in shapes if s])
        spent += us * 1e-6
    if spent <= 0:
        return None
    return 100.0 * least / spent
