"""Native (C/C++) host kernels, built on demand with the system compiler.

JAX counterpart: ``quemb_tpu/native/__init__.py``.  The sources
(``boys.c``, ``eri.cpp``) are copies.  Two differences: the library is
built into ``build/`` at the repository root under a name of its own
(a hash of the sources, the flags and the host CPU's features), never
beside the sources; and a build that fails, or a library that does not
reproduce the Boys reference, raises.  Nothing falls back to the
pure-Python integrals, which at chain sizes would run for hours: they are
the plain versions the tests hold the library against, taken only when the
caller asks for them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
_SRCS = (_HERE / "boys.c", _HERE / "eri.cpp")
_BUILD_DIR = _HERE.parents[1] / "build"
_CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-std=c++17", "-fPIC",
              "-shared")
_LIB = None


def _cpu_features() -> bytes:
    """The host CPU's feature flags: ``-march=native`` binds the binary to
    them, so a ``build/`` carried to another machine is rebuilt there."""
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith(("flags", "Features")):
                return line.encode()
    except OSError:
        pass
    return platform.processor().encode()


def _library_path() -> Path:
    digest = hashlib.sha256(
        b"".join(s.read_bytes() for s in _SRCS)
        + " ".join(_CXX_FLAGS).encode() + _cpu_features()
    ).hexdigest()[:16]
    return _BUILD_DIR / f"quemb_torch_native-{digest}.so"


def _build() -> dict:
    """Compile the library unless the hashed one is already built.

    Returns ``{"path", "cached", "seconds"}``; raises ``RuntimeError``
    with the compiler's output when the build fails.
    """
    so = _library_path()
    if so.exists():
        return dict(path=str(so), cached=True, seconds=0.0)
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile under a per-process name, then rename: rename is atomic, so
    # concurrent processes never load a half-written library
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    failures = []
    # $CXX first, then the compiler on the PATH: a $CXX without an OpenMP
    # runtime (no libgomp.spec) must not hide a g++ that has one
    for cxx in dict.fromkeys([os.environ.get("CXX") or "g++", "g++"]):
        cmd = [cxx, *_CXX_FLAGS, *[str(s) for s in _SRCS], "-o", str(tmp),
               "-lm"]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.TimeoutExpired) as exc:
            failures.append(f"{cxx} did not run ({exc})")
            continue
        if proc.returncode == 0:
            break
        failures.append(
            f"{cxx} failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    else:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            "native integral library: " + "\n".join(failures)
        )
    os.replace(tmp, so)
    return dict(path=str(so), cached=False,
                seconds=time.perf_counter() - t0)


def _validate(lib) -> bool:
    """Cross-check boys_batch against the pure-numpy formulation.

    A stale or miscompiled binary (or one built for another ISA that still
    loads) must never silently poison integrals: reject it unless it
    reproduces the incomplete-gamma reference on a spread of T values.
    """
    import numpy as np
    from scipy.special import gammainc, gammaln

    mmax = 12
    T = np.array([0.0, 1e-14, 0.3, 3.0, 11.0, 16.9, 17.1, 40.0, 300.0])
    out = np.empty((mmax + 1, T.size))
    lib.boys_batch(
        mmax,
        np.ascontiguousarray(T).ctypes.data_as(
            ctypes.POINTER(ctypes.c_double)
        ),
        T.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    a = np.arange(mmax + 1)[:, None] + 0.5
    Ts = np.where(T < 1e-13, 1.0, T)[None, :]
    ref = np.exp(gammaln(a)) * gammainc(a, Ts) / (2.0 * Ts**a)
    ref = np.where(
        T[None, :] < 1e-13,
        1.0 / (2 * a) - T[None, :] / (2 * a + 2.0),
        ref,
    )
    return bool(np.all(np.abs(out - ref) < 1e-12 * (1.0 + np.abs(ref))))


def get_lib():
    """ctypes handle of the native library.

    Built from source on first use on every machine (no binary is shipped)
    and validated against the pure-numpy Boys function before it is
    trusted; raises ``RuntimeError`` when either step fails.
    """
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(_build()["path"])
        lib.boys_batch.argtypes = [
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_ssize_t,
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.boys_batch.restype = None
        if not _validate(lib):
            raise RuntimeError(
                "native integral library: boys_batch does not reproduce"
                " the incomplete-gamma reference; remove build/ and rebuild"
            )
        _LIB = lib
    return _LIB
