"""Build a CUDA C++ source of ``quemb_tpu_torch/csrc`` into a shared library.

Each kernel file has a plain C interface and is bound with ``ctypes``.  It
is compiled with ``nvcc`` for ``sm_90a`` into ``build/`` at the repository
root on first use, under a name that carries a hash of the source and the
flags, so a changed source builds anew and an unchanged one is reused.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            path = Path(root) / "bin" / "nvcc"
            if path.is_file():
                return str(path)
    raise RuntimeError(
        "nvcc not found in $CUDA_HOME/bin or /usr/local/cuda/bin: the"
        " CUDA kernels cannot be built"
    )


def library_path(src: Path) -> Path:
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build(src: Path) -> dict:
    """Compile ``src`` unless its hashed library is already built.

    Returns ``{"path", "cached", "seconds", "ptxas"}``; ``ptxas`` holds the
    ``-Xptxas -v`` lines (registers, shared memory, spills) of a fresh
    build.
    """
    so = library_path(src)
    if so.exists():
        return dict(path=str(so), cached=True, seconds=0.0, ptxas=[])
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a per-process name, then rename: concurrent processes
    # never load a half-written library
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, so)
    ptxas = [
        ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
        if "ptxas" in ln or "spill" in ln
    ]
    return dict(path=str(so), cached=False, seconds=seconds, ptxas=ptxas)
