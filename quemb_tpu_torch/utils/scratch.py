"""Scratch-directory management (reference shared/manage_scratch.py).

``WorkDir`` creates a uniquely-named scratch area (SLURM job id or PID),
supports use as a context manager, per-fragment subdirectories, and cleanup
that runs only on clean exit.

JAX counterpart: ``quemb_tpu/utils/scratch.py``, of which this is a copy (it
holds no jax).
"""

from __future__ import annotations

import atexit
import os
import shutil
import sys
from pathlib import Path

from quemb_tpu_torch.config import settings

_clean_exit = False


def _mark_clean():
    global _clean_exit
    _clean_exit = True


def register_clean_exit(*paths: Path) -> None:
    """Delete the given paths at interpreter exit, but only on clean exit."""

    def hook():
        if sys.exc_info()[0] is None:
            for p in paths:
                shutil.rmtree(p, ignore_errors=True)

    atexit.register(hook)


class WorkDir:
    """A scratch working directory.

    Matches the reference's tested contract (scratch_manager_test.py):
    ``path`` is resolved to an absolute path, ``cleanup()`` raises
    :class:`FileNotFoundError` when the directory is already gone, and
    the context manager removes the directory on exit whether or not an
    exception is propagating (``register_clean_exit`` is the tool for
    keep-on-crash semantics at interpreter scope).
    """

    def __init__(
        self,
        path: str | Path | None = None,
        cleanup_at_end: bool = True,
    ):
        if path is None:
            job_id = os.environ.get("SLURM_JOB_ID", str(os.getpid()))
            path = Path(settings.SCRATCH_ROOT) / f"quemb_tpu_{job_id}"
        self.path = Path(path).resolve()
        self.path.mkdir(parents=True, exist_ok=True)
        self.cleanup_at_end = cleanup_at_end
        if cleanup_at_end:
            register_clean_exit(self.path)

    @classmethod
    def from_environment(
        cls, *, user_defined_root: str | Path | None = None, **kwargs
    ) -> "WorkDir":
        """SLURM-job-id / PID naming under ``user_defined_root`` (defaults
        to ``settings.SCRATCH_ROOT``; reference manage_scratch.py:21-42)."""
        if user_defined_root is None:
            return cls(None, **kwargs)
        job_id = os.environ.get("SLURM_JOB_ID", str(os.getpid()))
        return cls(
            Path(user_defined_root) / f"quemb_tpu_{job_id}", **kwargs
        )

    def make_subdir(self, name: str) -> "WorkDir":
        return WorkDir(self.path / name, cleanup_at_end=False)

    def cleanup(self) -> None:
        if not self.path.exists():
            raise FileNotFoundError(
                f"scratch directory already removed: {self.path}"
            )
        shutil.rmtree(self.path)

    def __truediv__(self, other) -> Path:
        return self.path / other

    def __fspath__(self) -> str:
        return str(self.path)

    def __enter__(self) -> "WorkDir":
        return self

    def __exit__(self, exc_type, exc, tb):
        if self.cleanup_at_end and self.path.exists():
            self.cleanup()
        return False

    def __repr__(self) -> str:
        return f"WorkDir({self.path})"
