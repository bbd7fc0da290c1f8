"""Global settings with an RC-file override (reference shared/config.py).

Reads ``~/.quemb_tpu_rc.yml`` (or ``$QUEMB_TPU_RC``) if present.  YAML
parsing is optional; a missing yaml module degrades to defaults.

JAX counterpart: ``quemb_tpu/config.py``, of which this is a copy (it
holds no jax).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path


@dataclass
class Settings:
    #: root for scratch working directories
    SCRATCH_ROOT: Path = field(
        default_factory=lambda: Path(os.environ.get("TMPDIR", "/tmp"))
    )
    #: memory budget (GB) for blocked integral transforms
    INTEGRAL_TRANSFORM_MAX_MEMORY: float = 50.0
    #: default dtype for the numerics stack
    DTYPE: str = "float64"
    #: print per-stage timing tables at exit
    PRINT_TIMINGS: bool = False


def _load() -> Settings:
    cfg = Settings()
    rc = Path(os.environ.get("QUEMB_TPU_RC", "~/.quemb_tpu_rc.yml")).expanduser()
    if rc.exists():
        try:
            import yaml  # noqa: PLC0415

            data = yaml.safe_load(rc.read_text()) or {}
            for k, v in data.items():
                if hasattr(cfg, k):
                    if k == "SCRATCH_ROOT":
                        v = Path(v)
                    setattr(cfg, k, v)
        except ImportError:
            pass
    return cfg


settings = _load()


def dump_settings(path: str | Path | None = None) -> None:
    import json

    path = Path(path or "~/.quemb_tpu_rc.yml").expanduser()
    d = {
        k: (str(v) if isinstance(v, Path) else v)
        for k, v in settings.__dict__.items()
    }
    path.write_text(
        "\n".join(f"{k}: {json.dumps(v)}" for k, v in d.items()) + "\n"
    )
