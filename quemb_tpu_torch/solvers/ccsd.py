"""Shared CCSD settings and the batched DIIS coefficient solve.

JAX counterpart: ``quemb_tpu/solvers/ccsd.py``.  This port takes only what
the closed-shell path needs: ``DIIS_SPACE``, :func:`_diis_coeffs`,
:func:`_default_conv_tol` and :func:`_f32_only`.  The spin-orbital
kernels are ROADMAP A14.  The JAX module solves the bordered DIIS system
by an unrolled pivoted elimination (a TPU-safe form inside
``lax.while_loop``); here it is ``torch.linalg.solve_ex`` on the same
masked, scale-normalized system.  Mixed f32-then-f64 iteration
(``_use_mixed``) is not ported: the f64 path runs plain f64.
"""

from __future__ import annotations

import os

import torch

#: amplitude history length of the CCSD DIIS (the JAX default)
DIIS_SPACE = 6


def _diis_coeffs(B: torch.Tensor, nvalid: torch.Tensor) -> torch.Tensor:
    """DIIS coefficients [nf, m] from error Gram matrices B [nf, m, m]
    of a shift-append history whose valid entries are the LAST ``nvalid``
    [nf] slots (the JAX function with ``newest_last=True``).

    Invalid slots are masked to identity rows and the Gram block is
    scale-normalized for conditioning.
    """
    nf, m, _ = B.shape
    dt, dev = B.dtype, B.device
    valid = torch.arange(m, device=dev)[None, :] >= (m - nvalid)[:, None]
    B = torch.where(valid[:, :, None] & valid[:, None, :], B, 0.0)
    scale = B.abs().amax((1, 2)).clamp_min(1e-280)
    B = B / scale[:, None, None]
    eye = torch.eye(m, dtype=dt, device=dev)
    B = B + torch.diag_embed((~valid).to(dt)) + 1e-14 * eye
    # scaling B -> B/s leaves the coefficient part of the bordered
    # solution unchanged (only the multiplier rescales)
    border = torch.where(valid, -1.0, 0.0).to(dt)
    Bfull = torch.zeros((nf, m + 1, m + 1), dtype=dt, device=dev)
    Bfull[:, :m, :m] = B
    Bfull[:, m, :m] = border
    Bfull[:, :m, m] = border
    rhs = torch.zeros((nf, m + 1), dtype=dt, device=dev)
    rhs[:, m] = -1.0
    x, _ = torch.linalg.solve_ex(Bfull, rhs)
    return x[:, :m]


def _default_conv_tol() -> float:
    """Amplitude-norm convergence target (env QUEMB_TPU_CCSD_CONV_TOL)."""
    return float(os.environ.get("QUEMB_TPU_CCSD_CONV_TOL", "1e-9"))


def _f32_only() -> bool:
    """Capacity tier: run the whole CCSD in f32 (env
    QUEMB_TPU_CCSD_F32_ONLY=1), iterated to QUEMB_TPU_CCSD_F32_TOL; under
    ``BE(int_transform="sparse-DF")`` it also selects the f32 transform
    tier that runs the screened-DF kernel."""
    return os.environ.get("QUEMB_TPU_CCSD_F32_ONLY", "") in (
        "1", "true", "yes",
    )
