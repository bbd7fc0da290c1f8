"""Lowdin (symmetric) orthogonalization (reference mbe.py:1395-1449).

JAX counterpart: ``quemb_tpu/lo/lowdin.py``.
"""

from __future__ import annotations

import torch

from quemb_tpu_torch.ops.linalg import lowdin_inv_sqrt


def lowdin_orth(S: torch.Tensor, tol: float = 1e-15) -> torch.Tensor:
    """W = V s^{-1/2} V^T over the non-singular eigenspace of S."""
    return lowdin_inv_sqrt(S, tol)


def lowdin_localize(S, C):
    """Localized-orbital coefficients in the Lowdin AO basis: (W, W^T S C)
    with W = :func:`lowdin_orth` of S, on the device of ``S``."""
    S = torch.as_tensor(S, dtype=torch.float64)
    C = torch.as_tensor(C, dtype=torch.float64, device=S.device)
    W = lowdin_orth(S)
    return W, W.T @ S @ C
