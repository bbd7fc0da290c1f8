"""Lowdin (symmetric) orthogonalization (reference mbe.py:1395-1449).

JAX counterpart: ``quemb_tpu/lo/lowdin.py``.
"""

from __future__ import annotations

import torch

from quemb_tpu_torch.ops.linalg import lowdin_inv_sqrt


def lowdin_orth(S: torch.Tensor, tol: float = 1e-15) -> torch.Tensor:
    """W = V s^{-1/2} V^T over the non-singular eigenspace of S."""
    return lowdin_inv_sqrt(S, tol)
