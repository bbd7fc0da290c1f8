"""Dense symmetric linear algebra on torch.

JAX counterpart: ``quemb_tpu/ops/linalg.py``.  The JAX module wraps the
backend ``eigh`` in a Newton-Schulz / Jacobi refinement because the TPU's
f64 ``eigh`` is accurate to about 1e-7 only; ``torch.linalg.eigh`` is
accurate to f64 roundoff on the CPU and on CUDA, so the refinement is
dropped and ``eigh`` is the library routine.
"""

from __future__ import annotations

import torch

from quemb_tpu_torch.utils.profiling import count


def eigh(A: torch.Tensor):
    """``torch.linalg.eigh``: eigenvalues ascending, eigenvectors in the
    columns (batched over leading dimensions).  Counted as a host sync
    (``syncs``): on a card it reads its error flags back."""
    count("syncs")
    return torch.linalg.eigh(A)


def lowdin_inv_sqrt(S: torch.Tensor, tol: float = 1e-15) -> torch.Tensor:
    """S^{-1/2} over the non-singular eigenspace."""
    s, V = eigh(S)
    keep = s > tol
    inv_sqrt = torch.where(
        keep, 1.0 / torch.sqrt(torch.where(keep, s, torch.ones_like(s))),
        torch.zeros_like(s),
    )
    return (V * inv_sqrt[..., None, :]) @ V.transpose(-1, -2)
