"""Dense symmetric linear algebra on torch.

JAX counterpart: ``quemb_tpu/ops/linalg.py``.  The JAX module wraps the
backend ``eigh`` in a Newton-Schulz / Jacobi refinement because the TPU's
f64 ``eigh`` is accurate to about 1e-7 only; ``torch.linalg.eigh`` is
accurate to f64 roundoff on the CPU and on CUDA, so the refinement is
dropped.  On a card, float64 matrices of order up to 64 go to the batched
Jacobi kernel (:mod:`quemb_tpu_torch.ops.jacobi_eigh`), everything else to
``torch.linalg.eigh``.
"""

from __future__ import annotations

import torch

from quemb_tpu_torch.ops import jacobi_eigh
from quemb_tpu_torch.utils.profiling import count


def eigh(A: torch.Tensor):
    """Eigenvalues ascending, eigenvectors in the columns (batched over
    leading dimensions), from the lower triangle.

    A CUDA float64 tensor with n <= ``jacobi_eigh.MAX_N`` is solved by the
    Jacobi kernel in one launch with nothing read back, and its matrices
    are counted as ``eigh.kernel``.  Everything else (the CPU, float32,
    complex, n > 64) goes to ``torch.linalg.eigh``, its matrices counted
    as ``eigh.library``, and counts as a host sync (``syncs``): on a card
    it reads its error flags back.  Counts go to the innermost open span
    of the tracer.
    """
    n = A.shape[-1]
    mats = A.numel() // (n * n) if n else 0
    if A.is_cuda and A.dtype == torch.float64 and n <= jacobi_eigh.MAX_N:
        count("eigh.kernel", mats)
        w, V, _ = jacobi_eigh.jacobi_eigh(A)
        return w, V
    count("eigh.library", mats)
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
