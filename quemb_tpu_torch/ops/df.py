"""Density-fitted fragment ERIs from a three-index factor.

JAX counterpart: ``quemb_tpu/ops/df.py``.  This port takes the pieces the
BE slice runs: the pivoted-Cholesky factor (:func:`cholesky_df_factor`,
host numpy, a copy), :func:`resolve_auxbasis` for ``"cholesky[:tol]"``
specs, and the fragment transform (:func:`df_fragment_eri`,
:func:`df_transform_batched`): two quarter transforms and one Gram product
per fragment, as batched ``torch.matmul``.  Auxiliary-basis fits need the
integral engine and raise (ROADMAP A11, A13).  The JAX module's aux-axis
chunking is a budget for emulated f64 on the TPU and is not carried over.
"""

from __future__ import annotations

import numpy as np
import torch


def cholesky_df_factor(
    mol, tol: float = 1.0e-10, eri: np.ndarray | None = None
) -> np.ndarray:
    """Pivoted-Cholesky (Beebe-Linderberg) three-index factor.

    Decomposes the ERI supermatrix M[(mu nu),(la si)] = (mu nu|la si) as
    M ~ L L^T by diagonal-pivoted Cholesky, stopping when the largest
    residual diagonal falls below ``tol``, so that every ERI element is
    reproduced to ``tol``.  Returns B [rank, nao, nao].  ``eri`` is the
    dense AO ERI; computing it here needs the integral engine (A11).
    """
    if eri is None:
        raise NotImplementedError(
            "cholesky_df_factor needs the dense AO ERI: the integral"
            " engine arrives with ROADMAP A11"
        )
    n = eri.shape[0]
    M = np.ascontiguousarray(np.asarray(eri, np.float64).reshape(
        n * n, n * n
    ))
    d = np.diagonal(M).copy()
    max_rank = n * n
    L = np.zeros((max_rank, n * n))
    piv_mask = np.ones(n * n, bool)
    rank = 0
    while rank < max_rank:
        dm = np.where(piv_mask, d, -np.inf)
        p = int(np.argmax(dm))
        dp = dm[p]
        if dp < tol:
            break
        col = M[:, p] - L[:rank].T @ L[:rank, p]
        ell = col / np.sqrt(dp)
        L[rank] = ell
        d = d - ell * ell
        piv_mask[p] = False
        rank += 1
    return L[:rank].reshape(rank, n, n)


def resolve_auxbasis(mol, spec):
    """Resolve an ``auxbasis`` spec: ``"cholesky"`` or ``"cholesky:<tol>"``
    gives ``("cholesky", tol)``.  Every other spec (aux molecules,
    even-tempered sets, tabulated fits) needs the integral engine and
    raises."""
    s = str(spec).lower() if spec is not None else ""
    if s.startswith("cholesky"):
        tol = float(s.split(":", 1)[1]) if ":" in s else 1.0e-10
        return "cholesky", tol
    raise NotImplementedError(
        f"auxbasis={spec!r}: auxiliary-basis fits need the integral engine"
        " (ROADMAP A11) and the DF tensors of A13; use 'cholesky[:tol]'"
    )


def df_fragment_eri(B: torch.Tensor, TA: torch.Tensor) -> torch.Tensor:
    """(ij|kl) for one fragment: B [naux, nao, nao], TA [nao, nemb]."""
    return df_transform_batched(B, TA[None])[0]


def df_transform_batched(B: torch.Tensor, TA_b: torch.Tensor) -> torch.Tensor:
    """Fragment ERIs [nf, nemb]^4 for a stack of bases TA_b [nf, nao, nemb]."""
    naux = B.shape[0]
    nf, _, nemb = TA_b.shape
    Bi = torch.einsum("pmn,fmi->fpin", B, TA_b)
    Bij = torch.matmul(Bi, TA_b[:, None])  # [nf, naux, nemb, nemb]
    Bf = Bij.reshape(nf, naux, nemb * nemb)
    eri = Bf.transpose(1, 2) @ Bf
    return eri.reshape(nf, nemb, nemb, nemb, nemb)
