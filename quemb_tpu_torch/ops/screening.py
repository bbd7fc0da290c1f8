"""Distance/overlap screening machinery (the sparse-DF analog).

Replacement for the reference's absolute-overlap screening
(molbe/eri_sparse_DF.py:723-968 ``_primitive_overlap``/``approx_S_abs``
and the C++ ``get_AO_per_MO`` reachability screen,
_cpp/eri_sparse_DF.cpp:443): the absolute-overlap matrix
S_abs[i,j] = int |phi_i| |phi_j| bounds which AOs can contribute to a
fragment MO, so downstream transforms can skip unreachable AO blocks.

S_abs is evaluated per primitive cartesian pair by Gauss-Hermite
quadrature (exact up to quadrature order; the integrand is
|poly| * gaussian), then contracted through the triangle inequality with
|coefficients| and normalized -- the reference's exact recipe, vectorized
over shell-pair classes instead of numba loops.

JAX counterpart: ``quemb_tpu/ops/screening.py``, of which this is a copy (it
holds no jax).
"""

from __future__ import annotations

import numpy as np
from numpy.polynomial.hermite import hermgauss

from quemb_tpu_torch.chem.mole import Mole, cart_components


def _primitive_abs_overlap_1d(la, lb, a, b, Ax, Bx, r, w):
    """int |x-Ax|^la |x-Bx|^lb e^{-a(x-Ax)^2 - b(x-Bx)^2} dx, batched.

    a, b, Ax, Bx broadcast together; (r, w) are Gauss-Hermite nodes.
    """
    p = a + b
    mu = a * b / p
    P = (a * Ax + b * Bx) / p
    pref = np.exp(-mu * (Ax - Bx) ** 2)
    x = P[..., None] + r / np.sqrt(p)[..., None]
    val = (
        np.abs(x - Ax[..., None]) ** la
        * np.abs(x - Bx[..., None]) ** lb
    )
    return pref * (val @ w) / np.sqrt(p)


def approx_S_abs(mol: Mole, nroots: int = 64) -> np.ndarray:
    """Approximate absolute-overlap matrix (>= |S| elementwise).

    Exact for uncontracted cartesian primitives; contractions are bounded
    via the triangle inequality (reference eri_sparse_DF.py:929).
    """
    r, w = hermgauss(nroots)
    nao = getattr(mol, "nao_cart", mol.nao)
    out = np.zeros((nao, nao))
    from quemb_tpu_torch.chem.mole import gaussian_norm

    for shi in mol.shells:
        for shj in mol.shells:
            ci = np.abs(shi.coefs)
            cj = np.abs(shj.coefs)
            a = shi.exps[:, None]
            b = shj.exps[None, :]
            val_ab = np.zeros(
                (len(shi.exps), len(shj.exps),
                 len(cart_components(shi.l)), len(cart_components(shj.l)))
            )
            for ia, ca in enumerate(cart_components(shi.l)):
                for ib, cb in enumerate(cart_components(shj.l)):
                    prod = np.ones_like(a * b)
                    for d in range(3):
                        prod = prod * _primitive_abs_overlap_1d(
                            ca[d], cb[d],
                            a, b,
                            shi.center[d] * np.ones(1)[0],
                            shj.center[d] * np.ones(1)[0],
                            r, w,
                        )
                    val_ab[:, :, ia, ib] = prod
            blk = np.einsum("p,q,pqab->ab", ci, cj, val_ab)
            out[
                shi.ao_offset : shi.ao_offset + blk.shape[0],
                shj.ao_offset : shj.ao_offset + blk.shape[1],
            ] = blk
    # normalize so the diagonal is 1 (reference _ensure_normalization)
    d = np.sqrt(np.diag(out))
    out = out / (d[:, None] * d[None, :])
    T = getattr(mol, "c2s", None)
    if T is not None:
        # |S_sph| <= |T| S_abs |T|^T elementwise (triangle inequality);
        # do NOT renormalize afterwards -- the sandwiched diagonal is
        # >= 1 and dividing it out would deflate the off-diagonal bound
        aT = np.abs(T) * d[None, :]
        out = aT @ out @ aT.T
    return out


def ao_reach_per_fragment(
    S_abs: np.ndarray, TA: np.ndarray, eps: float = 1e-8
) -> np.ndarray:
    """Boolean AO reachability mask of a fragment's embedding orbitals.

    AO mu is reachable if (S_abs @ |TA|)[mu, i] >= eps for any embedding
    orbital i (the C++ ``get_AO_per_MO`` screen, eri_sparse_DF.cpp:443).
    """
    reach = S_abs @ np.abs(TA)
    return (reach >= eps).any(axis=1)


def block_mask(reach: np.ndarray, block: int) -> np.ndarray:
    """Collapse an AO reachability mask to contraction blocks of ``block``."""
    nao = reach.shape[0]
    nblk = -(-nao // block)
    pad = np.zeros(nblk * block, dtype=bool)
    pad[:nao] = reach
    return pad.reshape(nblk, block).any(axis=1)
