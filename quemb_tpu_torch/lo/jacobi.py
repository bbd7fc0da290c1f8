"""Orbital localization by Jacobi pair-rotation sweeps: Boys, Pipek-Mezey,
Edmiston-Ruedenberg.

Replaces the reference's use of ``pyscf.lo.{Boys, PipekMezey,
EdmistonRuedenberg}`` (molbe/lo.py:get_loc).  All three maximize
``sum_i f(i,i)`` over orthogonal rotations; the optimal 2x2 rotation angle
has the standard closed form ``4a = atan2(B, -A)``.

JAX counterpart: ``quemb_tpu/lo/jacobi.py``, of which this is a copy (it
holds no jax): host numpy on the port's integrals, as there.
"""

from __future__ import annotations

import numpy as np

from quemb_tpu_torch.chem import integrals
from quemb_tpu_torch.chem.mole import Mole


def _jacobi_sweeps(compute_AB, apply_rot, n, max_sweeps=100, tol=1e-8):
    """Generic Jacobi loop: rotate every (i, j) pair toward the maximum."""
    for _ in range(max_sweeps):
        gain = 0.0
        for i in range(n):
            for j in range(i + 1, n):
                A, B = compute_AB(i, j)
                if abs(A) < 1e-14 and abs(B) < 1e-14:
                    continue
                alpha = 0.25 * np.arctan2(B, -A)
                dE = A + np.sqrt(A * A + B * B)  # gain of the rotation
                if dE < tol * 1e-2:
                    continue
                c, s = np.cos(alpha), np.sin(alpha)
                apply_rot(i, j, c, s)
                gain += dE
        if gain < tol:
            break
    return


def boys(mol: Mole, C: np.ndarray, max_sweeps=200, tol=1e-9) -> np.ndarray:
    """Foster-Boys localization: maximize sum_i |<i|r|i>|^2."""
    r_ints = integrals.dipole(mol)  # [3, nao, nao]
    C = np.array(C, copy=True)
    d = np.einsum("xpq,pi,qj->xij", r_ints, C, C, optimize=True)

    def AB(i, j):
        dij = d[:, i, j]
        diff = d[:, i, i] - d[:, j, j]
        A = float(dij @ dij - 0.25 * diff @ diff)
        B = float(dij @ diff)
        return A, B

    def rot(i, j, c, s):
        C[:, [i, j]] = C[:, [i, j]] @ np.array([[c, -s], [s, c]])
        _rotate_sym(d, i, j, c, s)

    _jacobi_sweeps(AB, rot, C.shape[1], max_sweeps, tol)
    return C


def _rotate_sym(T, i, j, c, s):
    """In-place R^T T R update of the last two (symmetric) axes of T."""
    Ti = c * T[..., :, i] + s * T[..., :, j]
    Tj = -s * T[..., :, i] + c * T[..., :, j]
    T[..., :, i], T[..., :, j] = Ti, Tj
    Ti = c * T[..., i, :] + s * T[..., j, :]
    Tj = -s * T[..., i, :] + c * T[..., j, :]
    T[..., i, :], T[..., j, :] = Ti, Tj


def pipek_mezey(
    mol: Mole, C: np.ndarray, S: np.ndarray | None = None,
    max_sweeps=200, tol=1e-9,
) -> np.ndarray:
    """Pipek-Mezey localization with Lowdin populations."""
    if S is None:
        S = integrals.overlap(mol)
    w, V = np.linalg.eigh(S)
    S_half = (V * np.sqrt(w)) @ V.T
    C = np.array(C, copy=True)
    X = S_half @ C  # [nao, nmo] orthogonalized
    slices = mol.aoslice_by_atom()
    # Q[A, i, j] = sum_{mu in A} X[mu,i] X[mu,j]
    Q = np.stack([X[p0:p1].T @ X[p0:p1] for p0, p1 in slices])

    def AB(i, j):
        qij = Q[:, i, j]
        diff = Q[:, i, i] - Q[:, j, j]
        A = float(qij @ qij - 0.25 * diff @ diff)
        B = float(qij @ diff)
        return A, B

    def rot(i, j, c, s):
        C[:, [i, j]] = C[:, [i, j]] @ np.array([[c, -s], [s, c]])
        _rotate_sym(Q, i, j, c, s)

    _jacobi_sweeps(AB, rot, C.shape[1], max_sweeps, tol)
    return C


def edmiston_ruedenberg(
    mol_or_eri, C: np.ndarray, max_sweeps=100, tol=1e-8
) -> np.ndarray:
    """Edmiston-Ruedenberg: maximize the orbital self-repulsion sum_i (ii|ii).

    Accepts a Mole (dense ERI computed) or a dense AO ERI tensor directly.
    Cost per sweep is O(n^2) 4-index updates - fine for the small spaces BE
    uses it on (bath localization, IAO post-localization).
    """
    eri = (
        mol_or_eri
        if isinstance(mol_or_eri, np.ndarray)
        else integrals.eri_full(mol_or_eri)
    )
    C = np.array(C, copy=True)
    g = np.einsum(
        "pqrs,pi,qj,rk,sl->ijkl", eri, C, C, C, C, optimize=True
    )

    def AB(i, j):
        A = g[i, j, i, j] - 0.25 * (
            g[i, i, i, i] + g[j, j, j, j] - 2 * g[i, i, j, j]
        )
        B = g[i, i, i, j] - g[j, j, j, i]
        return float(A), float(B)

    def rot(i, j, c, s):
        nonlocal g
        C[:, [i, j]] = C[:, [i, j]] @ np.array([[c, -s], [s, c]])
        R = np.eye(C.shape[1])
        R[i, i] = R[j, j] = c
        R[i, j] = -s
        R[j, i] = s
        g = np.einsum(
            "abcd,ai,bj,ck,dl->ijkl", g, R, R, R, R, optimize=True
        )

    _jacobi_sweeps(AB, rot, C.shape[1], max_sweeps, tol)
    return C


def get_loc(mol: Mole, C, method: str = "ER", S=None, **kw):
    """Localization dispatch (reference molbe/lo.py:get_loc)."""
    method = method.lower()
    if method == "boys":
        return boys(mol, C, **kw)
    if method == "pm":
        return pipek_mezey(mol, C, S=S, **kw)
    if method == "er":
        return edmiston_ruedenberg(mol, C, **kw)
    if method == "cholesky":
        # orbitals of the density C C^T from its eigenvectors
        P = C @ C.T
        w, V = np.linalg.eigh(P)
        keep = w > 1e-10
        return (V[:, keep] * np.sqrt(w[keep]))[:, ::-1]
    raise NotImplementedError(f"Localization scheme {method}")
