"""k-point orbital localization (per-k Lowdin, frozen-core aware).

Replacement for the reference ``kbe/lo.py:Mixin_k_Localize.localize``
(lowdin branch, reference kbe/lo.py:262-311): symmetric orthogonalization
per k-point; with frozen core the core projection is removed first and the
remaining valence space re-orthogonalized (population-filtered columns).

JAX counterpart: ``quemb_tpu/kbe/lo.py``, of which this is a copy (it
holds no jax).
"""

from __future__ import annotations

import numpy as np

__all__ = ["lowdin_k", "iao_pao_k"]


def _symm_orth_c(C, S, tol=1e-9):
    M = C.conj().T @ S @ C
    w, V = np.linalg.eigh(M)
    if w.min() < tol:
        raise ValueError(f"ill-conditioned symm orth (min eig {w.min():.1e})")
    return C @ (V / np.sqrt(w)) @ V.conj().T


def _cano_orth_c(C, S, tol=1e-7):
    M = C.conj().T @ S @ C
    w, V = np.linalg.eigh(M)
    keep = w > tol
    return C @ (V[:, keep] / np.sqrt(w[keep]))


def iao_pao_k(S_k, C_k, nocc: int, val_idx):
    """Per-k IAO + PAO coefficients (complex Knizia construction).

    Replacement for the reference ``kbe/lo.py:get_iao_k/get_pao_native_k``
    (reference kbe/lo.py:85,166) using the label-subset variant: the
    valence functions are the working-basis AOs at ``val_idx``, so the
    column -> atom assignment is deterministic and identical at every
    k-point (no per-k population reordering that could break cross-k
    phase consistency).

    Returns (Ciao_k [nk, nao, nval], Cpao_k [nk, nao, nao-nval]).
    """
    S_k = np.asarray(S_k)
    C_k = np.asarray(C_k)
    nk, nao, _ = S_k.shape
    val_idx = list(val_idx)
    vir_idx = [i for i in range(nao) if i not in set(val_idx)]
    Ciao_k, Cpao_k = [], []
    for k in range(nk):
        S1 = S_k[k]
        Co = C_k[k][:, :nocc]
        S12 = S1[:, val_idx]
        S2 = S1[np.ix_(val_idx, val_idx)]
        P12 = np.linalg.solve(S1, S12)
        P21 = np.linalg.solve(S2, S12.conj().T)
        O_pol = Co @ Co.conj().T
        C_depol = P12 @ P21 @ Co
        S_til = C_depol.conj().T @ S1 @ C_depol
        O_depol = C_depol @ np.linalg.inv(S_til) @ C_depol.conj().T
        Ciao_pol = (
            np.eye(nao)
            - (O_depol + O_pol - 2 * O_pol @ S1 @ O_depol) @ S1
        ) @ P12
        Ciao = _symm_orth_c(Ciao_pol, S1)
        rep = np.linalg.norm(Ciao @ Ciao.conj().T @ S1 @ O_pol - O_pol)
        if rep > 1e-8:
            raise RuntimeError(f"IAO_k occupied-span error {rep:.2e} at k={k}")
        Piao = Ciao @ Ciao.conj().T @ S1
        Cpao_red = (np.eye(nao) - Piao)[:, vir_idx]
        try:
            Cpao = _symm_orth_c(Cpao_red, S1)
        except ValueError:
            Cpao = _cano_orth_c(Cpao_red, S1)
        Ciao_k.append(Ciao)
        Cpao_k.append(Cpao)
    return np.asarray(Ciao_k), np.asarray(Cpao_k)


def _lowdin_W(S: np.ndarray) -> np.ndarray:
    es, vs = np.linalg.eigh(S)
    keep = es > 1e-14
    return (vs[:, keep] / np.sqrt(es[keep])) @ vs[:, keep].conj().T


def lowdin_k(S_k, C_k, ncore: int = 0, P_core=None):
    """Per-k Lowdin localized orbitals.

    Returns (W_k [nk, nao, nlo], lmo_k [nk, nlo, nmo-ncore]) where lmo_k are
    the occupied+virtual valence MOs expressed in the LO basis
    (reference kbe/lo.py:262).
    """
    S_k = np.asarray(S_k)
    C_k = np.asarray(C_k)
    nk, nao, _ = S_k.shape
    Ws, lmos = [], []
    for k in range(nk):
        W = _lowdin_W(S_k[k])
        for i in range(W.shape[1]):
            if W[i, i].real < 0:
                W[:, i] *= -1
        if ncore > 0:
            pcore = np.eye(nao) - P_core[k] @ S_k[k]
            C_ = pcore @ W
            Cpop = np.diag(
                (C_.conj().T @ S_k[k] @ C_).real
            )
            # keep exactly nao-ncore columns (largest remaining
            # population): the reference's fixed 0.7 threshold
            # (kbe/lo.py:296) yields k-dependent ragged counts for
            # borderline populations
            no_core_idx = np.sort(
                np.argsort(Cpop)[::-1][: nao - ncore]
            )
            C_ = C_[:, no_core_idx]
            S_ = C_.conj().T @ S_k[k] @ C_
            W = C_ @ _lowdin_W(S_)
        lmo = W.conj().T @ S_k[k] @ C_k[k][:, ncore:]
        Ws.append(W)
        lmos.append(lmo)
    return np.asarray(Ws), np.asarray(lmos)


def remove_core_lo_k(Clo_k, C_k, ncore: int, S_k):
    """Project the core MOs out of per-k localized orbitals.

    Mirror of the reference ``kbe/lo.py:remove_core_mo_k`` (its 0.5
    population threshold is replaced by keeping exactly nlo-ncore
    columns chosen from the k-SUMMED population, so the kept column set
    is identical at every k-point -- per-k thresholds can disagree
    between k-points and produce ragged LO spaces).
    """
    Clo_k = np.asarray(Clo_k)
    nk, nao, nlo = Clo_k.shape
    proj, pop = [], np.zeros(nlo)
    for k in range(nk):
        Ccore = C_k[k][:, :ncore]
        P = np.eye(nao) - Ccore @ Ccore.conj().T @ S_k[k]
        C1 = P @ Clo_k[k]
        proj.append(C1)
        pop += np.einsum("mi,mn,ni->i", C1.conj(), S_k[k], C1).real
    keep = np.sort(np.argsort(pop)[::-1][: nlo - ncore])
    out = np.asarray(
        [_symm_orth_c(proj[k][:, keep], S_k[k]) for k in range(nk)]
    )
    return out, keep
