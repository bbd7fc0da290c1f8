"""Intrinsic atomic orbitals (IAO) + projected atomic orbitals (PAO).

Self-contained implementation of the Knizia IAO construction
(G. Knizia, JCTC 2013, 9, 4834) and the PAO complement, covering the
reference's ``molbe/lo.py:get_iao/get_pao/get_xovlp`` and
``shared/external/lo_helper.py`` orthogonalizers.

JAX counterpart: ``quemb_tpu/lo/iao.py``, of which this is a copy (it holds
no jax): host numpy on the port's integrals and ``Mole``, as there.
"""

from __future__ import annotations

import numpy as np

from quemb_tpu_torch.chem import integrals
from quemb_tpu_torch.chem.mole import Mole


def symm_orth(C: np.ndarray, ovlp: np.ndarray, tol: float = 1e-9):
    """Symmetric (Lowdin) orthogonalization w.r.t. an overlap metric."""
    S = C.T @ ovlp @ C
    w, V = np.linalg.eigh(S)
    if w.min() < tol:
        raise ValueError(
            f"Matrix too ill-conditioned for symmetric orth (min eig {w.min():.2e})"
        )
    return C @ (V / np.sqrt(w)) @ V.T


def cano_orth(C: np.ndarray, ovlp: np.ndarray, tol: float = 1e-7):
    """Canonical orthogonalization, dropping the null space."""
    S = C.T @ ovlp @ C
    w, V = np.linalg.eigh(S)
    keep = w > tol
    return C @ (V[:, keep] / np.sqrt(w[keep]))


def valence_mole(mol: Mole, basis: str = "sto-3g") -> Mole:
    """The molecule in the valence basis."""
    return Mole(
        atom=[(s, xyz) for s, xyz in mol._atoms],
        basis=basis,
        charge=mol.charge,
        spin=mol.spin,
        unit="bohr",
    )


def get_xovlp(mol: Mole, basis: str = "sto-3g"):
    """(S12, S22): cross overlap working/valence and valence overlap."""
    mol_alt = valence_mole(mol, basis)
    S12 = integrals.cross_overlap(mol, mol_alt)
    S22 = integrals.overlap(mol_alt)
    return S12, S22, mol_alt


def _valence_indices(mol: Mole, valence_mol: Mole) -> list[int]:
    """Working-basis AO indices whose labels appear in the valence basis."""
    full = mol.ao_labels()
    val = set(valence_mol.ao_labels())
    return [i for i, lbl in enumerate(full) if lbl in val]


def get_iao(
    Co: np.ndarray,
    S12: np.ndarray,
    S1: np.ndarray,
    S2: np.ndarray,
    mol: Mole | None = None,
    iao_valence_basis: str | None = None,
    iao_loc_method: str = "lowdin",
) -> np.ndarray:
    """Symmetrically orthogonalized IAO coefficients (Knizia scheme)."""
    n = Co.shape[0]
    if iao_loc_method == "lowdin" and mol is not None and iao_valence_basis:
        # label-subset variant (reference lo.py:118-146): the valence
        # basis's labels alone, none of its integrals
        idx = _valence_indices(mol, valence_mole(mol, iao_valence_basis))
        S2 = S1[np.ix_(idx, idx)]
        S12 = S1[:, idx]

    P_12 = np.linalg.solve(S1, S12)
    P_21 = np.linalg.solve(S2, S12.T)
    O_pol = Co @ Co.T
    C_depol = P_12 @ P_21 @ Co
    S_til = C_depol.T @ S1 @ C_depol
    O_depol = C_depol @ np.linalg.inv(S_til) @ C_depol.T
    Ciao_pol = (
        np.eye(n) - (O_depol + O_pol - 2 * O_pol @ S1 @ O_depol) @ S1
    ) @ P_12
    Ciao = symm_orth(Ciao_pol, ovlp=S1)
    rep_err = np.linalg.norm(Ciao @ Ciao.T @ S1 @ O_pol - O_pol)
    if rep_err > 1e-10:
        raise RuntimeError(f"IAO occupied-span error {rep_err:.2e}")
    return Ciao


def get_pao(
    Ciao: np.ndarray,
    S1: np.ndarray,
    S12: np.ndarray,
    mol: Mole | None = None,
    iao_valence_basis: str | None = None,
    iao_loc_method: str = "lowdin",
) -> np.ndarray:
    """Orthogonalized PAOs: the complement of the IAO space."""
    n = Ciao.shape[0]
    Piao = Ciao @ Ciao.T @ S1
    if iao_loc_method == "lowdin" and mol is not None and iao_valence_basis:
        idx = _valence_indices(mol, valence_mole(mol, iao_valence_basis))
        vir_idx = [i for i in range(n) if i not in set(idx)]
        Cpao_red = (np.eye(n) - Piao)[:, vir_idx]
    else:
        P_12 = np.linalg.inv(S1) @ S12
        nonval = np.eye(n) - P_12 @ P_12.T
        Cpao_red = (np.eye(n) - Piao) @ nonval
    try:
        return symm_orth(Cpao_red, ovlp=S1)
    except ValueError:
        return cano_orth(Cpao_red, ovlp=S1)


def remove_core_mo(Clo, Ccore, S, thr: float = 0.5):
    """Project core MOs out of a localized set (reference lo.py:27)."""
    n, nlo = Clo.shape
    ncore = Ccore.shape[1]
    Pcore = Ccore @ Ccore.T @ S
    Clo1 = (np.eye(n) - Pcore) @ Clo
    pop = np.diag(Clo1.T @ S @ Clo1)
    idx_keep = np.where(pop > thr)[0]
    assert len(idx_keep) == nlo - ncore
    return symm_orth(Clo1[:, idx_keep], ovlp=S)
