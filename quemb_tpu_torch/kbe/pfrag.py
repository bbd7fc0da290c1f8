"""Periodic fragment embedding: supercell SVD Schmidt + phase transforms.

Replacement for the reference ``kbe/pfrag.py:Frags.sd`` (reference
kbe/pfrag.py:143-210) and ``kbe/solver.py:schmidt_decomp_svd``: the k-space
LO density is phase-transformed to the real-space supercell, the
environment-fragment block is SVD'd for bath orbitals, and the resulting
real supercell rotation is phased back to per-k ``TA_k``.

JAX counterpart: ``quemb_tpu/kbe/pfrag.py``, of which this is a copy (it
holds no jax).
"""

from __future__ import annotations

import numpy as np

__all__ = ["get_phase", "get_phase1", "schmidt_supercell_svd", "sd_kpts"]


def _cell_translations(cell, kmesh) -> np.ndarray:
    Ts = np.array(
        [
            (i, j, k)
            for i in range(kmesh[0])
            for j in range(kmesh[1])
            for k in range(kmesh[2])
        ],
        dtype=np.float64,
    )
    return Ts @ cell.a


def get_phase(cell, kpts, kmesh) -> np.ndarray:
    """(1/sqrt(NR)) e^{i T_R . k}  [R, k]  (reference kbe/misc.py:24)."""
    Ts = _cell_translations(cell, kmesh)
    return np.exp(1j * (Ts @ np.asarray(kpts).T)) / np.sqrt(Ts.shape[0])


def get_phase1(cell, kpts, kmesh) -> np.ndarray:
    """e^{-i T_R . k}  [R, k]  (reference kbe/misc.py:31)."""
    Ts = _cell_translations(cell, kmesh)
    return np.exp(-1j * (Ts @ np.asarray(kpts).T))


def schmidt_supercell_svd(rdm, frag_sites, thr_bath: float = 1e-10):
    """SVD Schmidt of the real supercell 1-RDM (ref kbe/solver.py:9).

    TA columns: fragment unit vectors, then env bath singular vectors with
    sigma >= thr_bath.
    """
    ntot = rdm.shape[0]
    frag = list(frag_sites)
    env = np.asarray([i for i in range(ntot) if i not in set(frag)])
    Denv = rdm[env][:, frag]
    U, sigma, _ = np.linalg.svd(Denv, full_matrices=False)
    nbath = int((sigma >= thr_bath).sum())
    nfs = len(frag)
    TA = np.zeros((ntot, nfs + nbath))
    TA[frag, :nfs] = np.eye(nfs)
    TA[env, nfs:] = U[:, :nbath]
    return TA, nfs, nbath


def sd_kpts(
    lao_k,
    lmo_k,
    nocc: int,
    AO_in_frag,
    cell,
    kpts,
    kmesh,
    thr_bath: float = 1e-10,
):
    """Supercell Schmidt for one fragment; returns (TA_ao_k, TA_lo_k, nf, nb).

    Mirrors reference kbe/pfrag.py:143 ``Frags.sd``:
    rdm1_lo_k -> phase to supercell -> real SVD Schmidt -> phase back.
    ``AO_in_frag`` are LO indices in the supercell LO space (cell-R block at
    offset R*nlo).
    """
    lao_k = np.asarray(lao_k)
    lmo_k = np.asarray(lmo_k)
    nk, nao, nlo = lao_k.shape
    rdm1_lo_k = np.asarray(
        [lmo_k[k][:, :nocc] @ lmo_k[k][:, :nocc].conj().T for k in range(nk)]
    )
    phase = get_phase(cell, kpts, kmesh)
    sup = np.einsum("Rk,kuv,Sk->RuSv", phase, rdm1_lo_k, phase.conj())
    sup = sup.reshape(nk * nlo, nk * nlo)
    if (mx := np.abs(sup.imag).max()) > 1e-6:
        raise ValueError(f"Imaginary density in supercell SD: {mx}")
    sup = sup.real

    TA_R, nf, nb = schmidt_supercell_svd(sup, AO_in_frag, thr_bath)
    teo = TA_R.shape[-1]
    TA_R = TA_R.reshape(nk, nlo, teo)
    phase1 = get_phase1(cell, kpts, kmesh)
    TA_lo_k = np.einsum("Rim,Rk->kim", TA_R, phase1)
    TA_ao_k = np.asarray(
        [lao_k[k] @ TA_lo_k[k] for k in range(nk)]
    )
    return TA_ao_k, TA_lo_k, nf, nb
