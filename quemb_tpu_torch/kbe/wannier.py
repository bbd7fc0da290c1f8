"""Maximally-localized Wannier orbitals by Marzari-Vanderbilt spread
minimization over per-k gauge unitaries.

From-scratch replacement for the reference's pywannier90/wannier90 path
(reference kbe/lo.py:472,623): the discretized MV spread functional

  Omega = (1/Nk) sum_{k,b} w_b sum_n
            [ 1 - |M^{(k,b)}_nn|^2 + (Im ln M^{(k,b)}_nn + b . rbar_n)^2 ]

is minimized by steepest descent on U(k) with the standard MV gradient
(Marzari & Vanderbilt, PRB 56, 12847 (1997), eqs. 52-57).  The overlap
matrices M^{(k,b)} = <w_mk| e^{-i b.r} |w_n,k+b> come from the lattice
pair-FT machinery of :mod:`kbe.pbc_int`; directions with a single mesh
point use the full reciprocal vector (single-k Resta overlaps), so
aperiodic (vacuum) directions need no special casing.

Seeded from the per-k Lowdin orbitals (smooth gauge), rotating the FULL
LO space (occupied + virtual jointly) -- the BE pipeline consumes a
complete orthonormal localized basis, and the HF-in-HF invariant holds
for any unitary gauge.

JAX counterpart: ``quemb_tpu/kbe/wannier.py``, of which this is a copy (it
holds no jax).
"""

from __future__ import annotations

import numpy as np

from quemb_tpu_torch.kbe.lo import lowdin_k


def _overlap_matrices(cell, kpts, kmesh, W_k):
    """Per-(b, k) LO overlaps N[b][k] = W(k)^H B_b(k, k+b) W(k_partner),
    partner index map, b-vectors, and weights."""
    from quemb_tpu_torch.kbe.pbc_int import ft_aopair_kpts, pair_images

    kpts = np.asarray(kpts).reshape(-1, 3)
    nk = len(kpts)
    recip = cell.reciprocal_vectors()
    kmesh = np.asarray(kmesh, dtype=int)
    pairs = pair_images(cell, 1e-12)

    # k index bookkeeping on the Monkhorst mesh: kpts ordering follows
    # make_kpts (C order over the mesh)
    def k_index(ix):
        return int(np.ravel_multi_index(ix % kmesh, kmesh))

    grid = np.array(
        list(np.ndindex(*kmesh))
    )  # [nk, 3] integer mesh coords
    bs, wbs, partners, Ns = [], [], [], []
    for d in range(3):
        step = recip[d] / kmesh[d]
        for sgn in (+1, -1):
            b = sgn * step
            wb = 1.0 / (2.0 * float(b @ b))
            part = np.array([
                k_index(grid[k] + sgn * np.eye(3, dtype=int)[d])
                for k in range(nk)
            ])
            # B_b(k, k') in the AO Bloch basis; the pair-FT phase runs
            # with the ket's mesh k-point
            # M_mn = <psi_mk| e^{-i b.r} |psi_n,k+b>; with the periodic
            # AO Bloch gauge, psi_{k+b} == psi at the WRAPPED mesh point,
            # while the operator keeps the true (unwrapped) b.  A global
            # FT sign flip only swaps the +/-b partners.
            N_k = []
            for k in range(nk):
                kp = part[k]
                rho = ft_aopair_kpts(
                    cell, b[None, :], kpts[kp][None, :], pairs=pairs,
                )[0][:, :, 0]
                N_k.append(W_k[k].conj().T @ rho @ W_k[kp])
            bs.append(b)
            wbs.append(wb)
            partners.append(part)
            Ns.append(N_k)
    return bs, wbs, partners, Ns


def _spread(bs, wbs, partners, Ms, nk, nlo):
    """(Omega, rbar [nlo, 3]) of the current gauge."""
    rbar = np.zeros((nlo, 3))
    for b, wb, part, M_k in zip(bs, wbs, partners, Ms):
        for k in range(nk):
            d = np.diagonal(M_k[k])
            rbar -= (wb / nk) * np.outer(
                np.angle(d), b
            )
    om = 0.0
    for b, wb, part, M_k in zip(bs, wbs, partners, Ms):
        for k in range(nk):
            d = np.diagonal(M_k[k])
            q = np.angle(d) + rbar @ b
            om += (wb / nk) * float(
                np.sum(1.0 - np.abs(d) ** 2) + np.sum(q * q)
            )
    return om, rbar


def wannier_k(
    S_k,
    C_k,
    cell,
    kpts,
    kmesh,
    ncore: int = 0,
    P_core=None,
    max_iter: int = 300,
    tol: float = 1e-9,
    step: float = 0.25,
):
    """MLWF localization; same contract as :func:`kbe.lo.lowdin_k`.

    Returns (W_k [nk, nao, nlo], lmo_k, info) where info records the
    initial/final spread.
    """
    W0, lmo0 = lowdin_k(S_k, C_k, ncore=ncore, P_core=P_core)
    nk, nao, nlo = W0.shape
    bs, wbs, partners, N0 = _overlap_matrices(cell, kpts, kmesh, W0)

    U = [np.eye(nlo, dtype=np.complex128) for _ in range(nk)]

    def current_Ms():
        return [
            [
                U[k].conj().T @ N0[ib][k] @ U[partners[ib][k]]
                for k in range(nk)
            ]
            for ib in range(len(bs))
        ]

    Ms = current_Ms()
    om, rbar = _spread(bs, wbs, partners, Ms, nk, nlo)
    om0 = om
    eps = step
    for _ in range(max_iter):
        # MV gradient per k (anti-Hermitian)
        G = [np.zeros((nlo, nlo), dtype=np.complex128) for _ in range(nk)]
        for ib, (b, wb, part) in enumerate(zip(bs, wbs, partners)):
            for k in range(nk):
                M = Ms[ib][k]
                d = np.diagonal(M)
                d_safe = np.where(np.abs(d) < 1e-12, 1.0, d)
                q = np.angle(d) + rbar @ b
                R = M * d.conj()[None, :]
                T = (M / d_safe[None, :]) * q[None, :]
                A_ = 0.5 * (R - R.conj().T)
                S_ = (T + T.conj().T) / (2.0j)
                G[k] += (4.0 * wb / nk) * (A_ - S_)
        gnorm = max(float(np.abs(g).max()) for g in G)
        if gnorm < tol:
            break
        # backtracking steepest descent on U(k) <- U(k) exp(eps G(k))
        import scipy.linalg as sla

        for _bt in range(12):
            U_try = [
                U[k] @ sla.expm(eps * G[k]) for k in range(nk)
            ]
            U_save, U_now = U, U_try
            U = U_try
            Ms_try = current_Ms()
            om_try, rbar_try = _spread(bs, wbs, partners, Ms_try, nk, nlo)
            if om_try < om:
                Ms, om, rbar = Ms_try, om_try, rbar_try
                eps = min(eps * 1.5, 2.0)
                break
            U = U_save
            eps *= 0.5
        else:
            break
        if abs(om - om_try) < tol and om_try >= om:
            break

    W = np.asarray([W0[k] @ U[k] for k in range(nk)])
    lmo = np.asarray([U[k].conj().T @ lmo0[k] for k in range(nk)])
    info = {"spread_init": om0, "spread_final": om, "n_b": len(bs)}
    return W, lmo, info


def lo_spread(cell, kpts, kmesh, W_k):
    """MV spread of an arbitrary per-k LO set (diagnostic; used to
    compare Wannier vs IAO+PAO / Lowdin locality)."""
    W_k = np.asarray(W_k)
    nk, nao, nlo = W_k.shape
    bs, wbs, partners, Ns = _overlap_matrices(cell, kpts, kmesh, W_k)
    om, _ = _spread(bs, wbs, partners, Ns, nk, nlo)
    return om
