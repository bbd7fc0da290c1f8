"""Full CI for embedded fragments: direct (matrix-free) determinant CI.

Replaces the reference's use of ``pyscf.fci`` (molbe/solver.py:339-343).
The sigma vector is built Knowles-Handy style from per-string single
excitation tables; the heavy (pq|rs) contraction is one dense matmul.
RDM conventions follow PySCF: ``E2 = 0.5 * sum((pq|rs) * dm2[p,q,r,s])``
with chemist-notation ERIs.

JAX counterpart: ``quemb_tpu/solvers/fci.py``, of which this is a copy (it
holds no jax): the CI is host numpy/scipy work in both packages.
"""

from __future__ import annotations

from itertools import combinations

import numpy as np
import scipy.linalg
import scipy.sparse.linalg


def _strings(nmo: int, nocc: int) -> list[tuple[int, ...]]:
    return list(combinations(range(nmo), nocc))


class FCISpace:
    """Direct-CI machinery for (nmo, nocc_alpha = nocc_beta = nocc)."""

    def __init__(self, nmo: int, nocc: int):
        self.nmo = nmo
        self.nocc = nocc
        strs = _strings(nmo, nocc)
        index = {s: i for i, s in enumerate(strs)}
        self.ns = ns = len(strs)
        self.dim = ns * ns
        # flattened single-excitation table: E_pq |I> = sign |J>
        I_l, p_l, q_l, s_l, J_l = [], [], [], [], []
        for I, occ in enumerate(strs):
            for q in occ:
                pos_q = occ.index(q)
                sign_q = (-1.0) ** pos_q
                reduced = occ[:pos_q] + occ[pos_q + 1 :]
                for p in range(nmo):
                    if p in reduced:
                        continue
                    n_before = sum(1 for x in reduced if x < p)
                    J = index[tuple(sorted(reduced + (p,)))]
                    I_l.append(I)
                    p_l.append(p)
                    q_l.append(q)
                    s_l.append(sign_q * (-1.0) ** n_before)
                    J_l.append(J)
        self.tab_I = np.array(I_l, dtype=np.int64)
        self.tab_p = np.array(p_l, dtype=np.int64)
        self.tab_q = np.array(q_l, dtype=np.int64)
        self.tab_s = np.array(s_l)
        self.tab_J = np.array(J_l, dtype=np.int64)
        # sparse operators: E_apply [(pq*ns + J), I] -> u = E_apply @ c
        #                   E_gather [J, (pq*ns + I)] -> sigma = E_gather @ g
        from scipy.sparse import csr_matrix

        pq = self.tab_p * nmo + self.tab_q
        self._E_apply = csr_matrix(
            (self.tab_s, (pq * ns + self.tab_J, self.tab_I)),
            shape=(nmo * nmo * ns, ns),
        )
        self._E_gather = csr_matrix(
            (self.tab_s, (self.tab_J, pq * ns + self.tab_I)),
            shape=(ns, nmo * nmo * ns),
        )

    # ------------------------------------------------------------ operators
    def apply_E_all(self, c: np.ndarray) -> np.ndarray:
        """u[p,q] = (E_pq^alpha + E_pq^beta) |c> for all (p,q).

        c: [ns, ns] (alpha strings x beta strings).
        Returns u: [nmo, nmo, ns, ns].
        """
        nmo, ns = self.nmo, self.ns
        ua = (self._E_apply @ c).reshape(nmo, nmo, ns, ns)
        ub = (self._E_apply @ c.T).reshape(nmo, nmo, ns, ns)
        return ua + ub.transpose(0, 1, 3, 2)

    def apply_E_weighted(self, g: np.ndarray) -> np.ndarray:
        """sigma = sum_pq E_pq g[p,q] where g: [nmo, nmo, ns, ns]."""
        nmo, ns = self.nmo, self.ns
        out = self._E_gather @ g.reshape(nmo * nmo * ns, ns)
        gb = np.ascontiguousarray(g.transpose(0, 1, 3, 2))
        outb = self._E_gather @ gb.reshape(nmo * nmo * ns, ns)
        return out + outb.T

    def sigma(self, c, h_eff, eri) -> np.ndarray:
        """H|c> with h_eff[p,s] = h1[p,s] - 0.5 sum_q (pq|qs)."""
        nmo, ns = self.nmo, self.ns
        u = self.apply_E_all(c.reshape(ns, ns))
        s1 = np.einsum("pq,pqxy->xy", h_eff, u, optimize=True)
        g = (
            eri.reshape(nmo * nmo, nmo * nmo)
            @ u.reshape(nmo * nmo, ns * ns)
        ).reshape(nmo, nmo, ns, ns)
        s2 = 0.5 * self.apply_E_weighted(g)
        return (s1 + s2).reshape(-1)

    def h_diag(self, h1, eri) -> np.ndarray:
        """Hamiltonian diagonal <D|H|D> over all determinants."""
        nmo, ns = self.nmo, self.ns
        occ = np.zeros((ns, nmo))
        for I, s in enumerate(_strings(nmo, self.nocc)):
            occ[I, list(s)] = 1.0
        hpp = np.diag(h1)
        J = np.einsum("ppqq->pq", eri)
        K = np.einsum("pqqp->pq", eri)
        hA = occ @ hpp  # [ns]
        jAA = 0.5 * np.einsum("ip,pq,iq->i", occ, J - K, occ)
        cross = occ @ J @ occ.T  # [ns, ns]
        diag = (
            hA[:, None]
            + hA[None, :]
            + jAA[:, None]
            + jAA[None, :]
            + cross
        )
        return diag.reshape(-1)

    # --------------------------------------------------------------- kernel
    def kernel(self, h1, eri, tol=1e-11, max_iter=200):
        """Davidson iteration for the lowest eigenpair."""
        h1 = np.asarray(h1, dtype=np.float64)
        eri = np.asarray(eri, dtype=np.float64)
        h_eff = h1 - 0.5 * np.einsum("pqqs->ps", eri)
        if self.dim == 1:
            c = np.ones(1)
            e = float(c @ self.sigma(c, h_eff, eri))
            return e, c
        if self.dim <= 400:
            # small spaces: build H densely by columns
            H = np.stack(
                [
                    self.sigma(np.eye(self.dim)[i], h_eff, eri)
                    for i in range(self.dim)
                ],
                axis=1,
            )
            w, v = scipy.linalg.eigh(H)
            return float(w[0]), v[:, 0]

        diag = self.h_diag(h1, eri)
        x0 = np.zeros(self.dim)
        x0[int(np.argmin(diag))] = 1.0
        V = [x0]
        S = [self.sigma(x0, h_eff, eri)]
        theta = float(x0 @ S[0])
        x = x0
        for _ in range(max_iter):
            Vm = np.stack(V, axis=1)
            Sm = np.stack(S, axis=1)
            Hm = Vm.T @ Sm
            Hm = 0.5 * (Hm + Hm.T)
            w, y = scipy.linalg.eigh(Hm)
            theta = float(w[0])
            x = Vm @ y[:, 0]
            r = Sm @ y[:, 0] - theta * x
            rnorm = np.linalg.norm(r)
            if rnorm < tol:
                break
            precond = diag - theta
            precond = np.where(np.abs(precond) < 1e-8, 1e-8, precond)
            t = r / precond
            # orthogonalize against the subspace (twice, for stability)
            for _ in range(2):
                t = t - Vm @ (Vm.T @ t)
            tn = np.linalg.norm(t)
            if tn < 1e-12:
                break
            t /= tn
            V.append(t)
            S.append(self.sigma(t, h_eff, eri))
            if len(V) > 40:  # collapse the subspace
                V = [x]
                S = [self.sigma(x, h_eff, eri)]
        return theta, x / np.linalg.norm(x)

    def make_rdm12(self, ci: np.ndarray):
        """(dm1, dm2) in the PySCF convention (mean-field part included)."""
        nmo, ns = self.nmo, self.ns
        c = ci.reshape(ns, ns)
        u = self.apply_E_all(c)  # chi_pq = E_pq |psi>
        dm1 = np.einsum("pqxy,xy->pq", u, c, optimize=True)
        uf = u.reshape(nmo, nmo, -1)
        dm2 = np.einsum("qpx,rsx->pqrs", uf, uf, optimize=True)
        for q in range(nmo):
            dm2[:, q, q, :] -= dm1
        return dm1, dm2


_SPACE_CACHE: dict[tuple[int, int], FCISpace] = {}


def fci_space(nmo: int, nocc: int) -> FCISpace:
    key = (nmo, nocc)
    if key not in _SPACE_CACHE:
        _SPACE_CACHE[key] = FCISpace(nmo, nocc)
    return _SPACE_CACHE[key]


def solve_fci(h1_mo, eri_mo, nocc: int):
    """FCI ground state in the given MO basis.

    Returns (e_el, dm1, dm2) with RDMs in the MO basis (pyscf convention).
    """
    nmo = h1_mo.shape[0]
    sp = fci_space(nmo, nocc)
    e, ci = sp.kernel(h1_mo, eri_mo)
    dm1, dm2 = sp.make_rdm12(ci)
    return e, dm1, dm2


def remove_mf_part(dm1, dm2, nsocc: int):
    """Subtract the mean-field/semi-cumulant part from an FCI dm2.

    Mirrors the cumulant correction applied for FCI solvers in the
    reference ``molbe/solver.py:533-556``.
    """
    hf_dm = np.zeros_like(dm1)
    np.fill_diagonal(hf_dm[:nsocc, :nsocc], 2.0)
    del_rdm1 = dm1.copy()
    del_rdm1[np.diag_indices(nsocc)] -= 2.0
    nc = (
        np.einsum("ij,kl->ijkl", hf_dm, hf_dm)
        + np.einsum("ij,kl->ijkl", hf_dm, del_rdm1)
        + np.einsum("ij,kl->ijkl", del_rdm1, hf_dm)
    )
    nc -= (
        np.einsum("ij,kl->iklj", hf_dm, hf_dm)
        + np.einsum("ij,kl->iklj", hf_dm, del_rdm1)
        + np.einsum("ij,kl->iklj", del_rdm1, hf_dm)
    ) * 0.5
    return dm2 - nc
