"""Periodic Gaussian density fitting (own GDF) with k-points.

Replacement for the reference's use of pyscf ``df.GDF`` + libdmet
(reference kbe/pbe.py:39,530 consumes GDF through
``get_emb_eri_fast_gdf``; kbe/eri_onthefly.py:48 is its own
real-space + Fourier-space DF with charge compensation).

Here every Coulomb 2c/3c integral is evaluated with the background-
regularized kernel via the erf/erfc split of :mod:`kbe.pbc_int`:

  j2c[q][P,Q]      = (conj(X_P^q) | X_Q^q)
  j3c[k1,k2][P,uv] = (conj(X_P^q) | mu*_{k1} nu_{k2}),  q = k2 - k1

with X_P^q(r) = sum_L e^{i q.L} chi_P(r - L).  The auxiliary basis is an
even-tempered (ETB) set generated from the orbital basis (no external
tables).  ERIs assemble as  j3c^T . pinv(j2c[q]) . j3c  (metric inverted
by eigendecomposition -- the reference's ``_j2c_cholesky_or_eig``,
kbe/eri_onthefly.py:18).

JAX counterpart: ``quemb_tpu/kbe/df.py``.  The aux bases and
:meth:`KGDF.build` (host numpy lattice sums and the metric's
pseudo-inverse, by ``np.linalg.eigh`` as there) are copies; after the build
``_j3c`` and the metric's half-inverse factor ``_j2c_half`` (in place of
the JAX package's explicit pseudo-inverse, from the same host eigh) live
on the ``KGDF``'s device as complex128 tensors, and :meth:`KGDF.get_jk`
and :meth:`KGDF.emb_eri` run there.
"""

from __future__ import annotations

import numpy as np
import torch

from quemb_tpu_torch.chem.integrals import (
    _eri_quartets,
    _PairClass,
    hermite_index_list,
)
from quemb_tpu_torch.chem.mole import Shell, _normalize_contraction, ncart
from quemb_tpu_torch.kbe.cell import Cell
from quemb_tpu_torch.kbe.pbc_int import (
    _R_sparse_kernel,
    ft_aopair_kpts,
    ft_single,
    pair_images,
    s_t_kpts,
)
from quemb_tpu_torch.utils.device import resolve_device

__all__ = ["make_etb_aux", "KGDF"]


class AuxBasis:
    """Minimal shell container for the auxiliary basis."""

    def __init__(self, shells: list[Shell]):
        self.shells = shells
        self.nao = sum(ncart(sh.l) for sh in shells)


def make_etb_aux(
    cell, beta: float = 1.6, lmax_cap: int = 3, l_extra: int = 0
) -> AuxBasis:
    """Even-tempered auxiliary basis from the orbital basis.

    Per atom: for each l up to min(2*l_max + l_extra, lmax_cap + l_extra),
    single-primitive Gaussians with exponents beta-spaced covering
    [2*e_min, 2*e_max] of the atom's orbital exponents (products of two
    orbital Gaussians).

    ``l_extra`` raises the angular ceiling beyond the 2*l_max product rule.
    Atom-centered aux sets cannot represent *off-center* product Gaussians
    at finite l, so the plain product rule leaves a fit floor (s-only aux
    for an H/sto-3g cell plateaus at ~1e-3 in J/K no matter how dense the
    exponent grid).  Measured against the fit-free
    :class:`~quemb_tpu_torch.kbe.exact4c.ExactFourCenter` oracle on the
    H2-chain test cell, each extra l buys ~25x: l_extra 0/1/2/3 -> max|dJ| 1.2e-3 /
    5.2e-5 / 3.6e-6 / 1.1e-7.

    Aux-quality note (polyacetylene/STO-3G KRHF vs the reference's
    pyscf-GDF value): beta 2.0 -> -1.3 mHa, 1.6 -> -0.62 mHa,
    1.4 -> -0.48 mHa, all at cutoff-converged lattice/G sums (precision
    1e-12 moves the energy by 3e-7).  The aux-converged limit sits
    ~0.5 mHa below the reference number, i.e. the residual is the
    difference between two DF fit errors (pyscf's default aux cannot be
    reproduced offline), not a convergence defect of this stack.
    """
    shells: list[Shell] = []
    offset = 0
    # group orbital shells by atom
    by_atom: dict[int, list[Shell]] = {}
    for sh in cell.shells:
        by_atom.setdefault(sh.atom_idx, []).append(sh)
    for ia, shs in sorted(by_atom.items()):
        emin = min(float(np.min(s.exps)) for s in shs)
        emax = max(float(np.max(s.exps)) for s in shs)
        lmax = min(2 * max(s.l for s in shs), lmax_cap) + l_extra
        lo, hi = 2.0 * emin, 2.0 * emax
        n = int(np.ceil(np.log(hi / lo) / np.log(beta))) + 1
        exps = lo * beta ** np.arange(n)
        center = shs[0].center
        for l in range(lmax + 1):
            for e in exps:
                coefs = _normalize_contraction(l, [e], [1.0])
                shells.append(
                    Shell(l, np.array([e]), coefs, center, ia, offset)
                )
                offset += ncart(l)
    return AuxBasis(shells)


def make_aug_etb_aux(cell, beta: float = 2.0) -> AuxBasis:
    """Even-tempered aux in the pyscf ``aug_etb`` style.

    Per atom: collect the min/max orbital exponent PER angular momentum,
    then for each auxiliary l up to 2*l_max use the geometric means over
    (l1, l2) pairs with l1+l2 == l, with the max doubled (alpha+alpha on
    one center), as the ETB range.  This is the recipe behind the
    reference's default PBC GDF auxiliary basis when no tabulated fitting
    set exists (pyscf df/addons.py aug_etb), so matching it reproduces
    the reference's fit-error signature on minimal bases.
    """
    shells: list[Shell] = []
    offset = 0
    by_atom: dict[int, list[Shell]] = {}
    for sh in cell.shells:
        by_atom.setdefault(sh.atom_idx, []).append(sh)
    for ia, shs in sorted(by_atom.items()):
        lmax = max(s.l for s in shs)
        emin_l = np.full(lmax + 1, np.inf)
        emax_l = np.zeros(lmax + 1)
        for s in shs:
            emin_l[s.l] = min(emin_l[s.l], float(np.min(s.exps)))
            emax_l[s.l] = max(emax_l[s.l], float(np.max(s.exps)))
        center = shs[0].center
        for laux in range(2 * lmax + 1):
            pairs = [
                (l1, l2)
                for l1 in range(lmax + 1)
                for l2 in range(lmax + 1)
                if l1 + l2 == laux
            ]
            # pyscf df/addons.py aug_etb: BOTH bounds doubled (alpha+alpha
            # on one center) and n from log((emax+emin)/emin)/log(beta),
            # exponents emin * beta**i -- reproduced exactly so the fit
            # error signature matches the reference's default PBC aux
            emin = 2.0 * min(
                np.sqrt(emin_l[l1] * emin_l[l2]) for l1, l2 in pairs
            )
            emax = 2.0 * max(
                np.sqrt(emax_l[l1] * emax_l[l2]) for l1, l2 in pairs
            )
            n = max(
                1,
                int(np.ceil(np.log((emax + emin) / emin) / np.log(beta))),
            )
            exps = emin * beta ** np.arange(n)
            for e in exps:
                coefs = _normalize_contraction(laux, [e], [1.0])
                shells.append(
                    Shell(laux, np.array([e]), coefs, center, ia, offset)
                )
                offset += ncart(laux)
    return AuxBasis(shells)


def _wrap_q_key(cell: Cell, q: np.ndarray) -> tuple:
    frac = (q @ cell.a.T) / (2.0 * np.pi)
    frac = frac - np.floor(frac + 0.5 + 1e-9)
    return tuple(np.round(frac, 8))


def _aux_image_classes(aux: AuxBasis, Ls: np.ndarray):
    """Single-shell 'pair' classes over (aux shell, lattice image).

    Returns list of (_PairClass, Lvecs[n,3], aux_ao_offsets[n]) grouped by
    (l, nprim); the dummy partner makes 2c/3c reuse the 4c quartet code
    (same trick as integrals._single_shell_pairs).
    """
    from collections import defaultdict

    groups = defaultdict(list)
    for sh in aux.shells:
        for L in Ls:
            groups[(sh.l, len(sh.exps))].append((sh, L))
    out = []
    for items in groups.values():
        flat = []
        prs = []
        Lv = []
        offs = []
        for sh, L in items:
            dummy = Shell(
                0, np.array([0.0]), np.array([1.0]), sh.center + L,
                sh.atom_idx, 0,
            )
            shifted = Shell(
                sh.l, sh.exps, sh.coefs, sh.center + L, sh.atom_idx,
                sh.ao_offset,
            )
            flat += [shifted, dummy]
            prs.append((len(flat) - 2, len(flat) - 1))
            Lv.append(L)
            offs.append(sh.ao_offset)
        pc = _PairClass(flat, prs)
        pc._H = pc.hermite_coefs()
        out.append((pc, np.asarray(Lv), np.asarray(offs)))
    return out


def _eri_quartets_erfc(pc1, pc2, b, k, omega, shiftQ=None):
    """Contracted erfc-kernel Coulomb quartets (mirror of _eri_quartets).

    ``shiftQ``: optional [3] lattice translation applied to the ket pair's
    Gaussian product centers (translation leaves the Hermite expansion
    coefficients invariant, so shifted-image quartets reuse pc2._H).
    """
    from quemb_tpu_torch.chem.integrals import _combined_hermite_map

    L1, L2 = pc1.Lx, pc2.Lx
    cmap, sgn = _combined_hermite_map(L1, L2)
    p = pc1.p[b]
    q = pc2.p[k]
    P = pc1.P[b]
    Q = pc2.P[k]
    if shiftQ is not None:
        Q = Q + np.asarray(shiftQ)[None, None, :]
    psum = p[:, :, None] + q[:, None, :]
    theta = p[:, :, None] * q[:, None, :] / psum
    PQ = P[:, :, None, :] - Q[:, None, :, :]
    pref = (
        2.0
        * np.pi**2.5
        / (p[:, :, None] * q[:, None, :] * np.sqrt(psum))
        * pc1.cc[b][:, :, None]
        * pc2.cc[k][:, None, :]
    )
    Rsp = _R_sparse_kernel(
        hermite_index_list(L1 + L2), L1 + L2, theta, PQ, omega=omega
    )
    Rsp = Rsp * pref[..., None]
    H1 = pc1._H[b]
    nq, nk_, nl, nidx = Rsp.shape
    nt, ns = cmap.shape
    na, nc = H1.shape[2], pc2._H.shape[2]
    # batched BLAS matmuls (the einsum forms fall to the slow c_einsum
    # kernel: the batch/contraction layout is not directly BLAS-able);
    # np.take fuses the (l,s)->combined gather with the (l,t) swap
    flat_idx = (
        np.arange(nl)[:, None, None] * nidx + cmap[None]
    ).reshape(-1)
    Rg = np.take(
        Rsp.reshape(nq, nk_, nl * nidx), flat_idx, axis=2
    ).reshape(nq, nk_, nl, nt, ns)
    Rm = np.ascontiguousarray(Rg.transpose(0, 1, 3, 2, 4)).reshape(
        nq, nk_ * nt, nl * ns
    )
    # H2 in [q,(l,s),c] layout; the transposed multiply allocates
    # C-contiguous directly
    Hm2 = (
        pc2._H[k].transpose(0, 1, 3, 2) * sgn[None, None, :, None]
    ).reshape(nq, nl * ns, nc)
    tmp = np.matmul(Rm, Hm2)  # [q, k*t, c]
    # out[q,a,c] = sum_{k,t} H1[q,a,(k,t)] tmp[q,(k,t),c]
    Hm1 = np.ascontiguousarray(H1.transpose(0, 2, 1, 3)).reshape(
        nq, na, nk_ * nt
    )
    return np.matmul(Hm1, tmp)


class KGDF:
    """k-point Gaussian density fitting over an ETB auxiliary basis."""

    def __init__(
        self,
        cell: Cell,
        kpts: np.ndarray,
        auxbasis: AuxBasis | None = None,
        omega: float = 0.6,
        beta: float = 1.6,
        cut: float = 1e-12,
        device: torch.device | str | None = None,
    ):
        self.device = resolve_device(device, "KGDF")
        self.cell = cell
        self.kpts = np.asarray(kpts).reshape(-1, 3)
        self.nk = len(self.kpts)
        # Default aux: the l_extra=1 ETB tier.  Measured fit errors vs
        # the fit-free exact4c oracle: CH2 chain +4.6e-5 (vs +1.7e-4 at
        # l_extra=0), polyacetylene KRHF +2.3e-4 (vs -1.08e-3) -- i.e.
        # the default now sits CLOSER to the exact answer than the
        # reference's own pyscf-GDF mean field (-4.6e-4 there).  Pass an
        # explicit make_etb_aux(cell, beta=...) for the lean tier.
        self.aux = auxbasis or make_etb_aux(cell, beta=beta, l_extra=1)
        self.naux = self.aux.nao
        self.omega = omega
        self.cut = cut
        self._built = False

    # ------------------------------------------------------------------ build
    def build(self):
        cell, aux, omega = self.cell, self.aux, self.omega
        nk, nao, naux = self.nk, cell.nao, self.naux
        Om = cell.vol

        self._pairs = pair_images(cell, self.cut)

        # SR image range: erfc(w_eff r) decay; w_eff bounded below by the
        # most diffuse pair-aux theta.
        p_min = min(float(np.min(s.exps)) for s in cell.shells) * 2.0 * 0.5
        q_min = min(float(np.min(s.exps)) for s in aux.shells)
        theta_min = p_min * q_min / (p_min + q_min)
        w_eff = min(omega, np.sqrt(theta_min))
        ext = float(
            np.max(np.linalg.norm(cell.atom_coords(), axis=1), initial=0.0)
        )
        rcut_sr = 6.5 / w_eff + 2.0 * ext + 2.0
        Laux = cell.lattice_Ls(rcut_sr)
        aux_classes = _aux_image_classes(aux, Laux)

        # unique q list and (k1,k2) -> q mapping
        qmap = {}
        self.kpair_q = np.empty((nk, nk), dtype=np.int64)
        qlist = []
        for a in range(nk):
            for b in range(nk):
                qv = self.kpts[b] - self.kpts[a]
                key = _wrap_q_key(cell, qv)
                if key not in qmap:
                    qmap[key] = len(qlist)
                    qlist.append(qv)
                self.kpair_q[a, b] = qmap[key]
        self.qlist = np.asarray(qlist)
        nq = len(qlist)

        # G grids per q
        gmax = 2.0 * omega * np.sqrt(np.log(1.0 / cell.precision) + 8.0)
        self._j2c = []
        j3c = [
            np.zeros((nk, naux, nao * nao), dtype=np.complex128)
            for _ in range(nq)
        ]  # indexed [q][k2-index restricted later]; see below

        # --- for each q: LR parts of j2c and j3c + SR parts
        S_k = None
        for iq, qv in enumerate(self.qlist):
            Gv = cell.get_Gv(gmax, q=qv)
            Gq = Gv + qv
            G2 = np.einsum("gi,gi->g", Gq, Gq)
            nzero = G2 > 1e-12
            Gv_nz, Gq_nz, G2_nz = Gv[nzero], Gq[nzero], G2[nzero]
            vG = 4.0 * np.pi * np.exp(-G2_nz / (4.0 * omega**2)) / G2_nz
            chi = ft_single(aux, Gq_nz)  # [naux, nG]

            # j2c LR + SR + G0
            j2c = np.einsum(
                "g,pg,qg->pq", vG, np.conj(chi), chi, optimize=True
            ) / Om
            j2c += self._sr_j2c(aux_classes, qv, omega)
            if not nzero.all():  # q = 0 grid contains G+q = 0
                nP = ft_single(aux, np.zeros((1, 3)))[:, 0].real
                j2c -= (np.pi / (Om * omega**2)) * np.outer(nP, nP)
            self._j2c.append(0.5 * (j2c + j2c.conj().T))

            # j3c LR: need rho^{(k1,k2)}(G+q) = sum_T e^{i k2 T} FT(...)(G+q)
            # for every k2 with k2 - k1 = q (k1 determined by k2).
            k2_list = []
            for a in range(nk):
                for b in range(nk):
                    if self.kpair_q[a, b] == iq:
                        k2_list.append((a, b))
            k2_phases = np.asarray([self.kpts[b] for (a, b) in k2_list])
            rho = ft_aopair_kpts(
                cell, Gq_nz, k2_phases, self.cut, pairs=self._pairs
            )  # [npair_k, nao, nao, nG]
            for i, (a, b) in enumerate(k2_list):
                v = np.einsum(
                    "g,pg,uvg->puv", vG, np.conj(chi), rho[i],
                    optimize=True,
                ) / Om
                j3c[iq][self._kpair_slot(a, b)] += v.reshape(naux, -1)
            # j3c G0 correction at q=0
            if not nzero.all():
                if S_k is None:
                    S_k, _ = s_t_kpts(cell, self.kpts, self.cut)
                nP = ft_single(aux, np.zeros((1, 3)))[:, 0].real
                for (a, b) in k2_list:
                    # here a == b (q=0)
                    j3c[iq][self._kpair_slot(a, b)] -= (
                        np.pi / (Om * omega**2)
                    ) * np.einsum("p,uv->puv", nP, S_k[b]).reshape(naux, -1)

            # j3c SR
            self._sr_j3c(
                j3c[iq], iq, qv, k2_list, aux_classes, omega
            )

        # [q, slot, naux, nao*nao] and [q, naux, nkeep], uploaded once
        self._j3c = torch.as_tensor(np.stack(j3c), device=self.device)
        halves = [self._half_inv(j) for j in self._j2c]
        nkeep = max(h.shape[1] for h in halves)
        self._j2c_half = torch.as_tensor(np.stack([
            np.pad(h, ((0, 0), (0, nkeep - h.shape[1]))) for h in halves
        ]), device=self.device)
        self._built = True
        return self

    def _kpair_slot(self, a: int, b: int) -> int:
        # slot within the q-group: index by k2 (b); for fixed q, each b
        # appears exactly once.
        return b

    @staticmethod
    def _half_inv(M, tol=1e-9):
        """L = V w^-1/2 over the metric's eigenvalues above ``tol`` times
        the largest: L L^H is the JAX package's pseudo-inverse
        (``KGDF._pinv``), from the same ``np.linalg.eigh``.

        tol=1e-9 (vs 1e-10), as there: the ETB default aux is
        near-linearly dependent, and dropping the tiny-eigenvalue metric
        directions shifts absolute energies by ~5e-7 (within the fit-error
        floor documented in KBE_PARITY.md).

        J/K and the embedding ERIs contract with L twice instead of with
        the pseudo-inverse once.  Its entries reach 1e9 / wmax, and
        rounding in a product with it comes back amplified that much:
        against 80-bit sums the JAX package's J is 5e-9 off on a H2 chain
        and its KRHF energy wanders by ~3e-9 a cycle at a commutator of
        ~1e-9 (1e-6 on polyacetylene, where it stops at its cycle cap).
        Through L, rounding is amplified by at most w^-1/2 (3e4): the same
        J is 3e-12 off and the KRHF stops after 12-14 cycles.
        """
        w, V = np.linalg.eigh(M)
        keep = w > tol * float(np.max(np.abs(w)))
        return V[:, keep] / np.sqrt(w[keep])

    # ----------------------------------------------------------- SR assembly
    def _sr_j2c(self, aux_classes, qv, omega):
        naux = self.naux
        out = np.zeros((naux, naux), dtype=np.complex128)
        # bra: aux at L=0 only (per-cell convention); ket: all images with
        # phase e^{+i q.L}  [ (conj X_P^q | X_Q^q) picks e^{iq(L_Q - L_P)};
        # fixing bra in cell 0 and summing ket images is the per-cell value ]
        for pc1, Lv1, off1 in aux_classes:
            sel1 = np.where(np.linalg.norm(Lv1, axis=1) < 1e-9)[0]
            if len(sel1) == 0:
                continue
            for pc2, Lv2, off2 in aux_classes:
                q1_min = float(np.min(pc1.a))
                q2_min = float(np.min(pc2.a))
                theta_min = q1_min * q2_min / (q1_min + q2_min)
                rcut = 6.5 / min(omega, np.sqrt(theta_min)) + 1.0
                d = np.linalg.norm(
                    pc1.A[sel1][:, None, :] - pc2.A[None, :, :], axis=-1
                )
                b, k = np.nonzero(d < rcut)
                b = sel1[b]
                if b.size == 0:
                    continue
                val = _eri_quartets_erfc(pc1, pc2, b, k, omega)
                na, nc = len(pc1.comps_a), len(pc2.comps_a)
                phase = np.exp(1j * (Lv2[k] @ qv))
                val = val.reshape(len(b), na, nc) * phase[:, None, None]
                rows = off1[b]
                cols = off2[k]
                for ia in range(na):
                    for ic in range(nc):
                        np.add.at(
                            out.reshape(-1),
                            (rows + ia) * naux + (cols + ic),
                            val[:, ia, ic],
                        )
        return out

    def _sr_j3c(self, j3c_q, iq, qv, k2_list, aux_classes, omega):
        """Accumulate SR (mu_0 nu_T |erfc| chi_{P,L}) e^{i k2 T} e^{-i q L}."""
        cell = self.cell
        nao, naux = cell.nao, self.naux
        for pc, Tv in self._pairs:
            if not hasattr(pc, "_H"):
                pc._H = pc.hermite_coefs()
            # effective pair centers for screening
            ctr = 0.5 * (pc.A + pc.B)  # [n,3]
            ext_pair = 0.5 * np.linalg.norm(pc.A - pc.B, axis=1)
            for pca, Lv, offs in aux_classes:
                q_min = float(np.min(pca.a))
                p_min = float(np.min(pc.p))
                theta_min = p_min * q_min / (p_min + q_min)
                w_eff = min(omega, np.sqrt(theta_min))
                rcut = 6.5 / w_eff
                actr = pca.A  # aux centers (incl. image shift), [m,3]
                d = np.linalg.norm(
                    ctr[:, None, :] - actr[None, :, :], axis=-1
                )
                mask = d < (rcut + ext_pair[:, None] + 1.0)
                b, k = np.nonzero(mask)
                if b.size == 0:
                    continue
                chunk = 200_000 // max(pc.K, 1)
                k2_vecs = np.asarray(
                    [self.kpts[b2] for (_, b2) in k2_list]
                )
                phases_T = np.exp(1j * (k2_vecs @ Tv.T))  # [nk2, n]
                phase_L = np.exp(-1j * (Lv @ qv))  # [m]
                for s in range(0, b.size, chunk):
                    sl = slice(s, min(s + chunk, b.size))
                    val = _eri_quartets_erfc(pc, pca, b[sl], k[sl], omega)
                    na, nb_ = len(pc.comps_a), len(pc.comps_b)
                    nc = len(pca.comps_a)
                    val = val.reshape(-1, na * nb_, nc)
                    rows_uv = (
                        (pc.ao_a[b[sl], None] + np.arange(na)[None, :])
                        [:, :, None] * nao
                        + (pc.ao_b[b[sl], None] + np.arange(nb_)[None, :])
                        [:, None, :]
                    ).reshape(-1, na * nb_)
                    wL = phase_L[k[sl]]
                    for i2, (a2, b2) in enumerate(k2_list):
                        w = phases_T[i2][b[sl]] * wL  # [nq_]
                        slot = self._kpair_slot(a2, b2)
                        tgt = j3c_q[slot]
                        for ic in range(nc):
                            cols = offs[k[sl]] + ic
                            flat = (
                                cols[:, None] * (nao * nao) + rows_uv
                            ).ravel()
                            np.add.at(
                                tgt.reshape(-1),
                                flat,
                                (w[:, None] * val[:, :, ic]).ravel(),
                            )
        return j3c_q

    # ------------------------------------------------------------------ J/K
    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.complex128, device=self.device)

    def _j3(self, iq: int, slot: int) -> torch.Tensor:
        nao = self.cell.nao
        return self._j3c[iq, slot].reshape(self.naux, nao, nao)

    def get_jk(self, dm_kpts):
        """Coulomb and exchange matrices per k (closed-shell dm), as
        [nk, nao, nao] complex128 tensors on the device.

        ERI(mu_k1 nu_k2 | lam_k3 sig_k4)
          = sum_PQ j3c[k1,k2][P,uv] conj(pinv[q])[P,Q] j3c[k3,k4][Q,ls]
          = sum_m (L_q^H j3c[k1,k2])[m,uv] (L_q^T j3c[k3,k4])[m,ls],
        with pinv[q] = L_q L_q^H (:meth:`_half_inv`).
        """
        assert self._built
        nk, nao = self.nk, self.cell.nao
        dm = self._tensor(dm_kpts).reshape(nk, nao, nao)
        iq0 = int(self.kpair_q[0, 0])
        slots0 = [self._kpair_slot(k, k) for k in range(nk)]
        j3_0 = self._j3c[iq0, slots0]  # [k, P, uv]
        L0 = self._j2c_half[iq0]
        c = torch.einsum("pm,kpx,kx->m", L0, j3_0,
                         dm.transpose(1, 2).reshape(nk, -1)) / nk
        J = torch.einsum("pm,kpx,m->kx", L0.conj(), j3_0, c)
        J = J.reshape(nk, nao, nao)
        J = 0.5 * (J + J.conj().transpose(1, 2))

        K = torch.zeros((nk, nao, nao), dtype=torch.complex128,
                        device=self.device)
        for k in range(nk):
            for kp in range(nk):
                iq = int(self.kpair_q[k, kp])
                L = self._j2c_half[iq]
                # bra pair (mu_k lam_kp), ket pair (sig_kp nu_k)
                A = torch.tensordot(
                    L.conj(), self._j3(iq, self._kpair_slot(k, kp)),
                    dims=([0], [0]),
                )
                B = torch.tensordot(
                    L, self._j3(int(self.kpair_q[kp, k]),
                                self._kpair_slot(kp, k)),
                    dims=([0], [0]),
                )
                K[k] += torch.einsum("qms,qsn->mn", A @ dm[kp], B)
        K /= nk
        K = 0.5 * (K + K.conj().transpose(1, 2))
        return J, K

    # --------------------------------------------------------- embedding ERI
    def _minus_q(self) -> list[int]:
        keys = [_wrap_q_key(self.cell, q) for q in self.qlist]
        return [keys.index(_wrap_q_key(self.cell, -q)) for q in self.qlist]

    def emb_eri(self, TA_k) -> torch.Tensor:
        """Real embedding-basis ERI (ij|kl) for supercell orbitals, as a
        [neo]^4 float64 tensor on the device.

        TA_k: [nk, nao, neo] per-k coefficients of real supercell embedding
        orbitals (analog of libdmet ``get_emb_eri_fast_gdf``, reference
        kbe/pbe.py:530).  With normalized Bloch AOs and the per-cell j3c
        convention:

          (ij|kl) = (1/nk^3) sum_q A_q[:,ij]^T conj(pinv[q]) A_{-q}[:,kl],
          A_q[P,ij] = sum_{(k1,k2): k2-k1 = q} conj(TA_{k1})^T j3c[k1,k2] TA_{k2}

        contracted as (L_q^H A_q)^T (L_q^T A_{-q}) (:meth:`_half_inv`).
        """
        assert self._built
        nk, nao, naux = self.nk, self.cell.nao, self.naux
        TA_k = self._tensor(TA_k).reshape(nk, nao, -1)
        neo = TA_k.shape[-1]

        nq = len(self.qlist)
        A = torch.zeros((nq, naux, neo, neo), dtype=torch.complex128,
                        device=self.device)
        for a in range(nk):
            for b in range(nk):
                iq = int(self.kpair_q[a, b])
                half = self._j3(iq, self._kpair_slot(a, b)) @ TA_k[b]
                A[iq] += TA_k[a].conj().T @ half  # [P, i, j]
        eri = torch.zeros((neo * neo, neo * neo), dtype=torch.complex128,
                          device=self.device)
        for iq, jq in enumerate(self._minus_q()):
            L = self._j2c_half[iq]
            Aq = L.conj().T @ A[iq].reshape(naux, neo * neo)
            Amq = L.T @ A[jq].reshape(naux, neo * neo)
            eri += Aq.T @ Amq
        eri = eri.reshape(neo, neo, neo, neo) / nk**3
        return _real_symmetrized(eri)


def _real_symmetrized(eri: torch.Tensor) -> torch.Tensor:
    """The real part of a complex embedding ERI, which must be real to
    1e-6, with its 8-fold symmetry enforced."""
    if (mx := float(eri.imag.abs().max())) > 1e-6:
        raise ValueError(f"Imaginary embedding ERI: {mx}")
    eri = eri.real
    eri = 0.5 * (eri + eri.permute(1, 0, 3, 2))
    return (0.5 * (eri + eri.permute(2, 3, 0, 1))).contiguous()
