"""Fit-free periodic 4-center ERIs: the exact oracle for the k-point DF stack.

The molecular stack has an in-core exact tier that every DF variant is
tested against; the periodic stack so far only had fitted integrals (KGDF,
``kbe/df.py``), so DF fit error and everything-else error could not be
separated — the reference never separates them either (it inherits pyscf
GDF's fit error silently, kbe test ``kbe_polyacetylene_test.py:45-49``
builds ``df.GDF`` and asserts against numbers that embed its aux-basis
bias).  This module evaluates the Bloch-basis 4c ERIs *exactly* with the
same G=0-regularized range-separated kernel as KGDF:

  (f^q | g^{-q}) = SR_realspace(erfc)                       [MD lattice sum]
                 - pi/(Omega w^2) f~(0) g~(0)   (q = 0 only) [erfc G=0 moment]
                 + (1/Omega) sum_{G+q != 0} v_lr(|G+q|) f~(G+q) g~(-G-q)

with f = conj(mu^{k1}) nu^{k2} (momentum q = k2-k1, per-cell convention:
bra cell fixed at 0) and g = conj(lam^{k3}) sig^{k4} (momentum -q, ket
summed over cells L with phase e^{-i q.L}).  The conventions mirror
``KGDF.build`` term by term, so agreement between :class:`ExactFourCenter`
and a converged-aux KGDF validates both.

Intended scale: small cells (the truth anchor for tests and for the
polyacetylene north-star), not production — production stays on the
fitted path whose error this module bounds.

JAX counterpart: ``quemb_tpu/kbe/exact4c.py``.  :meth:`ExactFourCenter.build`
is a host copy; the tensors it leaves live on the instance's device as one
complex128 tensor, and :meth:`ExactFourCenter.get_jk` and
:meth:`ExactFourCenter.emb_eri` run there.
"""

from __future__ import annotations

import numpy as np
import torch

from quemb_tpu_torch.kbe.cell import Cell
from quemb_tpu_torch.kbe.df import (
    _eri_quartets_erfc,
    _real_symmetrized,
    _wrap_q_key,
)
from quemb_tpu_torch.kbe.pbc_int import ft_aopair_kpts, pair_images, s_t_kpts
from quemb_tpu_torch.utils.device import resolve_device

__all__ = ["ExactFourCenter"]


class ExactFourCenter:
    """Exact Bloch 4c ERI tensors per momentum transfer q.

    Storage: ``self._eri[iq][b2, b4, u, v, l, s]`` complex, where ``b2``
    indexes the bra pair (k1, k2) by k2 (k1 = k2 - q is determined) and
    ``b4`` the ket pair (k3, k4) by k4 (k3 = k4 + q).  Pair index order
    matches KGDF's j3c ``(mu, nu)`` rows.
    """

    def __init__(
        self,
        cell: Cell,
        kpts: np.ndarray,
        omega: float = 0.6,
        cut: float = 1e-12,
        sr_tol: float = 1e-11,
        device: torch.device | str | None = None,
    ):
        self.device = resolve_device(device, "ExactFourCenter")
        self.cell = cell
        self.kpts = np.asarray(kpts).reshape(-1, 3)
        self.nk = len(self.kpts)
        self.omega = omega
        self.cut = cut
        self.sr_tol = sr_tol
        self._built = False

    # ------------------------------------------------------------------ build
    def build(self):
        cell, omega = self.cell, self.omega
        nk, nao = self.nk, cell.nao
        Om = cell.vol

        pairs = pair_images(cell, self.cut)
        for pc, _ in pairs:
            if not hasattr(pc, "_H"):
                pc._H = pc.hermite_coefs()

        # unique q list + (k1,k2) -> q map (same recipe as KGDF.build)
        qmap: dict = {}
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

        S_k, _ = s_t_kpts(cell, self.kpts, self.cut)
        self._S_k = S_k

        # SR image range: erfc(w_eff r) decay over ket cells L (w_eff from
        # the most diffuse pair-pair theta, as in KGDF.build)
        p_min = 2.0 * min(float(np.min(s.exps)) for s in cell.shells)
        theta_min = p_min * p_min / (p_min + p_min)
        w_eff = min(omega, np.sqrt(theta_min))
        ext = float(
            np.max(np.linalg.norm(cell.atom_coords(), axis=1), initial=0.0)
        )
        # pair products live up to ~2 ext (+ image offsets folded into the
        # per-pair centers below), so pad generously: the erfc tail sets it
        rcut_sr = 6.5 / w_eff + 2.0 * ext + 2.0
        Lsr = cell.lattice_Ls(rcut_sr)

        gmax = 2.0 * omega * np.sqrt(np.log(1.0 / cell.precision) + 8.0)

        eri = [
            np.zeros((nk, nk, nao, nao, nao, nao), dtype=np.complex128)
            for _ in range(nq)
        ]

        # effective centers/extents/magnitudes of each pair instance for
        # quartet screening: W ~ integral-magnitude of the contracted pair
        from scipy.special import erfc as _erfc  # noqa: PLC0415

        ctr = [0.5 * (pc.A + pc.B) for pc, _ in pairs]
        extp = [
            0.5 * np.linalg.norm(pc.A - pc.B, axis=1) for pc, _ in pairs
        ]
        wgt = []
        for pc, _ in pairs:
            ab2 = np.einsum("ni,ni->n", pc.AB, pc.AB)
            th_ab = pc.a * pc.b / pc.p
            wgt.append(
                np.einsum(
                    "nk->n",
                    np.abs(pc.cc)
                    * (np.pi / pc.p) ** 1.5
                    * np.exp(-th_ab * ab2[:, None]),
                )
            )

        for iq, qv in enumerate(self.qlist):
            # ---------------- LR (G-space, exact given the erf kernel)
            Gv = cell.get_Gv(gmax, q=qv)
            Gq = Gv + qv
            G2 = np.einsum("gi,gi->g", Gq, Gq)
            nzero = G2 > 1e-12
            Gq_nz, G2_nz = Gq[nzero], G2[nzero]
            vG = 4.0 * np.pi * np.exp(-G2_nz / (4.0 * omega**2)) / G2_nz
            # bra pair FTs f~(G+q) at every k2 slot; ket pair FTs g~(-G-q)
            # at every k4 slot
            rho_b = ft_aopair_kpts(
                cell, Gq_nz, self.kpts, self.cut, pairs=pairs
            ).reshape(nk, nao * nao, -1)
            rho_k = ft_aopair_kpts(
                cell, -Gq_nz, self.kpts, self.cut, pairs=pairs
            ).reshape(nk, nao * nao, -1)
            nG = Gq_nz.shape[0]
            tgt = eri[iq].reshape(nk, nk, nao * nao, nao * nao)
            chunk = max(1, int(2e8 // (nao * nao * nk)))
            for s in range(0, nG, chunk):
                sl = slice(s, min(s + chunk, nG))
                fb = rho_b[:, :, sl] * vG[None, None, sl]
                tgt += (
                    np.einsum(
                        "bxg,dyg->bdxy", fb, rho_k[:, :, sl], optimize=True
                    )
                    / Om
                )

            # ---------------- G = 0 correction of the erfc moment (q=0)
            if not nzero.all():
                tgt -= (np.pi / (Om * omega**2)) * np.einsum(
                    "bx,dy->bdxy",
                    S_k.reshape(nk, nao * nao),
                    S_k.reshape(nk, nao * nao),
                )

            # ---------------- SR (erfc real-space lattice sum)
            for i1, (pc1, Tv1) in enumerate(pairs):
                ph_b = np.exp(1j * (self.kpts @ Tv1.T))  # [nk(b2), n1]
                na, nb_ = len(pc1.comps_a), len(pc1.comps_b)
                rows_uv = (
                    (pc1.ao_a[:, None] + np.arange(na)[None, :])[:, :, None]
                    * nao
                    + (pc1.ao_b[:, None] + np.arange(nb_)[None, :])[:, None, :]
                ).reshape(pc1.n, na * nb_)
                for i2, (pc2, Tv2) in enumerate(pairs):
                    nc, nd = len(pc2.comps_a), len(pc2.comps_b)
                    cols_ls = (
                        (pc2.ao_a[:, None] + np.arange(nc)[None, :])
                        [:, :, None] * nao
                        + (pc2.ao_b[:, None] + np.arange(nd)[None, :])
                        [:, None, :]
                    ).reshape(pc2.n, nc * nd)
                    ph_k = np.exp(1j * (self.kpts @ Tv2.T))  # [nk(b4), n2]
                    p1 = float(np.min(pc1.p))
                    p2 = float(np.min(pc2.p))
                    th = p1 * p2 / (p1 + p2)
                    w12 = min(omega, np.sqrt(th))
                    ww = wgt[i1][:, None] * wgt[i2][None, :]  # [n1, n2]
                    # bounding-sphere prune: outside r_max even the largest
                    # weight product cannot beat sr_tol
                    from scipy.special import erfcinv as _erfcinv

                    wmax = float(np.max(wgt[i1])) * float(np.max(wgt[i2]))
                    arg = min(1.0, max(self.sr_tol / max(wmax, 1e-300), 0.0))
                    r_max = (
                        _erfcinv(arg) / w12
                        + float(np.max(extp[i1], initial=0.0))
                        + float(np.max(extp[i2], initial=0.0))
                        + 1.0
                    )
                    c1m = 0.5 * (ctr[i1].max(0) + ctr[i1].min(0))
                    c2m = 0.5 * (ctr[i2].max(0) + ctr[i2].min(0))
                    rad1 = float(
                        np.max(np.linalg.norm(ctr[i1] - c1m, axis=1))
                    )
                    rad2 = float(
                        np.max(np.linalg.norm(ctr[i2] - c2m, axis=1))
                    )
                    for L in Lsr:
                        if (
                            np.linalg.norm(c1m - c2m - L)
                            > r_max + rad1 + rad2
                        ):
                            continue
                        d = np.linalg.norm(
                            ctr[i1][:, None, :]
                            - (ctr[i2][None, :, :] + L[None, None, :]),
                            axis=-1,
                        )
                        deff = np.maximum(
                            d - extp[i1][:, None] - extp[i2][None, :] - 1.0,
                            0.0,
                        )
                        est = (
                            ww * _erfc(w12 * deff) / np.maximum(d, 1.0)
                        )
                        mask = est > self.sr_tol
                        b, k = np.nonzero(mask)
                        if b.size == 0:
                            continue
                        phL = np.exp(-1j * float(qv @ L))
                        ck = max(1, 400_000 // max(pc1.K * pc2.K, 1))
                        for s0 in range(0, b.size, ck):
                            sl = slice(s0, min(s0 + ck, b.size))
                            val = _eri_quartets_erfc(
                                pc1, pc2, b[sl], k[sl], omega, shiftQ=L
                            )  # [nq_, na*nb_, nc*nd]
                            w_b = ph_b[:, b[sl]] * phL  # [nk, nq_]
                            w_k = ph_k[:, k[sl]]  # [nk, nq_]
                            r_uv = rows_uv[b[sl]]  # [nq_, na*nb_]
                            c_ls = cols_ls[k[sl]]  # [nq_, nc*nd]
                            flat = (
                                r_uv[:, :, None] * (nao * nao)
                                + c_ls[:, None, :]
                            ).ravel()  # [nq_ * nab * ncd]
                            # accumulate for every (b2, b4) slot pair
                            for b2 in range(nk):
                                for b4 in range(nk):
                                    wv = (
                                        w_b[b2][:, None, None]
                                        * w_k[b4][:, None, None]
                                        * val
                                    )
                                    np.add.at(
                                        tgt[b2, b4].reshape(-1),
                                        flat,
                                        wv.ravel(),
                                    )

        # [q, b2, b4, u, v, l, s], uploaded once
        self._eri = torch.as_tensor(np.stack(eri), device=self.device)
        self._built = True
        return self

    # ------------------------------------------------------------------ J/K
    def get_jk(self, dm_kpts):
        """Exact Coulomb/exchange per k (closed-shell dm; exxdiv=None), as
        [nk, nao, nao] complex128 tensors on the device."""
        assert self._built
        nk, nao = self.nk, self.cell.nao
        dm = torch.as_tensor(
            dm_kpts, dtype=torch.complex128, device=self.device
        ).reshape(nk, nao, nao)
        E0 = self._eri[int(self.kpair_q[0, 0])]
        J = torch.einsum("abuvls,bsl->auv", E0, dm) / nk
        J = 0.5 * (J + J.conj().transpose(1, 2))

        K = torch.zeros((nk, nao, nao), dtype=torch.complex128,
                        device=self.device)
        for k in range(nk):
            for kp in range(nk):
                iq = int(self.kpair_q[k, kp])
                # bra (mu_k lam_kp) slot b2=kp; ket (sig_kp nu_k) slot b4=k
                K[k] += torch.einsum(
                    "mlsn,ls->mn", self._eri[iq, kp, k], dm[kp]
                ) / nk
        K = 0.5 * (K + K.conj().transpose(1, 2))
        return J, K

    # --------------------------------------------------------- embedding ERI
    def emb_eri(self, TA_k) -> torch.Tensor:
        """Exact real embedding-basis ERI (mirror of KGDF.emb_eri), as a
        [neo]^4 float64 tensor on the device."""
        assert self._built
        nk, nao = self.nk, self.cell.nao
        TA_k = torch.as_tensor(
            TA_k, dtype=torch.complex128, device=self.device
        ).reshape(nk, nao, -1)
        neo = TA_k.shape[-1]

        eri = torch.zeros((neo,) * 4, dtype=torch.complex128,
                          device=self.device)
        for iq in range(len(self.qlist)):
            for b2 in range(nk):
                a = int(
                    np.argmax(self.kpair_q[:, b2] == iq)
                )  # k1 with k2-k1=q
                if self.kpair_q[a, b2] != iq:
                    continue
                for b4 in range(nk):
                    c = int(np.argmax(self.kpair_q[b4, :] == iq))
                    # ket has k4 - k3 = -q  <=>  kpair_q[k3=c', k4=b4]=-q;
                    # equivalently kpair_q[b4, c] == iq means c - b4 = q,
                    # i.e. k3 = c
                    if self.kpair_q[b4, c] != iq:
                        continue
                    # (uv|ls) -> (ij|xy), one index at a time
                    blk = self._eri[iq, b2, b4]
                    for C in (TA_k[a].conj(), TA_k[b2], TA_k[c].conj(),
                              TA_k[b4]):
                        blk = torch.tensordot(blk, C, dims=([0], [0]))
                    eri += blk
        return _real_symmetrized(eri / nk**3)
