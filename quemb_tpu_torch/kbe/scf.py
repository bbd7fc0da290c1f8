"""Periodic restricted Hartree-Fock with k-points (KRHF).

Self-contained replacement for ``pyscf.pbc.scf.KRHF`` as consumed by the
reference kbe driver (reference kbe/pbe.py:78 takes a converged KRHF and
caches S/hcore/C/dm/veff; the test baseline kbe_polyacetylene_test.py:49
runs KRHF with GDF and ``exxdiv=None``).

Uses the background-regularized integrals of :mod:`kbe.pbc_int` and the
own-aux GDF of :mod:`kbe.df`; all G=0 conventions follow ``exxdiv=None``
(no Madelung correction in the SCF; the kbe driver applies the Ewald
correction to the embedding energy separately, ref kbe/pbe.py:484).

JAX counterpart: ``quemb_tpu/kbe/scf.py``.  The integrals are host copies;
the SCF loop runs on the ``KRHF``'s device with the k-blocks stacked: the
Fock build, the commutator error, the generalized eigenproblem (reduced by
the Cholesky factor of each overlap block) and the densities.  The DIIS
coefficients are solved on the host, as there (one read-back of the small
Gram matrix a cycle), and the converged orbitals, energies, density and
potential are read back once, as the JAX package's numpy types.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import torch

from quemb_tpu_torch.kbe.cell import Cell
from quemb_tpu_torch.kbe.df import KGDF
from quemb_tpu_torch.kbe.pbc_int import s_t_kpts, vnuc_kpts
from quemb_tpu_torch.utils.device import resolve_device


class KRHF:
    """Closed-shell k-point HF: complex Fock, per-k DIIS, DF J/K."""

    def __init__(
        self,
        cell: Cell,
        kpts: np.ndarray,
        with_df: KGDF | None = None,
        omega: float = 0.6,
        conv_tol: float = 1e-10,
        # the near-linearly-dependent default (l_extra=1) aux leaves
        # fit-conditioning noise that stretches the DIIS tail below
        # ~1e-10; 300 cycles covers conv_tol=1e-11 on such cells
        max_cycle: int = 300,
        device: torch.device | str | None = None,
    ):
        self.device = resolve_device(device, "KRHF")
        self.cell = cell
        self.kpts = np.asarray(kpts).reshape(-1, 3)
        self.nk = len(self.kpts)
        self.with_df = with_df or KGDF(
            cell, self.kpts, omega=omega, device=self.device
        )
        self.omega = omega
        self.conv_tol = conv_tol
        self.max_cycle = max_cycle
        self.mo_coeff = None
        self.mo_energy = None
        self.e_tot = None
        self.converged = False
        self.cycles = 0
        self._S = None
        self._hcore = None
        self.exxdiv = None  # only exxdiv=None supported (ref test config)

    # ------------------------------------------------------------- integrals
    def get_ovlp(self):
        if self._S is None:
            self._S, self._T = s_t_kpts(self.cell, self.kpts)
        return self._S

    def get_hcore(self):
        if self._hcore is None:
            S = self.get_ovlp()
            V = vnuc_kpts(
                self.cell, self.kpts, omega=min(self.omega, 0.4), S_k=S
            )
            self._hcore = self._T + V
        return self._hcore

    def energy_nuc(self):
        return self.cell.ewald()

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.complex128, device=self.device)

    def _veff(self, dm_kpts) -> torch.Tensor:
        J, K = self.with_df.get_jk(dm_kpts)
        return (J - 0.5 * K).to(self.device)

    def get_veff(self, dm_kpts):
        return self._veff(dm_kpts).cpu().numpy()

    def make_rdm1(self, mo_coeff=None, nocc=None):
        C = self.mo_coeff if mo_coeff is None else mo_coeff
        nocc = self.cell.nelectron // 2 if nocc is None else nocc
        return np.asarray(
            [2.0 * C[k][:, :nocc] @ C[k][:, :nocc].conj().T
             for k in range(self.nk)]
        )

    # ------------------------------------------------------------------- SCF
    def kernel(self, dm0=None):
        if not self.with_df._built:
            self.with_df.build()
        S = self._tensor(self.get_ovlp())
        h = self._tensor(self.get_hcore())
        nocc = self.cell.nelectron // 2
        # F C = S C e  ->  (L^-1 F L^-H) (L^H C) = (L^H C) e,  S = L L^H
        Linv = torch.linalg.inv(torch.linalg.cholesky(S))

        def eig_all(F):
            # the Hermitian matrix that scipy.linalg.eigh(F[k], S[k]) reads
            # from F's lower triangle: a DIIS extrapolation with complex
            # coefficients leaves F slightly non-Hermitian
            low = torch.tril(F, -1)
            F = (low + low.conj().transpose(1, 2)
                 + torch.diag_embed(F.diagonal(dim1=1, dim2=2).real)
                 .to(F.dtype))
            w, v = torch.linalg.eigh(Linv @ F @ Linv.conj().transpose(1, 2))
            return w, Linv.conj().transpose(1, 2) @ v

        def density(C):
            Co = C[..., :nocc]
            return 2.0 * Co @ Co.conj().transpose(1, 2)

        def energy(veff, dm):
            e1 = torch.einsum("kuv,kvu->", h, dm) / self.nk
            e2 = 0.5 * torch.einsum("kuv,kvu->", veff, dm) / self.nk
            return float((e1 + e2).real)

        if dm0 is None:
            # the core guess on the host, by the JAX package's own call: a
            # degenerate level at the Fermi level (a uniform chain at
            # Gamma) is then filled with the same vector, and the SCF
            # reaches the same solution
            S_h, h_h = self.get_ovlp(), self.get_hcore()
            dm = density(self._tensor(np.asarray([
                scipy.linalg.eigh(h_h[k], S_h[k])[1] for k in range(self.nk)
            ])))
        else:
            dm = self._tensor(dm0)
        e_nuc = self.energy_nuc()
        e_last = 0.0
        diis_err, diis_F = [], []
        self.converged = False
        for it in range(self.max_cycle):
            veff = self._veff(dm)
            F = h + veff
            # DIIS on the stacked k-blocks
            err = F @ dm @ S - S @ dm @ F
            diis_err.append(err.reshape(-1))
            diis_F.append(F)
            if len(diis_err) > 8:
                diis_err.pop(0)
                diis_F.pop(0)
            if it > 0:
                m = len(diis_err)
                E = torch.stack(diis_err)
                B = np.empty((m + 1, m + 1), dtype=np.complex128)
                B[:m, :m] = (E.conj() @ E.T).cpu().numpy()
                B[m, :m] = -1.0
                B[:m, m] = -1.0
                B[m, m] = 0.0
                rhs = np.zeros(m + 1, dtype=np.complex128)
                rhs[m] = -1.0
                try:
                    c = np.linalg.lstsq(B, rhs, rcond=None)[0][:m]
                    F = torch.einsum(
                        "i,ikuv->kuv", self._tensor(c), torch.stack(diis_F)
                    )
                except np.linalg.LinAlgError:
                    pass
            moe, C = eig_all(F)
            dm = density(C)
            e_tot = energy(veff, dm) + e_nuc
            if abs(e_tot - e_last) < self.conv_tol and it > 1:
                self.converged = True
                break
            e_last = e_tot
        self.cycles = it + 1
        self.mo_energy = moe.cpu().numpy()
        self.mo_coeff = C.cpu().numpy()
        # final veff with converged density
        veff = self._veff(dm)
        self.hf_dm = dm.cpu().numpy()
        self.hf_veff = veff.cpu().numpy()
        self.e_tot = energy(veff, dm) + e_nuc
        return self.e_tot
