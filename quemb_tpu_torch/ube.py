"""Unrestricted bootstrap embedding (one-shot UBE-UCCSD) on PyTorch.

JAX counterpart: ``quemb_tpu/ube.py`` (a mirror of the reference
``molbe/ube.py`` UBE class): spin-separated Schmidt spaces, three spin
ERI blocks per fragment, per-spin-channel fragment SCFs, and a
generalized spin-orbital UCCSD.  With a frozen core the core potential is
folded into each spin's one-electron Hamiltonian, so the HF-in-HF
invariant holds.

Device work (the AO ERI and its fragment transforms, the fragment SCFs,
the fragment potentials, UCCSD and the energies) runs on an explicit
``torch.device``: ``UBE(..., device=...)`` defaults to CUDA and raises
when no card is present.  The per-spin localization and the Schmidt
decompositions are host numpy, as in the JAX package.  Conventions kept
from it: ``dm0`` is twice the spin density, the fragment environment
potential is built with ``cons_fock`` from twice the spin density, and
the fragment HF energy uses ``unrestricted_fac = 1``.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from quemb_tpu_torch.chem.scf import UHF
from quemb_tpu_torch.embed.fragment import Fragment
from quemb_tpu_torch.fragment.frag_part import FragPart
from quemb_tpu_torch.lo.lowdin import lowdin_orth
from quemb_tpu_torch.ops.eri_transform import incore_transform
from quemb_tpu_torch.solvers.dispatch import run_fragment_scf
from quemb_tpu_torch.solvers.uccsd import _mo4, solve_uccsd
from quemb_tpu_torch.utils.device import resolve_device


def _transform_ab(eri_ao, TA_a, TA_b):
    """(ij|kl) with i, j in the alpha and k, l in the beta embedding
    basis."""
    return _mo4(eri_ao, TA_a, TA_a, TA_b, TA_b)


class UBE:
    """Unrestricted BE driver (one-shot only, like the reference)."""

    def __init__(
        self,
        mf: UHF,
        fobj: FragPart,
        *,
        lo_method: str = "lowdin",
        thr_bath: float = 1.0e-10,
        device: torch.device | str | None = None,
    ):
        self.device = resolve_device(device, "UBE")
        mf.bind_device(self.device)
        self.mf = mf
        self.fobj = fobj
        self.mol = mf.mol
        self.thr_bath = thr_bath
        self.unrestricted = True

        na, nb = mf.nelec
        self.Nocc = [na, nb]
        self.enuc = mf.energy_nuc()
        self.hcore = np.asarray(mf.get_hcore())
        self.S = np.asarray(mf.get_ovlp())
        self.C_a = np.asarray(mf.mo_coeff[0])
        self.C_b = np.asarray(mf.mo_coeff[1])
        dm = mf.make_rdm1()
        self.hf_dm = [dm[0], dm[1]]  # occupancy 1 per spin
        veff = mf.get_veff()
        self.hf_veff = [veff[0], veff[1]]
        self.hf_etot = mf.e_tot
        self.uhf_full_e = mf.e_tot
        self.ebe_hf = 0.0
        self.ebe_tot = 0.0

        self.frozen_core = fobj.frozen_core
        self.ncore = 0
        self.E_core = 0.0
        self.core_veff = None
        if self.frozen_core:
            self.ncore = fobj.ncore
            self.Nocc = [na - self.ncore, nb - self.ncore]
            C_val = [C[:, self.ncore : self.ncore + n]
                     for C, n in ((self.C_a, self.Nocc[0]),
                                  (self.C_b, self.Nocc[1]))]
            self.hf_dm = [C @ C.T for C in C_val]
            self.P_core = [C[:, : self.ncore] @ C[:, : self.ncore].T
                           for C in (self.C_a, self.C_b)]
            self.core_veff = mf.get_veff(dm=np.stack(self.P_core))
            self.E_core = 0.5 * sum(
                np.einsum("ji,ji->", 2 * self.hcore + self.core_veff[s],
                          self.P_core[s])
                for s in (0, 1)
            )
            # fold the per-spin core potential into the valence one-body
            # Hamiltonian and take it out of the mean-field veff, as the
            # restricted driver does (reference mbe.py:417)
            self.hf_veff = [self.hf_veff[s] - self.core_veff[s]
                            for s in (0, 1)]
            self.hcore_s = [self.hcore + self.core_veff[s] for s in (0, 1)]
        else:
            self.hcore_s = [self.hcore, self.hcore]
        self._localize(lo_method)
        self.Fobjs_a: list[Fragment] = []
        self.Fobjs_b: list[Fragment] = []
        self._initialize()

    # ------------------------------------------------------------- localize
    def _localize(self, lo_method: str) -> None:
        if lo_method != "lowdin":
            raise NotImplementedError("UBE supports lowdin localization")
        W = lowdin_orth(torch.as_tensor(self.S, device=self.device))
        W = W.cpu().numpy()
        if self.frozen_core:
            # per-spin core projection (reference mbe.py:1408 unrestricted)
            Ws, lmos = [], []
            for s, C in enumerate((self.C_a, self.C_b)):
                C_ = (np.eye(W.shape[0]) - self.P_core[s] @ self.S) @ W
                Cpop = np.diag(C_.T @ self.S @ C_)
                C_ = C_[:, np.where(Cpop > 0.7)[0]]
                es_, vs_ = np.linalg.eigh(C_.T @ self.S @ C_)
                Ws.append(C_ @ ((vs_ / np.sqrt(es_)) @ vs_.T))
                lmos.append(Ws[s].T @ self.S @ C[:, self.ncore :])
            self.W = Ws
            self.lmo_coeff_a, self.lmo_coeff_b = lmos
        else:
            self.W = W
            self.lmo_coeff_a = W.T @ self.S @ self.C_a
            self.lmo_coeff_b = W.T @ self.S @ self.C_b

    # ----------------------------------------------------------- initialize
    def _initialize(self) -> None:
        fobj = self.fobj
        dev = self.device
        eri_ao = self.mf.get_eri_dev()
        E_hf = 0.0
        self.Vab = []
        Wa, Wb = self.W if self.frozen_core else (self.W, self.W)
        for I in range(fobj.n_frag):
            fr_a = Fragment.from_frag_part(fobj, I)
            fr_b = Fragment.from_frag_part(fobj, I)
            fr_a.sd(Wa, self.lmo_coeff_a, self.Nocc[0], self.thr_bath)
            fr_b.sd(Wb, self.lmo_coeff_b, self.Nocc[1], self.thr_bath)
            TA_a, TA_b = (torch.as_tensor(fr.TA, device=dev)
                          for fr in (fr_a, fr_b))
            fr_a.eri = incore_transform(eri_ao, TA_a)
            fr_b.eri = incore_transform(eri_ao, TA_b)
            self.Vab.append(_transform_ab(eri_ao, TA_a, TA_b))

            for s, (fr, C, dm_s, veff_s) in enumerate((
                (fr_a, self.C_a, self.hf_dm[0], self.hf_veff[0]),
                (fr_b, self.C_b, self.hf_dm[1], self.hf_veff[1]),
            )):
                C_occ = C[:, self.ncore : self.ncore + self.Nocc[s]]
                C_ = fr.TA.T @ self.S @ C_occ
                fr.nsocc = int(round(np.trace(C_ @ C_.T)))
                fr._mo_coeffs = np.linalg.svd(C_)[0]
                fr.h1 = fr.TA.T @ self.hcore_s[s] @ fr.TA
                # cons_fock with dm = 2 * spin density (reference
                # ube.py:262)
                ST = self.S @ fr.TA
                P_emb = torch.as_tensor(ST.T @ (dm_s * 2.0) @ ST, device=dev)
                vj = torch.tensordot(fr.eri, P_emb, dims=([2, 3], [0, 1]))
                vk = torch.tensordot(fr.eri, P_emb, dims=([1, 3], [0, 1]))
                fr.veff0 = fr.TA.T @ veff_s @ fr.TA
                fr.veff = fr.veff0 - (vj - 0.5 * vk).cpu().numpy()
                fr.fock = fr.h1 + fr.veff
                fr.heff = np.zeros_like(fr.h1)
                fr.dm0 = 2.0 * (fr._mo_coeffs[:, : fr.nsocc]
                                @ fr._mo_coeffs[:, : fr.nsocc].T)
                moe, C_frag = (t.cpu().numpy() for t in run_fragment_scf(fr))
                fr._mo_coeffs = C_frag
                fr.mo_energy = moe
                fr.dm0 = 2.0 * (C_frag[:, : fr.nsocc]
                                @ C_frag[:, : fr.nsocc].T)
                E_hf += self._frag_hf_energy(fr)

            self.Fobjs_a.append(fr_a)
            self.Fobjs_b.append(fr_b)

        self.ebe_hf = E_hf + self.enuc + self.E_core
        hf_err = self.hf_etot - self.ebe_hf
        print(f"HF-in-HF error                 :  {hf_err:>.4e} Ha")
        if abs(hf_err) > 1.0e-5:
            warnings.warn("Large HF-in-HF energy error")

    def _frag_hf_energy(self, fr: Fragment) -> float:
        """update_ebe_hf with unrestricted_fac = 1 (reference
        pfrag.py:327)."""
        eri = fr.eri
        C = torch.as_tensor(fr._mo_coeffs[:, : fr.nsocc], device=eri.device)
        rho = C @ C.T
        h1, veff = (torch.as_tensor(a, device=eri.device)
                    for a in (fr.h1, fr.veff))
        J = torch.tensordot(eri, rho, dims=([2, 3], [0, 1]))
        K = torch.einsum("ijkl,jl->ik", eri, rho)
        e_ = ((h1 + 0.5 * veff) * rho).sum(-1) + 0.5 * (
            2.0 * (J * rho).sum(-1) - (K * rho).sum(-1)
        )
        w, idx = fr.weight_and_relAO_per_center
        return float(w * e_[list(idx)].sum())

    # --------------------------------------------------------------- oneshot
    def oneshot(self, solver: str = "UCCSD") -> None:
        if solver != "UCCSD":
            raise NotImplementedError("UBE supports the UCCSD solver")
        total_e = [0.0, 0.0, 0.0]
        for fr_a, fr_b, Vab in zip(self.Fobjs_a, self.Fobjs_b, self.Vab):
            # spin-channel fragment SCFs (reference Frags.scf unrestricted)
            fr_a.mo_coeffs = run_fragment_scf(fr_a)[1].cpu().numpy()
            fr_b.mo_coeffs = run_fragment_scf(fr_b)[1].cpu().numpy()
            rdm1s, rdm2s, _ = solve_uccsd(fr_a, fr_b, Vab, use_cumulant=True)
            e_f = self._frag_energy_u(fr_a, fr_b, Vab, rdm1s, rdm2s)
            total_e = [a + b for a, b in zip(total_e, e_f)]
        E = sum(total_e)
        self.ebe_tot = E + self.uhf_full_e
        print(
            f"One-shot UBE ({solver}): E_corr = {E:.10f} Ha, "
            f"E_tot = {self.ebe_tot:.10f} Ha"
        )

    def _frag_energy_u(self, fr_a, fr_b, Vab, rdm1s, rdm2s):
        """Cumulant fragment energy (reference helper.py:get_frag_energy_u),
        on the device of the fragment ERIs."""
        frs = (fr_a, fr_b)
        dev = fr_a.eri.device

        def t(a):
            return torch.as_tensor(a, device=dev)

        mos = [t(fr.mo_coeffs) for fr in frs]
        if self.frozen_core:
            # vhf from the fragment-SCF densities (uccsd_eri.frank_get_veff)
            rho = [mos[s][:, : fr.nsocc] @ mos[s][:, : fr.nsocc].T
                   for s, fr in enumerate(frs)]
            vhf = [
                torch.tensordot(frs[s].eri, rho[s], dims=([3, 2], [0, 1]))
                - torch.tensordot(frs[s].eri, rho[s], dims=([1, 2], [0, 1]))
                for s in (0, 1)
            ]
            vhf[0] = vhf[0] + torch.tensordot(Vab, rho[1],
                                              dims=([3, 2], [0, 1]))
            vhf[1] = vhf[1] + torch.tensordot(rho[0], Vab,
                                              dims=([1, 0], [0, 1]))
            core_veffs = [t(fr.TA.T @ self.core_veff[s] @ fr.TA)
                          for s, fr in enumerate(frs)]
            # effective h1/veff0 after the reference's gcore shuffling
            h1s = [t(frs[s].h1) + core_veffs[s] for s in (0, 1)]
            veff0s = [core_veffs[s] + vhf[s] for s in (0, 1)]
        else:
            h1s = [t(fr.h1) for fr in frs]
            veff0s = [t(fr.veff0) for fr in frs]

        w, idx = fr_a.weight_and_relAO_per_center
        idx = list(idx)
        e1 = ec = 0.0
        for s, fr in enumerate(frs):
            mo = mos[s]
            w_s, idx_s = fr.weight_and_relAO_per_center
            idx_s = list(idx_s)
            delta = 2.0 * (mo @ rdm1s[s] @ mo.T
                           - mo[:, : fr.nsocc] @ mo[:, : fr.nsocc].T)
            e1 += w_s * float((h1s[s] * delta).sum(-1)[idx_s].sum())
            ec += w_s * float((veff0s[s] * delta).sum(-1)[idx_s].sum())

        # two-electron cumulant energy
        moa, mob = mos
        G_aa = _mo4(rdm2s[0], moa.T, moa.T, moa.T, moa.T)
        G_ab = _mo4(rdm2s[1], moa.T, moa.T, mob.T, mob.T)
        G_bb = _mo4(rdm2s[2], mob.T, mob.T, mob.T, mob.T)
        e2_aa = 0.5 * (G_aa * fr_a.eri).sum((1, 2, 3))[idx].sum()
        e2_bb = 0.5 * (G_bb * fr_b.eri).sum((1, 2, 3))[idx].sum()
        e2_ab = 0.5 * (G_ab * Vab).sum((1, 2, 3))[idx].sum()
        e2_ba = 0.5 * (G_ab * Vab).sum((0, 1, 3))[idx].sum()
        e2 = w * float(e2_aa + e2_bb + e2_ab + e2_ba)
        return [e1, e2, ec]
