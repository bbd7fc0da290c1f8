"""Potential-energy-surface scanner + finite-difference gradients.

Covers the reference ``molbe/scanner.py`` API surface: an ``Energy`` object
whose ``as_scanner()`` returns a callable evaluating the BE total energy at
displaced geometries, plus finite-difference gradient/Hessian helpers, and
:class:`FragmentProbe`, which re-initializes only the displaced fragment
(reference scanner.py:217).

JAX counterpart: ``quemb_tpu/scanner.py``.  ``Energy``, the FD helpers and
``FDinfo`` are copies over the port's ``RHF``/``BE``/``fragmentate``, with
the port's ``device=`` keyword: every geometry runs on the card unless the
caller names the CPU.  In :meth:`FragmentProbe.__call__` the fragment's
ERI transform, its SCF, the four-index MO transform and its CCSD run on
that device.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field

import numpy as np
import torch

from quemb_tpu_torch.chem.elements import BOHR2ANG
from quemb_tpu_torch.chem.mole import Mole
from quemb_tpu_torch.chem.scf import RHF
from quemb_tpu_torch.utils.device import resolve_device


@dataclass
class Energy:
    """BE energy evaluator over geometries (reference scanner.py:381).

    ``device`` defaults to CUDA and raises when no card is present.
    """

    basis: str
    n_BE: int = 2
    solver: str = "CCSD"
    frag_type: str = "chemgen"
    only_chem: bool = False
    oneshot: bool = False
    frozen_core: bool = False
    charge: int = 0
    additional_args: object = None
    conv_tol_hf: float = 1e-12
    device: torch.device | str | None = None

    last_result: dict = field(default_factory=dict)

    def __post_init__(self):
        self.device = resolve_device(self.device, "Energy")

    def energy(self, mol: Mole) -> float:
        from quemb_tpu_torch import BE, fragmentate

        mf = RHF(mol, conv_tol=self.conv_tol_hf, device=self.device)
        mf.kernel()
        fobj = fragmentate(
            mol=mol,
            n_BE=self.n_BE,
            frag_type=self.frag_type,
            frozen_core=self.frozen_core,
            additional_args=self.additional_args,
            print_frags=False,
        )
        mybe = BE(mf, fobj, device=self.device)
        if self.oneshot:
            mybe.oneshot(solver=self.solver)
        else:
            mybe.optimize(solver=self.solver, only_chem=self.only_chem)
        self.last_result = {
            "e_tot": mybe.ebe_tot,
            "e_hf": mybe.ebe_hf,
            "e_corr": mybe.ebe_tot - mybe.ebe_hf,
        }
        return mybe.ebe_tot

    def energy_at(self, coords_bohr: np.ndarray, elements: list[str]) -> float:
        mol = Mole(
            atom=[
                (el, xyz * BOHR2ANG)
                for el, xyz in zip(elements, coords_bohr)
            ],
            basis=self.basis,
            charge=self.charge,
        )
        return self.energy(mol)

    def as_scanner(self):
        """Callable mol -> energy (pyscf as_scanner convention)."""
        return self.energy


def fd_gradient(
    scanner: Energy,
    mol: Mole,
    step: float = 1e-3,
) -> np.ndarray:
    """Central-difference nuclear gradient dE/dR [natm, 3] (Ha/Bohr)."""
    coords = mol.atom_coords()
    elements = mol.elements
    grad = np.zeros_like(coords)
    for ia in range(mol.natm):
        for d in range(3):
            cp = coords.copy()
            cp[ia, d] += step
            ep = scanner.energy_at(cp, elements)
            cm = coords.copy()
            cm[ia, d] -= step
            em = scanner.energy_at(cm, elements)
            grad[ia, d] = (ep - em) / (2 * step)
    return grad


def fd_hessian_diag(
    scanner: Energy, mol: Mole, step: float = 1e-3
) -> np.ndarray:
    """Diagonal second derivatives d2E/dR2 [natm, 3] (Ha/Bohr^2)."""
    coords = mol.atom_coords()
    elements = mol.elements
    e0 = scanner.energy_at(coords, elements)
    hess = np.zeros_like(coords)
    for ia in range(mol.natm):
        for d in range(3):
            cp = coords.copy()
            cp[ia, d] += step
            ep = scanner.energy_at(cp, elements)
            cm = coords.copy()
            cm[ia, d] -= step
            em = scanner.energy_at(cm, elements)
            hess[ia, d] = (ep + em - 2 * e0) / step**2
    return hess


# ------------------------------------------ displaced-fragment FD machinery
@dataclass
class FDinfo:
    """Finite-difference probe metadata (reference scanner.py:367).

    ``detect`` classifies a probe geometry against the reference: which
    atom/axis moved and by how much.
    """

    kind: str = "reference"
    atom_idx: list = field(default_factory=list)
    axis_idx: list = field(default_factory=list)
    delta_bohr: list = field(default_factory=list)

    @classmethod
    def detect(cls, mol: Mole, ref_mol: Mole, tol: float = 1e-10):
        d = mol.atom_coords() - ref_mol.atom_coords()
        hits = np.argwhere(np.abs(d) > tol)
        if len(hits) == 0:
            return cls(kind="reference")
        kind = (
            "single_displacement" if len(hits) == 1 else "multi_displacement"
        )
        return cls(
            kind=kind,
            atom_idx=[int(a) for a, _ in hits],
            axis_idx=[int(x) for _, x in hits],
            delta_bohr=[float(d[a, x]) for a, x in hits],
        )


class FragmentProbe:
    """Cheap FD probes: re-initialize ONLY the displaced fragment.

    The reference geometry's embedding basis is carried to the probe
    geometry via TA' = S^-1 S_cross TA_ref (reference scanner.py:305
    ``energy_be_frag``); the probe energy is
    E_HF(probe) + Ecorr(displaced fragment), so a full BE re-init per
    probe is avoided.  Runs on ``scan.device``.
    """

    def __init__(self, ref_mol: Mole, scan: "Energy"):
        from quemb_tpu_torch import BE, fragmentate

        self.scan = scan
        self.ref_mol = ref_mol
        mf = RHF(ref_mol, conv_tol=scan.conv_tol_hf, device=scan.device)
        mf.kernel()
        self.ref_fobj = fragmentate(
            mol=ref_mol,
            n_BE=scan.n_BE,
            frag_type=scan.frag_type,
            frozen_core=scan.frozen_core,
            additional_args=scan.additional_args,
            print_frags=False,
        )
        self.ref_be = BE(mf, self.ref_fobj, device=scan.device)
        # owning fragment of each atom: the fragment whose center AOs
        # contain the atom's AOs
        aoslice = ref_mol.aoslice_by_atom()
        self.frag_per_atom = np.zeros(ref_mol.natm, dtype=int)
        for ia, (p0, p1) in enumerate(aoslice):
            for fi, fr in enumerate(self.ref_be.fragments):
                cen_aos = {
                    fr.AO_in_frag[i]
                    for i in fr.weight_and_relAO_per_center[1]
                }
                if any(a in cen_aos for a in range(p0, p1)):
                    self.frag_per_atom[ia] = fi
                    break

    def __call__(self, mol: Mole) -> float:
        from quemb_tpu_torch.chem.integrals import cross_overlap
        from quemb_tpu_torch.ops.eri_transform import (
            batched_mo_eri,
            incore_transform_batched,
        )
        from quemb_tpu_torch.solvers.dispatch import run_fragment_scf
        from quemb_tpu_torch.solvers.rccsd import solve_rccsd

        dev = self.scan.device
        info = FDinfo.detect(mol, self.ref_mol)
        mf = RHF(mol, conv_tol=self.scan.conv_tol_hf, device=dev)
        mf.kernel()
        if info.kind == "reference":
            return mf.e_tot
        if info.kind != "single_displacement":
            raise RuntimeError(
                "fragment probes support single displacements only"
            )
        fi = int(self.frag_per_atom[info.atom_idx[0]])
        ref_fr = self.ref_be.fragments[fi]

        S = mf.get_ovlp()
        S_cross = cross_overlap(mol, self.ref_mol)
        TA = np.linalg.solve(S, S_cross @ ref_fr.TA)

        # rebuild the displaced fragment's Hamiltonian with the carried
        # TA; the copy shares the reference fragment's arrays, so every
        # one that changes is assigned anew, none written in place
        fr = copy.copy(ref_fr)
        fr.TA = TA
        hcore = mf.get_hcore()
        hf_dm = mf.make_rdm1()
        hf_veff = mf.get_veff()
        eri = incore_transform_batched(
            mf.get_eri_dev(), torch.as_tensor(TA, device=dev)[None]
        )[0]
        fr.eri = eri
        fr.h1 = TA.T @ hcore @ TA
        C_occ = mf.mo_coeff[:, : mol.nelectron // 2]
        C_ = TA.T @ S @ C_occ
        P_ = C_ @ C_.T
        fr.nsocc = int(round(np.trace(P_)))
        fr._mo_coeffs = np.linalg.svd(C_)[0]
        ST = S @ TA
        P_emb = torch.as_tensor(ST.T @ hf_dm @ ST, device=dev)
        vj = torch.tensordot(eri, P_emb, dims=([2, 3], [0, 1]))
        vk = torch.tensordot(eri, P_emb, dims=([1, 3], [0, 1]))
        fr.veff0 = TA.T @ hf_veff @ TA
        fr.veff = fr.veff0 - (vj - 0.5 * vk).cpu().numpy()
        fr.fock = fr.h1 + fr.veff
        fr.heff = np.zeros_like(fr.h1)
        fr.dm0 = 2.0 * (
            fr._mo_coeffs[:, : fr.nsocc] @ fr._mo_coeffs[:, : fr.nsocc].T
        )
        moe, C_frag = run_fragment_scf(fr)
        eri_mo = batched_mo_eri(eri[None], C_frag[None])[0]
        _, _, e_corr = solve_rccsd(eri_mo, moe, fr.nsocc)
        return mf.e_tot + e_corr
