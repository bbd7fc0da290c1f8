"""One-call drivers and external-field support (reference molbe/misc.py).

``be2puffin``: xyz -> HF (with optional QM/MM point charges or a custom
hcore) -> fragmentate -> BE/UBE -> one-shot CCSD/UCCSD.  Point-charge
integrals come from the own McMurchie-Davidson machinery
(:func:`point_charge_matrix`).

JAX counterpart: ``quemb_tpu/misc.py``.  The point-charge integrals and
the libint reordering are copies (host numpy).  ``be2puffin`` takes the
port's ``device=`` keyword: the mean field, the BE and its solves run on
the card unless the caller names the CPU, and custom ``jk=`` tensors are
copied there once, so that ``mf._jk`` hands back float64 ``(vj, vk)`` on
``mf.device``.  ``h5py`` is imported only to read a PySCF chkfile
(``from_chk=True`` with an HDF5 ``checkfile``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from quemb_tpu_torch.chem import integrals
from quemb_tpu_torch.chem.integrals import _group_pairs, _R_sparse, \
    hermite_index_list
from quemb_tpu_torch.chem.mole import Mole
from quemb_tpu_torch.chem.scf import RHF, UHF
from quemb_tpu_torch.utils.device import resolve_device


def point_charge_matrix(mol: Mole, coords_bohr, charges) -> np.ndarray:
    """Electron-point-charge attraction matrix sum_A q_A <mu| -1/|r-R_A| |nu>.

    Same Hermite machinery as nuclear attraction with external charges
    (used for QM/MM embedding; reference relies on pyscf.qmmm.mm_charge).
    """
    coords_bohr = np.asarray(coords_bohr, dtype=np.float64).reshape(-1, 3)
    charges = np.asarray(charges, dtype=np.float64)
    V = np.zeros((mol.nao, mol.nao))
    for pc in _group_pairs(mol.shells):
        L = pc.Lx
        idx_list = hermite_index_list(L)
        H = pc.hermite_coefs()
        acc = np.zeros((pc.n, pc.K, len(idx_list)))
        for C, q in zip(coords_bohr, charges):
            PC = pc.P - C
            acc -= q * _R_sparse(idx_list, L, pc.p, PC)
        pref = 2.0 * np.pi / pc.p * pc.cc
        val = np.einsum("nkat,nkt,nk->na", H, acc, pref, optimize=True)
        val = val.reshape(pc.n, len(pc.comps_a), len(pc.comps_b))
        for ia in range(val.shape[1]):
            for ib in range(val.shape[2]):
                V[pc.ao_a + ia, pc.ao_b + ib] = val[:, ia, ib]
                V[pc.ao_b + ib, pc.ao_a + ia] = val[:, ia, ib]
    return V


def nuc_point_charge_energy(mol: Mole, coords_bohr, charges) -> float:
    """Nuclear - MM-point-charge interaction energy."""
    coords_bohr = np.asarray(coords_bohr, dtype=np.float64).reshape(-1, 3)
    charges = np.asarray(charges, dtype=np.float64)
    Z = mol.atom_charges().astype(float)
    R = mol.atom_coords()
    e = 0.0
    for C, q in zip(coords_bohr, charges):
        e += float(np.sum(Z * q / np.linalg.norm(R - C[None, :], axis=1)))
    return e


class _QMMM_RHF(RHF):
    """RHF with external point charges folded into hcore and enuc."""

    def __init__(self, mol, pts_bohr, charges, **kw):
        super().__init__(mol, **kw)
        self._pts = np.asarray(pts_bohr)
        self._q = np.asarray(charges)
        self._e_mm = nuc_point_charge_energy(mol, self._pts, self._q)

    def get_hcore(self):
        if self._hcore is None:
            self._hcore = integrals.core_hamiltonian(
                self.mol
            ) + point_charge_matrix(self.mol, self._pts, self._q)
        return self._hcore

    def energy_nuc(self):
        return self.mol.energy_nuc() + self._e_mm


class _QMMM_UHF(UHF, _QMMM_RHF):
    def __init__(self, mol, pts_bohr, charges, **kw):
        _QMMM_RHF.__init__(self, mol, pts_bohr, charges, **kw)


def _libint_perm(mol: Mole) -> list[int]:
    """libint->pyscf AO permutation: libint orders p shells (py, pz, px);
    PySCF uses (px, py, pz) (reference molbe/misc.py:16 libint2pyscf)."""
    perm = []
    for i, lbl in enumerate(mol.ao_labels()):
        comp = lbl.split()[2]
        if "p" not in comp:
            perm.append(i)
        elif comp.endswith("x"):
            perm.append(i + 2)
        else:  # py, pz
            perm.append(i - 1)
    return perm


def libint2pyscf_hcore(mol: Mole, hcore_libint: np.ndarray) -> np.ndarray:
    """Reorder a libint-ordered matrix into the PySCF AO convention."""
    perm = _libint_perm(mol)
    return hcore_libint[np.ix_(perm, perm)]


def be2puffin(
    xyzfile,
    basis,
    hcore=None,
    libint_inp: bool = False,
    pts_and_charges=None,
    jk=None,
    use_df: bool = False,
    charge: int = 0,
    spin: int = 0,
    nproc: int = 1,
    ompnum: int = 1,
    n_BE: int = 1,
    df_aux_basis=None,
    frozen_core: bool = True,
    localization_method: str = "lowdin",
    unrestricted: bool = False,
    from_chk: bool = False,
    checkfile=None,
    ecp=None,
    frag_type: str = "chemgen",
    device: torch.device | str | None = None,
):
    """One-call BE driver (reference molbe/misc.py:247 be2puffin).

    Returns the one-shot BE correlation energy (reference misc.py:499).
    ``device`` defaults to CUDA and raises when no card is present.
    """
    from quemb_tpu_torch import BE, fragmentate  # noqa: PLC0415
    from quemb_tpu_torch.ube import UBE  # noqa: PLC0415

    dev = resolve_device(device, "be2puffin")
    assert os.path.exists(xyzfile), "Input xyz file does not exist"
    if use_df and unrestricted:
        raise ValueError("UHF and df are incompatible: use_df = False")
    # ecp: per-element semi-local ECP spec (chem/ecp.py).  The reference
    # forwards ecp to PySCF (misc.py:266,331); here the own quadrature
    # ECP integrals are used.  No tabulated ECP libraries ship offline,
    # so parameters must be supplied explicitly in the spec dict.
    mol = Mole.from_xyz_file(
        xyzfile, basis=basis, charge=charge, spin=spin, ecp=ecp
    )
    if hcore is not None and libint_inp:
        hcore = libint2pyscf_hcore(mol, np.asarray(hcore))

    cls = UHF if unrestricted else RHF
    if pts_and_charges is not None:
        # QM structure in Angstrom, MM coordinates in Bohr (SCINE convention)
        pts, q = pts_and_charges
        mf = (
            _QMMM_UHF(mol, pts, q, device=dev)
            if unrestricted
            else _QMMM_RHF(mol, pts, q, device=dev)
        )
    else:
        mf = cls(mol, with_df=use_df, auxbasis=df_aux_basis, device=dev) \
            if not unrestricted else cls(mol, device=dev)
        if hcore is not None:
            mf._hcore = np.asarray(hcore)
    if jk is not None:
        # custom (J, K) 2e tensors (reference misc.py:356 jk_pyscf): the
        # mean field builds vj/vk from these instead of its own ERIs
        Jt, Kt = jk
        if libint_inp:
            perm = _libint_perm(mol)
            Jt = Jt[np.ix_(perm, perm, perm, perm)]
            Kt = Kt[np.ix_(perm, perm, perm, perm)]
        Jt_d, Kt_d = (torch.as_tensor(np.asarray(a, np.float64), device=dev)
                      for a in (Jt, Kt))
        mf._jk = lambda dm: (
            torch.einsum("pqrs,rs->pq", Jt_d, dm),
            torch.einsum("prqs,rs->pq", Kt_d, dm),
        )

    if from_chk and checkfile is not None:
        import h5py  # noqa: PLC0415

        if h5py.is_hdf5(checkfile):
            # PySCF chkfile layout (scf/mo_coeff, ...): ingest a mean
            # field converged by the reference stack directly -- the AO
            # ordering convention matches for s/p bases
            with h5py.File(checkfile, "r") as f:
                mf.mo_coeff = np.asarray(f["scf/mo_coeff"])
                mf.mo_energy = np.asarray(f["scf/mo_energy"])
                mf.e_tot = float(np.asarray(f["scf/e_tot"]))
        else:
            data = np.load(checkfile)
            mf.mo_coeff = data["mo_coeff"]
            mf.mo_energy = data["mo_energy"]
            mf.e_tot = float(data["e_tot"])
        mf.converged = True
    else:
        mf.kernel()
        if checkfile is not None:
            np.savez(
                checkfile,
                mo_coeff=mf.mo_coeff,
                mo_energy=mf.mo_energy,
                e_tot=mf.e_tot,
            )

    fobj = fragmentate(
        mol=mol,
        n_BE=n_BE,
        frag_type=frag_type,
        frozen_core=frozen_core,
        print_frags=False,
    )
    if unrestricted:
        mybe = UBE(mf, fobj, lo_method=localization_method, device=dev)
        mybe.oneshot(solver="UCCSD")
    else:
        mybe = BE(mf, fobj, lo_method=localization_method, device=dev)
        mybe.oneshot(solver="CCSD")
    # the reference returns the one-shot correlation energy
    # (molbe/misc.py:499)
    return mybe.ebe_tot - mybe.ebe_hf
