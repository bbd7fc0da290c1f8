"""The restricted mean field that BE reads, filled from arrays.

JAX counterpart: ``quemb_tpu/chem/scf.py:RHF``.  This port carries the
accessors the BE driver consumes (``get_hcore``, ``get_ovlp``, ``get_eri``,
``get_veff``, ``make_rdm1``, ``energy_nuc``, ``e_tot``, ``mo_coeff``,
``mo_energy``) and no SCF kernel: the integral engine and the SCF iteration
arrive with ROADMAP A11.  A mean field comes from arrays computed elsewhere
(:meth:`RHF.from_arrays`, for instance the JAX package's) or from a
committed fixture (:func:`load_fixture`).  Host bookkeeping stays numpy.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from quemb_tpu_torch.chem.mole import Mole
from quemb_tpu_torch.utils.eri_pack import unpack_eri_s8


def get_jk(eri: np.ndarray, dm: np.ndarray):
    """Coulomb and exchange matrices from a dense AO ERI (chemist notation)."""
    vj = np.tensordot(eri, dm, axes=([2, 3], [0, 1]))
    vk = np.tensordot(eri, dm, axes=([1, 3], [0, 1]))
    return vj, vk


class RHF:
    """Restricted Hartree-Fock mean field of a :class:`Mole`."""

    def __init__(self, mol: Mole):
        self.mol = mol
        self.mo_coeff: np.ndarray | None = None
        self.mo_energy: np.ndarray | None = None
        self.e_tot = 0.0
        self._hcore: np.ndarray | None = None
        self._S: np.ndarray | None = None
        self._eri: np.ndarray | None = None

    @classmethod
    def from_arrays(
        cls, mol: Mole, hcore, S, eri, mo_coeff, mo_energy, e_tot: float
    ) -> "RHF":
        """A converged mean field from its AO matrices, dense AO ERI
        [nao]^4 (chemist notation), orbitals and total energy."""
        mf = cls(mol)
        mf._hcore = np.asarray(hcore, np.float64)
        mf._S = np.asarray(S, np.float64)
        mf._eri = np.asarray(eri, np.float64)
        mf.mo_coeff = np.asarray(mo_coeff, np.float64)
        mf.mo_energy = np.asarray(mo_energy, np.float64)
        mf.e_tot = float(e_tot)
        return mf

    def kernel(self, dm0=None) -> float:
        raise NotImplementedError(
            "the SCF kernel arrives with the integral engine (ROADMAP A11);"
            " build the mean field with RHF.from_arrays or load_fixture"
        )

    # --- pyscf-compatible accessors used by the BE driver -------------------
    def get_hcore(self) -> np.ndarray:
        return self._hcore

    def get_ovlp(self) -> np.ndarray:
        return self._S

    def get_eri(self) -> np.ndarray:
        return self._eri

    @property
    def nocc(self) -> int:
        if self.mol.nelectron % 2:
            raise ValueError("RHF needs an even electron count")
        return self.mol.nelectron // 2

    def make_rdm1(self) -> np.ndarray:
        C = self.mo_coeff[:, : self.nocc]
        return 2.0 * C @ C.T

    def get_veff(self, dm: np.ndarray | None = None) -> np.ndarray:
        if dm is None:
            dm = self.make_rdm1()
        vj, vk = get_jk(self.get_eri(), dm)
        return vj - 0.5 * vk

    def energy_nuc(self) -> float:
        return self.mol.energy_nuc()


def load_fixture(path: str | Path, xyz: str | Path, basis: str = "sto-3g"):
    """Mean field from a committed RHF fixture (``fixtures/*_hf.npz``).

    The fixture holds ``hcore``, ``S``, the s8-packed AO ERI ``eri_s8``,
    ``nao``, the orbitals ``C`` and ``moe``, and ``e_tot``; the geometry
    comes from ``xyz``.  Returns an :class:`RHF` whose ``mol`` is built.
    """
    mol = Mole.from_xyz_file(xyz, basis=basis)
    with np.load(path) as d:
        nao = int(d["nao"])
        if nao != mol.nao:
            raise ValueError(f"fixture nao {nao} != molecule nao {mol.nao}")
        return RHF.from_arrays(
            mol, d["hcore"], d["S"], unpack_eri_s8(d["eri_s8"], nao),
            d["C"], d["moe"], float(d["e_tot"]),
        )
