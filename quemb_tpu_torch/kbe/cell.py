"""Periodic cell container: geometry + basis + lattice.

Self-contained replacement for ``pyscf.pbc.gto.Cell`` as consumed by the
reference kbe layer (reference kbe/pbe.py:78 caches S/hcore/veff from a
KRHF built on a Cell; kbe/misc.py:11 sgeom builds supercells).

A :class:`Cell` is a :class:`~quemb_tpu_torch.chem.mole.Mole` plus lattice
vectors.
It provides k-point generation, real-space lattice image enumeration,
reciprocal-space G-vector grids, and the Ewald nuclear energy / Madelung
constant under the uniform-background (``exxdiv=None``) convention.

JAX counterpart: ``quemb_tpu/kbe/cell.py``, of which this is a copy (it
holds no jax).
"""

from __future__ import annotations

import numpy as np
from scipy.special import erfc

from quemb_tpu_torch.chem.elements import ANG2BOHR
from quemb_tpu_torch.chem.mole import Mole


class Cell(Mole):
    """Periodic system: Mole + lattice vectors ``a`` (rows, Bohr)."""

    def __init__(
        self,
        atom=None,
        a=None,
        basis: str = "sto-3g",
        charge: int = 0,
        spin: int = 0,
        unit: str = "angstrom",
        precision: float = 1e-10,
    ):
        if a is None:
            raise ValueError("Cell requires lattice vectors `a` (3x3, rows)")
        scale = ANG2BOHR if unit.lower().startswith("ang") else 1.0
        self.a = np.asarray(a, dtype=np.float64) * scale
        self.precision = precision
        super().__init__(
            atom=atom, basis=basis, charge=charge, spin=spin, unit=unit
        )

    # ---------------------------------------------------------------- lattice
    @property
    def vol(self) -> float:
        return float(abs(np.linalg.det(self.a)))

    def reciprocal_vectors(self) -> np.ndarray:
        """Rows b_i with b_i . a_j = 2 pi delta_ij."""
        return 2.0 * np.pi * np.linalg.inv(self.a).T

    def make_kpts(self, kmesh, wrap_around: bool = True) -> np.ndarray:
        """Monkhorst-Pack (Gamma-centered) k-points, [nk, 3] in Bohr^-1.

        Matches pyscf ``cell.make_kpts(kmesh, wrap_around=True)``: fractions
        i/n mapped to (-1/2, 1/2] when wrapping.
        """
        b = self.reciprocal_vectors()
        fracs = []
        for n in kmesh:
            f = np.arange(n) / float(n)
            if wrap_around:
                f = np.where(f >= 0.5 + 1e-12, f - 1.0, f)
            fracs.append(f)
        mesh = np.array(
            [(x, y, z) for x in fracs[0] for y in fracs[1] for z in fracs[2]]
        )
        return mesh @ b

    def lattice_Ls(self, rcut: float) -> np.ndarray:
        """All lattice vectors T with |T| <= rcut (plus boundary shells)."""
        a = self.a
        # bound the integer search box by the inverse metric
        inv_norms = np.linalg.norm(np.linalg.inv(a), axis=0)
        nmax = np.ceil(rcut * inv_norms).astype(int) + 1
        grids = [np.arange(-n, n + 1) for n in nmax]
        ijk = np.array(
            [(i, j, k) for i in grids[0] for j in grids[1] for k in grids[2]]
        )
        Ls = ijk @ a
        keep = np.linalg.norm(Ls, axis=1) <= rcut + 1e-9
        return Ls[keep]

    def get_Gv(self, gmax: float, q: np.ndarray | None = None) -> np.ndarray:
        """All reciprocal vectors G with |G + q| <= gmax, [nG, 3]."""
        b = self.reciprocal_vectors()
        inv_norms = np.linalg.norm(np.linalg.inv(b), axis=0)
        nmax = np.ceil((gmax + 1e-9) * inv_norms).astype(int) + 1
        grids = [np.arange(-n, n + 1) for n in nmax]
        ijk = np.array(
            [(i, j, k) for i in grids[0] for j in grids[1] for k in grids[2]]
        )
        Gv = ijk @ b
        Gq = Gv if q is None else Gv + np.asarray(q)
        keep = np.linalg.norm(Gq, axis=1) <= gmax
        return Gv[keep]

    # ----------------------------------------------------------------- Ewald
    def ewald(self, eta: float | None = None) -> float:
        """Nuclear repulsion energy with uniform neutralizing background.

        The point charges Z_i interact through the G=0-regularized Coulomb
        kernel (reference convention: pyscf ``cell.energy_nuc``/``ewald``,
        consumed at kbe/pbe.py:179 ``self.enuc = mf.energy_nuc()``).
        """
        Z = self.atom_charges().astype(np.float64)
        R = self.atom_coords()
        Om = self.vol
        if eta is None:
            eta = np.sqrt(np.pi) / Om ** (1.0 / 3.0) * 2.0

        # real-space: 0.5 sum_{i,j,L}' Zi Zj erfc(eta r)/r
        rcut = 7.0 / eta
        Ls = self.lattice_Ls(rcut + float(np.linalg.norm(R, axis=1).max(initial=0.0)) * 2)
        rij = R[:, None, :] - R[None, :, :]  # [n,n,3]
        d = rij[None] + Ls[:, None, None, :]  # [nL,n,n,3]
        dist = np.linalg.norm(d, axis=-1)
        mask = dist > 1e-10
        with np.errstate(divide="ignore", invalid="ignore"):
            terms = np.where(mask, erfc(eta * dist) / np.where(mask, dist, 1.0), 0.0)
        e_real = 0.5 * np.einsum("i,j,Lij->", Z, Z, terms)

        # self + background (charged-system) terms
        e_self = -eta / np.sqrt(np.pi) * np.sum(Z**2)
        e_bg = -np.pi / (2.0 * eta**2 * Om) * np.sum(Z) ** 2

        # reciprocal: (2 pi / Om) sum_{G != 0} e^{-G^2/4eta^2}/G^2 |S(G)|^2
        gmax = 2.0 * eta * np.sqrt(np.log(np.sum(Z) ** 2 / self.precision) + 30.0)
        Gv = self.get_Gv(gmax)
        G2 = np.einsum("gi,gi->g", Gv, Gv)
        nz = G2 > 1e-12
        Gv, G2 = Gv[nz], G2[nz]
        SG = Z @ np.exp(1j * (R @ Gv.T))  # [nG]
        e_rec = (
            2.0
            * np.pi
            / Om
            * np.sum(np.exp(-G2 / (4.0 * eta**2)) / G2 * np.abs(SG) ** 2)
        )
        return float(e_real + e_self + e_bg + e_rec)

    def energy_nuc(self) -> float:  # overrides the molecular pair sum
        return self.ewald()

    def madelung(self) -> float:
        """Madelung constant of a unit probe charge in this cell.

        Used by the reference's Ewald exxdiv correction
        (kbe/pbe.py:484 via pyscf ``_ewald_exxdiv_for_G0``): the exchange
        G=0 correction per electron is -madelung/2 per unit charge.
        """
        probe = Cell.__new__(Cell)
        probe.a = self.a
        probe.precision = self.precision
        probe._atoms = [("H", np.zeros(3))]
        probe.basis = self.basis
        probe.charge = 0
        probe.spin = 0
        probe.shells = []
        probe.nao = 0
        return -2.0 * probe.ewald()

    def supercell(self, kmesh) -> "Cell":
        """Supercell Cell replicating this cell over the kmesh (ref sgeom).

        Image ordering matches ``make_kpts``/phase conventions:
        cartesian product of (0..n_i-1) over the three lattice directions.
        """
        reps = [
            (i, j, k)
            for i in range(kmesh[0])
            for j in range(kmesh[1])
            for k in range(kmesh[2])
        ]
        atoms = []
        for rep in reps:
            T = np.asarray(rep) @ self.a
            for sym, xyz in self._atoms:
                atoms.append((sym, xyz + T))
        sup = Cell.__new__(Cell)
        sup.a = self.a * np.asarray(kmesh, dtype=np.float64)[:, None]
        sup.precision = self.precision
        sup.basis = self.basis
        sup.charge = self.charge * len(reps)
        sup.spin = 0
        sup._atoms = atoms
        sup.shells = []
        sup.nao = 0
        sup.build()
        return sup
