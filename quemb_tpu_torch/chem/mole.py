"""Molecule container: geometry + basis -> shell table, AO bookkeeping.

Self-contained replacement for ``pyscf.gto.Mole`` as used by the reference
(geometry/basis handling, ``aoslice_by_atom``, ``energy_nuc``, nelectron).
AO ordering follows the PySCF convention: AOs grouped by atom; within an atom
shells are sorted by angular momentum (all s shells, then p shells, ...);
p components ordered (x, y, z).

JAX counterpart: ``quemb_tpu/chem/mole.py``, of which this is a copy (it
holds no jax).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from quemb_tpu_torch.chem.basis_data import get_basis_shells
from quemb_tpu_torch.chem.elements import ANG2BOHR, charge_of, ncore_of


def ncart(l: int) -> int:
    return (l + 1) * (l + 2) // 2


def cart_components(l: int) -> list[tuple[int, int, int]]:
    """Cartesian exponent triples in PySCF order (lexicographic by x desc)."""
    out = []
    for lx in range(l, -1, -1):
        for ly in range(l - lx, -1, -1):
            out.append((lx, ly, l - lx - ly))
    return out


_DF2 = np.ones(32)  # (2n-1)!! table
for _n in range(2, 32):
    _DF2[_n] = _DF2[_n - 1] * (2 * _n - 1)


def _double_factorial_2nm1(n: int) -> float:
    """(2n-1)!! with (−1)!! = 1."""
    return float(_DF2[n]) if n >= 1 else 1.0


def gaussian_norm(l: int, alpha: float) -> float:
    """Norm of the cartesian primitive x^l exp(-alpha r^2) (i.e. (l,0,0))."""
    return (
        (2 * alpha / np.pi) ** 0.75
        * (4 * alpha) ** (l / 2.0)
        / np.sqrt(_double_factorial_2nm1(l))
    )


@dataclass
class Shell:
    l: int
    exps: np.ndarray          # [nprim]
    coefs: np.ndarray         # [nprim] fully normalized contraction coefs
    center: np.ndarray        # [3] in Bohr
    atom_idx: int
    ao_offset: int = 0        # first AO index of this shell

    @property
    def nfunc(self) -> int:
        return ncart(self.l)


def _normalize_contraction(l: int, exps, coefs) -> np.ndarray:
    """Multiply primitive norms and normalize the contracted function.

    Matches the PySCF normalization for s/p (and cartesian (l,0,0)) shells.
    """
    exps = np.asarray(exps, dtype=np.float64)
    coefs = np.asarray(coefs, dtype=np.float64) * np.array(
        [gaussian_norm(l, a) for a in exps]
    )
    # contracted self-overlap of the (l,0,0) component
    ee = exps[:, None] + exps[None, :]
    ov = (
        (np.pi / ee) ** 1.5
        * _double_factorial_2nm1(l)
        / (2.0 * ee) ** l
    )
    s = coefs @ ov @ coefs
    return coefs / np.sqrt(s)


_SPH_COMP_LABELS = {
    0: [""],
    1: ["x", "y", "z"],
    2: ["xy", "yz", "z^2", "xz", "x2-y2"],
    3: ["y^3", "xyz", "yz^2", "z^3", "xz^2", "zx^2", "x^3"],
    4: ["m-4", "m-3", "m-2", "m-1", "m0", "m1", "m2", "m3", "m4"],
}


class Mole:
    """Molecular system: atoms, charge, basis; builds the shell table."""

    def __init__(
        self,
        atom: str | list | None = None,
        basis: str = "sto-3g",
        charge: int = 0,
        spin: int = 0,
        unit: str = "angstrom",
        cart: bool = True,
        ecp=None,
    ):
        """cart=False builds real-spherical-harmonic AOs (the PySCF
        default for d and higher); the integral engine stays cartesian
        internally with a block c2s transform at the interface.
        ``ecp``: per-element semi-local ECP spec (chem/ecp.py) -- reduces
        the effective nuclear charges and adds <mu|V_ECP|nu> to hcore."""
        from quemb_tpu_torch.chem.ecp import normalize_ecp

        self.cart = cart
        self.basis = basis
        self.charge = charge
        self.spin = spin  # 2S = Nalpha - Nbeta
        self.ecp = normalize_ecp(ecp)
        self._atoms: list[tuple[str, np.ndarray]] = []
        if atom is not None:
            self._parse_atoms(atom, unit)
        self.shells: list[Shell] = []
        self.nao = 0
        if self._atoms:
            self.build()

    # ------------------------------------------------------------------ setup
    def _parse_atoms(self, atom, unit: str):
        scale = ANG2BOHR if unit.lower().startswith("ang") else 1.0
        if isinstance(atom, str):
            entries = []
            for line in atom.replace(";", "\n").splitlines():
                line = line.strip()
                if not line:
                    continue
                parts = line.split()
                entries.append((parts[0], [float(x) for x in parts[1:4]]))
        else:
            entries = [(sym, list(xyz)) for sym, xyz in atom]
        self._atoms = [
            (sym, np.asarray(xyz, dtype=np.float64) * scale) for sym, xyz in entries
        ]

    @classmethod
    def from_xyz_file(cls, path: str | Path, **kwargs) -> "Mole":
        lines = Path(path).read_text().strip().splitlines()
        natm = int(lines[0].split()[0])
        body = "\n".join(lines[2 : 2 + natm])
        return cls(atom=body, **kwargs)

    def build(self) -> "Mole":
        self.shells = []
        offset = 0
        sph_offset = 0
        self._aoslice = []
        cart = getattr(self, "cart", True)
        for ia, (sym, xyz) in enumerate(self._atoms):
            if isinstance(self.basis, dict):
                # explicit per-element (or per-atom-index) shell data:
                # {key: [(l, [(exp, coef), ...]), ...]} — used by external
                # mean-field ingestion (ORCA JSON embeds its basis) and
                # custom/tabulated auxiliary sets
                raw = self.basis.get(ia, self.basis.get(sym))
                if raw is None:
                    raise NotImplementedError(
                        f"no basis entry for atom {ia} ({sym})"
                    )
            else:
                raw = get_basis_shells(self.basis, sym)
            # PySCF convention: within an atom group shells by l
            raw = sorted(raw, key=lambda sh: sh[0])
            start = offset if cart else sph_offset
            for l, prims in raw:
                exps = np.array([p[0] for p in prims])
                coefs = _normalize_contraction(
                    l, exps, np.array([p[1] for p in prims])
                )
                self.shells.append(
                    Shell(l, exps, coefs, np.asarray(xyz), ia, offset)
                )
                offset += ncart(l)
                sph_offset += 2 * l + 1
            self._aoslice.append(
                (start, offset if cart else sph_offset)
            )
        self.nao_cart = offset
        if cart:
            self.nao = offset
            self.c2s = None
        else:
            from quemb_tpu_torch.chem.sph import mol_c2s

            self.nao = sph_offset
            self.c2s = mol_c2s(self)
        return self

    # -------------------------------------------------------------- accessors
    @property
    def natm(self) -> int:
        return len(self._atoms)

    @property
    def elements(self) -> list[str]:
        return [sym for sym, _ in self._atoms]

    def atom_charge(self, ia: int) -> int:
        sym = self._atoms[ia][0]
        z = charge_of(sym)
        ecp = getattr(self, "ecp", None)  # __new__-built auxmols lack it
        if ecp and sym in ecp:
            z -= ecp[sym].ncore
        return z

    def atom_charges(self) -> np.ndarray:
        return np.array([self.atom_charge(i) for i in range(self.natm)])

    def atom_coords(self) -> np.ndarray:
        """Coordinates in Bohr, [natm, 3]."""
        return np.array([xyz for _, xyz in self._atoms])

    @property
    def nelectron(self) -> int:
        return int(self.atom_charges().sum()) - self.charge

    def aoslice_by_atom(self) -> list[tuple[int, int]]:
        """(ao_start, ao_stop) per atom."""
        return list(self._aoslice)

    def ncore(self) -> int:
        return sum(ncore_of(self.atom_charge(i)) for i in range(self.natm))

    def core_info(self) -> tuple[int, list[int], list[int]]:
        """(Ncore, valence AO idx list, per-atom core counts).

        Mirrors the reference's ``molbe/helper.py:get_core``.
        """
        Ncore = 0
        idx: list[int] = []
        corelist: list[int] = []
        for ia, (p0, p1) in enumerate(self.aoslice_by_atom()):
            nc = ncore_of(self.atom_charge(ia))
            corelist.append(nc)
            Ncore += nc
            idx.extend(range(p0 + nc, p1))
        return Ncore, idx, corelist

    def energy_nuc(self) -> float:
        coords = self.atom_coords()
        Z = self.atom_charges().astype(np.float64)
        e = 0.0
        for i in range(self.natm):
            for j in range(i):
                e += Z[i] * Z[j] / np.linalg.norm(coords[i] - coords[j])
        return e

    def ao_labels(self) -> list[str]:
        labels = []
        shell_count_per_atom_l: dict[tuple[int, int], int] = {}
        for sh in self.shells:
            n = shell_count_per_atom_l.get((sh.atom_idx, sh.l), 0)
            shell_count_per_atom_l[(sh.atom_idx, sh.l)] = n + 1
            pq = "spdfg"[sh.l]
            if getattr(self, "cart", True):
                comps = [
                    "x" * lx + "y" * ly + "z" * lz
                    for lx, ly, lz in cart_components(sh.l)
                ]
            else:
                comps = _SPH_COMP_LABELS.get(
                    sh.l, [f"m{m}" for m in range(-sh.l, sh.l + 1)]
                )
            for comp in comps:
                labels.append(
                    f"{sh.atom_idx} {self._atoms[sh.atom_idx][0]} "
                    f"{n + sh.l + 1}{pq}{comp}"
                )
        return labels
