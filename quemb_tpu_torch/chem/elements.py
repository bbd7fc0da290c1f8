"""Periodic-table data needed by the framework.

Self-contained replacement for the element data the reference pulls in through
PySCF / chemcoord (cf. reference ``molbe/helper.py:get_core`` and
``molbe/chemfrag.py:BondConnectivity.from_cartesian``).  All numeric data here
is standard public reference data (IUPAC symbols, Cordero covalent radii).

JAX counterpart: ``quemb_tpu/chem/elements.py``, of which this is a copy (it
holds no jax).
"""

from __future__ import annotations

ELEMENTS = [
    "X", "H", "He",
    "Li", "Be", "B", "C", "N", "O", "F", "Ne",
    "Na", "Mg", "Al", "Si", "P", "S", "Cl", "Ar",
    "K", "Ca", "Sc", "Ti", "V", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn",
    "Ga", "Ge", "As", "Se", "Br", "Kr",
    "Rb", "Sr", "Y", "Zr", "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd",
    "In", "Sn", "Sb", "Te", "I", "Xe",
]

SYMBOL_TO_Z = {s: i for i, s in enumerate(ELEMENTS)}
# Case-insensitive lookup, also accept e.g. "H1" style labels stripped upstream.
_SYMBOL_TO_Z_UPPER = {s.upper(): i for i, s in enumerate(ELEMENTS)}


def charge_of(symbol: str) -> int:
    s = symbol.strip()
    if s.upper() in _SYMBOL_TO_Z_UPPER:
        return _SYMBOL_TO_Z_UPPER[s.upper()]
    raise KeyError(f"Unknown element symbol: {symbol!r}")


#: Covalent radii in Angstrom (Cordero et al., Dalton Trans. 2008 — the same
#: public data set chemcoord tabulates).  Used for bond detection in the
#: chemgen fragmenter with the reference's ``max(0.55, 1.2*r)`` floor
#: (reference chemfrag.py:247).
COVALENT_RADIUS = {
    "H": 0.31, "He": 0.28,
    "Li": 1.28, "Be": 0.96, "B": 0.84, "C": 0.76, "N": 0.71, "O": 0.66,
    "F": 0.57, "Ne": 0.58,
    "Na": 1.66, "Mg": 1.41, "Al": 1.21, "Si": 1.11, "P": 1.07, "S": 1.05,
    "Cl": 1.02, "Ar": 1.06,
    "K": 2.03, "Ca": 1.76, "Fe": 1.32, "Cu": 1.32, "Zn": 1.22,
    "Br": 1.20, "I": 1.39,
}

#: Number of frozen-core orbitals per element (reference shared/helper.py
#: ``ncore_``): 0 for H-He, 1 for Li-Ne, 5 for Na-Ar, ...
def ncore_of(z: int) -> int:
    if z <= 2:
        return 0
    elif z <= 10:
        return 1
    elif z <= 18:
        return 5
    elif z <= 36:
        return 9
    elif z <= 54:
        return 18
    raise NotImplementedError(f"ncore not tabulated for Z={z}")


ANG2BOHR = 1.8897261245650618  # CODATA: 1 Angstrom in Bohr (pyscf param.BOHR)
BOHR2ANG = 1.0 / ANG2BOHR
