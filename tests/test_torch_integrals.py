"""The port's host integral engine is a copy: it is held to the JAX
package's engine, and its native library to its pure-Python plain version.

Molecules: water/6-31G* (a d shell on O) in spherical and cartesian AOs,
and the H8/STO-3G chain.  Copies against the originals agree to 1e-13
(the same arithmetic from two builds of the same sources); the native
library against the pure-Python routes to 1e-10, also on two carbon and
two sulfur atoms of the thiophene dimer in 6-31G, turned to an
orientation where a primitive screen on the Schwarz diagonals lost
quartets of 1e-8 (the JAX package's engine still screens them, so only
the pure-Python route can hold the native one there).
"""

import numpy as np
import pytest
import torch

from quemb_tpu.chem import integrals as jint
from quemb_tpu.chem.mole import Mole as JMole
from quemb_tpu.ops.df import make_even_tempered_auxbasis as j_etb
from quemb_tpu.utils.geometry import alkane_atoms as j_alkane_atoms
from quemb_tpu_torch import native
from quemb_tpu_torch.chem import integrals as tint
from quemb_tpu_torch.chem.mole import Mole
from quemb_tpu_torch.ops.df import make_even_tempered_auxbasis as t_etb
from quemb_tpu_torch.utils.geometry import alkane_atoms
from tests.test_torch_eri_rotation import ATOMS as C2S2, _rotation

torch.set_num_threads(1)
native.get_lib()  # load the engine's OpenMP runtime before capping it
try:
    # several test workers share the cores: two engine threads per worker
    from threadpoolctl import threadpool_limits
except ImportError:
    pass
else:
    threadpool_limits(limits=1, user_api="blas")
    threadpool_limits(limits=2, user_api="openmp")

WATER = "O 0 0 0.1; H 0 0.75 -0.45; H 0 -0.7 -0.46"
H8 = "; ".join(f"H 0 0 {i * 1.0}" for i in range(8))
MOLS = {
    "water-631gs-sph": dict(atom=WATER, basis="6-31g*", cart=False),
    "water-631gs-cart": dict(atom=WATER, basis="6-31g*", cart=True),
    "h8-sto3g": dict(atom=H8, basis="sto-3g"),
}
#: held to the pure-Python routes alone
TURNED = {
    "c2s2-631g-turned": dict(
        atom=[(s, np.asarray(c) @ _rotation(2300000011).T) for s, c in C2S2],
        basis="6-31g"),
}
COPY_TOL = 1e-13
NATIVE_TOL = 1e-10


def _pair(name):
    return Mole(**MOLS[name]), JMole(**MOLS[name])


# dipole is cartesian-only in both packages
ONE_MOL_CASES = [
    (name, fn) for name in MOLS
    for fn in ("overlap", "kinetic", "nuclear_attraction",
               "core_hamiltonian", "dipole", "eri_full")
    if not (fn == "dipole" and name.endswith("sph"))
]


@pytest.mark.parametrize("name,fn", ONE_MOL_CASES)
def test_one_molecule_integrals_match_original(name, fn):
    mol, jmol = _pair(name)
    assert mol.nao == jmol.nao
    out = getattr(tint, fn)(mol)
    ref = getattr(jint, fn)(jmol)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= COPY_TOL * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("name", MOLS)
def test_aux_integrals_match_original(name):
    mol, jmol = _pair(name)
    aux, jaux = t_etb(mol), j_etb(jmol)
    assert aux.nao == jaux.nao
    for out, ref in (
        (tint.int2c2e(aux), jint.int2c2e(jaux)),
        (tint.int3c2e(mol, aux), jint.int3c2e(jmol, jaux)),
        (tint.cross_overlap(mol, Mole(atom=MOLS[name]["atom"])),
         jint.cross_overlap(jmol, JMole(atom=MOLS[name]["atom"]))),
    ):
        assert out.shape == ref.shape
        assert np.abs(out - ref).max() <= COPY_TOL * max(
            1.0, np.abs(ref).max()
        )


def test_boys_matches_original_and_plain():
    T = np.array([0.0, 1e-14, 0.3, 3.0, 11.0, 16.9, 17.1, 40.0, 300.0])
    out = tint.boys(10, T)
    assert np.abs(out - jint.boys(10, T)).max() <= COPY_TOL
    assert np.abs(out - tint.boys(10, T, native=False)).max() <= 1e-12


@pytest.mark.parametrize("name", ["water-631gs-sph", "h8-sto3g",
                                  "c2s2-631g-turned"])
@pytest.mark.parametrize("fn", ["eri_full", "int2c2e", "int3c2e"])
def test_native_matches_pure_python(name, fn, monkeypatch):
    mol = Mole(**{**MOLS, **TURNED}[name])
    aux = t_etb(mol)
    args = {"eri_full": (mol,), "int2c2e": (aux,), "int3c2e": (mol, aux)}[fn]
    fast = getattr(tint, fn)(*args)
    monkeypatch.setenv("QUEMB_TPU_NATIVE_ERI", "0")
    plain = getattr(tint, fn)(*args)
    assert np.abs(fast - plain).max() <= NATIVE_TOL


def test_failed_native_build_raises(monkeypatch, tmp_path):
    """A build that fails with every compiler must raise, never fall back
    to pure Python."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_CXX_FLAGS",
                        (*native._CXX_FLAGS, "--no-such-flag"))
    mol = Mole(**MOLS["h8-sto3g"])
    with pytest.raises(RuntimeError, match="native integral library"):
        tint.eri_full(mol)
    with pytest.raises(RuntimeError, match="native integral library"):
        tint.int2c2e(t_etb(mol))


def test_unusable_cxx_falls_through_to_gxx(monkeypatch, tmp_path):
    """$CXX may name a compiler without an OpenMP runtime; g++ on the PATH
    is tried before the build counts as failed."""
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "false")
    build = native._build()
    assert not build["cached"] and build["path"].startswith(str(tmp_path))
    assert native._build()["cached"]


def test_invalid_native_library_raises(monkeypatch):
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_validate", lambda lib: False)
    with pytest.raises(RuntimeError, match="boys_batch"):
        native.get_lib()


def test_library_is_built_outside_the_sources():
    so = native._library_path()
    assert so.parent.name == "build"
    assert so.exists()
    here = native._HERE
    assert not list(here.glob("*.so"))


def test_alkane_atoms_and_ecp():
    for n in (1, 8, 40):
        a, b = alkane_atoms(n), j_alkane_atoms(n)
        assert [s for s, _ in a] == [s for s, _ in b]
        assert np.array_equal(np.array([x for _, x in a]),
                              np.array([x for _, x in b]))
    # ECPs are ported: the effective charges, the electron count and the
    # core Hamiltonian (ECP quadrature included) equal the JAX package's
    ecp = {"C": {"ncore": 2, "local": [(2, 4.5, 8.0), (1, 2.8, 2.0)],
                 "semilocal": {0: [(2, 6.0, 10.0)]}}}
    kw = dict(atom="C 0 0 0; H 0 0 1.09; H 1.03 0 -0.36", basis="sto-3g",
              spin=0, charge=-1, ecp=ecp)
    mol, jmol = Mole(**kw), JMole(**kw)
    assert mol.nelectron == jmol.nelectron == 7
    assert np.array_equal(mol.atom_charges(), jmol.atom_charges())
    h, jh = tint.core_hamiltonian(mol), jint.core_hamiltonian(jmol)
    assert np.abs(h - jh).max() <= COPY_TOL * np.abs(jh).max()
