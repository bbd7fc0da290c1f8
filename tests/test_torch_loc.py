"""The port's localizers against the JAX package.

- the copies ``lo/jacobi.py`` (Boys, Pipek-Mezey, Edmiston-Ruedenberg,
  ``get_loc``) and ``lo/iao.py`` (``get_xovlp``, ``get_iao``, ``get_pao``,
  ``remove_core_mo``) against their originals on the same orbitals of
  water/6-31G, each package on its own integrals: gauge-free quantities
  (the projector W W^T S, the Boys spread, the PM and ER functionals) at
  1e-10;
- ``BE`` through every ``lo_method`` and ``iao_loc_method`` on water/6-31G
  BE1 (the whole molecule in one fragment), and H8 BE2 with Boys and PM:
  HF-in-HF and one-shot CCSD energies against the JAX package's at 1e-8
  (mirrors ``tests/test_loc.py``);
- ``_reorder_by_atom`` against the original on the IAOs.
"""

import numpy as np
import pytest
import torch

import quemb_tpu as jq
from quemb_tpu import api as jax_api
from quemb_tpu.chem.mole import Mole as JMole
from quemb_tpu.chem.scf import RHF as JRHF
from quemb_tpu.lo import iao as jax_iao
from quemb_tpu.lo import jacobi as jax_jacobi
import quemb_tpu_torch as qt
from quemb_tpu_torch import api
from quemb_tpu_torch.chem import integrals
from quemb_tpu_torch.chem.mole import Mole
from quemb_tpu_torch.chem.scf import RHF
from quemb_tpu_torch.lo import iao, jacobi

torch.set_num_threads(1)

WATER = "O 0 0 0.1173; H 0 0.7572 -0.4692; H 0 -0.7572 -0.4692"
H8 = "; ".join(f"H 0 0 {i * 0.9}" for i in range(8))


@pytest.fixture(autouse=True)
def _plain_f64_modes(monkeypatch):
    """Pin the JAX package's backend-dependent CCSD mode (mixed precision
    off), and start from the defaults on both sides."""
    monkeypatch.setenv("QUEMB_TPU_CCSD_MIXED", "0")
    for var in ("QUEMB_TPU_CCSD_F32_ONLY", "QUEMB_TPU_INCORE_CD",
                "QUEMB_TPU_CCSD_CONV_TOL", "QUEMB_TPU_CCSD_SPINORB"):
        monkeypatch.delenv(var, raising=False)


def _pair(geo, basis):
    """The JAX mean field and the port's, filled from the same arrays."""
    jmol = JMole(atom=geo, basis=basis)
    jmf = JRHF(jmol, conv_tol=1e-11)
    jmf.kernel()
    mol = Mole(atom=geo, basis=basis)
    mf = RHF.from_arrays(mol, jmf.get_hcore(), jmf.get_ovlp(),
                         jmf.get_eri(), np.array(jmf.mo_coeff),
                         jmf.mo_energy, jmf.e_tot)
    return jmol, jmf, mol, mf


@pytest.fixture(scope="module")
def water():
    return _pair(WATER, "6-31g")


@pytest.fixture(scope="module")
def h8():
    return _pair(H8, "sto-3g")


# ------------------------------------------------------------ the copies
def _projector(C, S):
    return C @ C.T @ S


def _boys_spread(mol, C):
    d = np.einsum("xpq,pi,qi->xi", integrals.dipole(mol), C, C)
    return float((d ** 2).sum())


def _pm_functional(mol, C, S):
    w, V = np.linalg.eigh(S)
    X = (V * np.sqrt(w)) @ V.T @ C
    return float(sum((np.einsum("mi,mi->i", X[p0:p1], X[p0:p1]) ** 2).sum()
                     for p0, p1 in mol.aoslice_by_atom()))


def _er_functional(eri, C):
    return float(np.einsum("pqrs,pi,qi,ri,si->", eri, C, C, C, C,
                           optimize=True))


@pytest.mark.parametrize("method", ["boys", "PM", "ER"])
def test_jacobi_copy_matches_original(water, method):
    """The localized occupied orbitals of water: the same span (projector)
    and the same value of each functional, 1e-10."""
    jmol, jmf, mol, mf = water
    S = mf.get_ovlp()
    Co = np.array(jmf.mo_coeff[:, :5])
    out = jacobi.get_loc(mol, Co, method, S=S)
    ref = jax_jacobi.get_loc(jmol, Co, method, S=S)
    assert np.abs(_projector(out, S) - _projector(ref, S)).max() < 1e-10
    assert abs(_boys_spread(mol, out) - _boys_spread(mol, ref)) < 1e-10
    assert abs(_pm_functional(mol, out, S)
               - _pm_functional(mol, ref, S)) < 1e-10
    eri = mf.get_eri()
    assert abs(_er_functional(eri, out) - _er_functional(eri, ref)) < 1e-10
    # it localized: the functional it maximizes went up from the MOs
    functional = {"boys": lambda C: _boys_spread(mol, C),
                  "PM": lambda C: _pm_functional(mol, C, S),
                  "ER": lambda C: _er_functional(eri, C)}[method]
    assert functional(out) > functional(Co) + 1e-3


@pytest.mark.parametrize("iao_loc_method", ["lowdin", "boys"])
def test_iao_copy_matches_original(water, iao_loc_method):
    """get_xovlp, get_iao, get_pao and remove_core_mo: projectors 1e-10,
    and the IAOs span the occupied orbitals."""
    jmol, jmf, mol, mf = water
    S = mf.get_ovlp()
    Co = np.array(jmf.mo_coeff[:, :5])
    S12, S22, _ = iao.get_xovlp(mol, "sto-3g")
    jS12, jS22, _ = jax_iao.get_xovlp(jmol, "sto-3g")
    assert np.abs(S12 - jS12).max() < 1e-12
    assert np.abs(S22 - jS22).max() < 1e-12
    Ciao = iao.get_iao(Co, S12, S, S22, mol, "sto-3g", iao_loc_method)
    jCiao = jax_iao.get_iao(Co, jS12, S, jS22, jmol, "sto-3g",
                            iao_loc_method)
    assert np.abs(_projector(Ciao, S) - _projector(jCiao, S)).max() < 1e-10
    Cpao = iao.get_pao(Ciao, S, S12, mol, "sto-3g", iao_loc_method)
    jCpao = jax_iao.get_pao(jCiao, S, jS12, jmol, "sto-3g", iao_loc_method)
    assert Cpao.shape == jCpao.shape
    assert np.abs(_projector(Cpao, S) - _projector(jCpao, S)).max() < 1e-10
    Cc = np.array(jmf.mo_coeff[:, :1])
    out = iao.remove_core_mo(Ciao, Cc, S)
    ref = jax_iao.remove_core_mo(jCiao, Cc, S)
    assert out.shape == (mol.nao, Ciao.shape[1] - 1)
    assert np.abs(_projector(out, S) - _projector(ref, S)).max() < 1e-10
    P_occ = _projector(Co, S)
    assert np.abs(_projector(Ciao, S) @ P_occ - P_occ).max() < 1e-10


def test_reorder_by_atom_matches_original(water):
    jmol, jmf, mol, mf = water
    S = mf.get_ovlp()
    S12, S22, _ = iao.get_xovlp(mol, "sto-3g")
    Ciao = iao.get_iao(np.array(jmf.mo_coeff[:, :5]), S12, S, S22)
    by_atom = [list(range(p0, p1)) for p0, p1 in mol.aoslice_by_atom()]
    out = api._reorder_by_atom(Ciao, by_atom, S)
    ref = jax_api._reorder_by_atom(Ciao, by_atom, S)
    assert out[1] == ref[1]
    assert np.array_equal(out[0], ref[0])


# --------------------------------------------------------- through BE
def _be_pair(pair, n_BE, iao_valence_basis=None, **kw):
    jmol, jmf, mol, mf = pair
    fkw = dict(n_BE=n_BE, frag_type="chemgen", print_frags=False,
               iao_valence_basis=iao_valence_basis)
    jbe = jq.BE(jmf, jq.fragmentate(jmol, **fkw), **kw)
    be = qt.BE(mf, qt.fragmentate(mol, **fkw), device="cpu", **kw)
    return jbe, be


def _oneshot_agree(jbe, be, e_tot_hf):
    assert abs(be.ebe_hf - jbe.ebe_hf) < 1e-8
    assert abs(be.ebe_hf - e_tot_hf) < 1e-8
    jbe.oneshot("CCSD")
    be.oneshot("CCSD")
    assert abs(be.ebe_tot - jbe.ebe_tot) < 1e-8
    return be.ebe_tot


@pytest.mark.parametrize("lo", ["lowdin", "boys", "PM", "ER", "IAO"])
def test_be1_localizers_match_jax(water, lo):
    """Water/6-31G BE1 (one fragment: the whole molecule), each localizer:
    HF-in-HF and the one-shot CCSD energy against the JAX package's, and
    the total is the localizer-free full CCSD (to 1e-8)."""
    basis = "sto-3g" if lo == "IAO" else None
    jbe, be = _be_pair(water, 1, basis, lo_method=lo)
    e = _oneshot_agree(jbe, be, water[3].e_tot)
    if not hasattr(water[3], "_e_ref"):
        jref, ref = _be_pair(water, 1)
        ref.oneshot("CCSD")
        water[3]._e_ref = ref.ebe_tot
    assert abs(e - water[3]._e_ref) < 1e-8


@pytest.mark.parametrize("iao_loc_method", ["boys", "PM", "ER"])
def test_be1_iao_loc_method_matches_jax(water, iao_loc_method):
    jbe, be = _be_pair(water, 1, "sto-3g", lo_method="IAO",
                       iao_loc_method=iao_loc_method)
    _oneshot_agree(jbe, be, water[3].e_tot)


@pytest.mark.parametrize("lo", ["boys", "pm"])
def test_be2_h8_localizers_match_jax(h8, lo):
    """H8 BE2 with Boys and PM (the lower-case alias too): energies 1e-8.
    One AO an atom: the Lowdin orbitals already maximize PM, and Boys
    moves them."""
    jbe, be = _be_pair(h8, 2, lo_method=lo)
    _oneshot_agree(jbe, be, h8[3].e_tot)
    moved = np.abs(be.W - _be_pair(h8, 2)[1].W).max()
    assert moved > 1e-3 if lo == "boys" else moved < 1e-8


def test_unknown_lo_method_raises(h8):
    mol, mf = h8[2], h8[3]
    fobj = qt.fragmentate(mol, n_BE=2, print_frags=False)
    with pytest.raises(NotImplementedError, match="lo_method='NBO'"):
        qt.BE(mf, fobj, lo_method="NBO", device="cpu")
