"""The port's semi-local ECP integrals are a copy: held to the JAX
package's, to a closed form, and through the BE pipeline.

``ecp_matrix`` equals the JAX package's to 1e-12 (the same quadrature on
the same grid) on cartesian and spherical bases; the local term of an
all-s basis equals its closed form to 1e-8 (the JAX test's bar).  Propane
with the synthetic 2-electron-core carbon ECP of ``tests/test_ecp.py``:
20 electrons, the port's RHF and one-shot BE1/BE2 CCSD on the CPU,
HF-in-HF below 1e-6 Ha, and E_HF and E_corr within 1e-8 Ha of the JAX
package's.
"""

import numpy as np
import pytest
import torch

import quemb_tpu as jq
import quemb_tpu_torch as qt
from quemb_tpu.chem.ecp import ecp_matrix as j_ecp_matrix
from quemb_tpu.chem.integrals import core_hamiltonian as j_core_hamiltonian
from quemb_tpu.chem.mole import Mole as JMole
from quemb_tpu.chem.scf import RHF as JRHF
from quemb_tpu_torch.chem.ecp import ECPData, ecp_matrix, normalize_ecp
from quemb_tpu_torch.chem.integrals import core_hamiltonian
from quemb_tpu_torch.chem.mole import Mole
from quemb_tpu_torch.chem.scf import RHF

torch.set_num_threads(1)

PSEUDO_C = {"C": {"ncore": 2, "local": [(2, 4.5, 8.0), (1, 2.8, 2.0)],
                  "semilocal": {0: [(2, 6.0, 10.0)]}}}
PROPANE = (
    "C 0 0 0; C 1.26 0.86 0; C 2.52 0 0;"
    "H -0.55 0.94 0; H -0.55 -0.55 0.8; H -0.55 -0.55 -0.8;"
    "H 1.26 1.5 0.88; H 1.26 1.5 -0.88;"
    "H 3.07 0.94 0; H 3.07 -0.55 0.8; H 3.07 -0.55 -0.8"
)
CASES = {
    "h2-local": dict(
        atom="H 0 0 0; H 0 0 0.9", basis="sto-3g",
        ecp={"H": {"ncore": 0, "local": [(2, 1.1, 1.0), (1, 2.0, 0.5)],
                   "semilocal": {0: [(2, 1.6, 0.8)]}}}),
    "ne-semilocal-sp": dict(
        atom="Ne 0 0 0", basis="sto-3g",
        ecp={"Ne": {"ncore": 0, "semilocal": {0: [(2, 0.9, 1.7)],
                                              1: [(2, 1.2, 0.6)]}}}),
    "propane-pseudo-c": dict(atom=PROPANE, basis="sto-3g", ecp=PSEUDO_C),
    "water-sph-d": dict(
        atom="O 0 0 0.1; H 0 0.75 -0.45; H 0 -0.7 -0.46", basis="6-31g*",
        cart=False,
        ecp={"O": {"ncore": 2, "local": [(2, 5.0, 6.0)],
                   "semilocal": {0: [(2, 7.0, 9.0)], 2: [(2, 3.0, 1.5)]}}}),
}


@pytest.mark.parametrize("name", list(CASES))
def test_ecp_matrix_matches_jax(name):
    mol, jmol = Mole(**CASES[name]), JMole(**CASES[name])
    V, jV = ecp_matrix(mol), j_ecp_matrix(jmol)
    assert V.shape == jV.shape == (mol.nao, mol.nao)
    assert np.abs(V - jV).max() <= 1e-12
    assert mol.nelectron == jmol.nelectron
    assert np.array_equal(mol.atom_charges(), jmol.atom_charges())
    # the core Hamiltonian carries the ECP and the reduced nuclear
    # charges, as in the JAX package
    h, jh = core_hamiltonian(mol), j_core_hamiltonian(jmol)
    assert np.abs(h - jh).max() <= 1e-12 * np.abs(jh).max()


def _analytic_sss(mol, alpha, C):
    """<mu|exp(-alpha |r-C|^2)|nu> for an all-s (contracted) basis."""
    V = np.zeros((mol.nao, mol.nao))
    for shi in mol.shells:
        for shj in mol.shells:
            acc = 0.0
            for a, ca in zip(shi.exps, np.ravel(shi.coefs)):
                for b, cb in zip(shj.exps, np.ravel(shj.coefs)):
                    p = a + b
                    P = (a * shi.center + b * shj.center) / p
                    K1 = np.exp(-a * b / p
                                * np.sum((shi.center - shj.center) ** 2))
                    q = p + alpha
                    K2 = np.exp(-p * alpha / q * np.sum((P - C) ** 2))
                    acc += ca * cb * K1 * K2 * (np.pi / q) ** 1.5
            V[shi.ao_offset, shj.ao_offset] = acc
    return V


def test_local_term_vs_closed_form():
    """tests/test_ecp.py:38 on the port: an r^0 local term on both H
    centers is a sum of two three-center s overlaps."""
    mol = Mole(atom="H 0 0 0; H 0 0 0.9", basis="sto-3g")
    alpha, c = 1.3, 2.5
    V = ecp_matrix(mol, {"H": ECPData(ncore=0, local=[(2, alpha, c)])})
    C1, C2 = (np.asarray(x) for _, x in mol._atoms)
    ref = c * (_analytic_sss(mol, alpha, C1) + _analytic_sss(mol, alpha, C2))
    assert np.abs(V - ref).max() < 1e-8
    assert normalize_ecp(None) == {}


@pytest.fixture(scope="module")
def propane():
    mol = Mole(atom=PROPANE, basis="sto-3g", ecp=PSEUDO_C)
    mf = RHF(mol, conv_tol=1e-12, device="cpu")
    mf.kernel()
    jmol = JMole(atom=PROPANE, basis="sto-3g", ecp=PSEUDO_C)
    jmf = JRHF(jmol, conv_tol=1e-12)
    jmf.kernel()
    return mol, mf, jmol, jmf


@pytest.mark.parametrize("n_BE", [1, 2])
def test_propane_ecp_be_matches_jax(propane, n_BE, monkeypatch):
    monkeypatch.setenv("QUEMB_TPU_CCSD_CONV_TOL", "1e-9")
    mol, mf, jmol, jmf = propane
    assert mol.nelectron == 3 * 4 + 8
    assert mf.converged and jmf.converged
    assert abs(mf.e_tot - jmf.e_tot) < 1e-8
    be = qt.BE(mf, qt.fragmentate(mol, n_BE=n_BE, print_frags=False),
               device="cpu")
    assert abs(be.ebe_hf - mf.e_tot) < 1e-6
    be.oneshot(solver="CCSD")
    jbe = jq.BE(jmf, jq.fragmentate(jmol, n_BE=n_BE, print_frags=False))
    jbe.oneshot(solver="CCSD")
    assert abs((be.ebe_tot - be.ebe_hf) - (jbe.ebe_tot - jbe.ebe_hf)) < 1e-8
