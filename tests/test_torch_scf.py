"""The port's RHF (dense and density-fitted J/K, Roothaan + DIIS on torch)
against the JAX package's on the same molecules.

H2, water/STO-3G and the H8 chain.  The orbitals of two eigensolvers differ
by signs and by rotations inside degenerate sets, so the comparison is
``e_tot`` (1e-9 Ha), the density (1e-7) and ``mo_energy`` (1e-7), never
``mo_coeff``.  ``get_jk_df`` is held to ``get_jk`` of the reconstructed
dense ERI at 1e-10.
"""

import numpy as np
import pytest
import torch

from quemb_tpu.chem.mole import Mole as JMole
from quemb_tpu.chem.scf import RHF as JRHF
from quemb_tpu_torch import native
from quemb_tpu_torch.chem import scf as tscf
from quemb_tpu_torch.chem.mole import Mole
from quemb_tpu_torch.chem.scf import RHF, UHF
from quemb_tpu_torch.ops.df import DFTensor

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

MOLS = {
    "h2": "H 0 0 0; H 0 0 0.74086",
    "water": "O 0 0 0.1173; H 0 0.7572 -0.4692; H 0 -0.7572 -0.4692",
    "h8": "; ".join(f"H 0 0 {i * 1.0}" for i in range(8)),
}
#: textbook / recorded RHF energies (STO-3G), loose: geometry conventions
KNOWN = {"h2": (-1.116714, 1e-6), "water": (-74.96302, 1e-5)}
E_TOL = 1e-9
DM_TOL = 1e-7


@pytest.fixture(scope="module")
def solved():
    out = {}
    for name, atom in MOLS.items():
        for with_df in (False, True):
            mf = RHF(Mole(atom=atom, basis="sto-3g"), with_df=with_df,
                     device="cpu")
            mf.kernel()
            jmf = JRHF(JMole(atom=atom, basis="sto-3g"), with_df=with_df)
            jmf.kernel()
            out[name, with_df] = (mf, jmf)
    return out


@pytest.mark.parametrize("with_df", [False, True], ids=["dense", "df"])
@pytest.mark.parametrize("name", MOLS)
def test_rhf_kernel_matches_jax(solved, name, with_df):
    mf, jmf = solved[name, with_df]
    assert mf.converged and jmf.converged
    assert abs(mf.e_tot - jmf.e_tot) < E_TOL
    assert np.abs(mf.make_rdm1() - jmf.make_rdm1()).max() < DM_TOL
    assert np.abs(mf.mo_energy - jmf.mo_energy).max() < DM_TOL
    assert np.array_equal(mf.mo_occ, jmf.mo_occ)
    if name in KNOWN and not with_df:
        ref, tol = KNOWN[name]
        assert abs(mf.e_tot - ref) < tol
    # SCF stationarity: the commutator FDS - SDF vanishes
    S, dm = mf.get_ovlp(), mf.make_rdm1()
    F = mf.get_hcore() + mf.get_veff(dm)
    assert np.abs(F @ dm @ S - S @ dm @ F).max() < 1e-5


def test_distorted_water_energy():
    """An asymmetric water (no degeneracy forced by symmetry)."""
    atom = "O 0 0 0.1; H 0 0.75 -0.45; H 0 -0.7 -0.46"
    mf = RHF(Mole(atom=atom, basis="sto-3g"), device="cpu")
    jmf = JRHF(JMole(atom=atom, basis="sto-3g"))
    assert abs(mf.kernel() - jmf.kernel()) < E_TOL


@pytest.mark.parametrize("name", MOLS)
def test_energy_tot_and_veff_match_jax(solved, name):
    mf, jmf = solved[name, True]
    rng = np.random.default_rng(5)
    n = mf.mol.nao
    dm = rng.standard_normal((n, n))
    dm = dm + dm.T
    assert np.abs(mf.get_veff(dm) - jmf.get_veff(dm)).max() < 1e-10
    assert abs(mf.energy_tot(dm) - jmf.energy_tot(dm)) < 1e-9
    assert abs(mf.energy_tot() - mf.e_tot) < 1e-9


@pytest.mark.parametrize("name", MOLS)
def test_get_jk_df_matches_dense_jk_of_the_fit(name):
    mol = Mole(atom=MOLS[name], basis="sto-3g")
    dft = DFTensor(mol)
    rng = np.random.default_rng(11)
    dm = rng.standard_normal((mol.nao, mol.nao))
    dm = torch.as_tensor(dm + dm.T)
    vj, vk = tscf.get_jk_df(torch.as_tensor(dft.B), dm)
    rj, rk = tscf.get_jk(torch.as_tensor(dft.eri_full()), dm)
    assert (vj - rj).abs().max() < 1e-10
    assert (vk - rk).abs().max() < 1e-10
    # and to the plain contractions in numpy
    eri = dft.eri_full()
    assert np.abs(np.einsum("pqrs,rs->pq", eri, dm.numpy())
                  - vj.numpy()).max() < 1e-10
    assert np.abs(np.einsum("prqs,rs->pq", eri, dm.numpy())
                  - vk.numpy()).max() < 1e-10


def test_kernel_restarts_from_a_density(solved):
    mf, _ = solved["h8", True]
    again = RHF(mf.mol, with_df=True, device="cpu")
    e = again.kernel(dm0=mf.make_rdm1())
    assert again.converged and again.cycles <= 3
    assert abs(e - mf.e_tot) < 1e-10


def test_df_mean_field_never_builds_the_dense_eri(monkeypatch):
    from quemb_tpu_torch.chem import integrals

    def boom(*a, **k):
        raise AssertionError("dense ERI built on the DF path")

    monkeypatch.setattr(integrals, "eri_full", boom)
    mf = RHF(Mole(atom=MOLS["h8"], basis="sto-3g"), with_df=True,
             auxbasis="etb:6.0", device="cpu")
    mf.kernel()
    mf.get_veff()
    assert mf.converged and mf._eri is None


def test_device_defaults_to_cuda_and_uhf_waits():
    mol = Mole(atom=MOLS["h2"], basis="sto-3g")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            RHF(mol).kernel()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            RHF(mol, device="cuda")
    uhf = UHF(mol)  # constructs; the device is resolved by the SCF
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            uhf.kernel()
    uhf = UHF(mol, device="cpu")
    assert abs(uhf.kernel() - RHF(mol, device="cpu").kernel()) < 1e-10
    with pytest.raises(ValueError, match="even electron"):
        RHF(Mole(atom="H 0 0 0", basis="sto-3g", spin=1), device="cpu").nocc
