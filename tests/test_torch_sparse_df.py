"""Sparse-DF f32 tier: the port's fragment ERIs against the JAX package's.

The H8 chain of ``tests/test_screening.py`` with its mean field from the
JAX package, the pivoted-Cholesky factor of its ERI, and the Schmidt bases
of a BE2 chemgen fragmentation go through
``quemb_tpu.ops.sparse_df.SparseDF.fragment_eri_f32`` (Pallas kernel in
interpret mode) and the port's counterpart (plain torch on the CPU).  The
ERIs agree to 1e-5 x max|eri| (f32 arithmetic in both).  The f64 tiers are
held in ``tests/test_torch_df.py``.
"""

import numpy as np
import pytest
import torch

import quemb_tpu_torch as qt
from quemb_tpu.chem.mole import Mole as JMole
from quemb_tpu.chem.scf import RHF as JRHF
from quemb_tpu.ops import df as jdf
from quemb_tpu.ops import screening as jscreen
from quemb_tpu.ops.sparse_df import SparseDF as JSparseDF
from quemb_tpu_torch.chem.mole import Mole
from quemb_tpu_torch.chem.scf import RHF
from quemb_tpu_torch.ops import df as tdf
from quemb_tpu_torch.ops import screening as tscreen
from quemb_tpu_torch.ops.sparse_df import SparseDF

torch.set_num_threads(1)

ATOM = "; ".join(f"H 0 0 {i * 1.0}" for i in range(8))
N_FRAG = 6


@pytest.fixture(scope="module")
def h8():
    jmol = JMole(atom=ATOM, basis="sto-3g")
    jmf = JRHF(jmol, conv_tol=1e-12)
    jmf.kernel()
    mol = Mole(atom=ATOM, basis="sto-3g")
    mf = RHF.from_arrays(mol, jmf.get_hcore(), jmf.get_ovlp(),
                         jmf.get_eri(), jmf.mo_coeff, jmf.mo_energy,
                         jmf.e_tot)
    fobj = qt.fragmentate(mol, n_BE=2, print_frags=False)
    be = qt.BE(mf, fobj, device="cpu")
    B = jdf.cholesky_df_factor(jmol, tol=1e-10, eri=jmf.get_eri())
    return jmol, mol, mf, B, [fr.TA for fr in be.fragments]


def test_factor_and_screen_are_copies(h8):
    jmol, mol, mf, B, TAs = h8
    assert np.array_equal(
        tdf.cholesky_df_factor(mol, tol=1e-10, eri=mf.get_eri()), B
    )
    S_abs = tscreen.approx_S_abs(mol)
    assert np.array_equal(S_abs, jscreen.approx_S_abs(jmol))
    sdf = SparseDF.from_factor(mol, B, device=torch.device("cpu"))
    for TA in TAs:
        _, union = sdf.screen(TA)
        assert np.array_equal(
            union, jscreen.ao_reach_per_fragment(S_abs, TA, eps=1e-5)
        )


@pytest.mark.parametrize("ifrag", range(N_FRAG))
def test_f32_fragment_eri_matches_jax(h8, ifrag):
    jmol, mol, mf, B, TAs = h8
    assert len(TAs) == N_FRAG
    TA = TAs[ifrag]
    ref = JSparseDF.from_factor(
        jmol, B, tier="f32-pallas"
    ).fragment_eri_f32(TA, interpret=True)
    sdf = SparseDF.from_factor(mol, B, device=torch.device("cpu"))
    eri = sdf.fragment_eri_f32(TA)
    assert eri.dtype == torch.float64
    eri = eri.numpy()
    assert eri.shape == ref.shape
    assert np.abs(eri - ref).max() <= 1e-5 * np.abs(ref).max()
    # the (ij) symmetrisation keeps the ERI's permutational symmetry
    assert np.abs(eri - eri.transpose(1, 0, 2, 3)).max() == 0.0
    assert np.abs(eri - eri.transpose(2, 3, 0, 1)).max() <= 1e-6 * np.abs(
        eri
    ).max()


@pytest.mark.parametrize("what", ["f64-tier", "auxbasis", "constructor"])
def test_unported_sparse_df_paths_raise(h8, monkeypatch, what):
    """The sparse-DF paths that used to raise are ported; each case runs
    its path and checks beside it what once raised or still raises: an ECP
    (ported since: its core Hamiltonian is the plain one plus the ECP
    matrix), an unknown auxiliary-basis spec, an unknown tier."""
    jmol, mol, mf, B, TAs = h8
    monkeypatch.delenv("QUEMB_TPU_CCSD_F32_ONLY", raising=False)
    if what == "f64-tier":
        be = qt.BE(mf, qt.fragmentate(mol, n_BE=2, print_frags=False),
                   int_transform="sparse-DF", auxbasis="cholesky",
                   device="cpu")
        assert abs(be.ebe_hf - mf.e_tot) < 1e-6
        from quemb_tpu_torch.chem.ecp import ecp_matrix
        from quemb_tpu_torch.chem.integrals import core_hamiltonian

        emol = Mole(atom=ATOM, basis="sto-3g",
                    ecp={"H": {"ncore": 0, "local": [(2, 1.1, 1.0)]}})
        assert emol.nelectron == mol.nelectron
        assert np.abs(core_hamiltonian(emol) - core_hamiltonian(mol)
                      - ecp_matrix(emol)).max() < 1e-12
    elif what == "auxbasis":
        kind, aux = tdf.resolve_auxbasis(mol, "etb:2.0")
        assert kind == "mol" and aux.nao > mol.nao
        with pytest.raises(ValueError):
            tdf.resolve_auxbasis(mol, "no-such-set")
    else:
        sdf = SparseDF(mol, device="cpu")
        assert sdf.tier == "f64" and sdf.naux == sdf.dft.B.shape[0]
        with pytest.raises(ValueError):
            SparseDF(mol, tier="f16", device="cpu")
