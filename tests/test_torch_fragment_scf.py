"""Batched fragment SCF: the port against the JAX package, and merged-bucket
padding against no padding.

Inputs are the H8 BE2 fragments (mean field from the JAX package) with a
seeded symmetric perturbation on the Fock matrix, so that every SCF
iterates.  Orbital energies, densities and SCF energies agree at 1e-10.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import quemb_tpu_torch as qt
from quemb_tpu.chem.mole import Mole as JMole
from quemb_tpu.chem.scf import RHF as JRHF
from quemb_tpu.embed.fragment_scf import rhf_orthonormal as jax_rhf
from quemb_tpu_torch.chem.mole import Mole
from quemb_tpu_torch.chem.scf import RHF
from quemb_tpu_torch.embed.fragment_scf import _fock, rhf_orthonormal
from quemb_tpu_torch.solvers.dispatch import _PAD_SHIFT, _pad_frag_op

torch.set_num_threads(1)

TOL = 1e-10
N_FRAG = 6


@pytest.fixture(scope="module")
def bucket():
    atom = "\n".join(f"H 0 0 {i}." for i in range(8))
    jmol = JMole(atom=atom, basis="sto-3g")
    jmf = JRHF(jmol, conv_tol=1e-12)
    jmf.kernel()
    mol = Mole(atom=atom, basis="sto-3g")
    mf = RHF.from_arrays(mol, jmf.get_hcore(), jmf.get_ovlp(),
                         jmf.get_eri(), jmf.mo_coeff, jmf.mo_energy,
                         jmf.e_tot)
    fobj = qt.fragmentate(
        mol, n_BE=2, print_frags=False,
        additional_args=qt.ChemGenArgs(
            h_treatment="treat_H_like_heavy_atom"
        ),
    )
    be = qt.BE(mf, fobj, device="cpu")
    frs = be.fragments
    rng = np.random.default_rng(0)
    h = []
    for fr in frs:
        X = rng.standard_normal(fr.fock.shape) * 2e-2
        h.append(fr.fock + X + X.T)
    h = np.stack(h)
    eri = torch.stack([fr.eri for fr in frs]).numpy()
    dm0 = np.stack([fr.dm0 for fr in frs])
    nocc = frs[0].nsocc
    return h, eri, dm0, nocc


def _run(h, eri, dm0, nocc):
    e, C, e_el, it = rhf_orthonormal(
        torch.as_tensor(h), torch.as_tensor(eri), nocc, torch.as_tensor(dm0)
    )
    return e.numpy(), C.numpy(), e_el.numpy(), it.numpy()


@pytest.fixture(scope="module")
def batched(bucket):
    return _run(*bucket)


def _dm(C, nocc):
    return 2.0 * C[..., :nocc] @ np.swapaxes(C[..., :nocc], -1, -2)


@pytest.mark.parametrize("k", range(N_FRAG))
def test_batched_scf_matches_jax(bucket, batched, k):
    h, eri, dm0, nocc = bucket
    assert h.shape[0] == N_FRAG
    e, C, e_el, it = batched
    je, jC, je_el, jit = (
        np.asarray(x)
        for x in jax_rhf(jnp.asarray(h[k]), jnp.asarray(eri[k]), nocc,
                         jnp.asarray(dm0[k]))
    )
    assert it[k] > 3  # the perturbation makes every lane iterate
    assert np.abs(e[k] - je).max() < TOL
    assert abs(e_el[k] - je_el) < TOL
    assert np.abs(_dm(C[k], nocc) - _dm(jC, nocc)).max() < TOL


def test_converged_lanes_stay_frozen(bucket, batched):
    """Each lane of the batch stops where it would stop alone."""
    h, eri, dm0, nocc = bucket
    e, C, e_el, it = batched
    for k in (0, 2):
        ek, Ck, e_elk, itk = _run(h[k : k + 1], eri[k : k + 1],
                                  dm0[k : k + 1], nocc)
        assert itk[0] == it[k]
        assert abs(e_elk[0] - e_el[k]) < 1e-13
        assert np.abs(ek[0] - e[k]).max() < 1e-13


@pytest.mark.parametrize("pads", [(1, 0), (0, 2), (2, 1)])
def test_padded_equals_unpadded(bucket, batched, pads):
    h, eri, dm0, nocc = bucket
    e, C, e_el, it = batched
    po, pv = pads
    n = h.shape[-1]
    hp = np.stack([
        _pad_frag_op(x, po, pv, diag_occ=-_PAD_SHIFT, diag_vir=_PAD_SHIFT)
        for x in h
    ])
    erip = np.stack([_pad_frag_op(x, po, pv) for x in eri])
    dm0p = np.stack([_pad_frag_op(x, po, pv, diag_occ=2.0) for x in dm0])
    ep, Cp, _, _ = _run(hp, erip, dm0p, nocc + po)
    # occupied pads sort first, virtual pads last
    assert np.abs(ep[:, po : po + n] - e).max() < TOL
    dmp = _dm(Cp, nocc + po)[:, :n, :n]
    assert np.abs(dmp - _dm(C, nocc)).max() < TOL
    Fp = _fock(torch.as_tensor(h), torch.as_tensor(eri),
               torch.as_tensor(dmp)).numpy()
    e_el_p = 0.5 * ((h + Fp) * dmp).sum((-2, -1))
    assert np.abs(e_el_p - e_el).max() < TOL
