"""The BE slice end to end: the port against the JAX package.

H8 BE2 chemgen, built as ``tests/test_molbe_h8.py`` builds it, with the
JAX package's mean field carried across by ``RHF.from_arrays``:

- HF-in-HF and one-shot E_corr agree at 1e-8 on the in-core routes (the
  CPU quarter transform and the pivoted-Cholesky route) and at 1e-5 on the
  f32 sparse-DF tier;
- the ``be_func`` error vector and energy at a seeded matching potential
  agree at 1e-7 (f64);
- chemgen fragmentations and Schmidt projectors TA TA^T equal the JAX
  package's for H8 and octane;
- merged-bucket padding leaves the objective unchanged.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import quemb_tpu as jq
import quemb_tpu_torch as qt
from quemb_tpu.chem.mole import Mole as JMole
from quemb_tpu.chem.scf import RHF as JRHF
from quemb_tpu.embed.fragment import Fragment as JFragment
from quemb_tpu.lo.lowdin import lowdin_orth as jax_lowdin_orth
from quemb_tpu.solvers.dispatch import be_func as jax_be_func
from quemb_tpu_torch.chem.mole import Mole
from quemb_tpu_torch.chem.scf import RHF, load_fixture
from quemb_tpu_torch.embed.fragment import Fragment
from quemb_tpu_torch.lo.lowdin import lowdin_orth
from quemb_tpu_torch.solvers.dispatch import _solve_bucket_batched, be_func

from conftest import DATA_DIR

torch.set_num_threads(1)

H8 = "\n".join(f"H 0 0 {i}." for i in range(8))
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OCTANE_FIXTURE = os.path.join(ROOT, "fixtures", "octane_sto3g_hf.npz")
OCTANE_XYZ = os.path.join(DATA_DIR, "xyz", "octane.xyz")
FRAG_FIELDS = (
    "AO_per_frag", "AO_per_edge_per_frag", "ref_frag_idx_per_edge_per_frag",
    "relAO_per_edge_per_frag", "relAO_in_ref_per_edge_per_frag",
    "weight_and_relAO_per_center_per_frag", "relAO_per_origin_per_frag",
)


@pytest.fixture(autouse=True)
def _plain_f64_modes(monkeypatch):
    """Pin the JAX package's backend-dependent CCSD mode (mixed precision
    off), and start from the defaults on both sides."""
    monkeypatch.setenv("QUEMB_TPU_CCSD_MIXED", "0")
    for var in ("QUEMB_TPU_CCSD_F32_ONLY", "QUEMB_TPU_INCORE_CD",
                "QUEMB_TPU_CCSD_CONV_TOL"):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def h8():
    jmol = JMole(atom=H8, basis="sto-3g")
    jmf = JRHF(jmol, conv_tol=1e-12)
    jmf.kernel()
    mol = Mole(atom=H8, basis="sto-3g")
    mf = RHF.from_arrays(mol, jmf.get_hcore(), jmf.get_ovlp(),
                         jmf.get_eri(), jmf.mo_coeff, jmf.mo_energy,
                         jmf.e_tot)
    return jmol, jmf, mol, mf


def _fobjs(jmol, mol):
    kw = dict(n_BE=2, frag_type="chemgen", print_frags=False)
    jf = jq.fragmentate(
        jmol, additional_args=jq.ChemGenArgs(
            h_treatment="treat_H_like_heavy_atom"), **kw
    )
    tf = qt.fragmentate(
        mol, additional_args=qt.ChemGenArgs(
            h_treatment="treat_H_like_heavy_atom"), **kw
    )
    return jf, tf


ROUTES = {
    # name: (environment, BE keyword arguments, tolerance)
    "in-core": ({}, {}, 1e-8),
    "cholesky": ({"QUEMB_TPU_INCORE_CD": "1"}, {}, 1e-8),
    "f32-sparse-DF": (
        {"QUEMB_TPU_CCSD_F32_ONLY": "1"},
        dict(int_transform="sparse-DF", auxbasis="cholesky"), 1e-5,
    ),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_oneshot_matches_jax(h8, monkeypatch, route):
    env, kw, tol = ROUTES[route]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jmol, jmf, mol, mf = h8
    jf, tf = _fobjs(jmol, mol)
    jbe = jq.BE(jmf, jf, **kw)
    jbe.oneshot("CCSD")
    be = qt.BE(mf, tf, device="cpu", **kw)
    be.oneshot("CCSD")
    assert abs(be.ebe_hf - mf.e_tot) < 1e-9
    assert abs(be.ebe_hf - jbe.ebe_hf) < 1e-8
    assert abs((be.ebe_tot - be.ebe_hf) - (jbe.ebe_tot - jbe.ebe_hf)) < tol
    assert be.ebe_tot - be.ebe_hf < -0.1


def test_be_func_error_vector_matches_jax(h8):
    jmol, jmf, mol, mf = h8
    jf, tf = _fobjs(jmol, mol)
    jbe = jq.BE(jmf, jf)
    be = qt.BE(mf, tf, device="cpu")
    assert len(be.pot) == len(jbe.pot)
    pot = np.random.default_rng(0).standard_normal(len(be.pot)) * 1e-3
    ref = jax_be_func(pot, jbe.fragments, jbe.Nocc, "CCSD", eeval=True,
                      return_vec=True)
    out = be_func(pot, be.fragments, be.Nocc, "CCSD", eeval=True,
                  return_vec=True)
    assert np.abs(out[1] - ref[1]).max() < 1e-7
    assert abs(out[0] - ref[0]) < 1e-7
    assert abs(out[2][0] - ref[2][0]) < 1e-7
    err_only = be_func(pot, be.fragments, be.Nocc, "CCSD", return_vec=True)
    assert np.abs(err_only[1] - out[1]).max() < 1e-12
    assert np.abs(out[1]).max() > 1e-6  # the potential moved the RDMs


@pytest.mark.parametrize("pads", [(1, 1), (2, 0)])
def test_merged_bucket_padding_is_exact(h8, pads):
    jmol, jmf, mol, mf = h8
    _, tf = _fobjs(jmol, mol)
    be = qt.BE(mf, tf, device="cpu")
    frs = be.fragments
    pot = np.random.default_rng(1).standard_normal(len(be.pot)) * 1e-3
    for fr in frs:
        fr.update_heff(pot)
    e0 = _solve_bucket_batched(frs, "CCSD", True, True, False,
                               pads=((0, 0),) * len(frs))
    rdm0 = [fr._rdm1.copy() for fr in frs]
    e1 = _solve_bucket_batched(frs, "CCSD", True, True, False,
                               pads=(pads,) * len(frs))
    assert np.abs(np.array(e1) - np.array(e0)).max() < 1e-10
    for fr, r in zip(frs, rdm0):
        assert np.abs(fr._rdm1 - r).max() < 1e-10


@pytest.mark.parametrize("shapes", [
    # (nao, nsocc) per fragment: octane BE2, and one that needs two classes
    [(41, 21)] * 4 + [(40, 22)] * 2,
    [(30, 15), (46, 23), (24, 12), (29, 15), (46, 22)],
])
def test_merge_plan_matches_jax(shapes):
    from types import SimpleNamespace

    from quemb_tpu.solvers.dispatch import form_merge_classes as jax_plan
    from quemb_tpu_torch.solvers.dispatch import form_merge_classes

    cpu = SimpleNamespace(device=torch.device("cpu"))
    frs = [SimpleNamespace(nao=n, nsocc=o, eri=cpu) for n, o in shapes]

    def plan(classes):
        return [[(frs.index(fr), p) for fr, p in c] for c in classes]

    out = plan(form_merge_classes(frs))
    assert out == plan(jax_plan(frs))
    if len(set(shapes)) == 2:
        assert len(out) == 1  # octane: one bucket of (nsocc 22, nvir 20)


def _same_fragments(jf, tf):
    assert jf.n_frag == tf.n_frag
    for name in FRAG_FIELDS:
        assert getattr(jf, name) == getattr(tf, name), name


def _projectors(mod_frag, W, lmo, nocc, n_frag, fobj):
    out = []
    for i in range(n_frag):
        fr = mod_frag.from_frag_part(fobj, i)
        fr.sd(W, lmo, nocc, thr_bath=1.0e-10)
        out.append(fr.TA @ fr.TA.T)
    return out


@pytest.mark.parametrize("system", ["H8", "octane"])
def test_fragments_and_schmidt_projectors_match_jax(h8, system):
    if system == "H8":
        jmol, _, mol, mf = h8
        jf, tf = _fobjs(jmol, mol)
    else:
        mf = load_fixture(OCTANE_FIXTURE, OCTANE_XYZ)
        jmol = JMole.from_xyz_file(OCTANE_XYZ, basis="sto-3g")
        mol = mf.mol
        kw = dict(n_BE=2, frag_type="chemgen", print_frags=False)
        jf, tf = jq.fragmentate(jmol, **kw), qt.fragmentate(mol, **kw)
    S, C = mf.get_ovlp(), mf.mo_coeff
    _same_fragments(jf, tf)
    nocc = mol.nelectron // 2
    jW = np.asarray(jax_lowdin_orth(jnp.asarray(S)))
    W = lowdin_orth(torch.as_tensor(S)).numpy()
    assert np.abs(W - jW).max() < 1e-12
    ref = _projectors(JFragment, jW, jW.T @ S @ C, nocc, jf.n_frag, jf)
    # the same Lowdin orbitals give the same projectors
    same = _projectors(Fragment, jW, jW.T @ S @ C, nocc, tf.n_frag, tf)
    # each package's own orbitals: octane keeps bath orbitals whose
    # environment occupation is down to 5e-10, so the 3e-15 difference in
    # W moves their projector by up to ~3e-15 / 5e-10 = 6e-6 (1.9e-6
    # observed); H8's bath is well separated
    tol = 1e-5 if system == "octane" else 1e-10
    out = _projectors(Fragment, W, W.T @ S @ C, nocc, tf.n_frag, tf)
    for a, b, c in zip(out, same, ref):
        assert a.shape == b.shape == c.shape
        assert np.abs(b - c).max() < 1e-12
        assert np.abs(a - c).max() < tol


def test_default_device_is_cuda(h8):
    jmol, jmf, mol, mf = h8
    _, tf = _fobjs(jmol, mol)
    if torch.cuda.is_available():
        assert qt.BE(mf, tf).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            qt.BE(mf, tf)
