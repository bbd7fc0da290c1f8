"""The port's bucket solvers against the JAX package.

- the copies ``solvers/fci.py`` and ``matching/optqn.py`` against their
  originals on seeded inputs: 1e-12;
- ``solvers/mp2.py`` (torch, batched) against the host-numpy original on a
  seeded MO Hamiltonian, one fragment and a stack of two: 1e-12;
- ``_rdm12_urlx_batched(with_dm1=True)`` and ``_batched_energy_rows_nc``
  against the originals on seeded amplitudes: 1e-12;
- one H8 BE2 objective evaluation (``be_func`` at a seeded potential) with
  FCI, MP2, non-cumulant CCSD and non-cumulant FCI against the JAX
  package's: 1e-9 on the error vector and the energies;
- the plan of buckets per solver, and the paths that stay unported raise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import quemb_tpu as jq
import quemb_tpu_torch as qt
from quemb_tpu.chem.mole import Mole as JMole
from quemb_tpu.chem.scf import RHF as JRHF
from quemb_tpu.matching import optqn as jax_optqn
from quemb_tpu.solvers import dispatch as jax_dispatch
from quemb_tpu.solvers import fci as jax_fci
from quemb_tpu.solvers import mp2 as jax_mp2
from quemb_tpu_torch.chem.mole import Mole
from quemb_tpu_torch.chem.scf import RHF
from quemb_tpu_torch.matching import optqn
from quemb_tpu_torch.solvers import dispatch, fci, mp2

torch.set_num_threads(1)
try:
    # numpy's BLAS threads as well: the FCI solves of both packages run in
    # numpy, and several test workers share the cores; a BLAS pool per
    # worker oversubscribes them many times over.  Like torch's, the limit
    # holds for the process from the moment this file is imported.
    from threadpoolctl import threadpool_limits
except ImportError:
    pass
else:
    threadpool_limits(limits=1, user_api="blas")

H8 = "\n".join(f"H 0 0 {i}." for i in range(8))


@pytest.fixture(autouse=True)
def _plain_f64_modes(monkeypatch):
    """Pin the JAX package's backend-dependent CCSD mode (mixed precision
    off), and start from the defaults on both sides."""
    monkeypatch.setenv("QUEMB_TPU_CCSD_MIXED", "0")
    for var in ("QUEMB_TPU_CCSD_F32_ONLY", "QUEMB_TPU_INCORE_CD",
                "QUEMB_TPU_CCSD_CONV_TOL", "QUEMB_TPU_CCSD_SPINORB"):
        monkeypatch.delenv(var, raising=False)


def _seeded_hamiltonian(nmo, seed):
    """A symmetric one-body matrix with a gapped diagonal and a positive
    ERI with the 8-fold symmetry, from a seed."""
    rng = np.random.default_rng(seed)
    h1 = np.diag(np.arange(nmo, dtype=float))
    h1 += 0.05 * rng.standard_normal((nmo, nmo))
    h1 = 0.5 * (h1 + h1.T)
    A = 0.1 * rng.standard_normal((nmo * nmo, nmo * nmo))
    eri = (A @ A.T).reshape(nmo, nmo, nmo, nmo)
    eri = 0.5 * (eri + eri.transpose(1, 0, 2, 3))
    eri = 0.5 * (eri + eri.transpose(0, 1, 3, 2))
    eri = 0.5 * (eri + eri.transpose(2, 3, 0, 1))
    return h1, eri


# ------------------------------------------------------------ the copies
def test_fci_copy_matches_original():
    """solve_fci and remove_mf_part, 6 orbitals and 3 pairs: 1e-12."""
    h1, eri = _seeded_hamiltonian(6, seed=1)
    e0, d1_0, d2_0 = jax_fci.solve_fci(h1, eri, 3)
    e1, d1_1, d2_1 = fci.solve_fci(h1, eri, 3)
    assert abs(e1 - e0) < 1e-12
    assert np.abs(d1_1 - d1_0).max() < 1e-12
    assert np.abs(d2_1 - d2_0).max() < 1e-12
    assert abs(np.trace(d1_1) - 6.0) < 1e-10
    c0 = jax_fci.remove_mf_part(d1_0, d2_0, 3)
    c1 = fci.remove_mf_part(d1_1, d2_1, 3)
    assert np.abs(c1 - c0).max() < 1e-12
    assert np.abs(c1 - d2_1).max() > 1.0  # the mean-field part is gone


def _residual(x):
    """A smooth map R^4 -> R^4 with a root near the origin."""
    M = np.array([[2.0, 0.3, 0.0, 0.1], [0.2, 1.5, 0.4, 0.0],
                  [0.0, 0.1, 1.8, 0.3], [0.3, 0.0, 0.2, 2.2]])
    return M @ x + 0.3 * np.sin(x) ** 2 - np.array([0.5, -0.2, 0.3, 0.1])


@pytest.mark.parametrize("trust_region", [False, True])
def test_optqn_copy_matches_original(trust_region):
    """The same iterates from FrankQN on a seeded map, with a poor J0 so
    that the line search backtracks: 1e-12."""
    x0 = np.zeros(4)
    J0 = 0.2 * np.eye(4)
    a = jax_optqn.FrankQN(_residual, x0, _residual(x0), J0)
    b = optqn.FrankQN(_residual, x0, _residual(x0), J0)
    for it in range(20):
        a.next_step(it, trust_region_opt=trust_region)
        b.next_step(it, trust_region_opt=trust_region)
        assert np.abs(a.x - b.x).max() < 1e-12
        assert np.abs(a.f - b.f).max() < 1e-12
    assert np.linalg.norm(b.f) < 1e-6  # it found the root


def test_optqn_line_search_and_dogleg_match_original():
    x = np.array([0.4, -0.3, 0.2, 0.1])
    fx = _residual(x)
    step = -5.0 * fx  # too long: backtracks
    ref = jax_optqn.lf_line_search(_residual, x, fx, step, 0)
    out = optqn.lf_line_search(_residual, x, fx, step, 0)
    assert ref[3] == out[3] > 1
    assert ref[0] == out[0]
    assert np.abs(ref[1] - out[1]).max() < 1e-12
    J = np.eye(4) * 2.0 + 0.1
    Jinv = np.linalg.inv(J)
    for radius in (1e-3, 0.05, 10.0):  # Cauchy, dogleg leg, Gauss-Newton
        d0 = jax_optqn.dogleg_step(J, Jinv, fx, radius)
        d1 = optqn.dogleg_step(J, Jinv, fx, radius)
        assert np.abs(d1 - d0).max() < 1e-12
        assert np.linalg.norm(d1) <= radius * (1 + 1e-12)


# ------------------------------------------------------------------- MP2
@pytest.mark.parametrize("nmo,no", [(7, 3), (6, 4)])
def test_mp2_matches_original(nmo, no):
    """Amplitudes, energy and both RDMs, alone and as a stack of two:
    1e-12."""
    hams = [_seeded_hamiltonian(nmo, seed=s) for s in (2, 3)]
    moes = [np.sort(np.diag(h)) for h, _ in hams]
    eri_b = torch.as_tensor(np.stack([e for _, e in hams]))
    moe_b = torch.as_tensor(np.stack(moes))
    t2_b, e_b = mp2.mp2_amplitudes(eri_b, moe_b, no)
    rdm1_b = mp2.make_rdm1_mp2(t2_b, nmo)
    rdm2_b = mp2.make_rdm2_mp2(t2_b, nmo)
    for k, ((_, eri), moe) in enumerate(zip(hams, moes)):
        t2, e = jax_mp2.mp2_amplitudes(eri, jnp.asarray(moe), no)
        assert np.abs(t2_b[k].numpy() - t2).max() < 1e-12
        assert abs(float(e_b[k]) - e) < 1e-12
        assert e < -1e-4
        ref1 = jax_mp2.make_rdm1_mp2(t2, nmo)
        ref2 = jax_mp2.make_rdm2_mp2(t2, nmo)
        assert np.abs(rdm1_b[k].numpy() - ref1).max() < 1e-12
        assert np.abs(rdm2_b[k].numpy() - ref2).max() < 1e-12
        # the unbatched call gives the same
        t2_1, _ = mp2.mp2_amplitudes(eri_b[k], moe_b[k], no)
        assert np.abs(
            mp2.make_rdm2_mp2(t2_1, nmo).numpy() - ref2
        ).max() < 1e-12


def test_solve_mp2_matches_original():
    from types import SimpleNamespace

    nmo, no = 6, 3
    h1, eri = _seeded_hamiltonian(nmo, seed=4)
    moe, C = np.linalg.eigh(h1)
    ref1, ref2 = jax_mp2.solve_mp2(
        SimpleNamespace(eri=eri, nsocc=no), C, moe
    )
    fr = SimpleNamespace(eri=torch.as_tensor(eri), nsocc=no)
    out1, out2 = mp2.solve_mp2(fr, C, moe)
    assert np.abs(out1.numpy() - ref1).max() < 1e-12
    assert np.abs(out2.numpy() - ref2).max() < 1e-12
    assert mp2.solve_mp2(fr, C, moe, with_dm2=False)[1] is None


# --------------------------------------- non-cumulant RDMs and energy rows
def _seeded_amplitudes(nf, no, nv, seed):
    rng = np.random.default_rng(seed)
    t1 = 0.1 * rng.standard_normal((nf, no, nv))
    t2 = 0.1 * rng.standard_normal((nf, no, no, nv, nv))
    return t1, t2 + t2.transpose(0, 2, 1, 4, 3)


@pytest.mark.parametrize("with_dm1", [False, True])
def test_urlx_rdms_match_original(with_dm1):
    t1, t2 = _seeded_amplitudes(2, 3, 4, seed=5)
    ref1, ref2 = jax_dispatch._rdm12_urlx_batched(
        jnp.asarray(t1), jnp.asarray(t2), with_dm1=with_dm1
    )
    out1, out2 = dispatch._rdm12_urlx_batched(
        torch.as_tensor(t1), torch.as_tensor(t2), with_dm1=with_dm1
    )
    assert np.abs(out1.numpy() - np.asarray(ref1)).max() < 1e-12
    assert np.abs(out2.numpy() - np.asarray(ref2)).max() < 1e-12


def test_energy_rows_nc_match_original():
    nf, n = 2, 7
    rng = np.random.default_rng(6)
    t1, t2 = _seeded_amplitudes(nf, 3, 4, seed=7)
    rdm1, rdm2 = (np.array(a) for a in jax_dispatch._rdm12_urlx_batched(
        jnp.asarray(t1), jnp.asarray(t2), with_dm1=True
    ))
    mo = np.stack([np.linalg.qr(rng.standard_normal((n, n)))[0]
                   for _ in range(nf)])
    h1 = rng.standard_normal((nf, n, n))
    veff = rng.standard_normal((nf, n, n))
    eri = np.stack([_seeded_hamiltonian(n, seed=8 + k)[1] for k in range(nf)])
    w = np.zeros((nf, n))
    w[:, 1:3] = 0.5
    args = (mo, h1, veff, eri, rdm1, rdm2, w)
    ref = jax_dispatch._batched_energy_rows_nc(
        *(jnp.asarray(a) for a in args)
    )
    out = dispatch._batched_energy_rows_nc(
        *(torch.as_tensor(a) for a in args)
    )
    for a, b in zip(out, ref):
        assert np.abs(a.numpy() - np.asarray(b)).max() < 1e-12


# ----------------------------------------- one objective evaluation on H8
@pytest.fixture(scope="module")
def h8_pair():
    jmol = JMole(atom=H8, basis="sto-3g")
    jmf = JRHF(jmol, conv_tol=1e-12)
    jmf.kernel()
    mol = Mole(atom=H8, basis="sto-3g")
    mf = RHF.from_arrays(mol, jmf.get_hcore(), jmf.get_ovlp(),
                         jmf.get_eri(), jmf.mo_coeff, jmf.mo_energy,
                         jmf.e_tot)
    kw = dict(n_BE=2, frag_type="chemgen", print_frags=False)
    jf = jq.fragmentate(jmol, additional_args=jq.ChemGenArgs(
        h_treatment="treat_H_like_heavy_atom"), **kw)
    tf = qt.fragmentate(mol, additional_args=qt.ChemGenArgs(
        h_treatment="treat_H_like_heavy_atom"), **kw)
    return jq.BE(jmf, jf), qt.BE(mf, tf, device="cpu")


@pytest.mark.parametrize("solver,use_cumulant", [
    ("FCI", True), ("FCI", False), ("MP2", True), ("MP2", False),
    ("CCSD", False),
])
def test_objective_matches_jax(h8_pair, solver, use_cumulant):
    """Error vector, error norm, energy and its three parts: 1e-9."""
    jbe, be = h8_pair
    pot = np.random.default_rng(0).standard_normal(len(be.pot)) * 1e-3
    kw = dict(eeval=True, return_vec=True, use_cumulant=use_cumulant)
    ref = jax_dispatch.be_func(pot, jbe.fragments, jbe.Nocc, solver, **kw)
    out = dispatch.be_func(pot, be.fragments, be.Nocc, solver, **kw)
    assert abs(out[0] - ref[0]) < 1e-9
    assert np.abs(out[1] - ref[1]).max() < 1e-9
    assert abs(out[2][0] - ref[2][0]) < 1e-9
    assert np.abs(np.array(out[2][1]) - np.array(ref[2][1])).max() < 1e-9
    assert np.abs(out[1]).max() > 1e-6  # the potential moved the RDMs
    for fr in be.fragments:
        assert fr.rdm2__.device.type == "cpu"
    err_only = dispatch.be_func(pot, be.fragments, be.Nocc, solver,
                                return_vec=True, use_cumulant=use_cumulant)
    assert np.abs(err_only[1] - out[1]).max() < 1e-12


@pytest.mark.parametrize("use_cumulant", [True, False])
def test_oneshot_matches_jax(h8_pair, use_cumulant):
    """oneshot(solver, use_cumulant): the total energy at 1e-9."""
    jbe, be = h8_pair
    for obj in (jbe, be):
        for fr in obj.fragments:
            fr.heff = np.zeros_like(fr.h1)
        obj.oneshot("FCI", use_cumulant=use_cumulant)
    assert abs(be.ebe_tot - jbe.ebe_tot) < 1e-9
    assert be.ebe_tot < be.ebe_hf - 0.1


def test_solve_one_fragment_matches_bucket(h8_pair):
    _, be = h8_pair
    frs = be.fragments
    pot = np.random.default_rng(1).standard_normal(len(be.pot)) * 1e-3
    dispatch.be_func(pot, frs, be.Nocc, "FCI", eeval=True)
    rdm = frs[1]._rdm1.copy()
    ebe = frs[1].ebe
    frs[1]._rdm1 = None
    (e1, e2, ec) = dispatch.solve_one_fragment(frs[1], "FCI", eeval=True)
    assert np.abs(frs[1]._rdm1 - rdm).max() < 1e-10
    assert abs(e1 + e2 + ec - ebe) < 1e-10
    assert dispatch.solve_one_fragment(frs[1], "FCI", eeval=False) is None


# ------------------------------------------------ the plan, and what raises
def test_merge_plan_per_solver_matches_jax():
    from types import SimpleNamespace

    shapes = [(41, 21)] * 4 + [(40, 22)] * 2
    frs = [SimpleNamespace(nao=n, nsocc=o) for n, o in shapes]

    def plan(classes):
        return [[(frs.index(fr), p) for fr, p in c] for c in classes]

    for solver, relax in (("CCSD", False), ("MP2", False), ("FCI", False),
                          ("CCSD", True)):
        out = plan(dispatch.form_merge_classes(frs, solver, relax))
        assert out == plan(
            jax_dispatch.form_merge_classes(frs, solver, relax)
        )
        merged = solver in ("CCSD", "MP2") and not relax
        assert len(out) == (1 if merged else 2)
        assert merged or all(p == (0, 0) for c in out for _, p in c)


def test_unported_paths_raise(h8_pair, monkeypatch):
    _, be = h8_pair
    frs = be.fragments
    for solver in ("SCI", "DMRG", "SHCI", "HCI"):
        with pytest.raises(NotImplementedError, match="A9"):
            dispatch.be_func(None, frs, be.Nocc, solver)
    with pytest.raises(NotImplementedError, match="A9"):
        dispatch.be_func(None, frs, be.Nocc, "CCSD", relax_density=True)
    with pytest.raises(NotImplementedError, match="not implemented"):
        dispatch.be_func(None, frs, be.Nocc, "CISD")
    with pytest.raises(ValueError, match="CCSD/MP2 only"):
        dispatch._solve_bucket_batched(frs[:1], "FCI", False, True, False,
                                       pads=((1, 0),))
    monkeypatch.setenv("QUEMB_TPU_CCSD_SPINORB", "1")
    with pytest.raises(NotImplementedError, match="A9"):
        dispatch.be_func(None, frs, be.Nocc, "CCSD")
