"""Relaxed CCSD densities: the port's adjoint (Lambda) response against
the JAX package's, and density matching with ``relax_density=True``.

- ``ccsd_relaxed_rdms`` on the seeded system of ``test_relaxed_rdm.py``:
  E_elec at 1e-10 and both RDMs at 1e-8 from the JAX function; on the
  port alone, the trace identity E_elec = tr(h g1) + 0.5 eri : g2 at
  1e-10, tr(g1) = 2 nsocc at 1e-9, and a central finite difference of
  E_elec along a one-body perturbation at 1e-7;
- the plan never solves a relaxed fragment alone;
- H8 BE2 ``optimize(solver="CCSD", relax_density=True)`` against the JAX
  package's: ``ebe_tot`` at 1e-6, and within 1e-2 Ha of the unrelaxed
  matched energy, as the JAX package's own test holds it.

The ``gpu`` test runs the relaxed densities on the card against the CPU.
"""

import numpy as np
import pytest
import torch

from quemb_tpu_torch.solvers import dispatch
from quemb_tpu_torch.solvers.ccsd_relaxed import ccsd_relaxed_rdms

torch.set_num_threads(1)

H8 = "; ".join(f"H 0 0 {i * 1.0}" for i in range(8))
on_card = pytest.mark.skipif(not torch.cuda.is_available(),
                             reason="needs a CUDA card")


@pytest.fixture(autouse=True)
def _plain_f64_modes(monkeypatch):
    """Pin the JAX package's backend-dependent CCSD mode (mixed precision
    off), and start from the defaults on both sides."""
    monkeypatch.setenv("QUEMB_TPU_CCSD_MIXED", "0")
    for var in ("QUEMB_TPU_CCSD_F32_ONLY", "QUEMB_TPU_INCORE_CD",
                "QUEMB_TPU_CCSD_CONV_TOL", "QUEMB_TPU_CCSD_SPINORB"):
        monkeypatch.delenv(var, raising=False)


def _random_system(nmo=8, nsocc=3, seed=5):
    """The seeded system of ``tests/test_relaxed_rdm.py``."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((nmo * nmo, nmo * nmo)) * 0.06
    eri = (A @ A.T).reshape(nmo, nmo, nmo, nmo)
    eri = 0.5 * (eri + eri.transpose(1, 0, 2, 3))
    eri = 0.5 * (eri + eri.transpose(0, 1, 3, 2))
    eri = 0.5 * (eri + eri.transpose(2, 3, 0, 1))
    h = rng.standard_normal((nmo, nmo)) * 0.1
    h = 0.5 * (h + h.T) + np.diag(np.arange(nmo) * 1.5 - 4)
    return h, eri, nsocc


def _rdms(h, eri, nsocc, device="cpu"):
    r1, r2, e = ccsd_relaxed_rdms(torch.as_tensor(h, device=device),
                                  torch.as_tensor(eri, device=device), nsocc)
    return r1.cpu().numpy(), r2.cpu().numpy(), e


def test_relaxed_rdms_match_jax():
    from quemb_tpu.solvers.ccsd_relaxed import ccsd_relaxed_rdms as jrdms

    h, eri, nsocc = _random_system()
    jr1, jr2, je = jrdms(h, eri, nsocc)
    r1, r2, e = _rdms(h, eri, nsocc)
    assert abs(e - je) < 1e-10
    assert np.abs(r1 - jr1).max() < 1e-8
    assert np.abs(r2 - jr2).max() < 1e-8


def test_trace_identity_and_finite_difference():
    h, eri, nsocc = _random_system()
    r1, r2, e = _rdms(h, eri, nsocc)
    e_trace = np.einsum("pq,qp->", h, r1) + 0.5 * np.einsum(
        "pqrs,pqrs->", eri, r2)
    assert abs(e_trace - e) < 1e-10
    assert abs(np.trace(r1) - 2 * nsocc) < 1e-9
    eps = 1e-6
    dh = np.zeros_like(h)
    dh[1, 4] = dh[4, 1] = 1.0
    ep = _rdms(h + eps * dh, eri, nsocc)[2]
    em = _rdms(h - eps * dh, eri, nsocc)[2]
    assert abs((ep - em) / (2 * eps) - (r1[1, 4] + r1[4, 1])) < 1e-7


def test_relaxed_bucket_is_never_large():
    cuda = torch.device("cuda")
    for solver in ("CCSD", "MP2"):
        assert dispatch._solved_alone(60, cuda, solver)
        assert not dispatch._solved_alone(60, cuda, solver,
                                          relax_density=True)
    assert not dispatch._solved_alone(60, torch.device("cpu"), "CCSD")


def test_h8_relaxed_matching_matches_jax():
    import quemb_tpu as jq
    import quemb_tpu_torch as qt
    from quemb_tpu.chem.mole import Mole as JMole
    from quemb_tpu.chem.scf import RHF as JRHF
    from quemb_tpu_torch.chem.mole import Mole
    from quemb_tpu_torch.chem.scf import RHF

    jmol = JMole(atom=H8, basis="sto-3g")
    jmf = JRHF(jmol, conv_tol=1e-12)
    jmf.kernel()
    mol = Mole(atom=H8, basis="sto-3g")
    mf = RHF.from_arrays(mol, jmf.get_hcore(), jmf.get_ovlp(),
                         jmf.get_eri(), jmf.mo_coeff, jmf.mo_energy,
                         jmf.e_tot)
    kw = dict(n_BE=2, frag_type="chemgen", print_frags=False)
    jbe = jq.BE(jmf, jq.fragmentate(jmol, **kw))
    jbe.optimize(solver="CCSD", relax_density=True)
    fobj = qt.fragmentate(mol, **kw)
    be = qt.BE(mf, fobj, device="cpu")
    be.optimize(solver="CCSD", relax_density=True)
    assert abs(be.ebe_tot - jbe.ebe_tot) < 1e-6
    unrelaxed = qt.BE(mf, fobj, device="cpu")
    unrelaxed.optimize(solver="CCSD")
    assert abs(be.ebe_tot - unrelaxed.ebe_tot) < 1e-2
    for fr in be.fragments:  # the relaxed RDMs the last evaluation kept
        assert fr.rdm1__.device.type == "cpu"
        assert abs(float(torch.trace(fr.rdm1__)) - 2 * fr.nsocc) < 1e-8


@pytest.mark.gpu
@on_card
@pytest.mark.parametrize("nmo,nsocc", [(8, 3), (10, 4)])
def test_relaxed_rdms_on_card_match_cpu(nmo, nsocc):
    """The same seeded system through the adjoint on the card and on the
    CPU: energy 1e-10, RDMs 1e-8, trace identity 1e-10 on the card.  (Past
    nmo 10 the seeded systems' adjoint iteration diverges on either
    device.)"""
    h, eri, ns = _random_system(nmo, nsocc)
    r1, r2, e = _rdms(h, eri, ns, "cuda")
    c1, c2, ce = _rdms(h, eri, ns, "cpu")
    assert abs(e - ce) < 1e-10
    assert np.abs(r1 - c1).max() < 1e-8
    assert np.abs(r2 - c2).max() < 1e-8
    e_trace = np.einsum("pq,qp->", h, r1) + 0.5 * np.einsum(
        "pqrs,pqrs->", eri, r2)
    assert abs(e_trace - e) < 1e-10

