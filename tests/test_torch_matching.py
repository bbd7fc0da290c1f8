"""Density matching: the port against the JAX package, on the CPU.

The H8 chain mean field is built once by the JAX package and handed over
as arrays; every port object runs with ``device="cpu"``.  Only gauge-free
quantities are compared (density responses, Jacobians, error vectors,
energies), never orbitals or CPHF solutions.

- ``cphf_kernel_batch`` -> dP on a seeded fragment: 1e-9;
- ``_dPmp2_batch`` and ``_dPccsd_urlx_batch`` on the same fragment: 1e-9;
- ``get_be_error_jacobian`` on H8 BE2 (HF, MP2, CCSD) and BE3 with
  ``swallow_replace`` (HF): 1e-8;
- ``compute_numerical_jacobian`` (FCI) against the JAX package's: 1e-7,
  and the matched energy from it against the one from the analytic HF
  Jacobian: 1e-5;
- ``optimize`` on H8 with FCI and CCSD, density matching and chemical
  potential, line search and trust region: matched energies at 1e-8 from
  the JAX package's, and at the reference values of record;
- the two ``ValueError`` of ``optimize``.

The JAX package is imported inside the fixtures, so that the ``gpu`` tests
(every bucket solver and every response on the card against the CPU on
seeded fragments, and octane BE2-CCSD to its matched energy) also run
where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_matching.py
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import quemb_tpu_torch as qt
from quemb_tpu_torch.chem.mole import Mole
from quemb_tpu_torch.chem.scf import RHF, load_fixture
from quemb_tpu_torch.matching import cphf
from quemb_tpu_torch.matching.numerical_jac import compute_numerical_jacobian

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
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OCTANE_FIXTURE = os.path.join(ROOT, "fixtures", "octane_sto3g_hf.npz")
OCTANE_XYZ = os.path.join(ROOT, "tests", "data", "xyz", "octane.xyz")


@pytest.fixture(autouse=True)
def _plain_f64_modes(monkeypatch):
    """Pin the JAX package's backend-dependent CCSD mode (mixed precision
    off), and start from the defaults on both sides."""
    monkeypatch.setenv("QUEMB_TPU_CCSD_MIXED", "0")
    for var in ("QUEMB_TPU_CCSD_F32_ONLY", "QUEMB_TPU_INCORE_CD",
                "QUEMB_TPU_CCSD_CONV_TOL", "QUEMB_TPU_CCSD_SPINORB"):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's modules and its H8 mean field."""
    import quemb_tpu as jq
    from quemb_tpu.chem.mole import Mole as JMole
    from quemb_tpu.chem.scf import RHF as JRHF
    from quemb_tpu.matching import cphf as jcphf
    from quemb_tpu.matching.numerical_jac import \
        compute_numerical_jacobian as jnumjac

    jmol = JMole(atom=H8, basis="sto-3g")
    jmf = JRHF(jmol, conv_tol=1e-12)
    jmf.kernel()
    return SimpleNamespace(jq=jq, cphf=jcphf, numjac=jnumjac, mol=jmol,
                           mf=jmf)


@pytest.fixture(scope="module")
def h8(jax_side):
    jmf = jax_side.mf
    mol = Mole(atom=H8, basis="sto-3g")
    mf = RHF.from_arrays(mol, jmf.get_hcore(), jmf.get_ovlp(),
                         jmf.get_eri(), jmf.mo_coeff, jmf.mo_energy,
                         jmf.e_tot)
    return mol, mf


def _pair(jax_side, h8, n_BE, swallow=False):
    """(JAX BE, port BE) of the H8 chain at one BE level."""
    mol, mf = h8
    jq = jax_side.jq
    kw = dict(n_BE=n_BE, frag_type="chemgen", print_frags=False)
    ckw = dict(h_treatment="treat_H_like_heavy_atom",
               swallow_replace=swallow)
    jf = jq.fragmentate(jax_side.mol, additional_args=jq.ChemGenArgs(**ckw),
                        **kw)
    tf = qt.fragmentate(mol, additional_args=qt.ChemGenArgs(**ckw), **kw)
    return jq.BE(jax_side.mf, jf), qt.BE(mf, tf, device="cpu")


# ------------------------------------------- responses on a seeded fragment
def _seeded_fragment(n=8, no=3, npot=5, seed=0):
    """Orthogonal orbitals, gapped orbital energies, an ERI with the 8-fold
    symmetry and symmetric perturbations, from a seed."""
    rng = np.random.default_rng(seed)
    C = np.linalg.qr(rng.standard_normal((n, n)))[0]
    moe = np.concatenate([-2.0 + 0.3 * np.arange(no),
                          0.5 + 0.4 * np.arange(n - no)])
    moe += 0.01 * rng.standard_normal(n)
    A = 0.15 * rng.standard_normal((n * n, n * n))
    eri = (A @ A.T).reshape(n, n, n, n)
    eri = 0.5 * (eri + eri.transpose(1, 0, 2, 3))
    eri = 0.5 * (eri + eri.transpose(0, 1, 3, 2))
    eri = 0.5 * (eri + eri.transpose(2, 3, 0, 1))
    vs = rng.standard_normal((npot, n, n))
    return C, moe, eri, no, list(vs + vs.transpose(0, 2, 1))


def test_cphf_kernel_batch_dP_matches_jax(jax_side):
    """u is gauge-dependent only through C, which is shared here; dP from
    it at 1e-9."""
    C, moe, eri, no, vs = _seeded_fragment()
    us_ref = jax_side.cphf.cphf_kernel_batch(C, moe, eri, no, vs)
    us = cphf.cphf_kernel_batch(C, moe, torch.as_tensor(eri), no, vs)
    assert us.shape == (len(vs), no * (C.shape[0] - no))
    dP = cphf.get_rhf_dP_from_u(torch.as_tensor(C), no, us).numpy()
    for k in range(len(vs)):
        ref = jax_side.cphf.get_rhf_dP_from_u(C, no, us_ref[k])
        assert np.abs(dP[k] - ref).max() < 1e-9
    assert np.abs(dP).max() > 1e-2


@pytest.mark.parametrize("name", ["_dPmp2_batch", "_dPccsd_urlx_batch"])
def test_correlated_response_matches_jax(jax_side, monkeypatch, name):
    """The MP2 and CCSD(urlx) density responses, whole and with the
    potential axis cut into chunks of two: 1e-9."""
    C, moe, eri, no, vs = _seeded_fragment(seed=1)
    ref = getattr(jax_side.cphf, name)(C, moe, eri, no, vs)
    out = getattr(cphf, name)(C, moe, torch.as_tensor(eri), no, vs).numpy()
    assert out.shape == ref.shape == (len(vs), 8, 8)
    assert np.abs(out - ref).max() < 1e-9
    assert np.abs(out).max() > 1e-2
    monkeypatch.setattr(cphf, "_POT_CHUNK", 2)
    cut = getattr(cphf, name)(C, moe, torch.as_tensor(eri), no, vs).numpy()
    assert np.abs(cut - out).max() < 1e-12


def test_rotated_eri_matches_retransformed():
    """d(pq|rs) along dC = C U from the MO tensor equals the sum of the
    four AO transforms with one slot differentiated: 1e-12."""
    C, _, eri, _, vs = _seeded_fragment(seed=2)
    U = np.stack(vs[:2])
    U = U - U.transpose(0, 2, 1) + 0.1 * np.stack(vs[2:4])
    eri_mo = np.einsum("pqrs,pi,qj,rk,sl->ijkl", eri, C, C, C, C,
                       optimize=True)
    out = cphf._rotated_eri_mo(torch.as_tensor(eri_mo),
                               torch.as_tensor(U)).numpy()
    for x in range(2):
        dC = C @ U[x]
        ref = sum(
            np.einsum("pqrs,pi,qj,rk,sl->ijkl", eri,
                      *[dC if j == k else C for j in range(4)],
                      optimize=True)
            for k in range(4)
        )
        assert np.abs(out[x] - ref).max() < 1e-12


# ------------------------------------------------------------ the Jacobian
@pytest.mark.parametrize("n_BE,swallow,jac_solver", [
    (2, False, "HF"), (2, False, "MP2"), (2, False, "CCSD"),
    (3, True, "HF"),
])
def test_error_jacobian_matches_jax(jax_side, h8, n_BE, swallow,
                                    jac_solver):
    jbe, be = _pair(jax_side, h8, n_BE, swallow)
    ref = jbe.get_be_error_jacobian(jac_solver)
    J = be.get_be_error_jacobian(jac_solver)
    assert J.shape == (len(be.pot),) * 2
    assert np.abs(J - ref).max() < 1e-8
    assert np.abs(J).max() > 0.1


def test_error_jacobian_rejects_unknown_solver(jax_side, h8):
    _, be = _pair(jax_side, h8, 2)
    with pytest.raises(NotImplementedError, match="available"):
        be.get_be_error_jacobian("FCI")


@pytest.mark.parametrize("only_chem", [True, False])
def test_numerical_jacobian_matches_jax(jax_side, h8, only_chem):
    """Central differences through FCI solves: 1e-7 (step 1e-6, so a
    1e-13 difference in an error vector shows as 5e-8)."""
    jbe, be = _pair(jax_side, h8, 2)
    ref = jax_side.numjac(jbe, "FCI", only_chem)
    J = compute_numerical_jacobian(be, "FCI", only_chem)
    n = 1 if only_chem else len(be.pot)
    assert J.shape == ref.shape == (n, n)
    assert np.abs(J - ref).max() < 1e-7
    assert np.abs(J).max() > 0.1


def test_numerical_and_analytic_jacobian_same_fixed_point(jax_side, h8):
    """FCI chemical-potential matching started from the numerical and
    from the analytic HF Jacobian: the same energy at 1e-5."""
    _, be_num = _pair(jax_side, h8, 2)
    be_num.optimize(solver="FCI", only_chem=True, jac_solver="Numerical")
    _, be_hf = _pair(jax_side, h8, 2)
    be_hf.optimize(solver="FCI", only_chem=True, jac_solver="HF")
    assert abs(be_num.ebe_tot - be_hf.ebe_tot) < 1e-5
    assert be_hf.ebe_tot - be_hf.ebe_hf < -0.1


# ----------------------------------------------------------------- optimize
OPTIMIZE_CASES = {
    # name: (n_BE, swallow, optimize keywords, E_corr of record or None,
    #        E_tot of record or None)
    "FCI-BE2-density": (2, False, dict(solver="FCI"),
                        -0.1343036698277933, None),
    "FCI-BE3-density": (3, True, dict(solver="FCI"),
                        -0.1332017928466369, None),
    "FCI-BE1-chempot": (1, False, dict(solver="FCI", only_chem=True),
                        -0.12831444938462155, None),
    "FCI-BE2-chempot": (2, False, dict(solver="FCI", only_chem=True),
                        -0.1343968038684169, None),
    "FCI-BE3-chempot": (3, False, dict(solver="FCI", only_chem=True),
                        -0.1332017928466369, None),
    "CCSD-BE2-chempot": (2, False, dict(solver="CCSD", only_chem=True),
                         None, -4.30628355),
    "CCSD-BE3-chempot": (3, False, dict(solver="CCSD", only_chem=True),
                         None, -4.30649890),
    "CCSD-BE2-density": (2, False, dict(solver="CCSD"), None, None),
    "CCSD-BE2-density-trust-region": (
        2, False, dict(solver="CCSD", trust_region=True), None, None),
    "CCSD-BE2-density-noncumulant": (
        2, False, dict(solver="CCSD", use_cumulant=False), None, None),
}


@pytest.mark.parametrize("case", sorted(OPTIMIZE_CASES))
def test_optimize_matches_jax(jax_side, h8, case):
    """Matched energies at 1e-8 from the JAX package's; the values of
    record as ``tests/test_molbe_h8.py`` holds them (``np.isclose``, and
    1e-4 for the CCSD totals)."""
    n_BE, swallow, kw, ecorr, etot = OPTIMIZE_CASES[case]
    jbe, be = _pair(jax_side, h8, n_BE, swallow)
    jbe.optimize(**kw)
    be.optimize(**kw)
    assert abs(be.ebe_hf - jbe.ebe_hf) < 1e-8
    assert abs(be.ebe_tot - jbe.ebe_tot) < 1e-8
    if ecorr is not None:
        assert np.isclose(be.ebe_tot - be.ebe_hf, ecorr)
    if etot is not None:
        assert abs(be.ebe_tot - etot) < 1e-4
    assert be.ebe_tot < be.ebe_hf - 0.1


def test_trust_region_and_line_search_same_fixed_point(jax_side, h8):
    _, be_ls = _pair(jax_side, h8, 2)
    be_ls.optimize(solver="CCSD")
    _, be_tr = _pair(jax_side, h8, 2)
    be_tr.optimize(solver="CCSD", trust_region=True)
    assert abs(be_ls.ebe_tot - be_tr.ebe_tot) < 1e-6


@pytest.mark.parametrize("n_BE,match", [
    (1, "BE1 only works with chemical potential"),
    (3, "centers that are not origins"),
])
def test_optimize_value_errors(jax_side, h8, n_BE, match):
    _, be = _pair(jax_side, h8, n_BE)
    with pytest.raises(ValueError, match=match):
        be.optimize(solver="FCI", only_chem=False)


def test_optimize_rejects_unported(jax_side, h8):
    _, be = _pair(jax_side, h8, 2)
    with pytest.raises(NotImplementedError, match="A9"):
        be.optimize(solver="CCSD", relax_density=True)
    with pytest.raises(ValueError, match="Unsupported optimization"):
        be.optimize(solver="CCSD", method="Newton")


# --------------------------------------------------------------- on a card
def _synthetic_bucket(device):
    """Two seeded 6-orbital, 3-pair fragments with every field the bucket
    solve reads, their ERIs on ``device``."""
    frs = []
    for k in range(2):
        C, moe, eri, no, vs = _seeded_fragment(n=6, no=3, seed=10 + k)
        h = (C * moe) @ C.T
        frs.append(SimpleNamespace(
            nao=6, nsocc=no, eri=torch.as_tensor(eri, device=device),
            fock=h, heff=0.01 * vs[0], h1=h, veff0=0.1 * vs[1],
            veff=0.1 * vs[2], dm0=2.0 * C[:, :no] @ C[:, :no].T,
            weight_and_relAO_per_center=(1.0, [0, 1]),
            _cache_token=("synthetic", str(device), k),
        ))
    return frs


@pytest.mark.gpu
@pytest.mark.parametrize("solver,use_cumulant", [
    ("FCI", True), ("FCI", False), ("MP2", True), ("CCSD", True),
    ("CCSD", False),
])
def test_bucket_solvers_on_card_match_cpu(solver, use_cumulant):
    """Every bucket solver on the card against the same solve on the CPU:
    energies and embedding-basis 1-RDMs at 1e-9."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from quemb_tpu_torch.solvers.dispatch import _solve_bucket_batched

    out = {}
    for device in ("cpu", "cuda"):
        frs = _synthetic_bucket(device)
        e = _solve_bucket_batched(frs, solver, True, use_cumulant, False)
        assert frs[0].rdm2__.device.type == device
        out[device] = (np.array(e), [fr._rdm1 for fr in frs])
    assert np.abs(out["cuda"][0] - out["cpu"][0]).max() < 1e-9
    assert np.abs(out["cpu"][0]).max() > 1e-3
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        assert np.abs(a - b).max() < 1e-9


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["_dPhf_batch", "_dPmp2_batch",
                                  "_dPccsd_urlx_batch"])
def test_responses_on_card_match_cpu(name):
    """The HF, MP2 and CCSD density responses on the card against the CPU:
    1e-9."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    C, moe, eri, no, vs = _seeded_fragment(seed=3)
    fn = getattr(cphf, name)
    ref = fn(torch.as_tensor(C), moe, torch.as_tensor(eri), no, vs)
    out = fn(torch.as_tensor(C, device="cuda"), moe,
             torch.as_tensor(eri, device="cuda"), no, vs)
    assert out.device.type == "cuda"
    assert np.abs(out.cpu().numpy() - ref.numpy()).max() < 1e-9


@pytest.mark.gpu
def test_octane_be2_ccsd_density_matching_on_card():
    """Octane BE2-CCSD to its matched energy (the JAX package gates the
    same run behind QUEMB_TPU_EXPENSIVE_TESTS; here the gate is the card):
    E_tot and E_corr within 1e-6 Ha of the reference values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    mf = load_fixture(OCTANE_FIXTURE, OCTANE_XYZ)
    fobj = qt.fragmentate(mf.mol, n_BE=2, frag_type="chemgen",
                          print_frags=False)
    be = qt.BE(mf, fobj)
    assert be.device.type == "cuda"
    be.optimize(solver="CCSD", only_chem=False)
    assert abs(be.ebe_tot - (-310.3347211309688)) < 1e-6
    assert abs((be.ebe_tot - be.ebe_hf) - (-0.5499514850769742)) < 1e-6
    assert be.fragments[0].rdm2__.device.type == "cuda"
