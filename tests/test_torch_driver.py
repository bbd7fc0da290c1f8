"""The rest of the restricted driver against the JAX package, on the CPU.

- frozen core: butane (STO-3G, 30 AOs, two BE2 fragments) one-shot CCSD:
  ``E_core``, HF-in-HF and E_corr at 1e-8; its HF matching Jacobian at
  1e-8;
- save/restart: a file written by either package restarts the other; the
  one-shot MP2 ``ebe_tot`` at 1e-9;
- full-basis RDMs: ``rdm1_fullbasis`` in every return mode after an H8 BE2
  one-shot at 1e-9, ``compute_energy_full`` in both modes at 1e-8;
- wide fragments solved alone: the plan split into one bucket a fragment
  (the predicate forced, as on a card above nemb 48) on H8 BE2, CCSD and
  MP2, cumulant and not, against the JAX package's large path (CCSD) and
  its batched MP2 at 1e-9, and against the port's merged plan; the
  predicate's table and the plans it gives on a card and on the CPU;
- SCI and DMRG: ``solve_sci`` against the original at 1e-10, H8 BE1
  chemical-potential SCI against FCI at 1e-6, the DMRG gating message and
  the adapter on a mocked block2 driver;
- the fragment SCF's DIIS solve against the JAX function at 1e-10 on
  seeded histories, error vectors scaled by 1e+-8, a non-finite lane, and
  the case met on the card (every lane's one history entry non-finite).
"""

import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import quemb_tpu as jq
from quemb_tpu.chem.mole import Mole as JMole
from quemb_tpu.chem.scf import RHF as JRHF
from quemb_tpu.embed import fragment_scf as jax_fragment_scf
from quemb_tpu.matching.cphf import get_be_error_jacobian as jax_jacobian
from quemb_tpu.solvers import dispatch as jax_dispatch
from quemb_tpu.solvers import sci as jax_sci
from quemb_tpu.utils.geometry import alkane_atoms as jax_alkane_atoms
import quemb_tpu_torch as qt
from quemb_tpu_torch.chem.mole import Mole
from quemb_tpu_torch.chem.scf import RHF
from quemb_tpu_torch.embed import fragment_scf
from quemb_tpu_torch.solvers import dispatch, dmrg, sci
from quemb_tpu_torch.solvers.fci import solve_fci
from quemb_tpu_torch.utils.geometry import alkane_atoms

torch.set_num_threads(1)
try:
    # numpy's BLAS threads as well: FCI and SCI run in numpy on both
    # sides, and several test workers share the cores
    from threadpoolctl import threadpool_limits
except ImportError:
    pass
else:
    threadpool_limits(limits=1, user_api="blas")

H8 = "; ".join(f"H 0 0 {i * 1.0}" for i in range(8))


@pytest.fixture(autouse=True)
def _plain_f64_modes(monkeypatch):
    """Pin the JAX package's backend-dependent CCSD mode (mixed precision
    off), and start from the defaults on both sides."""
    monkeypatch.setenv("QUEMB_TPU_CCSD_MIXED", "0")
    for var in ("QUEMB_TPU_CCSD_F32_ONLY", "QUEMB_TPU_INCORE_CD",
                "QUEMB_TPU_CCSD_CONV_TOL", "QUEMB_TPU_CCSD_SPINORB"):
        monkeypatch.delenv(var, raising=False)


def _mean_fields(jatoms, atoms):
    """The JAX mean field and the port's, filled from the same arrays."""
    jmol = JMole(atom=jatoms, basis="sto-3g")
    jmf = JRHF(jmol, conv_tol=1e-12)
    jmf.kernel()
    mol = Mole(atom=atoms, basis="sto-3g")
    mf = RHF.from_arrays(mol, jmf.get_hcore(), jmf.get_ovlp(),
                         jmf.get_eri(), np.array(jmf.mo_coeff),
                         jmf.mo_energy, jmf.e_tot)
    return jmol, jmf, mol, mf


def _be_pair(mfs, **fkw):
    jmol, jmf, mol, mf = mfs
    fkw = dict(n_BE=2, frag_type="chemgen", print_frags=False, **fkw)
    jf, tf = jq.fragmentate(jmol, **fkw), qt.fragmentate(mol, **fkw)
    return jq.BE(jmf, jf), qt.BE(mf, tf, device="cpu"), jf, tf


@pytest.fixture(scope="module")
def h8_mfs():
    return _mean_fields(H8, H8)


# ------------------------------------------------------------ frozen core
@pytest.fixture(scope="module")
def butane():
    mfs = _mean_fields(jax_alkane_atoms(4), alkane_atoms(4))
    return mfs, _be_pair(mfs, frozen_core=True)


def test_frozen_core_construction_matches_jax(butane):
    (_, jmf, _, mf), (jbe, be, _, _) = butane
    assert be.ncore == jbe.ncore == 4 and be.Nocc == jbe.Nocc
    assert len(be.fragments) == 2
    assert abs(be.E_core - jbe.E_core) < 1e-8
    assert abs(be.ebe_hf - jbe.ebe_hf) < 1e-8
    assert abs(mf.e_tot - be.ebe_hf) < 1e-8
    assert np.abs(be.core_veff - jbe.core_veff).max() < 1e-10
    assert np.abs(be.lmo_coeff.T @ be.lmo_coeff
                  - np.eye(be.lmo_coeff.shape[1])).max() < 1e-10


@pytest.mark.parametrize("use_cumulant", [True, False])
def test_frozen_core_oneshot_matches_jax(butane, use_cumulant):
    _, (jbe, be, _, _) = butane
    jbe.oneshot("CCSD", use_cumulant=use_cumulant)
    be.oneshot("CCSD", use_cumulant=use_cumulant)
    assert abs((be.ebe_tot - be.ebe_hf) - (jbe.ebe_tot - jbe.ebe_hf)) < 1e-8
    assert abs(be.ebe_tot - jbe.ebe_tot) < 1e-8
    assert be.ebe_tot < be.ebe_hf - 0.1


def test_frozen_core_jacobian_matches_jax(butane):
    """The HF response Jacobian needs nothing more for a frozen core: the
    core enters through the fragments' one-body Hamiltonians."""
    _, (jbe, be, _, _) = butane
    J = be.get_be_error_jacobian("HF")
    J_ref = np.asarray(jax_jacobian(jbe.fragments, "HF"))
    assert J.shape == J_ref.shape == (len(be.pot),) * 2
    assert np.abs(J - J_ref).max() < 1e-8


# ----------------------------------------------------------- save/restart
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_restart_file_crosses_packages(h8_mfs, tmp_path, writer):
    """One package writes, the other restarts from the file: the one-shot
    MP2 energies agree at 1e-9."""
    jbe, be, jf, tf = _be_pair(h8_mfs)
    path = str(tmp_path / "storebe.npz")
    if writer == "jax":
        jbe.save(path)
        restarted = qt.BE.from_restart_file(h8_mfs[3], tf, path,
                                            device="cpu")
        other = jbe
    else:
        be.save(path)
        restarted = jq.BE.from_restart_file(h8_mfs[1], jf, path)
        other = be
    assert abs(restarted.ebe_hf - other.ebe_hf) < 1e-10
    restarted.oneshot("MP2")
    other.oneshot("MP2")
    assert abs(restarted.ebe_tot - other.ebe_tot) < 1e-9


def test_restart_keeps_frozen_core(butane, tmp_path):
    _, (jbe, be, _, tf) = butane
    path = str(tmp_path / "fc.npz")
    be.save(path)
    again = qt.BE.from_restart_file(butane[0][3], tf, path, device="cpu")
    assert again.frozen_core and again.ncore == be.ncore
    assert again.E_core == be.E_core
    assert abs(again.ebe_hf - be.ebe_hf) < 1e-10


# ------------------------------------------------------ full-basis RDMs
@pytest.fixture(scope="module")
def h8_solved(h8_mfs):
    jbe, be, _, _ = _be_pair(h8_mfs)
    jbe.oneshot("CCSD")
    be.oneshot("CCSD")
    return jbe, be


@pytest.mark.parametrize("kw", [
    {}, {"return_ao": False}, {"return_lo": True},
    {"return_lo": True, "return_ao": False}, {"only_rdm1": True},
    {"only_rdm1": True, "return_ao": False}, {"only_rdm2": True},
    {"only_rdm2": True, "return_ao": False},
    {"only_rdm2": True, "return_RDM2": False}, {"return_RDM2": False},
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()) or "ao")
def test_rdm1_fullbasis_matches_jax(h8_solved, kw):
    jbe, be = h8_solved
    out = be.rdm1_fullbasis(**kw)
    ref = jbe.rdm1_fullbasis(**kw)
    if not isinstance(ref, tuple):
        out, ref = (out,), (ref,)
    assert len(out) == len(ref)
    for a, b in zip(out, ref):
        assert isinstance(a, np.ndarray) and a.shape == b.shape
        assert np.abs(a - np.asarray(b)).max() < 1e-9


def test_rdm1_fullbasis_counts_electrons(h8_solved):
    _, be = h8_solved
    rdm1, rdm2 = be.rdm1_fullbasis()
    # one-shot, not matched: the count is off by the densities' mismatch
    assert abs(np.trace(rdm1 @ be.S) - 8.0) < 1e-2
    assert rdm2.shape == (8,) * 4 and np.all(np.isfinite(rdm2))


@pytest.mark.parametrize("approx_cumulant", [True, False])
def test_compute_energy_full_matches_jax(h8_solved, approx_cumulant):
    jbe, be = h8_solved
    out = be.compute_energy_full(approx_cumulant=approx_cumulant)
    e = be.ebe_tot
    ref = jbe.compute_energy_full(approx_cumulant=approx_cumulant)
    assert abs(e - jbe.ebe_tot) < 1e-8
    for a, b in zip(out, ref):
        assert np.abs(a - np.asarray(b)).max() < 1e-9
    assert be.compute_energy_full(approx_cumulant=approx_cumulant,
                                  return_rdm=False) is None
    assert abs(be.ebe_tot - e) < 1e-12


# ------------------------------------------------- wide fragments alone
@pytest.fixture(scope="module")
def h8_potential(h8_mfs):
    """An H8 BE2 pair with the same seeded matching potential set on every
    fragment of both sides."""
    jbe, be, _, _ = _be_pair(h8_mfs)
    pot = np.random.default_rng(2).standard_normal(len(be.pot)) * 1e-3
    for obj in (jbe, be):
        for fr in obj.fragments:
            fr.update_heff(pot)
    return jbe, be


@pytest.fixture
def split_plan(monkeypatch):
    """The plan a card makes of fragments wider than 48, forced on every
    class: one bucket a fragment, no pads; returns the sizes of the buckets
    that ``_solve_bucket_batched`` gets."""
    sizes = []
    inner = dispatch._solve_bucket_batched

    def counted(frs, *args, **kwargs):
        sizes.append(len(frs))
        return inner(frs, *args, **kwargs)

    monkeypatch.setattr(dispatch, "_solved_alone", lambda *a: True)
    monkeypatch.setattr(dispatch, "_solve_bucket_batched", counted)
    return sizes


@pytest.mark.parametrize("solver", ["CCSD", "MP2"])
@pytest.mark.parametrize("use_cumulant", [True, False])
def test_large_path_matches_jax(h8_potential, split_plan, solver,
                                use_cumulant):
    """Each fragment a bucket of its own: the energies and every
    fragment's 1-RDM in the embedding basis at 1e-9 against the JAX
    package's fragment-at-a-time path (CCSD) and against its batched MP2,
    one fragment a bucket (its large path gives MP2 the CCSD form of the
    RDMs with t1 = 0: no correlation in the density)."""
    jbe, be = h8_potential
    plan = dispatch.form_merge_classes(be.fragments, solver)
    assert [[p for _, p in c] for c in plan] == [[(0, 0)]] * len(plan)
    assert len(plan) == len(be.fragments)
    out = dispatch.be_func(None, be.fragments, be.Nocc, solver, eeval=True,
                           use_cumulant=use_cumulant)[1]
    assert split_plan == [1] * len(be.fragments)
    if solver == "CCSD":
        ref = jax_dispatch._solve_bucket_large(jbe.fragments, solver, True,
                                               use_cumulant)
    else:
        ref = np.sum([jax_dispatch._solve_bucket_batched(
            [jfr], solver, True, use_cumulant, False)
            for jfr in jbe.fragments], axis=0)
    assert np.abs(np.array(out) - np.array(ref)).max() < 1e-9
    for fr, jfr in zip(be.fragments, jbe.fragments):
        assert np.abs(fr._rdm1 - np.asarray(jfr._rdm1)).max() < 1e-9
        assert abs(fr.ebe - jfr.ebe) < 1e-9
    assert dispatch._solve_bucket(be.fragments[:1], solver, False,
                                  use_cumulant, False) is None


@pytest.mark.parametrize("use_cumulant", [True, False])
def test_large_path_matches_batched_path(h8_potential, monkeypatch,
                                         use_cumulant):
    """CCSD through ``be_func`` once on the split plan, one bucket a
    fragment, and once on the merged plan: the error vector and the
    energies at 1e-9; a bucket of one works on its fragment's ERI."""
    _, be = h8_potential
    kw = dict(eeval=True, return_vec=True, use_cumulant=use_cumulant)
    pot = np.random.default_rng(3).standard_normal(len(be.pot)) * 1e-3
    merged = dispatch.form_merge_classes(be.fragments, "CCSD")
    batched = dispatch.be_func(pot, be.fragments, be.Nocc, "CCSD", **kw)
    monkeypatch.setattr(dispatch, "_solved_alone", lambda *a: True)
    split = dispatch.form_merge_classes(be.fragments, "CCSD")
    assert len(merged) < len(split) == len(be.fragments)
    out = dispatch.be_func(pot, be.fragments, be.Nocc, "CCSD", **kw)
    assert abs(out[0] - batched[0]) < 1e-9
    assert np.abs(out[1] - batched[1]).max() < 1e-9
    assert abs(out[2][0] - batched[2][0]) < 1e-9
    for fr in be.fragments:  # a bucket of one holds no copy of its ERI
        assert fr._bucket_cache["dev"]["eri"].data_ptr() == fr.eri.data_ptr()


def test_large_path_routing():
    """The JAX package's routing, decided by the plan alone: on a card,
    CCSD and MP2 classes wider than 48 become one unpadded bucket a
    fragment; never on the CPU, never for the CI solvers."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert dispatch._NEMB_BATCHED_MAX == 48
    assert dispatch._solved_alone(49, cuda, "CCSD")
    assert dispatch._solved_alone(54, cuda, "MP2")
    assert not dispatch._solved_alone(48, cuda, "CCSD")
    assert not dispatch._solved_alone(54, cuda, "FCI")
    for solver in ("CCSD", "MP2", "FCI"):
        assert not dispatch._solved_alone(200, cpu, solver)

    def fragments(device):
        # octane BE3's widths, two of one shape, beside a narrow pair
        shapes = [(57, 29), (57, 29), (54, 27), (41, 21), (40, 22)]
        eri = types.SimpleNamespace(device=device)
        return [types.SimpleNamespace(nao=n, nsocc=o, eri=eri)
                for n, o in shapes]

    def plan(frs, solver):
        ids = [id(fr) for fr in frs]  # stand-ins of one shape compare equal
        return [[(ids.index(id(fr)), p) for fr, p in c]
                for c in dispatch.form_merge_classes(frs, solver)]

    frs = fragments(cuda)
    for solver in ("CCSD", "MP2"):
        assert plan(frs, solver) == [[(0, (0, 0))], [(1, (0, 0))],
                                     [(2, (0, 0))],
                                     [(3, (1, 0)), (4, (0, 2))]]
    assert plan(frs, "FCI") == [[(0, (0, 0)), (1, (0, 0))], [(2, (0, 0))],
                                [(3, (0, 0))], [(4, (0, 0))]]
    assert plan(fragments(cpu), "CCSD") == [
        [(0, (0, 0)), (1, (0, 0))], [(2, (0, 0))],
        [(3, (1, 0)), (4, (0, 2))]]


# ------------------------------------------------------------ SCI, DMRG
def _seeded_hamiltonian(nmo, seed):
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


@pytest.mark.parametrize("eps_var", [1e-2, 1e-4])
def test_sci_copy_matches_original(eps_var):
    h1, eri = _seeded_hamiltonian(6, seed=4)
    out = sci.solve_sci(h1, eri, 3, eps_var=eps_var)
    ref = jax_sci.solve_sci(h1, eri, 3, eps_var=eps_var)
    assert abs(out[0] - ref[0]) < 1e-10
    for a, b in zip(out[1:], ref[1:]):
        assert np.abs(a - b).max() < 1e-10
    e_fci = solve_fci(h1, eri, 3)[0]
    assert e_fci - 1e-10 <= out[0] < e_fci + 1e-2


def test_sci_chemical_potential_matches_fci(h8_mfs):
    """H8 BE1 chemical-potential matching, SCI against FCI (as in
    tests/test_aux_surface.py:test_sci_solver_fci_limit)."""
    mol, mf = h8_mfs[2], h8_mfs[3]
    fobj = qt.fragmentate(mol, n_BE=1, frag_type="chemgen",
                          print_frags=False)
    e = {}
    for solver in ("FCI", "SCI"):
        be = qt.BE(mf, fobj, device="cpu")
        be.optimize(solver=solver, only_chem=True)
        e[solver] = be.ebe_tot
    assert abs(e["SCI"] - e["FCI"]) < 1e-6
    assert e["FCI"] < mf.e_tot - 0.05


def _h8_be1(h8_mfs):
    mol, mf = h8_mfs[2], h8_mfs[3]
    fobj = qt.fragmentate(mol, n_BE=1, frag_type="chemgen",
                          print_frags=False)
    return qt.BE(mf, fobj, device="cpu")


def test_dmrg_gating_and_external_solvers(h8_mfs):
    """Without block2 DMRG raises the JAX package's install hint; SHCI and
    HCI raise its cornell_shci message."""
    be = _h8_be1(h8_mfs)
    if dmrg.block2_available():
        be.optimize(solver="DMRG", only_chem=True)
        assert np.isclose(be.ebe_tot, -4.20236532, atol=1e-4)
    else:
        with pytest.raises(NotImplementedError, match="pip install block2"):
            be.oneshot(solver="DMRG")
    for solver in ("SHCI", "HCI"):
        with pytest.raises(NotImplementedError, match="cornell_shci"):
            be.oneshot(solver=solver)


class _FakeDriver:
    """A block2 ``DMRGDriver`` stand-in that solves by exact
    diagonalization and returns block2's conventions (pdm2[i,j,k,l] =
    <a+_i a+_j a_k a_l>, spin traced)."""

    seen: dict = {}

    def __init__(self, scratch=None, symm_type=None, n_threads=1):
        pass

    def initialize_system(self, n_sites, n_elec, spin):
        self.seen.update(n_sites=n_sites, n_elec=n_elec)

    def get_qc_mpo(self, fcidump, h1e, g2e, ecore):
        self.seen.update(h1e=np.asarray(h1e), g2e=np.asarray(g2e))
        return "mpo"

    def get_random_mps(self, tag, bond_dim, nroots):
        return "ket"

    def dmrg(self, mpo, ket, n_sweeps, bond_dims, noises, thrds):
        self.seen.update(bond_dims=list(bond_dims), noises=list(noises))
        e, self._rdm1, rdm2_c = solve_fci(
            self.seen["h1e"], self.seen["g2e"], self.seen["n_elec"] // 2
        )
        self._pdm2 = rdm2_c.transpose(0, 2, 3, 1)
        return e

    def get_1pdm(self, ket):
        return self._rdm1

    def get_2pdm(self, ket):
        return self._pdm2


@pytest.fixture
def fake_block2(monkeypatch):
    core = types.ModuleType("pyblock2.driver.core")
    core.DMRGDriver = _FakeDriver
    core.SymmetryTypes = types.SimpleNamespace(SU2="su2")
    driver = types.ModuleType("pyblock2.driver")
    driver.core = core
    pkg = types.ModuleType("pyblock2")
    pkg.driver = driver
    monkeypatch.setitem(sys.modules, "pyblock2", pkg)
    monkeypatch.setitem(sys.modules, "pyblock2.driver", driver)
    monkeypatch.setitem(sys.modules, "pyblock2.driver.core", core)
    _FakeDriver.seen = {}
    return _FakeDriver.seen


def test_dmrg_adapter_mock_driver(fake_block2):
    """Mirrors tests/test_solvers.py:test_dmrg_adapter_mock_driver: the
    adapter's physicist-to-chemist transpose gives the FCI RDMs, and the
    energy through the chemist contraction."""
    h1, eri = _seeded_hamiltonian(4, seed=3)
    e_fci, rdm1_fci, rdm2_fci = solve_fci(h1, eri, 2)
    e, rdm1, rdm2 = dmrg.solve_dmrg(h1, eri, 2, max_m=100)
    assert fake_block2["bond_dims"][-1] == 100
    assert fake_block2["noises"][-1] == 0.0
    assert abs(e - e_fci) < 1e-10
    assert np.abs(rdm1 - rdm1_fci).max() < 1e-10
    assert np.abs(rdm2 - rdm2_fci).max() < 1e-10
    e_rdm = np.einsum("pq,pq", h1, rdm1) + 0.5 * np.einsum(
        "pqrs,pqrs", eri, rdm2)
    assert abs(e_rdm - e_fci) < 1e-9


def test_dmrg_branch_matches_fci(h8_mfs, fake_block2):
    """The bucket solve's DMRG branch on the mocked driver: the one-shot
    energy of FCI."""
    be = _h8_be1(h8_mfs)
    be.oneshot("FCI")
    e_fci = be.ebe_tot
    be.oneshot("DMRG")
    assert abs(be.ebe_tot - e_fci) < 1e-10


# ---------------------------------------------------- the DIIS solve
def _histories(nf, m, seed, scale=1.0):
    """Seeded error histories (a few directions with a little noise, as
    an SCF's errors are) and one-hot Focks, so that the extrapolated
    "Fock" is the coefficient vector itself."""
    rng = np.random.default_rng(seed)
    err = np.stack([
        rng.standard_normal((m, 3)) @ rng.standard_normal((3, 40))
        + 0.1 * rng.standard_normal((m, 40)) for _ in range(nf)
    ]) * scale
    fock = np.broadcast_to(np.eye(m), (nf, m, m)).copy()
    return err, fock


def _port_diis(err, fock, nvalid):
    return fragment_scf._diis_solve(
        torch.as_tensor(err), torch.as_tensor(fock),
        torch.as_tensor(nvalid)).numpy()


def _jax_diis(err, fock, nvalid):
    return np.asarray(jax.vmap(jax_fragment_scf._diis_solve)(
        jnp.asarray(err), jnp.asarray(fock), jnp.asarray(nvalid)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_diis_solve_matches_jax(seed):
    err, fock = _histories(4, 8, seed)
    nvalid = np.array([2, 4, 7, 8])
    c = _port_diis(err, fock, nvalid)
    assert np.abs(c - _jax_diis(err, fock, nvalid)).max() < 1e-10
    assert np.abs(c.sum(1) - 1.0).max() < 1e-12
    for k, n in enumerate(nvalid):
        assert np.abs(c[k, n:]).max(initial=0.0) < 1e-15


@pytest.mark.parametrize("scale", [1e8, 1e-8])
def test_diis_solve_scaled_errors(scale):
    """Scaling every error vector leaves DIIS coefficients alone: at 1e+8
    they equal the unscaled ones; at 1e-8 (Gram entries below the 1e-14
    regularizer) they are finite, sum to one and solve the JAX function's
    regularized system, where its eigenvalues near the 1e-14 cutoff lose
    the JAX function digits."""
    err, fock = _histories(3, 8, seed=5)
    nvalid = np.array([3, 6, 8])
    c = _port_diis(err * scale, fock, nvalid)
    assert np.all(np.isfinite(c))
    assert np.abs(c.sum(1) - 1.0).max() < 1e-10
    if scale > 1:
        c0 = _port_diis(err, fock, nvalid)
        assert np.abs(c - c0).max() < 1e-10 * np.abs(c0).max()
    else:
        for k, n in enumerate(nvalid):
            e = err[k, :n] * scale
            B = np.zeros((n + 1, n + 1))
            B[:n, :n] = (e @ e.T + 1e-14 * np.eye(n)) / 1e-14
            B[n, :n] = B[:n, n] = -1.0
            rhs = np.zeros(n + 1)
            rhs[n] = -1.0
            assert np.abs(c[k, :n] - np.linalg.solve(B, rhs)[:n]).max() \
                < 1e-10


def test_diis_solve_non_finite_lane():
    """A lane with a non-finite history gets NaN coefficients, as the JAX
    function's eigh gives it, and the other lanes are unchanged."""
    err, fock = _histories(3, 8, seed=6)
    nvalid = np.array([5, 5, 8])
    c0 = _port_diis(err, fock, nvalid)
    bad = err.copy()
    bad[1, 2, 7] = np.nan
    c = _port_diis(bad, fock, nvalid)
    assert np.all(np.isnan(c[1]))
    assert np.array_equal(c[[0, 2]], c0[[0, 2]])


def test_diis_solve_card_case():
    """The case met on the card (C40H82 matching, a NaN potential): every
    lane of a bucket at its first SCF iteration, one history entry, most
    of its error vector NaN.  No lane stops the bucket; each gets NaN."""
    rng = np.random.default_rng(7)
    nf, m, nn = 5, 8, 43 * 43
    err = np.zeros((nf, m, nn))
    err[:, 0] = rng.standard_normal((nf, nn)) * 1e-9
    err[:, 0, rng.random(nn) < 0.74] = np.nan
    fock = np.zeros((nf, m, nn))
    fock[:, 0] = np.nan
    c = _port_diis(err, fock, np.ones(nf, dtype=np.int64))
    assert c.shape == (nf, nn) and np.all(np.isnan(c))


def test_fragment_scf_non_finite_lane():
    """A fragment whose Fock is not finite shows it in its own energy; its
    bucket's other lanes equal their solves alone."""
    from tests.test_torch_matching import _seeded_fragment

    frs = [_seeded_fragment(n=8, no=3, seed=s)[:3] for s in (20, 21, 22)]
    h = torch.stack([torch.as_tensor((C * moe) @ C.T) for C, moe, _ in frs])
    # weakened so that each SCF converges (25-30 iterations)
    eri = 0.2 * torch.stack([torch.as_tensor(e) for _, _, e in frs])
    dm0 = torch.stack([2.0 * torch.as_tensor(C[:, :3] @ C[:, :3].T)
                       for C, _, _ in frs])
    h[1, 0, 0] = float("nan")
    e, C, e_el, it = fragment_scf.rhf_orthonormal(h, eri, 3, dm0)
    assert torch.isnan(e_el[1]) and torch.isnan(e[1]).all()
    for k in (0, 2):
        e1, _, e_el1, it1 = fragment_scf.rhf_orthonormal(
            h[k:k + 1], eri[k:k + 1], 3, dm0[k:k + 1])
        assert int(it[k]) == int(it1[0]) < fragment_scf.MAX_CYCLE
        assert abs(float(e_el[k] - e_el1[0])) < 1e-12
        assert torch.isfinite(e[k]).all()
