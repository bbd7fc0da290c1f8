"""The rest of the molecular surface of the port against the JAX package:
``be2puffin`` (plain, QM/MM, custom hcore and jk, ECP, UHF, from a
checkpoint), the scanner and its fragment probe, ``solve_rccsd``, FCIDUMP
and cube I/O, the mean-field interchange (npz dumps and ORCA JSON), the
scratch manager, the timer table and the device trace.

Tolerances: energies of the same calculation in both packages within
1e-8 Ha (RHF, RCCSD and UCCSD converged to 1e-12, 1e-9 and 1e-10 per
step); the H6 BE3 scanner point within 1e-8 Ha of the reference's
-3.23567708251885; the H4 probe gradient within 1e-8 Ha/Bohr of the JAX
package's and 1e-6 of the full pipeline's (the JAX test's bar); integrals
in the embedding basis to 1e-12 (both packages build the basis with the
same numpy code); integrals in fragment orbitals only through the
fragment HF energy they give (1e-10 Ha), since the two packages choose
orbital signs independently.  The octane case from the reference's own
chkfile runs only with ``QUEMB_TPU_EXPENSIVE_TESTS=true``.
"""

import json
import os
import stat
from pathlib import Path
from tempfile import mkdtemp

import numpy as np
import pytest
import torch

import quemb_tpu as jq
import quemb_tpu_torch as qt
from quemb_tpu import misc as jmisc
from quemb_tpu import mf_interfaces as jmfi
from quemb_tpu import scanner as jscanner
from quemb_tpu.chem.mole import Mole as JMole
from quemb_tpu.chem.scf import RHF as JRHF
from quemb_tpu.chem.scf import UHF as JUHF
from quemb_tpu.utils import helper as jhelper
from quemb_tpu.utils import io as jio
from quemb_tpu_torch import misc, mf_interfaces as mfi, scanner
from quemb_tpu_torch.chem.elements import BOHR2ANG
from quemb_tpu_torch.chem.mole import Mole
from quemb_tpu_torch.chem.scf import RHF, UHF
from quemb_tpu_torch.fragment.chemgen import ChemGenArgs
from quemb_tpu_torch.utils import helper, io
from quemb_tpu_torch.utils.profiling import device_trace, print_timings
from quemb_tpu_torch.utils.scratch import WorkDir

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
H8_XYZ = os.path.join(DATA, "xyz", "h8.xyz")
H8 = "; ".join(f"H 0 0 {i * 1.0}" for i in range(8))
TOL = 1e-8
H6_REF = -3.23567708251885
CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def _ccsd_tol(monkeypatch):
    monkeypatch.setenv("QUEMB_TPU_CCSD_CONV_TOL", "1e-9")


def _xyz(tmp_path, name, atoms):
    """An xyz file of ``atoms`` ("El x y z; ...", Angstrom)."""
    lines = [a.strip() for a in atoms.split(";")]
    path = tmp_path / f"{name}.xyz"
    path.write_text(f"{len(lines)}\n\n" + "\n".join(lines) + "\n")
    return str(path)


def _both(xyz, **kw):
    """be2puffin of the port on the CPU and of the JAX package."""
    return misc.be2puffin(xyz, **kw, **CPU), jmisc.be2puffin(xyz, **kw)


# ----------------------------------------------------------- be2puffin
WATER = "O 0 0 0.1; H 0 0.75 -0.45; H 0 -0.7 -0.46"
METHANE = ("C 0 0 0; H 0.63 0.63 0.63; H -0.63 -0.63 0.63;"
           "H -0.63 0.63 -0.63; H 0.63 -0.63 -0.63")
PSEUDO_C = {"C": {"ncore": 2, "local": [(2, 4.5, 8.0), (1, 2.8, 2.0)],
                  "semilocal": {0: [(2, 6.0, 10.0)]}}}


@pytest.mark.parametrize("case", ["plain", "qmmm", "df"])
def test_be2puffin_h8_matches_jax(case):
    """Plain and QM/MM, and with the mean field's J/K density-fitted
    (``use_df``, the even-tempered auxiliary basis in both packages)."""
    kw = dict(basis="sto-3g", n_BE=2, frozen_core=False)
    if case == "qmmm":
        kw["pts_and_charges"] = (np.array([[0.0, 0.0, -20.0]]),
                                 np.array([-1.0]))
    if case == "df":
        kw["use_df"] = True
    e, je = _both(H8_XYZ, **kw)
    assert abs(e - je) < TOL
    if case == "plain":
        # the manual pipeline gives the same number (the JAX test's check)
        mol = Mole.from_xyz_file(H8_XYZ, basis="sto-3g")
        mf = RHF(mol, **CPU)
        mf.kernel()
        be = qt.BE(mf, qt.fragmentate(mol, n_BE=2, print_frags=False),
                   **CPU)
        be.oneshot(solver="CCSD")
        assert abs(e - (be.ebe_tot - be.ebe_hf)) < TOL
    elif case == "qmmm":
        e_plain = misc.be2puffin(H8_XYZ, "sto-3g", n_BE=2,
                                 frozen_core=False, **CPU)
        assert 1e-6 < abs(e - e_plain) < 1e-2


def test_qmmm_mean_field_matches_jax():
    """The QM/MM classes keep the JAX MRO; hcore, the MM nuclear energy
    and the restricted and unrestricted SCF energies match."""
    pts = np.array([[0.0, 1.0, -6.0], [1.0, 0.0, 12.0]])
    q = np.array([-0.4, 0.3])
    mol, jmol = Mole(atom=H8, basis="sto-3g"), JMole(atom=H8, basis="sto-3g")
    assert ([c.__name__ for c in misc._QMMM_UHF.__mro__][:4]
            == [c.__name__ for c in jmisc._QMMM_UHF.__mro__][:4])
    assert np.abs(misc.point_charge_matrix(mol, pts, q)
                  - jmisc.point_charge_matrix(jmol, pts, q)).max() < 1e-13
    for cls, jcls in ((misc._QMMM_RHF, jmisc._QMMM_RHF),
                      (misc._QMMM_UHF, jmisc._QMMM_UHF)):
        mf, jmf = cls(mol, pts, q, **CPU), jcls(jmol, pts, q)
        assert abs(mf.energy_nuc() - jmf.energy_nuc()) < 1e-12
        assert abs(mf.kernel() - jmf.kernel()) < TOL


def _capture_mf(monkeypatch):
    """Every mean field that ``be2puffin`` hands to the port's BE."""
    made, inner = [], qt.BE

    class Captured(inner):
        def __init__(self, mf, *args, **kwargs):
            made.append(mf)
            super().__init__(mf, *args, **kwargs)

    monkeypatch.setattr(qt, "BE", Captured)
    return made


@pytest.mark.parametrize("case", ["hcore-libint", "jk-libint"])
def test_be2puffin_custom_hcore_and_jk(tmp_path, case, monkeypatch):
    """A libint-ordered hcore or (J, K) pair is reordered into the PySCF
    convention: water BE1 equals the plain run and the JAX package's;
    the custom J/K build hands back float64 tensors on the mean field's
    device."""
    xyz = _xyz(tmp_path, "water", WATER)
    mol = Mole.from_xyz_file(xyz, basis="sto-3g")
    perm = misc._libint_perm(mol)
    assert perm == jmisc._libint_perm(JMole.from_xyz_file(xyz,
                                                          basis="sto-3g"))
    inv = np.argsort(perm)
    kw = dict(basis="sto-3g", n_BE=1, frozen_core=False, libint_inp=True)
    RHF_ = RHF(mol, **CPU)
    if case == "hcore-libint":
        kw["hcore"] = RHF_.get_hcore()[np.ix_(inv, inv)]
    else:
        eri = RHF_.get_eri()[np.ix_(inv, inv, inv, inv)]
        kw["jk"] = (eri, eri)
    made = _capture_mf(monkeypatch)
    e, je = _both(xyz, **kw)
    e_plain = misc.be2puffin(xyz, "sto-3g", n_BE=1, frozen_core=False,
                             **CPU)
    assert abs(e - je) < TOL and abs(e - e_plain) < TOL
    if case == "jk-libint":
        mf = made[-1]
        dm = torch.as_tensor(mf.make_rdm1(), device=mf.device)
        vj, vk = mf._jk(dm)
        assert vj.dtype == vk.dtype == torch.float64
        assert vj.device == vk.device == mf.device
        assert np.abs(mf.get_veff() - RHF_.get_veff(mf.make_rdm1())
                      ).max() < 1e-12


@pytest.mark.parametrize("case", ["ecp-frozen-core", "ecp", "uhf"])
def test_be2puffin_ecp_and_uhf_match_jax(tmp_path, case):
    """ECP on methane (with and without the frozen core, which freezes
    the carbon's lowest orbital in both packages whether or not the ECP
    removed its core) and the unrestricted branch (H5, spin 1,
    UBE1-UCCSD)."""
    if case == "uhf":
        xyz = _xyz(tmp_path, "h5", "; ".join(f"H 0 0 {i}.0"
                                             for i in range(5)))
        kw = dict(basis="sto-3g", n_BE=1, spin=1, unrestricted=True)
    else:
        xyz = _xyz(tmp_path, "methane", METHANE)
        kw = dict(basis="sto-3g", n_BE=1, ecp=PSEUDO_C,
                  frozen_core=case == "ecp-frozen-core")
    e, je = _both(xyz, **kw)
    assert np.isfinite(e) and abs(e - je) < TOL
    with pytest.raises(ValueError, match="incompatible"):
        misc.be2puffin(xyz, "sto-3g", use_df=True, unrestricted=True, **CPU)


def test_be2puffin_from_checkpoints(tmp_path):
    """From the npz that a run writes, and from a PySCF-layout HDF5
    chkfile (written here with h5py from the JAX package's RHF): the same
    E_corr as the run itself and as the JAX package's from the same
    file."""
    import h5py

    kw = dict(basis="sto-3g", n_BE=2, frozen_core=False)
    npz = str(tmp_path / "h8_scf.npz")
    e_run = misc.be2puffin(H8_XYZ, checkfile=npz, **kw, **CPU)
    e_npz, je_npz = _both(H8_XYZ, from_chk=True, checkfile=npz, **kw)
    jmf = JRHF(JMole.from_xyz_file(H8_XYZ, basis="sto-3g"))
    jmf.kernel()
    chk = str(tmp_path / "h8.chk")
    with h5py.File(chk, "w") as f:
        f["scf/mo_coeff"] = jmf.mo_coeff
        f["scf/mo_energy"] = jmf.mo_energy
        f["scf/e_tot"] = jmf.e_tot
    e_h5, je_h5 = _both(H8_XYZ, from_chk=True, checkfile=chk, **kw)
    for e in (e_npz, je_npz, e_h5, je_h5):
        assert abs(e - e_run) < TOL


@pytest.mark.skipif(
    os.environ.get("QUEMB_TPU_EXPENSIVE_TESTS", "").lower() != "true",
    reason="octane-scale one-shot on the CPU",
)
def test_qmmm_octane_from_reference_chk():
    """tests/test_aux_surface.py:315 on the port: the reference's own
    QM/MM chkfile; -0.54879605 at 5e-5 (the reference's value) and the
    JAX package's -0.54876462 at 1e-7."""
    charges = np.array([-0.2, -0.1, 0.15, 0.2])
    coords = np.array(
        [(-3, -8, -2), (-2, 6, 1), (2, -5, 2), (1, 8, 1.5)], float
    )
    e = misc.be2puffin(
        os.path.join(DATA, "xyz", "octane.xyz"), "sto-3g",
        pts_and_charges=(coords, charges), n_BE=2, frozen_core=False,
        from_chk=True, checkfile=os.path.join(DATA, "oneshot_rbe_qmmm.chk"),
        **CPU,
    )
    assert abs(e - -0.54879605) < 5e-5
    assert abs(e - -0.54876462) < 1e-7


# ------------------------------------------------------------- scanner
def test_scanner_h8_matches_direct_pipeline_and_jax():
    mol = Mole(atom=H8, basis="sto-3g")
    scan = scanner.Energy(basis="sto-3g", n_BE=2, solver="MP2",
                          oneshot=True, **CPU)
    e = scan.as_scanner()(mol)
    mf = RHF(mol, **CPU)
    mf.kernel()
    be = qt.BE(mf, qt.fragmentate(mol, n_BE=2, print_frags=False), **CPU)
    be.oneshot(solver="MP2")
    assert abs(e - be.ebe_tot) < TOL
    assert abs(scan.last_result["e_corr"] - (be.ebe_tot - be.ebe_hf)) < TOL
    je = jscanner.Energy(basis="sto-3g", n_BE=2, solver="MP2",
                         oneshot=True).as_scanner()(JMole(atom=H8,
                                                          basis="sto-3g"))
    assert abs(e - je) < TOL


def test_scanner_h6_reference_value():
    mol = Mole(atom="; ".join(f"H 0 0 {i}.0" for i in range(6)),
               basis="sto-3g")
    scan = scanner.Energy(
        basis="sto-3g", n_BE=3, solver="CCSD", oneshot=True,
        additional_args=ChemGenArgs(h_treatment="treat_H_like_heavy_atom"),
        **CPU,
    )
    assert abs(scan.as_scanner()(mol) - H6_REF) < TOL


def _h4_displaced(mol, dz):
    c = mol.atom_coords().copy()
    c[1, 2] += dz
    return [(e, x * BOHR2ANG) for e, x in zip(mol.elements, c)]


def test_fragment_probe_gradient_matches_jax_and_full():
    h4 = "; ".join(f"H 0 0 {i}.0" for i in range(4))
    mol, jmol = Mole(atom=h4, basis="sto-3g"), JMole(atom=h4, basis="sto-3g")
    kw = dict(basis="sto-3g", n_BE=2, solver="CCSD", oneshot=True)
    scan = scanner.Energy(**kw, **CPU)
    jscan = jscanner.Energy(**kw)
    probe = scanner.FragmentProbe(mol, scan)
    jprobe = jscanner.FragmentProbe(jmol, jscan)
    step = 1e-3

    def grad(fn, cls):
        return (fn(cls(atom=_h4_displaced(mol, step), basis="sto-3g"))
                - fn(cls(atom=_h4_displaced(mol, -step), basis="sto-3g"))
                ) / (2 * step)

    gp, gjp = grad(probe, Mole), grad(jprobe, JMole)
    gf = grad(scan.as_scanner(), Mole)
    assert abs(gp - gjp) < TOL
    assert abs(gp - gf) < 1e-6
    # the reference geometry is the HF energy; two displacements raise
    assert abs(probe(mol) - jprobe(jmol)) < 1e-10
    two = mol.atom_coords().copy()
    two[0, 0] += step
    two[2, 1] += step
    with pytest.raises(RuntimeError, match="single displacements"):
        probe(Mole(atom=[(e, x * BOHR2ANG)
                         for e, x in zip(mol.elements, two)],
                   basis="sto-3g"))
    info = scanner.FDinfo.detect(
        Mole(atom=_h4_displaced(mol, step), basis="sto-3g"), mol)
    assert info.kind == "single_displacement" and info.atom_idx == [1]


def test_fd_helpers_match_jax():
    """fd_gradient and fd_hessian_diag over the scanner on H2 (HF-sized
    fragments: BE1, MP2)."""
    h2 = "H 0 0 0; H 0 0 0.74"
    mol, jmol = Mole(atom=h2, basis="sto-3g"), JMole(atom=h2, basis="sto-3g")
    kw = dict(basis="sto-3g", n_BE=1, solver="MP2", oneshot=True)
    scan, jscan = scanner.Energy(**kw, **CPU), jscanner.Energy(**kw)
    g, jg = (scanner.fd_gradient(scan, mol, step=1e-3),
             jscanner.fd_gradient(jscan, jmol, step=1e-3))
    assert np.abs(g - jg).max() < 1e-6
    assert abs(g[0, 2] + g[1, 2]) < 1e-6
    h = scanner.fd_hessian_diag(scan, mol, step=1e-2)
    jh = jscanner.fd_hessian_diag(jscan, jmol, step=1e-2)
    assert np.abs(h - jh).max() < 1e-4


def test_solve_rccsd_matches_jax():
    from quemb_tpu.solvers.rccsd import solve_rccsd as j_solve_rccsd
    from quemb_tpu_torch.solvers.rccsd import solve_rccsd

    mol = JMole(atom="; ".join(f"H 0 0 {0.9 * i}" for i in range(6)),
                basis="sto-3g")
    mf = JRHF(mol, conv_tol=1e-12)
    mf.kernel()
    C = mf.mo_coeff
    eri_mo = np.einsum("pqrs,pi,qj,rk,sl->ijkl", mf.get_eri(), C, C, C, C,
                       optimize=True)
    moe = torch.tensor(np.array(mf.mo_energy))
    t1, t2, e = solve_rccsd(torch.as_tensor(eri_mo), moe, 3)
    jt1, jt2, je = j_solve_rccsd(eri_mo, mf.mo_energy, 3)
    assert abs(e - je) < 1e-10
    assert t1.shape == jt1.shape and t2.shape == jt2.shape
    assert np.abs(np.abs(t2.numpy()) - np.abs(jt2)).max() < 1e-8
    with pytest.warns(UserWarning, match="did not converge"):
        solve_rccsd(torch.as_tensor(eri_mo), moe, 3, max_cycle=2)


# -------------------------------------------------------------------- I/O
@pytest.fixture(scope="module")
def h8_be():
    mol = Mole(atom=H8, basis="sto-3g")
    mf = RHF(mol, **CPU)
    mf.kernel()
    be = qt.BE(mf, qt.fragmentate(mol, n_BE=2, print_frags=False), **CPU)
    jmol = JMole(atom=H8, basis="sto-3g")
    jmf = JRHF(jmol)
    jmf.kernel()
    jbe = jq.BE(jmf, jq.fragmentate(jmol, n_BE=2, print_frags=False))
    return mol, mf, be, jbe


def test_fcidump_roundtrip_matches_jax(tmp_path, h8_be):
    mol, mf, _, _ = h8_be
    C = mf.mo_coeff
    h1 = C.T @ mf.get_hcore() @ C
    eri_mo = np.einsum("pqrs,pi,qj,rk,sl->ijkl", mf.get_eri(), C, C, C, C,
                       optimize=True)
    io.write_fcidump(str(tmp_path / "t"), h1, eri_mo, norb=mol.nao,
                     nelec=8)
    jio.write_fcidump(str(tmp_path / "j"), h1, eri_mo, norb=mol.nao,
                      nelec=8)
    assert (tmp_path / "t").read_text() == (tmp_path / "j").read_text()
    h1r, erir, norb, nelec, ecore = io.read_fcidump(str(tmp_path / "t"))
    assert (norb, nelec, ecore) == (mol.nao, 8, 0.0)
    assert np.abs(h1r - h1).max() < 1e-9
    assert np.abs(erir - eri_mo).max() < 1e-9


def _fragment_hf_energy(h1, h2, nocc):
    """Closed-shell determinant energy of the lowest ``nocc`` orbitals of
    the Fock matrix ``h1`` against ``h2``: the same number in any
    orthonormal basis of the fragment."""
    _, C = np.linalg.eigh(h1)
    D = C[:, :nocc] @ C[:, :nocc].T
    J = np.einsum("pqrs,rs->pq", h2, D)
    K = np.einsum("prqs,rs->pq", h2, D)
    return np.einsum("pq,pq->", D, 2.0 * h1 - (2.0 * J - K))


@pytest.mark.parametrize("basis", ["embedding", "fragment_mo"])
def test_be2fcidump_matches_jax(tmp_path, h8_be, basis):
    _, _, be, jbe = h8_be
    io.be2fcidump(be, str(tmp_path / "t" / "frag"), basis)
    jio.be2fcidump(jbe, str(tmp_path / "j" / "frag"), basis)
    assert len(list((tmp_path / "t").iterdir())) == len(be.fragments)
    for i, fr in enumerate(be.fragments):
        h1, h2, norb, nelec, _ = io.read_fcidump(tmp_path / "t" / f"fragf{i}")
        jh1, jh2, *_ = io.read_fcidump(tmp_path / "j" / f"fragf{i}")
        assert (norb, nelec) == (fr.TA.shape[1], 2 * fr.nsocc)
        if basis == "embedding":
            assert np.abs(h1 - fr.fock).max() < 1e-12
            assert np.abs(h2 - fr.eri.numpy()).max() < 1e-12
            assert np.abs(h2 - jh2).max() < 1e-12
        e = _fragment_hf_energy(h1, h2, fr.nsocc)
        assert abs(e - _fragment_hf_energy(jh1, jh2, fr.nsocc)) < 1e-10
    with pytest.raises(ValueError, match="basis"):
        io.be2fcidump(be, str(tmp_path / "x"), "lo")


def test_ube2fcidump_matches_jax(tmp_path):
    from quemb_tpu.ube import UBE as JUBE
    from quemb_tpu_torch.ube import UBE

    h4 = "; ".join(f"H 0 0 {i * 1.0}" for i in range(4))
    mol, jmol = Mole(atom=h4, basis="sto-3g"), JMole(atom=h4, basis="sto-3g")
    mf, jmf = UHF(mol, conv_tol=1e-11, **CPU), JUHF(jmol, conv_tol=1e-11)
    mf.kernel()
    jmf.kernel()
    ube = UBE(mf, qt.fragmentate(mol, n_BE=1, print_frags=False), **CPU)
    jube = JUBE(jmf, jq.fragmentate(jmol, n_BE=1, print_frags=False))
    io.ube2fcidump(ube, str(tmp_path / "dump_"), "embedding")
    jio.ube2fcidump(jube, str(tmp_path / "jdump_"), "embedding")
    h1, h2, norb, nelec, _ = io.read_fcidump(tmp_path / "dump_f0a")
    jh1, jh2, *_ = io.read_fcidump(tmp_path / "jdump_f0a")
    fr = ube.Fobjs_a[0]
    assert np.abs(h1 - fr.fock).max() < 1e-12
    assert np.abs(h2 - fr.eri.numpy()).max() < 1e-12
    assert np.abs(h1 - jh1).max() < 1e-10 and np.abs(h2 - jh2).max() < 1e-12
    assert (norb, nelec) == (fr.TA.shape[1], fr.nsocc)
    io.ube2fcidump(ube, str(tmp_path / "mo_"), "fragment_mo")
    assert (tmp_path / "mo_f3b").exists()


def test_cube_files_match_jax(tmp_path, h8_be):
    mol, mf, be, _ = h8_be
    jmol = JMole(atom=H8, basis="sto-3g")
    grid = np.random.default_rng(0).standard_normal((50, 3)) * 3.0
    assert np.abs(io.eval_ao(mol, grid) - jio.eval_ao(jmol, grid)
                  ).max() < 1e-14
    io.write_orbital_cube(mol, str(tmp_path / "t.cube"), mf.mo_coeff[:, 0],
                          nx=12, ny=12, nz=16)
    jio.write_orbital_cube(jmol, str(tmp_path / "j.cube"),
                           mf.mo_coeff[:, 0], nx=12, ny=12, nz=16)
    assert (tmp_path / "t.cube").read_text() == (tmp_path
                                                 / "j.cube").read_text()
    io.write_cube(be, tmp_path / "cubes", fragment_idx=[0],
                  orbital_idx=[0, 1], nx=6, ny=6, nz=6)
    assert sorted(p.name for p in (tmp_path / "cubes").iterdir()) == [
        "frag_0_orb_0.cube", "frag_0_orb_1.cube"]


# ------------------------------------------------- mean-field interchange
@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port"])
def test_dump_load_scf_across_packages(tmp_path, h8_be, direction):
    mol, mf, _, jbe = h8_be
    path = str(tmp_path / "scf.npz")
    if direction == "port-to-jax":
        mfi.dump_scf(mf, path)
        jmol2, jmf2 = jmfi.load_scf(path)
        e_src, e_dst = mf.e_tot, jmf2.e_tot
        be = jq.BE(jmf2, jq.fragmentate(jmol2, n_BE=2, print_frags=False))
    else:
        jmfi.dump_scf(jbe.mf, path)
        mol2, mf2 = mfi.load_scf(path, **CPU)
        assert isinstance(mf2, RHF) and mf2.device == torch.device("cpu")
        e_src, e_dst = jbe.mf.e_tot, mf2.e_tot
        be = qt.BE(mf2, qt.fragmentate(mol2, n_BE=2, print_frags=False),
                   **CPU)
    assert abs(e_src - e_dst) < 1e-12
    be.oneshot(solver="MP2")
    ref = qt.BE(mf, qt.fragmentate(mol, n_BE=2, print_frags=False), **CPU)
    ref.oneshot(solver="MP2")
    assert abs(be.ebe_tot - ref.ebe_tot) < TOL


def test_dump_load_uhf_and_kscf(tmp_path):
    mol = Mole(atom="H 0 0 0; H 0 0 0.9; H 0 0.2 1.95", basis="sto-3g",
               spin=1)
    mf = UHF(mol, **CPU)
    mf.kernel()
    mfi.dump_scf(mf, str(tmp_path / "u.npz"))
    jmol, jmf = jmfi.load_scf(str(tmp_path / "u.npz"))
    assert isinstance(jmf, JUHF) and abs(jmf.e_tot - mf.e_tot) < 1e-12
    mol2, mf2 = mfi.load_scf(str(tmp_path / "u.npz"), **CPU)
    assert isinstance(mf2, UHF) and mol2.spin == 1
    # a KRHF dumped by the JAX package loads into the port's KRHF on the
    # CPU, and the port's dump of it back into the JAX package, unchanged
    from quemb_tpu.kbe import KRHF as JKRHF, Cell as JCell
    from quemb_tpu_torch.kbe import KRHF as KRHF_

    cell = JCell(atom="H 0 0 0; H 0 0 0.8", a=np.diag([6.0, 6.0, 2.4]),
                 basis="sto-3g")
    kmf = JKRHF(cell, cell.make_kpts([1, 1, 2]))
    kmf.kernel()
    jmfi.dump_kscf(kmf, str(tmp_path / "k.npz"))
    cell2, kmf2 = mfi.load_kscf(str(tmp_path / "k.npz"), **CPU)
    assert isinstance(kmf2, KRHF_) and kmf2.device == torch.device("cpu")
    mfi.dump_kscf(kmf2, str(tmp_path / "k2.npz"))
    _, kmf3 = jmfi.load_kscf(str(tmp_path / "k2.npz"))
    assert kmf3.e_tot == kmf2.e_tot == kmf.e_tot
    for a in (lambda m: m.mo_coeff, lambda m: m.hf_veff,
              lambda m: m.get_ovlp(), lambda m: m.get_hcore()):
        assert np.array_equal(a(kmf3), a(kmf)) and \
            np.array_equal(a(kmf2), a(kmf))


ORCA_JSON = os.path.join(DATA, "h2o_cc-pvqz_orca.json")


def test_orca_json_matches_jax():
    d, jd = mfi.load_orca_json(ORCA_JSON), jmfi.load_orca_json(ORCA_JSON)
    assert d["labels"] == jd["labels"]
    for key in ("mo_coeff", "mo_energy", "mo_occ"):
        assert np.array_equal(d[key], jd[key])
    keys = [mfi._pyscf_sort_key(o) for o in d["labels"]]
    assert keys == sorted(keys)
    mol, mf = mfi.mf_from_orca_json(ORCA_JSON, with_energy=False, **CPU)
    jmol, jmf = jmfi.mf_from_orca_json(ORCA_JSON, with_energy=False)
    assert mol.nao == jmol.nao == 115
    assert np.array_equal(mf.mo_coeff, jmf.mo_coeff)


def test_run_orca_mock_binary(tmp_path):
    mol = mfi.mole_from_orca_json(ORCA_JSON)
    orca = tmp_path / "orca"
    orca.write_text("#!/bin/sh\nd=$(dirname \"$1\")\ntouch \"$d/job.gbw\"\n")
    to_json = tmp_path / "orca_2json"
    to_json.write_text(
        f"#!/bin/sh\nd=$(dirname \"$1\")\ncp {ORCA_JSON} \"$d/job.json\"\n"
    )
    for p in (orca, to_json):
        p.chmod(p.stat().st_mode | stat.S_IEXEC)
    mol2, mf = mfi.run_orca(mol, basis="cc-pVQZ",
                            workdir=str(tmp_path / "wd"),
                            orca_exe=str(orca), with_energy=False, **CPU)
    _, mf3 = jmfi.mf_from_orca_json(ORCA_JSON, with_energy=False)
    assert np.abs(mf.mo_coeff - mf3.mo_coeff).max() < 1e-14
    inp = (tmp_path / "wd" / "job.inp").read_text()
    assert "cc-pVQZ" in inp and "* xyz 0 1" in inp
    old_path = os.environ.get("PATH", "")
    os.environ["PATH"] = str(tmp_path / "empty")
    try:
        with pytest.raises(RuntimeError, match="ORCA executable"):
            mfi.run_orca(mol, basis="cc-pVQZ", **CPU)
    finally:
        os.environ["PATH"] = old_path


def test_entry_points_need_a_card_or_the_cpu(tmp_path):
    """No fallback: without a card every entry point that was not given
    ``device="cpu"`` raises, as ``BE`` does."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    calls = [
        lambda: misc.be2puffin(H8_XYZ, "sto-3g"),
        lambda: scanner.Energy(basis="sto-3g"),
        lambda: mfi.load_scf(str(tmp_path / "none.npz")),
        lambda: mfi.mf_from_orca_json(ORCA_JSON, with_energy=False),
        lambda: mfi.run_orca(Mole(atom="H 0 0 0; H 0 0 0.74",
                                  basis="sto-3g")),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ------------------------------------------------ scratch, timer, trace
def test_workdir_contract(tmp_path, monkeypatch):
    """tests/test_scratch.py on the port's WorkDir."""
    my_tmp = Path(mkdtemp())
    scratch = WorkDir(my_tmp)
    scratch.cleanup()
    assert not my_tmp.exists()
    with pytest.raises(FileNotFoundError):
        scratch.cleanup()
    my_tmp = Path(mkdtemp())
    with pytest.raises(ValueError):
        with WorkDir(my_tmp):
            raise ValueError
    assert not my_tmp.exists()
    monkeypatch.chdir(tmp_path)
    with WorkDir("./scratch_test") as d:
        assert d.path == (tmp_path / "scratch_test").resolve()
        assert (d / "x") == d.path / "x" and os.fspath(d) == str(d.path)
        sub = d.make_subdir("frag_0")
        assert sub.path.exists() and not sub.cleanup_at_end
    assert not (tmp_path / "scratch_test").exists()
    monkeypatch.delenv("SLURM_JOB_ID", raising=False)
    with WorkDir.from_environment(user_defined_root=tmp_path) as d:
        assert d.path == tmp_path / f"quemb_tpu_{os.getpid()}"
    monkeypatch.setenv("SLURM_JOB_ID", "424242")
    with WorkDir.from_environment(user_defined_root=tmp_path) as d:
        assert d.path.name == "quemb_tpu_424242"


def test_timer_table_and_device_trace(tmp_path, h8_be, capsys):
    _, _, be, _ = h8_be
    before = helper.timer.counts["BE.oneshot"]
    with device_trace(str(tmp_path / "trace")):
        be.oneshot(solver="MP2")
    assert helper.timer.counts["BE.oneshot"] == before + 1
    assert helper.timer.counts["BE.initialize"] >= 1
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]
    print_timings()
    out = capsys.readouterr().out
    assert "BE.oneshot" in out and "total s" in out


def test_function_timer_matches_jax(capsys):
    """The port's FunctionTimer is the JAX package's: the same counts and
    the same table layout."""
    tables = []
    for mod in (helper, jhelper):
        reg = mod.FunctionTimer()

        @reg.timeit
        def work(n):
            return sum(range(n))

        assert work(10) == work(10) == 45
        assert reg.counts["test_function_timer_matches_jax.<locals>.work"] == 2
        reg.print_top()
        tables.append(capsys.readouterr().out.splitlines())
    assert [ln.split()[:2] for ln in tables[0]] == [
        ln.split()[:2] for ln in tables[1]]
