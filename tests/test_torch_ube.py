"""Unrestricted BE: the port's UHF, UCCSD, UBE and unrestricted responses
against the JAX package's, on the CPU.

The two packages choose eigenvector signs, and bases of degenerate
subspaces, independently, so only gauge-free quantities are compared:
energies, orbital energies, densities and density responses.

- ``UHF`` on water (closed shell) at 1e-10 and on the OH doublet: e_tot
  1e-10, mo_energy 1e-8; the closed-shell UHF equals the port's RHF at
  1e-10 and the doublet the STO-3G literature value at 1e-3;
- the four cases of ``tests/test_ube.py`` through both packages: ebe_hf
  and E_corr 1e-8, HF-in-HF 1e-9; H6 UBE within 2e-3 of restricted BE;
  OH BE1 against a direct UCCSD of the whole molecule 1e-7;
- the CP-UHF and unrestricted CP-MP2 responses of
  ``tests/test_aux_surface.py`` (asymmetric H3 doublet): against the JAX
  functions at 1e-8, and CP-UHF against finite-difference UHF densities;
- ``UBE`` and ``UHF`` default to the card.

The ``gpu`` tests run UHF, UCCSD and a UBE one-shot on the card against
the CPU:

    python -m pytest --noconftest -m gpu tests/test_torch_ube.py
"""

import numpy as np
import pytest
import torch

import quemb_tpu_torch as qt
from quemb_tpu_torch.chem.mole import Mole
from quemb_tpu_torch.chem.scf import RHF, UHF
from quemb_tpu_torch.matching import cphf
from quemb_tpu_torch.solvers.uccsd import _mo4, solve_uccsd_so
from quemb_tpu_torch.ube import UBE

torch.set_num_threads(1)
try:
    # the UCCSD solves and the JAX package's run numpy BLAS; one thread
    # per test worker keeps the workers from oversubscribing the cores
    from threadpoolctl import threadpool_limits
except ImportError:
    pass
else:
    threadpool_limits(limits=1, user_api="blas")

WATER = "O 0 0 0.1173; H 0 0.7572 -0.4692; H 0 -0.7572 -0.4692"
OH = "O 0 0 0; H 0 0 0.97"
H3 = "H 0 0 0; H 0 0 0.9; H 0 0.2 1.95"
H6 = "\n".join(f"H 0 0 {i}." for i in range(6))
H5 = "\n".join(f"H 0 0 {i}." for i in range(5))
on_card = pytest.mark.skipif(not torch.cuda.is_available(),
                             reason="needs a CUDA card")


def _uhf(atom, spin, conv_tol=1e-12, device="cpu"):
    mf = UHF(Mole(atom=atom, basis="sto-3g", spin=spin), conv_tol=conv_tol,
             device=device)
    mf.kernel()
    return mf


def _jax_uhf(atom, spin, conv_tol=1e-12):
    from quemb_tpu.chem.mole import Mole as JMole
    from quemb_tpu.chem.scf import UHF as JUHF

    mf = JUHF(JMole(atom=atom, basis="sto-3g", spin=spin), conv_tol=conv_tol)
    mf.kernel()
    return mf


# ------------------------------------------------------------------- UHF
@pytest.mark.parametrize("atom,spin", [(WATER, 0), (OH, 1)],
                         ids=["water", "OH"])
def test_uhf_matches_jax(atom, spin):
    jmf = _jax_uhf(atom, spin, conv_tol=1e-10)
    mf = UHF(Mole(atom=atom, basis="sto-3g", spin=spin), device="cpu")
    mf.kernel()
    assert mf.converged and jmf.converged
    assert abs(mf.e_tot - jmf.e_tot) < 1e-10
    assert np.abs(mf.mo_energy - jmf.mo_energy).max() < 1e-8
    assert mf.nelec == jmf.nelec
    assert np.array_equal(mf.mo_occ, jmf.mo_occ)
    dm = mf.make_rdm1()
    assert dm.shape == (2, mf.mol.nao, mf.mol.nao)
    assert abs(np.trace(dm[0] @ mf.get_ovlp()) - mf.nelec[0]) < 1e-10
    if spin == 0:
        rhf = RHF(Mole(atom=atom, basis="sto-3g"), device="cpu")
        assert abs(rhf.kernel() - mf.e_tot) < 1e-10
        assert np.abs(dm[0] - dm[1]).max() < 1e-8
    else:
        assert abs(mf.e_tot - -74.3627) < 1e-3  # literature STO-3G UHF
        # J(total) - K(sigma) of the converged densities, both packages
        jveff = jmf.get_veff(dm=jmf.make_rdm1())
        assert np.abs(np.einsum("spq,spq->", mf.get_veff(), dm)
                      - np.einsum("spq,spq->", jveff,
                                  jmf.make_rdm1())) < 1e-8


def test_uhf_restarts_from_a_density():
    mf = _uhf(H3, 1, conv_tol=1e-12)
    again = UHF(mf.mol, conv_tol=1e-12, device="cpu")
    e = again.kernel(dm0=mf.make_rdm1())
    assert again.converged and again.cycles <= 4
    assert abs(e - mf.e_tot) < 1e-10
    with pytest.raises(ValueError, match="charge/spin"):
        UHF(Mole(atom=H3, basis="sto-3g", spin=0), device="cpu").nelec


# ------------------------------------------------------------------- UBE
def _fobjs(jmol, mol, n_BE, treat_h):
    import quemb_tpu as jq

    kw = dict(n_BE=n_BE, frag_type="chemgen", print_frags=False)
    if not treat_h:
        return jq.fragmentate(mol=jmol, **kw), qt.fragmentate(mol, **kw)
    return (
        jq.fragmentate(mol=jmol, additional_args=jq.ChemGenArgs(
            h_treatment="treat_H_like_heavy_atom"), **kw),
        qt.fragmentate(mol, additional_args=qt.ChemGenArgs(
            h_treatment="treat_H_like_heavy_atom"), **kw),
    )


@pytest.mark.parametrize("case", ["closed_shell_H6", "open_shell_H5",
                                  "OH_BE1"])
def test_ube_matches_jax(case):
    """The UBE cases of ``tests/test_ube.py`` through both packages."""
    from quemb_tpu.ube import UBE as JUBE

    atom, spin, n_BE, treat_h = {
        "closed_shell_H6": (H6, 0, 2, True),
        "open_shell_H5": (H5, 1, 2, True),
        "OH_BE1": (OH, 1, 1, False),
    }[case]
    jmf = _jax_uhf(atom, spin)
    mf = _uhf(atom, spin)
    jf, tf = _fobjs(jmf.mol, mf.mol, n_BE, treat_h)
    jube = JUBE(jmf, jf)
    jube.oneshot()
    ube = UBE(mf, tf, device="cpu")
    assert ube.unrestricted and len(ube.Fobjs_a) == len(ube.Fobjs_b)
    ube.oneshot()
    e_corr = ube.ebe_tot - ube.uhf_full_e
    assert abs(ube.ebe_hf - mf.e_tot) < 1e-9  # HF-in-HF
    assert abs(ube.ebe_hf - jube.ebe_hf) < 1e-8
    assert abs(e_corr - (jube.ebe_tot - jube.uhf_full_e)) < 1e-8
    assert e_corr < 0
    if case == "closed_shell_H6":
        # restricted BE-CCSD of the same fragments (test_ube.py's 2e-3)
        rhf = RHF(mf.mol, conv_tol=1e-12, device="cpu")
        rhf.kernel()
        be = qt.BE(rhf, tf, device="cpu")
        be.oneshot(solver="CCSD")
        assert abs(e_corr - (be.ebe_tot - be.ebe_hf)) < 2e-3
    elif case == "open_shell_H5":
        assert -0.2 < e_corr
    else:
        # BE1 is the whole molecule: a direct UCCSD on the canonical UHF
        # orbitals gives the same correlation energy
        assert tf.n_frag == 1
        eri = torch.as_tensor(mf.get_eri())
        Ca, Cb = (torch.as_tensor(c) for c in mf.mo_coeff)
        na, nb = mf.nelec
        _, _, e_direct = solve_uccsd_so(
            _mo4(eri, Ca, Ca, Ca, Ca), _mo4(eri, Cb, Cb, Cb, Cb),
            _mo4(eri, Ca, Ca, Cb, Cb), np.diag(mf.mo_energy[0]),
            np.diag(mf.mo_energy[1]), na, nb,
        )
        assert abs(e_corr - e_direct) < 1e-7


def test_uccsd_matches_jax():
    """``solve_uccsd_so`` and the lambda=0 RDMs on the OH doublet's
    canonical orbitals, the same arrays through both packages: E_corr and
    amplitudes 1e-9, RDM blocks 1e-9, cumulant and not."""
    from quemb_tpu.solvers import uccsd as juccsd
    from quemb_tpu_torch.solvers import uccsd

    mf = _uhf(OH, 1)
    eri = mf.get_eri()
    Ca, Cb = mf.mo_coeff
    na, nb = mf.nelec
    blocks = [np.einsum("pqrs,pi,qj,rk,sl->ijkl", eri, A, A, B, B,
                        optimize=True)
              for A, B in ((Ca, Ca), (Cb, Cb), (Ca, Cb))]
    fa, fb = np.diag(mf.mo_energy[0]), np.diag(mf.mo_energy[1])
    jt1, jt2, je = juccsd.solve_uccsd_so(*blocks, fa, fb, na, nb)
    t1, t2, e = uccsd.solve_uccsd_so(*(torch.as_tensor(b) for b in blocks),
                                     fa, fb, na, nb)
    assert abs(e - je) < 1e-9
    for a, b in zip(t1 + t2, tuple(jt1) + tuple(jt2)):
        assert np.abs(a.numpy() - np.asarray(b)).max() < 1e-9
    for with_dm1 in (False, True):
        r2 = uccsd.make_rdm2_uccsd(t1, t2, (na, nb), with_dm1=with_dm1)
        jr2 = juccsd.make_rdm2_uccsd(
            tuple(np.asarray(a) for a in jt1),
            tuple(np.asarray(a) for a in jt2), (na, nb), with_dm1=with_dm1)
        for a, b in zip(r2, jr2):
            assert np.abs(a.numpy() - np.asarray(b)).max() < 1e-9
    for a, b in zip(uccsd.make_rdm1_uccsd(t1, (na, nb)),
                    juccsd.make_rdm1_uccsd(tuple(np.asarray(a) for a in jt1),
                                           (na, nb))):
        assert np.abs(a.numpy() - np.asarray(b)).max() < 1e-9
    V = [torch.as_tensor(b) for b in blocks]
    assert np.abs(uccsd._spin_blocked_chemist(*V).numpy()
                  - juccsd._spin_blocked_chemist(*blocks)).max() < 1e-14


def test_ube_and_uhf_default_to_the_card():
    mol = Mole(atom=H3, basis="sto-3g", spin=1)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        UHF(mol).kernel()
    mf = _uhf(H3, 1)
    mf._device = None  # a mean field that was given no device
    with pytest.raises(RuntimeError, match="no CUDA device"):
        UBE(mf, qt.fragmentate(mol, n_BE=1, frag_type="chemgen",
                               print_frags=False))
    with pytest.raises(NotImplementedError, match="lowdin"):
        UBE(_uhf(H3, 1), qt.fragmentate(mol, n_BE=1, frag_type="chemgen",
                                        print_frags=False),
            lo_method="boys", device="cpu")


# ----------------------------------------------- unrestricted responses
def _h3_responses():
    mf = _uhf(H3, 1, conv_tol=1e-13)
    n = mf.mol.nao
    v1 = np.zeros((n, n))
    v1[0, 1] = v1[1, 0] = 1.0
    v2 = np.zeros((n, n))
    v2[1, 1] = 1.0
    return mf, [v1, v2], mf.nelec


def test_cpuhf_matches_jax_and_finite_differences():
    """CP-UHF (``test_aux_surface.py::test_cpuhf_fixed_point``): the AO
    density responses against the JAX function at 1e-8, with the spinless
    and the spin-triplet ERI forms, and against central differences of
    re-converged port UHF densities at 5e-6."""
    from quemb_tpu.matching import cphf as jcphf

    mf, vs, no = _h3_responses()
    eri = mf.get_eri()
    jus = jcphf.cphf_kernel_batch_u(mf.mo_coeff, mf.mo_energy, eri, no, vs)
    us = cphf.cphf_kernel_batch_u(mf.mo_coeff, mf.mo_energy,
                                  torch.as_tensor(eri), no, vs)
    trip = cphf.cphf_kernel_batch_u(
        mf.mo_coeff, mf.mo_energy, (torch.as_tensor(eri),) * 3, no,
        np.stack([np.stack([v, v]) for v in vs]))
    assert (trip - us).abs().max() < 1e-12
    h0 = mf.get_hcore()
    eps = 2e-5
    for i, v in enumerate(vs):
        dP = cphf.get_uhf_dP_from_u(mf.mo_coeff, no, us[i])
        jdP = jcphf.get_uhf_dP_from_u(mf.mo_coeff, no, jus[i])
        for a, b in zip(dP, jdP):
            assert np.abs(a.numpy() - b).max() < 1e-8
        dms = []
        for sgn in (1.0, -1.0):
            mfp = UHF(mf.mol, conv_tol=1e-13, device="cpu")
            mfp._hcore = h0 + sgn * eps * v
            mfp.kernel()
            assert mfp.converged
            dms.append(mfp.make_rdm1())
        dP_fd = (dms[0] - dms[1]) / (2 * eps)
        for s in (0, 1):
            assert np.abs(dP[s].numpy() - dP_fd[s]).max() < 5e-6


def test_cpump2_u_matches_jax():
    """Unrestricted CP-MP2 (``test_aux_surface.py::test_cpump2_fixed_point``)
    against the JAX function: 1e-8, both spins, both perturbations."""
    from quemb_tpu.matching import cphf as jcphf

    mf, vs, no = _h3_responses()
    eri = mf.get_eri()
    ref = jcphf._dPmp2_batch_u(mf.mo_coeff, mf.mo_energy, eri, no, vs)
    out = cphf._dPmp2_batch_u(mf.mo_coeff, mf.mo_energy,
                              torch.as_tensor(eri), no, vs)
    assert out.shape == (len(vs), 2, mf.mol.nao, mf.mol.nao)
    assert np.abs(out.numpy() - ref).max() < 1e-8


# ---------------------------------------------------------------- on a card
@pytest.mark.gpu
@on_card
def test_uhf_and_uccsd_on_card_match_cpu():
    """UHF on the OH doublet and UCCSD on its canonical orbitals, on the
    card and on the CPU: e_tot and E_corr 1e-10."""
    cpu = _uhf(OH, 1)
    card = _uhf(OH, 1, device="cuda")
    assert abs(card.e_tot - cpu.e_tot) < 1e-10
    na, nb = cpu.nelec
    es = []
    for dev in ("cpu", "cuda"):
        eri = torch.as_tensor(cpu.get_eri(), device=dev)
        Ca, Cb = (torch.as_tensor(c, device=dev) for c in cpu.mo_coeff)
        _, t2, e = solve_uccsd_so(
            _mo4(eri, Ca, Ca, Ca, Ca), _mo4(eri, Cb, Cb, Cb, Cb),
            _mo4(eri, Ca, Ca, Cb, Cb), np.diag(cpu.mo_energy[0]),
            np.diag(cpu.mo_energy[1]), na, nb,
        )
        assert t2[1].device.type == dev
        es.append(e)
    assert abs(es[0] - es[1]) < 1e-10


@pytest.mark.gpu
@on_card
def test_ube_on_card_matches_cpu():
    """H5 doublet BE2 one-shot UBE on the card and on the CPU: ebe_hf and
    ebe_tot 1e-9, the fragment ERIs on the card."""
    out = []
    for dev in ("cpu", "cuda"):
        mf = _uhf(H5, 1, device=dev)
        fobj = qt.fragmentate(
            mf.mol, n_BE=2, frag_type="chemgen", print_frags=False,
            additional_args=qt.ChemGenArgs(
                h_treatment="treat_H_like_heavy_atom"))
        ube = UBE(mf, fobj, device=dev)
        assert ube.Fobjs_a[0].eri.device.type == dev
        ube.oneshot()
        out.append((ube.ebe_hf, ube.ebe_tot))
    assert abs(out[0][0] - out[1][0]) < 1e-9
    assert abs(out[0][1] - out[1][1]) < 1e-9
