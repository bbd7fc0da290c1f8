"""Periodic integrals, density fitting and KRHF: the port's ``kbe`` against
the JAX package's, on the CPU.

- ``Cell.ewald``/``madelung`` and the supercell identities of
  ``tests/test_kbe.py:21-45``; ``s_t_kpts``, ``vnuc_kpts`` and
  ``ft_aopair_kpts`` at 1e-12 (host copies: the same code on the same
  cell);
- ``KGDF``: ``_j2c`` and ``_j3c`` at 1e-12, and the metric's half-inverse
  factor L against the JAX package's pseudo-inverse (L L^H, relative to
  its largest entry, 1e-12); ``get_jk`` on a
  seeded Hermitian density and ``emb_eri`` on seeded real supercell
  orbitals;
- ``KRHF`` on the H2-chain cell of ``tests/test_kbe.py:48-75`` with the
  default and the lean aux: ``e_tot`` against the JAX package's, and the
  cell/supercell equivalence through the port;

The port contracts with the aux metric through its half-inverse factor
(``KGDF._half_inv``), the JAX package through the explicit pseudo-inverse,
whose entries reach 1e9 / wmax (the metric keeps eigenvalues down to 1e-9
of the largest).  So both are held to the same sums in 80-bit extended
precision on the shared eigendecomposition, the port at 1e-10 (measured:
3e-12 default aux, 4e-13 lean), and to each other at the JAX package's
distance from those sums (measured: J 5.0e-9, K 8.3e-9, emb_eri 1.5e-8
with the default aux; 2.3e-10, 2.8e-10, 6.9e-10 with the lean one).  The
KRHF e_tot follows: the JAX package's moves by up to 1.6e-8 (lean:
6.0e-10) when one element of its starting density moves by one ulp, so
e_tot is held at 5e-8 with the default aux and 1e-9 with the lean one;
- without a card, ``KRHF``, ``KGDF`` and ``ExactFourCenter`` raise unless
  the CPU is named.

Each cell's KGDF is built once per package (module fixtures): the host
lattice sums are nearly all of this file's time.
"""

import numpy as np
import pytest
import torch

from quemb_tpu.kbe import Cell as JCell
from quemb_tpu.kbe import KRHF as JKRHF
from quemb_tpu.kbe import df as jdf
from quemb_tpu.kbe import exact4c as jexact
from quemb_tpu.kbe import pbc_int as jpbc
from quemb_tpu_torch.kbe import KGDF, KRHF, Cell, make_etb_aux
from quemb_tpu_torch.kbe import pbc_int
from quemb_tpu_torch.kbe.exact4c import ExactFourCenter

torch.set_num_threads(1)
try:
    # the host lattice sums of both packages run numpy BLAS; one thread
    # per test worker keeps the workers from oversubscribing the cores
    from threadpoolctl import threadpool_limits
except ImportError:
    pass
else:
    threadpool_limits(limits=1, user_api="blas")

CPU = dict(device="cpu")
#: tests/test_kbe.py:48-75: the dimerized H2 chain
CHAIN = ("H 0 0 0; H 0 0 0.8", np.diag([6.0, 6.0, 2.4]))
#: tests/test_kbe.py:28, :397-489: the zig-zag H2 cells
ZIGZAG = "H 0.5 0 0; H -0.5 0 1.6"


def _cells(atom, lat):
    return (Cell(atom=atom, a=lat, basis="sto-3g"),
            JCell(atom=atom, a=lat, basis="sto-3g"))


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else t


# ------------------------------------------------------------ cell, ints
def test_ewald_madelung_and_supercell_against_jax():
    c, jc = _cells("H 0 0 0; H 0 0 0.74", np.eye(3) * 6.0)
    assert abs(c.ewald(0.8) - c.ewald(2.0)) < 1e-12
    sup = c.supercell([1, 1, 3])
    assert abs(3 * c.ewald() - sup.ewald()) < 1e-10
    assert abs(c.ewald() - jc.ewald()) < 1e-12
    assert abs(c.madelung() - jc.madelung()) < 1e-12
    jsup = jc.supercell([1, 1, 3])
    assert np.array_equal(sup.atom_coords(), jsup.atom_coords())
    assert np.array_equal(sup.a, jsup.a) and sup.nao == jsup.nao
    assert np.array_equal(c.make_kpts([1, 1, 3]), jc.make_kpts([1, 1, 3]))


def test_integrals_against_jax_and_identities():
    c, jc = _cells(ZIGZAG, np.diag([8.0, 8.0, 3.2]))
    kpts = c.make_kpts([1, 1, 3])
    Sk, Tk = pbc_int.s_t_kpts(c, kpts)
    jSk, jTk = jpbc.s_t_kpts(jc, kpts)
    assert np.abs(Sk - jSk).max() < 1e-12 and np.abs(Tk - jTk).max() < 1e-12
    V1 = pbc_int.vnuc_kpts(c, kpts, omega=0.3, S_k=Sk)
    V2 = pbc_int.vnuc_kpts(c, kpts, omega=0.5, S_k=Sk)
    assert np.abs(V1 - V2).max() < 1e-10
    assert np.abs(V1 - jpbc.vnuc_kpts(jc, kpts, omega=0.3, S_k=jSk)).max() \
        < 1e-12
    Gq = c.get_Gv(3.0, q=kpts[1]) + kpts[1]
    rho = pbc_int.ft_aopair_kpts(c, Gq, kpts)
    assert np.abs(rho - jpbc.ft_aopair_kpts(jc, Gq, kpts)).max() < 1e-12
    # k-mesh vs supercell phase-reconstruction identity
    sup = c.supercell([1, 1, 3])
    Ssup, _ = pbc_int.s_t_kpts(sup, np.zeros((1, 3)))
    Ts = np.array([i * c.a[2] for i in range(3)])
    ph = np.exp(1j * (Ts @ kpts.T))
    Srec = np.einsum("Rk,kuv,Sk->RuSv", ph, Sk, ph.conj()).reshape(
        3 * c.nao, 3 * c.nao) / 3
    assert np.abs(Srec - Ssup[0]).max() < 1e-12


# ------------------------------------------------------------ KGDF, KRHF
@pytest.fixture(scope="module")
def chain_krhf():
    """The H2 chain's KRHF in both packages, default and lean aux:
    {aux: (port mf, JAX mf)}, and the cells and k-points."""
    c, jc = _cells(*CHAIN)
    kpts = c.make_kpts([1, 1, 2])
    out = {}
    for aux in ("default", "lean"):
        kw, jkw = {}, {}
        if aux == "lean":
            kw = dict(with_df=KGDF(c, kpts, omega=0.6,
                                   auxbasis=make_etb_aux(c), **CPU))
            jkw = dict(with_df=jdf.KGDF(jc, kpts, omega=0.6,
                                        auxbasis=jdf.make_etb_aux(jc)))
        mf = KRHF(c, kpts, omega=0.6, **kw, **CPU)
        mf.kernel()
        jmf = JKRHF(jc, kpts, omega=0.6, **jkw)
        jmf.kernel()
        out[aux] = (mf, jmf)
    return out, c, jc, kpts


def _folded_orbitals(cell, kpts, neo, seed):
    """Per-k coefficients [nk, nao, neo] of seeded real supercell
    orbitals (the form kbe's Schmidt bases have)."""
    nk, nao = len(kpts), cell.nao
    TA_sup = np.random.default_rng(seed).standard_normal((nk * nao, neo))
    Ts = np.array([i * cell.a[2] for i in range(nk)])
    ph = np.exp(-1j * (Ts @ kpts.T))
    return np.einsum("rk,rue->kue", ph, TA_sup.reshape(nk, nao, neo))


def _hermitian(nk, nao, seed):
    rng = np.random.default_rng(seed)
    dm = rng.standard_normal((nk, nao, nao)) \
        + 1j * rng.standard_normal((nk, nao, nao))
    return 0.5 * (dm + np.conj(dm.transpose(0, 2, 1)))


def _extended_reference(jg, cell, kpts, dm, TA):
    """J, K and emb_eri from the JAX KGDF's tensors, summed in 80-bit
    extended precision with the pseudo-inverse formed there from the
    metric's float64 eigendecomposition (the one both packages take)."""
    X = np.clongdouble
    nk, nao, naux = len(kpts), cell.nao, jg.naux
    pinv = []
    for M in jg._j2c:
        w, V = np.linalg.eigh(M)
        keep = w > 1e-9 * np.abs(w).max()
        Vk = V[:, keep].astype(X)
        pinv.append(((Vk / w[keep].astype(np.longdouble)) @ Vk.conj().T)
                    .conj())
    j3 = [np.asarray(a, dtype=X).reshape(nk, naux, nao, nao)
          for a in jg._j3c]
    dm, TA = dm.astype(X), TA.astype(X)
    iq0 = int(jg.kpair_q[0, 0])
    rho = pinv[iq0] @ np.einsum("kpls,ksl->p", j3[iq0], dm) / nk
    J = np.einsum("kpuv,p->kuv", j3[iq0], rho)
    K = np.zeros((nk, nao, nao), dtype=X)
    for k in range(nk):
        for kp in range(nk):
            iq, iqr = int(jg.kpair_q[k, kp]), int(jg.kpair_q[kp, k])
            t = np.einsum("pml,ls->pms", j3[iq][kp], dm[kp])
            K[k] += np.einsum("pms,pq,qsn->mn", t, pinv[iq], j3[iqr][k]) / nk
    neo = TA.shape[-1]
    A = np.zeros((len(j3), naux, neo, neo), dtype=X)
    for a in range(nk):
        for b in range(nk):
            iq = int(jg.kpair_q[a, b])
            A[iq] += np.einsum("puv,ui,vj->pij", j3[iq][b], TA[a].conj(),
                               TA[b])
    keys = [jdf._wrap_q_key(cell, q) for q in jg.qlist]
    eri = sum(A[iq].reshape(naux, -1).T @ pinv[iq]
              @ A[keys.index(jdf._wrap_q_key(cell, -q))].reshape(naux, -1)
              for iq, q in enumerate(jg.qlist))
    eri = (eri / nk**3).real.reshape((neo,) * 4)
    eri = 0.5 * (eri + eri.transpose(1, 0, 3, 2))
    eri = 0.5 * (eri + eri.transpose(2, 3, 0, 1))
    herm = [0.5 * (x + x.conj().transpose(0, 2, 1)) for x in (J, K)]
    return herm + [eri]


@pytest.mark.parametrize("aux, jk_tol, eri_tol",
                         [("default", 2e-8, 3e-8), ("lean", 1e-9, 2e-9)])
def test_kgdf_tensors_jk_and_emb_eri_against_jax(chain_krhf, aux, jk_tol,
                                                 eri_tol):
    cases, c, jc, kpts = chain_krhf
    g, jg = (m.with_df for m in cases[aux])
    assert g.naux == jg.naux and np.array_equal(g.kpair_q, jg.kpair_q)
    assert isinstance(g._j3c, torch.Tensor) and g._j3c.dtype == \
        torch.complex128
    for a, b in zip(g._j2c, jg._j2c):
        assert np.abs(a - b).max() < 1e-12
    for iq in range(len(jg._j3c)):
        assert np.abs(_np(g._j3c[iq]) - jg._j3c[iq]).max() < 1e-12
        L = _np(g._j2c_half[iq])
        pinv = jg._j2c_pinv[iq]
        assert np.abs(L @ L.conj().T - pinv).max() \
            < 1e-12 * np.abs(pinv).max()
    dm = _hermitian(len(kpts), c.nao, 3)
    TA = _folded_orbitals(c, kpts, 3, 5)
    got = [*g.get_jk(dm), g.emb_eri(TA)]
    assert got[2].dtype == torch.float64
    for x, y, z, tol in zip(got, [*jg.get_jk(dm), jg.emb_eri(TA)],
                            _extended_reference(jg, jc, kpts, dm, TA),
                            (jk_tol, jk_tol, eri_tol)):
        assert x.shape == y.shape
        assert np.abs(_np(x) - z).max() < 1e-10
        assert np.abs(_np(x) - y).max() < tol


@pytest.mark.parametrize("aux, tol", [("default", 5e-8), ("lean", 1e-9)])
def test_krhf_against_jax(chain_krhf, aux, tol):
    cases, _, _, _ = chain_krhf
    mf, jmf = cases[aux]
    assert mf.converged and jmf.converged
    assert abs(mf.e_tot - jmf.e_tot) < tol
    assert np.abs(mf.mo_energy - jmf.mo_energy).max() < 1e-7
    assert np.abs(mf.hf_dm - mf.make_rdm1()).max() < 1e-12
    assert np.abs(mf.make_rdm1() - jmf.make_rdm1()).max() < 1e-7
    for a in (mf.mo_coeff, mf.hf_veff, mf.get_ovlp(), mf.get_hcore()):
        assert isinstance(a, np.ndarray) and a.dtype == np.complex128


def test_krhf_supercell_equivalence(chain_krhf):
    cases, c, _, kpts = chain_krhf
    sup = c.supercell([1, 1, 2])
    k0 = np.zeros((1, 3))
    esup = KRHF(sup, k0, omega=0.6, **CPU).kernel()
    # the default aux's measured fit-consistency floor (tests/test_kbe.py)
    assert abs(cases["default"][0].e_tot - esup / 2) < 5e-8
    esup0 = KRHF(sup, k0, with_df=KGDF(sup, k0, omega=0.6,
                                       auxbasis=make_etb_aux(sup), **CPU),
                 omega=0.6, **CPU).kernel()
    assert abs(cases["lean"][0].e_tot - esup0 / 2) < 1e-9


# ------------------------------------------------------- ExactFourCenter
@pytest.fixture(scope="module")
def zigzag_exact():
    c, jc = _cells(ZIGZAG, np.diag([6.0, 6.0, 3.2]))
    kpts = c.make_kpts([1, 1, 2])
    return (c, jc, kpts, ExactFourCenter(c, kpts, omega=0.6, **CPU).build(),
            jexact.ExactFourCenter(jc, kpts, omega=0.6).build())


def test_exact4c_against_jax(zigzag_exact):
    c, _, kpts, ex, jex = zigzag_exact
    assert np.abs(_np(ex._eri) - np.stack(jex._eri)).max() < 1e-12
    dm = _hermitian(len(kpts), c.nao, 7)
    for x, y in zip(ex.get_jk(dm), jex.get_jk(dm)):
        assert np.abs(_np(x) - y).max() < 1e-10
    TA = _folded_orbitals(c, kpts, 3, 5)
    assert np.abs(_np(ex.emb_eri(TA)) - jex.emb_eri(TA)).max() < 1e-10


def test_exact4c_omega_independence_and_df_limit(zigzag_exact):
    """tests/test_kbe.py:397-450 through the port."""
    c, _, kpts, ex, _ = zigzag_exact
    dm = _hermitian(len(kpts), c.nao, 7)
    J1, K1 = (_np(t) for t in ex.get_jk(dm))
    J2, K2 = (_np(t) for t in ExactFourCenter(c, kpts, omega=0.45, **CPU)
              .build().get_jk(dm))
    assert np.abs(J1 - J2).max() < 1e-8 and np.abs(K1 - K2).max() < 1e-8
    assert np.abs(J1 - np.conj(J1.transpose(0, 2, 1))).max() < 1e-12

    def df_jk(**aux):
        g = KGDF(c, kpts, auxbasis=make_etb_aux(c, **aux), **CPU).build()
        return (_np(t) for t in g.get_jk(dm))

    Jd, Kd = df_jk(beta=1.4)
    Jd2, _ = df_jk(beta=1.15)
    assert np.abs(J1 - Jd).max() < 5e-3 and np.abs(K1 - Kd).max() < 5e-3
    assert np.abs(Jd - Jd2).max() < 5e-4
    Jd1, Kd1 = df_jk(beta=1.4, l_extra=1)
    assert np.abs(J1 - Jd1).max() < 2e-4 and np.abs(K1 - Kd1).max() < 2e-4


def test_exact4c_emb_eri_supercell_folding(zigzag_exact):
    """tests/test_kbe.py:453-489 through the port: the k-mesh exact
    emb_eri equals the supercell-Gamma one, with its 8-fold symmetry."""
    c, _, kpts, ex, _ = zigzag_exact
    c2, _ = _cells(ZIGZAG, np.diag([6.0, 6.0, 3.2]))
    sup = c2.supercell([1, 1, 2])
    nao, neo = c.nao, 3
    TA_sup = np.random.default_rng(5).standard_normal((2 * nao, neo))
    TA_k = _folded_orbitals(c, kpts, neo, 5)
    e_k = _np(ex.emb_eri(TA_k))
    e_s = _np(ExactFourCenter(sup, np.zeros((1, 3)), **CPU).build()
              .emb_eri(TA_sup[None]))
    assert np.abs(e_k - e_s).max() < 1e-10
    assert np.allclose(e_k, e_k.transpose(1, 0, 3, 2), atol=1e-10)
    assert np.allclose(e_k, e_k.transpose(2, 3, 0, 1), atol=1e-10)


def test_no_card_no_default_device():
    """No device named means the card; without one these raise."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    c, _ = _cells(*CHAIN)
    kpts = c.make_kpts([1, 1, 2])
    for make in (lambda: KRHF(c, kpts), lambda: KGDF(c, kpts),
                 lambda: ExactFourCenter(c, kpts)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
