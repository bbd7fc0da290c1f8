"""Spin-orbital CCSD: the port's fused-matrix update, block builds,
iteration and routing against the JAX package's.

- one ``ccsd_update_mat`` step on seeded amplitudes and antisymmetrized
  blocks, with and without the off-diagonal Fock blocks: 1e-12; the plain
  einsum update ``_ccsd_update`` against its JAX original and against the
  fused form: 1e-12;
- the gather-free block build ``so_blocks`` against the JAX package's
  ``so_blocks_jax`` and its gather build ``_so_blocks_host``: 1e-12;
- ``solve_ccsd_so`` on an H8 BE2 fragment against the JAX function and
  against the port's closed-shell kernel at batch 1
  (``_rccsd_from_mo_batched``): E_corr 1e-9; ``_ccsd_so_batched`` at
  batch 1 and ``ccsd_so_batched`` on the same fragment, and the f32-only
  tier at 1e-5;
- the unrelaxed RDMs and ``solve_ccsd`` against the JAX functions: 1e-9;
- ``be_func`` on H8 BE2 under ``QUEMB_TPU_CCSD_SPINORB=1`` against the
  JAX package's: energies and error vector 1e-8, cumulant and not.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import quemb_tpu as jq
import quemb_tpu_torch as qt
from quemb_tpu.chem.mole import Mole as JMole
from quemb_tpu.chem.scf import RHF as JRHF
from quemb_tpu.solvers import ccsd as jccsd
from quemb_tpu.solvers import ccsd_mat as jmat
from quemb_tpu.solvers import dispatch as jax_dispatch
from quemb_tpu_torch.chem.mole import Mole
from quemb_tpu_torch.chem.scf import RHF
from quemb_tpu_torch.solvers import ccsd as tccsd
from quemb_tpu_torch.solvers import ccsd_mat as tmat
from quemb_tpu_torch.solvers import dispatch, rccsd

torch.set_num_threads(1)

H8 = "\n".join(f"H 0 0 {i}." for i in range(8))
BLOCKS = ("oovv", "ovvv", "ooov", "oooo", "vvvv", "ovov", "ovvo", "ovoo",
          "vvvo")


@pytest.fixture(autouse=True)
def _plain_f64_modes(monkeypatch):
    """Pin the JAX package's backend-dependent CCSD mode (mixed precision
    off), and start from the defaults on both sides."""
    monkeypatch.setenv("QUEMB_TPU_CCSD_MIXED", "0")
    for var in ("QUEMB_TPU_CCSD_F32_ONLY", "QUEMB_TPU_INCORE_CD",
                "QUEMB_TPU_CCSD_CONV_TOL", "QUEMB_TPU_CCSD_SPINORB"):
        monkeypatch.delenv(var, raising=False)


def _chemist(nmo, seed):
    """A real ERI with the 8-fold symmetry, from a seed."""
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((nmo, nmo, 11))
    L = L + L.transpose(1, 0, 2)
    return 0.1 * np.einsum("pqx,rsx->pqrs", L, L)


def _so_case(seed, nmo=6, nsocc=2):
    """Spin-orbital blocks of a seeded chemist ERI (through the JAX
    package's gather build), orbital energies, amplitudes and Fock
    blocks."""
    rng = np.random.default_rng(seed)
    eri = _chemist(nmo, seed)
    moe = np.sort(rng.standard_normal(nmo))
    moe[nsocc:] += 3.0
    g = np.asarray(jccsd._spin_antisym(eri, nmo))
    occ = list(range(nsocc)) + list(range(nmo, nmo + nsocc))
    order = np.array(occ + [p for p in range(2 * nmo) if p not in occ])
    g = g[np.ix_(order, order, order, order)]
    no, nv = 2 * nsocc, 2 * (nmo - nsocc)
    o, v = slice(0, no), slice(no, None)
    sl = dict(o=o, v=v)
    blocks = {k: g[sl[k[0]], sl[k[1]], sl[k[2]], sl[k[3]]] for k in BLOCKS}
    moe_so = np.concatenate([moe, moe])[order]
    t1 = 0.05 * rng.standard_normal((no, nv))
    t2 = 0.05 * rng.standard_normal((no, no, nv, nv))
    t2 = t2 - t2.transpose(1, 0, 2, 3)
    t2 = t2 - t2.transpose(0, 1, 3, 2)
    f = 0.02 * rng.standard_normal((no + nv, no + nv))
    f = f + f.T
    f_blocks = (f[o, o] - np.diag(np.diag(f[o, o])), f[o, v],
                f[v, v] - np.diag(np.diag(f[v, v])))
    return dict(eri=eri, moe=moe, blocks=blocks, moe_o=moe_so[:no],
                moe_v=moe_so[no:], t1=t1, t2=t2, f=f_blocks, no=no, nv=nv,
                nsocc=nsocc)


def _t(a):
    return torch.as_tensor(np.asarray(a))[None]


@pytest.mark.parametrize("with_f", [False, True], ids=["canonical", "fock"])
def test_update_mat_matches_jax(with_f):
    c = _so_case(3)
    no, nv = c["no"], c["nv"]
    fb_j = jmat.fused_blocks({k: jnp.asarray(b) for k, b in
                              c["blocks"].items()}, no, nv)
    fb_t = tmat.fused_blocks({k: _t(b) for k, b in c["blocks"].items()},
                             no, nv)
    assert tuple(fb_t) == tmat.BLOCK_KEYS == jmat.BLOCK_KEYS
    for k in tmat.BLOCK_KEYS:
        assert np.abs(fb_t[k][0].numpy() - np.asarray(fb_j[k])).max() < 1e-12
    T2p = c["t2"].reshape(no * no, nv * nv)
    fj = {} if not with_f else dict(zip(
        ("f_oo_off", "f_ov", "f_vv_off"), (jnp.asarray(a) for a in c["f"])))
    ft = {} if not with_f else dict(zip(
        ("f_oo_off", "f_ov", "f_vv_off"), (_t(a) for a in c["f"])))
    ref = jmat.ccsd_update_mat(jnp.asarray(c["t1"]), jnp.asarray(T2p),
                               jnp.asarray(c["moe_o"]),
                               jnp.asarray(c["moe_v"]), fb_j, **fj)
    out = tmat.ccsd_update_mat(_t(c["t1"]), _t(T2p), _t(c["moe_o"]),
                               _t(c["moe_v"]), fb_t, **ft)
    for a, b in zip(out, ref):
        assert np.abs(a[0].numpy() - np.asarray(b)).max() < 1e-12
    # the plain SGWB einsums: against the JAX original and the fused form
    args = [torch.as_tensor(c[k]) for k in ("t1", "t2", "moe_o", "moe_v")]
    args += [torch.as_tensor(c["blocks"][k]) for k in BLOCKS]
    fe = {} if not with_f else {k: v[0] for k, v in ft.items()}
    plain = tccsd._ccsd_update(*args, **fe)
    jplain = jccsd._ccsd_update(*(jnp.asarray(a.numpy()) for a in args),
                                **fj)
    for a, b, m in zip(plain, jplain, out):
        assert np.abs(a.numpy() - np.asarray(b)).max() < 1e-12
        assert np.abs(a.numpy().reshape(-1)
                      - m[0].numpy().reshape(-1)).max() < 1e-12


@pytest.mark.parametrize("nmo,nsocc", [(6, 2), (5, 3)])
def test_block_builds_match_jax(nmo, nsocc):
    eri = _chemist(nmo, nmo)
    moe = np.linspace(-1.0, 2.0, nmo)
    fb_j, mo_j, mv_j = jccsd.so_blocks_jax(jnp.asarray(eri),
                                           jnp.asarray(moe), nsocc)
    fb_t, mo_t, mv_t = tccsd.so_blocks(_t(eri), _t(moe), nsocc)
    fh_j, mho_j, mhv_j = jccsd._so_blocks_host(eri, moe, nsocc)
    for k, a in zip(tmat.BLOCK_KEYS, fb_j):
        assert np.abs(fb_t[k][0].numpy() - np.asarray(a)).max() < 1e-12
        assert np.abs(fb_t[k][0].numpy() - fh_j[k]).max() < 1e-12
    for a, b in ((mo_t, mo_j), (mv_t, mv_j), (mo_t, mho_j), (mv_t, mhv_j)):
        assert np.abs(a[0].numpy() - np.asarray(b)).max() < 1e-15


# --------------------------------------------------- an H8 BE2 fragment
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


@pytest.fixture(scope="module")
def h8_fragment(h8_pair):
    """The widest H8 fragment's SCF orbitals and MO integrals."""
    _, be = h8_pair
    fr = max(be.fragments, key=lambda f: f.nao)
    moe, C = dispatch.run_fragment_scf(fr)
    eri_mo = dispatch._batched_mo_eri(fr.eri[None], C[None])[0]
    return fr, C, moe, eri_mo


def test_solve_ccsd_so_matches_jax_and_rccsd(h8_fragment):
    fr, _, moe, eri_mo = h8_fragment
    ns = fr.nsocc
    t1, t2, e = tccsd.solve_ccsd_so(eri_mo, moe, ns)
    jt1, jt2, je = jccsd.solve_ccsd_so(eri_mo.numpy(), moe.numpy(), ns)
    assert abs(e - je) < 1e-9
    assert e < -1e-3
    rt1, rt2, _, delta = rccsd._rccsd_from_mo_batched(eri_mo[None],
                                                      moe[None], ns)
    assert float(delta[0]) <= 1e-9
    ovov = eri_mo[:ns, ns:, :ns, ns:]
    tau = rt2[0] + torch.einsum("ia,jb->ijab", rt1[0], rt1[0])
    e_r = float(torch.einsum("ijab,iajb->", tau, 2.0 * ovov)
                - torch.einsum("ijab,ibja->", tau, ovov))
    assert abs(e - e_r) < 1e-9
    # a bucket of one, as the plan solves a wide fragment, and the
    # mesh-sharded entry give the same
    lt1, lt2, _, _ = tccsd._ccsd_so_batched(eri_mo[None], moe[None], ns)
    bt1, bt2, _, _ = tccsd.ccsd_so_batched(eri_mo[None], moe[None], ns)
    for a in (lt1[0], bt1[0]):
        assert (a - t1).abs().max() < 1e-9
    for a in (lt2[0], bt2[0]):
        assert (a - t2).abs().max() < 1e-9


def test_f32_tier_matches_f64(h8_fragment, monkeypatch):
    fr, _, moe, eri_mo = h8_fragment
    ns = fr.nsocc
    t1, t2, _, _ = tccsd.ccsd_so_batched(eri_mo[None], moe[None], ns)
    monkeypatch.setenv("QUEMB_TPU_CCSD_F32_ONLY", "1")
    t1f, t2f, _, delta = tccsd.ccsd_so_batched(eri_mo[None], moe[None], ns)
    rt1, rt2, _, rdelta = rccsd._rccsd_from_mo_batched(
        eri_mo[None], moe[None], ns, f32_only=True)
    assert t1f.dtype == t2f.dtype == rt2.dtype == torch.float64
    assert max(float(delta.max()), float(rdelta.max())) <= 1e-5
    for a, b in ((t1f[0], t1[0]), (t2f[0], t2[0]), (rt1[0], t1[0]),
                 (rt2[0], t2[0])):
        assert (a - b).abs().max() < 1e-5


@pytest.mark.parametrize("use_cumulant", [True, False])
def test_rdms_and_solve_ccsd_match_jax(h8_fragment, use_cumulant):
    fr, C, moe, _ = h8_fragment
    Cn, moen = C.numpy(), moe.numpy()

    class JFrag:  # what the JAX entry reads and writes
        eri, nsocc = fr.eri.numpy(), fr.nsocc

    rdm1, rdm2 = tccsd.solve_ccsd(fr, Cn, moen, use_cumulant=use_cumulant)
    jrdm1, jrdm2 = jccsd.solve_ccsd(JFrag, Cn, moen,
                                    use_cumulant=use_cumulant)
    assert np.abs(rdm1.numpy() - jrdm1).max() < 1e-9
    assert np.abs(rdm2.numpy() - jrdm2).max() < 1e-9
    t1, t2 = fr.t1.numpy(), fr.t2.numpy()
    assert np.abs(tccsd.make_rdm1_ccsd_t1(fr.t1).numpy()
                  - jccsd.make_rdm1_ccsd_t1(t1)).max() < 1e-12
    assert np.abs(tccsd.make_rdm2_urlx(fr.t1, fr.t2, not use_cumulant)
                  .numpy() - jccsd.make_rdm2_urlx(t1, t2, not use_cumulant)
                  ).max() < 1e-12
    with pytest.raises(NotImplementedError, match="relaxed"):
        tccsd.solve_ccsd(fr, Cn, moen, relax=True)


# ------------------------------------------- the objective under SPINORB
@pytest.mark.parametrize("use_cumulant", [True, False])
def test_spinorb_objective_matches_jax(h8_pair, monkeypatch, use_cumulant):
    """be_func with the spin-orbital kernel (the JAX package needs the
    merge switch off beside it; the port plans no merged buckets):
    energies, error norm and error vector at 1e-8, and the same energy as
    the closed-shell kernel's."""
    jbe, be = h8_pair
    pot = np.random.default_rng(4).standard_normal(len(be.pot)) * 1e-3
    kw = dict(eeval=True, return_vec=True, use_cumulant=use_cumulant)
    closed = dispatch.be_func(pot, be.fragments, be.Nocc, "CCSD", **kw)
    monkeypatch.setenv("QUEMB_TPU_CCSD_SPINORB", "1")
    monkeypatch.setenv("QUEMB_TPU_MERGE_BUCKETS", "0")
    ref = jax_dispatch.be_func(pot, jbe.fragments, jbe.Nocc, "CCSD", **kw)
    out = dispatch.be_func(pot, be.fragments, be.Nocc, "CCSD", **kw)
    assert abs(out[0] - ref[0]) < 1e-8
    assert np.abs(out[1] - ref[1]).max() < 1e-8
    assert abs(out[2][0] - ref[2][0]) < 1e-8
    assert np.abs(np.array(out[2][1]) - np.array(ref[2][1])).max() < 1e-8
    assert abs(out[2][0] - closed[2][0]) < 1e-8
    plan = dispatch.form_merge_classes(be.fragments, "CCSD")
    assert all(p == (0, 0) for c in plan for _, p in c)
