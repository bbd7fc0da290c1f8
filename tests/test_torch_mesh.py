"""The port's fragment mesh (``quemb_tpu_torch/parallel/mesh.py``): sharded
equals unsharded, and equals the JAX package's sharded run, on the CPU.

H8 STO-3G BE2 chemgen, built as ``tests/test_mesh.py`` builds it (6
fragments in one bucket), on meshes of CPU shards:

- one-shot CCSD under 2, 3, 4 and 8 shards against no mesh: energies,
  fragment energies and embedding 1-RDMs at 1e-10 (8 shards is more than
  the bucket's fragments, 4 does not divide them); ``optimize(solver=
  "MP2")`` at 1e-8;
- the same two runs under the JAX package's 8-device mesh (the virtual
  CPU devices of ``tests/conftest.py``) against the port's 8 shards: 1e-8;
- under 2 shards: merged-bucket padding, the spin-orbital kernel
  (``QUEMB_TPU_CCSD_SPINORB=1``), FCI (host CI buckets) at 1e-10, and the
  f32-only tier (``QUEMB_TPU_CCSD_F32_ONLY=1``) at 1e-8;
- kBE H4 ``optimize(solver="CCSD", only_chem=True)`` under 2 shards;
- ``rccsd_batched`` (with and without a mesh), ``rhf_orthonormal_batched``
  and ``lowdin_localize`` against the JAX functions on seeded inputs, and
  ``entry.entry`` against ``__graft_entry__._solve_step``;
- ``shard_batch`` and ``shard_ranges``, ``make_fragment_mesh`` without a
  card, and an exception in one shard raising out of ``be_func``.

The JAX package is imported inside the tests, so that the ``gpu`` test
(mesh ``(cuda:0, cpu)`` against no mesh on the card) runs where JAX is
absent:

    python -m pytest --noconftest -m gpu tests/test_torch_mesh.py
"""

from contextlib import contextmanager
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import quemb_tpu_torch as qt
from quemb_tpu_torch.chem.mole import Mole
from quemb_tpu_torch.chem.scf import RHF
from quemb_tpu_torch.parallel import mesh
from quemb_tpu_torch.solvers import dispatch

torch.set_num_threads(1)

H8 = "; ".join(f"H 0 0 {i * 1.0}" for i in range(8))
TOL = 1e-10  # sharded against unsharded, one evaluation
MATCHED_TOL = 1e-8  # after a matching loop, and against the JAX package


@pytest.fixture(autouse=True)
def _plain_modes(monkeypatch):
    """Pin the JAX package's backend-dependent CCSD mode (mixed precision
    off), and start from the defaults on both sides."""
    monkeypatch.setenv("QUEMB_TPU_CCSD_MIXED", "0")
    for var in ("QUEMB_TPU_CCSD_F32_ONLY", "QUEMB_TPU_INCORE_CD",
                "QUEMB_TPU_CCSD_CONV_TOL", "QUEMB_TPU_CCSD_SPINORB"):
        monkeypatch.delenv(var, raising=False)


@contextmanager
def port_mesh(devices):
    """The port's fragment mesh over ``devices`` for the block, removed
    after it whatever happens."""
    mesh.set_mesh(mesh.make_fragment_mesh(devices))
    try:
        yield
    finally:
        mesh.set_mesh(None)


@pytest.fixture(scope="module")
def h8():
    mol = Mole(atom=H8, basis="sto-3g")
    mf = RHF(mol, conv_tol=1e-12, device="cpu")
    mf.kernel()
    fobj = qt.fragmentate(mol=mol, n_BE=2, frag_type="chemgen",
                          print_frags=False)
    return mf, fobj


def _state(be):
    """What a sharded run must reproduce: the total, every fragment's
    energy and embedding 1-RDM."""
    return (be.ebe_tot, np.array([fr.ebe for fr in be.fragments]),
            [fr._rdm1.copy() for fr in be.fragments])


def _assert_same(a, b, tol):
    assert abs(a[0] - b[0]) < tol
    assert np.abs(a[1] - b[1]).max() < tol
    for x, y in zip(a[2], b[2]):
        assert np.abs(x - y).max() < tol


def _run(mf, fobj, how, solver):
    be = qt.BE(mf, fobj, device="cpu")
    if how == "oneshot":
        be.oneshot(solver)
    else:
        be.optimize(solver)
    return be


@pytest.fixture
def chunk_sizes(monkeypatch):
    """The fragment counts of the chunks ``_solve_bucket_batched`` gets."""
    sizes = []
    inner = dispatch._solve_bucket_batched

    def counted(frs, *args, **kwargs):
        sizes.append(len(frs))
        return inner(frs, *args, **kwargs)

    monkeypatch.setattr(dispatch, "_solve_bucket_batched", counted)
    return sizes


@pytest.mark.parametrize("how,solver,tol", [
    ("oneshot", "CCSD", TOL), ("optimize", "MP2", MATCHED_TOL),
])
@pytest.mark.parametrize("n_shards", [2, 3, 4, 8])
def test_sharded_equals_unsharded(h8, chunk_sizes, n_shards, how, solver,
                                  tol):
    mf, fobj = h8
    ref = _state(_run(mf, fobj, how, solver))
    del chunk_sizes[:]
    with port_mesh(["cpu"] * n_shards):
        be = _run(mf, fobj, how, solver)
    _assert_same(_state(be), ref, tol)
    n_frag = len(be.fragments)
    expect = [len(c) for c in np.array_split(np.arange(n_frag), n_shards)
              if len(c)]
    assert chunk_sizes[:len(expect)] == expect


@pytest.mark.parametrize("how,solver", [("oneshot", "CCSD"),
                                        ("optimize", "MP2")])
def test_sharded_matches_jax_sharded(how, solver):
    """The port on 8 CPU shards against the JAX package on its 8-device
    mesh, from the JAX package's mean field."""
    import jax

    import quemb_tpu as jq
    from quemb_tpu.chem.mole import Mole as JMole
    from quemb_tpu.chem.scf import RHF as JRHF
    from quemb_tpu.parallel import mesh as jmesh

    assert len(jax.devices()) == 8
    jmol = JMole(atom=H8, basis="sto-3g")
    jmf = JRHF(jmol, conv_tol=1e-12)
    jmf.kernel()
    mol = Mole(atom=H8, basis="sto-3g")
    mf = RHF.from_arrays(mol, jmf.get_hcore(), jmf.get_ovlp(),
                         jmf.get_eri(), jmf.mo_coeff, jmf.mo_energy,
                         jmf.e_tot)
    kw = dict(n_BE=2, frag_type="chemgen", print_frags=False)
    jmesh.set_mesh(jmesh.make_fragment_mesh(jax.devices()))
    try:
        jbe = jq.BE(jmf, jq.fragmentate(mol=jmol, **kw))
        getattr(jbe, how)(solver)
    finally:
        jmesh.set_mesh(None)
    with port_mesh(["cpu"] * 8):
        be = _run(mf, qt.fragmentate(mol=mol, **kw), how, solver)
    assert abs(be.ebe_tot - jbe.ebe_tot) < MATCHED_TOL
    assert np.abs(np.array([fr.ebe for fr in be.fragments])
                  - np.array([fr.ebe for fr in jbe.fragments])).max() \
        < MATCHED_TOL


def _padded_bucket(be, solver):
    """The merged-bucket path by hand: every fragment padded by one
    occupied and one virtual orbital, at a seeded potential."""
    pot = np.random.default_rng(1).standard_normal(len(be.pot)) * 1e-3
    for fr in be.fragments:
        fr.update_heff(pot)
    frs = be.fragments
    e = dispatch._solve_bucket(frs, solver, True, True, False,
                               pads=((1, 1),) * len(frs))
    return (sum(e), np.array([fr.ebe for fr in frs]),
            [fr._rdm1.copy() for fr in frs])


TWO_SHARD_CASES = {
    # name: (environment, run, tolerance)
    "merged-padding": ({}, lambda be: _padded_bucket(be, "CCSD"), TOL),
    "spin-orbital": ({"QUEMB_TPU_CCSD_SPINORB": "1"},
                     lambda be: _state(_oneshot(be, "CCSD")), TOL),
    "fci": ({}, lambda be: _state(_oneshot(be, "FCI")), TOL),
    "f32-only": ({"QUEMB_TPU_CCSD_F32_ONLY": "1"},
                 lambda be: _state(_oneshot(be, "CCSD")), MATCHED_TOL),
}


def _oneshot(be, solver):
    be.oneshot(solver)
    return be


@pytest.mark.parametrize("case", sorted(TWO_SHARD_CASES))
def test_two_shards_equal_no_mesh(h8, monkeypatch, case):
    env, run, tol = TWO_SHARD_CASES[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    mf, fobj = h8
    ref = run(qt.BE(mf, fobj, device="cpu"))
    with port_mesh(["cpu", "cpu"]):
        out = run(qt.BE(mf, fobj, device="cpu"))
    _assert_same(out, ref, tol)


def test_kbe_h4_chempot_matching_sharded():
    """kBE goes through the same ``be_func``: H4 BE2 chemgen (the cell of
    ``tests/test_torch_kbe.py``) matched on the chemical potential, under
    2 shards against no mesh."""
    from quemb_tpu_torch import kbe

    cell = kbe.Cell(atom="H 0 0 0; H 0 0 1.0; H 0 0 2.0; H 0 0 3.0",
                    a=np.diag([6.0, 6.0, 4.0]), basis="sto-3g")
    kmesh = [1, 1, 3]
    kpts = cell.make_kpts(kmesh)
    mf = kbe.KRHF(cell, kpts, omega=0.6, conv_tol=1e-11, device="cpu")
    mf.kernel()
    out = []
    for devices in (None, ["cpu", "cpu"]):
        be = kbe.BE(mf, kbe.fragmentate(mol=cell, kpt=kmesh, n_BE=2),
                    kpts=kpts)
        if devices is None:
            be.optimize(solver="CCSD", only_chem=True)
        else:
            with port_mesh(devices):
                be.optimize(solver="CCSD", only_chem=True)
        out.append((be.ebe_tot, np.array([fr.ebe for fr in be.fragments])))
    assert abs(out[1][0] - out[0][0]) < MATCHED_TOL
    assert np.abs(out[1][1] - out[0][1]).max() < MATCHED_TOL
    assert out[0][0] < -2.0  # a real energy, not a default


# ------------------------------------------------- the batched entry points
def _scf_bucket(seed=0, nf=3, nemb=6, nsocc=2):
    """A seeded bucket: one-body, two-body (positive semidefinite) and a
    starting density per fragment (numpy)."""
    from quemb_tpu_torch.entry import _example_bucket

    return _example_bucket(nf, nemb, nsocc, seed), nsocc


def test_rhf_orthonormal_batched_matches_jax():
    import jax.numpy as jnp

    from quemb_tpu.embed.fragment_scf import \
        rhf_orthonormal_batched as jax_scf
    from quemb_tpu_torch.embed.fragment_scf import rhf_orthonormal_batched

    (h, eri, dm0), nsocc = _scf_bucket()
    je, jC, jel, _ = (np.asarray(a) for a in jax_scf(
        jnp.asarray(h), jnp.asarray(eri), nsocc, jnp.asarray(dm0)))
    e, C, el, _ = (a.numpy() for a in rhf_orthonormal_batched(
        *(torch.as_tensor(a) for a in (h, eri)), nsocc, torch.as_tensor(dm0)))
    assert np.abs(el - jel).max() < 1e-10
    assert np.abs(e - je).max() < 1e-10

    def density(C):
        return C[:, :, :nsocc] @ C[:, :, :nsocc].transpose(0, 2, 1)

    assert np.abs(density(C) - density(jC)).max() < 1e-10


@pytest.mark.parametrize("n_shards", [None, 2])
def test_rccsd_batched_matches_jax(n_shards):
    """Closed-shell CCSD amplitudes from the same MO integrals and orbital
    energies (the JAX package's fragment SCF on a seeded bucket of 3)."""
    import jax.numpy as jnp

    from quemb_tpu.embed.fragment_scf import \
        rhf_orthonormal_batched as jax_scf
    from quemb_tpu.solvers.rccsd import rccsd_batched as jax_rccsd
    from quemb_tpu_torch.solvers.rccsd import rccsd_batched

    (h, eri, dm0), nsocc = _scf_bucket(seed=3)
    moe, C, _, _ = (np.array(a) for a in jax_scf(
        jnp.asarray(h), jnp.asarray(eri), nsocc, jnp.asarray(dm0)))
    eri_mo = np.einsum("fpqrs,fpi,fqj,frk,fsl->fijkl", eri, C, C, C, C)
    jt1, jt2, _, jdelta = (np.asarray(a)
                           for a in jax_rccsd(eri_mo, moe, nsocc))
    if n_shards is None:
        out = rccsd_batched(eri_mo, moe, nsocc)
    else:
        with port_mesh(["cpu"] * n_shards):
            out = rccsd_batched(eri_mo, moe, nsocc)
    t1, t2, it, delta = (a.numpy() for a in out)
    assert t1.shape == jt1.shape and t2.shape == jt2.shape
    assert np.abs(t1 - jt1).max() < 1e-8
    assert np.abs(t2 - jt2).max() < 1e-8
    assert np.abs(t2).max() > 1e-4
    assert delta.max() < 1e-9 and jdelta.max() < 1e-9


def test_lowdin_localize_matches_jax():
    from quemb_tpu.lo import lowdin_localize as jax_localize
    from quemb_tpu_torch.lo import lowdin_localize

    rng = np.random.default_rng(4)
    A = rng.standard_normal((7, 7))
    S = A @ A.T / 7 + np.eye(7)
    C = rng.standard_normal((7, 5))
    jW, jL = (np.asarray(a) for a in jax_localize(S, C))
    W, L = (a.numpy() for a in lowdin_localize(S, C))
    assert np.abs(W.T @ S @ W - np.eye(7)).max() < 1e-12
    assert np.abs(W - jW).max() < 1e-10
    assert np.abs(L - jL).max() < 1e-10


def test_entry_matches_graft_entry():
    import jax

    import __graft_entry__ as graft
    from quemb_tpu_torch.entry import _example_bucket, entry

    step, args = entry(device="cpu")
    assert all(a.device.type == "cpu" for a in args)
    t1, t2, e_el, rdm1, delta = step(*args)
    nsocc = 2
    ref = jax.jit(graft._solve_step(nsocc))(
        *graft._example_bucket(4, 8, nsocc))
    for a, b in zip(args, _example_bucket(4, 8, nsocc)):
        assert np.array_equal(a.numpy(), b)
    assert np.abs(e_el.numpy() - np.asarray(ref[2])).max() < 1e-10
    assert np.abs(rdm1.numpy() - np.asarray(ref[3])).max() < 1e-10
    assert t2.shape == ref[1].shape and float(delta.max()) < 1e-9


# ------------------------------------------------------ the mesh itself
def test_shard_batch_pieces():
    """Contiguous pieces in shard order on their devices, empty shards
    dropped, the JAX package's pad arithmetic, and no mesh: the batch."""
    from quemb_tpu.parallel.mesh import pad_to_multiple as jax_pad

    x = torch.arange(5.0)[:, None].repeat(1, 3)
    for n in (1, 2, 3, 5, 8):
        m = mesh.make_fragment_mesh(["cpu"] * n)
        pieces, nf = mesh.shard_batch(x.numpy(), m)
        assert nf == 5
        assert [len(p) for p in pieces] == [
            len(p) for p in torch.tensor_split(x, n) if len(p)]
        assert torch.equal(torch.cat(pieces), x)
        assert mesh.pad_to_multiple(5, n) == jax_pad(5, n)
    pieces, nf = mesh.shard_batch(x)
    assert nf == 5 and len(pieces) == 1 and pieces[0] is not None
    assert torch.equal(pieces[0], x)
    assert mesh.shard_ranges(5) == [(range(5), None)]


def test_make_fragment_mesh_needs_a_card_or_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_fragment_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_fragment_mesh(["cuda:0", "cpu"])
    m = mesh.make_fragment_mesh(["cpu", "cpu"])
    assert m.size == 2 and m.axis_names == ("frag",)
    assert mesh.get_mesh() is None


def test_a_failing_shard_raises_out_of_be_func(h8, monkeypatch):
    """4 shards over the 6 fragments hold 2, 2, 1 and 1; the fragment SCF
    fails on the chunks of one: be_func raises it, after the other shards
    have finished."""
    mf, fobj = h8
    be = qt.BE(mf, fobj, device="cpu")
    inner = dispatch.rhf_orthonormal
    done = []

    def failing(h, *args):
        if h.shape[0] == 1:
            raise FloatingPointError("shard failed")
        out = inner(h, *args)
        done.append(h.shape[0])
        return out

    monkeypatch.setattr(dispatch, "rhf_orthonormal", failing)
    with port_mesh(["cpu"] * 4):
        with pytest.raises(FloatingPointError, match="shard failed"):
            dispatch.be_func(None, be.fragments, be.Nocc, "CCSD",
                             eeval=True)
    assert done == [2, 2]


@pytest.mark.gpu
def test_card_and_cpu_mesh_equals_no_mesh():
    """Mesh (cuda:0, cpu) on the card's BE: a tensor of one shard meeting
    one of the other in an operation would raise; the one-shot CCSD and
    the error vector at a seeded potential equal no mesh at 1e-10."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    mol = Mole(atom=H8, basis="sto-3g")
    mf = RHF(mol, conv_tol=1e-12, device="cuda")
    mf.kernel()
    fobj = qt.fragmentate(mol=mol, n_BE=2, frag_type="chemgen",
                          print_frags=False)
    out = []
    for devices in (None, ["cuda:0", "cpu"]):
        be = qt.BE(mf, fobj, device="cuda")
        pot = np.random.default_rng(0).standard_normal(len(be.pot)) * 1e-3
        if devices is None:
            ret = dispatch.be_func(pot, be.fragments, be.Nocc, "CCSD",
                                   eeval=True, return_vec=True)
        else:
            with port_mesh(devices):
                ret = dispatch.be_func(pot, be.fragments, be.Nocc, "CCSD",
                                       eeval=True, return_vec=True)
            assert {fr.rdm1__.device.type for fr in be.fragments} == {
                "cuda", "cpu"}
        out.append(SimpleNamespace(
            norm=ret[0], vec=ret[1], ecorr=ret[2][0],
            ebe=np.array([fr.ebe for fr in be.fragments])))
    a, b = out
    assert abs(a.norm - b.norm) < TOL and abs(a.ecorr - b.ecorr) < TOL
    assert np.abs(a.vec - b.vec).max() < TOL
    assert np.abs(a.ebe - b.ebe).max() < TOL
