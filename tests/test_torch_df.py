"""The density-fitted path of the port against the JAX package's: the DF
factors, the dense and streamed transforms, every f64 ``SparseDF`` path,
``OnFlySparseDF``, and H8 BE2 energies through the four DF routes.

Inputs are seeded numpy; the JAX side runs on the CPU, the port with
``device="cpu"``.  Molecules: water, the H8 chain (union-gather regime:
its band is as wide as the molecule) and the H64 chain of
``tests/test_df.py`` (banded regime, band_fraction <= 0.6).  Tolerances:
factors through B^T B and transforms against the JAX function at 1e-10,
banded against dense at 1e-8, BE energies at 1e-8 Ha.
"""

import numpy as np
import pytest
import torch

import quemb_tpu as qj
import quemb_tpu_torch as qt
from quemb_tpu.chem.mole import Mole as JMole
from quemb_tpu.chem.scf import RHF as JRHF
from quemb_tpu.ops import df as jdf
from quemb_tpu.ops.sparse_df import OnFlySparseDF as JOnFly
from quemb_tpu.ops.sparse_df import SparseDF as JSparseDF
from quemb_tpu_torch import native
from quemb_tpu_torch.chem.mole import Mole
from quemb_tpu_torch.chem.scf import RHF
from quemb_tpu_torch.ops import df as tdf
from quemb_tpu_torch.ops import sparse_df as tsdf
from quemb_tpu_torch.ops.sparse_df import OnFlySparseDF, SparseDF

torch.set_num_threads(1)
native.get_lib()  # load the engine's OpenMP runtime before capping it
try:
    # several test workers share the cores: two engine threads per worker
    from threadpoolctl import threadpool_limits
except ImportError:
    pass
else:
    threadpool_limits(limits=1, user_api="blas")
    threadpool_limits(limits=2, user_api="openmp")

CPU = torch.device("cpu")
WATER = "O 0 0 0.1; H 0 0.75 -0.45; H 0 -0.7 -0.46"
H8 = "; ".join(f"H 0 0 {i * 1.0}" for i in range(8))
H64 = [("H", [0.0, 0.0, 2.0 * i]) for i in range(64)]
TOL = 1e-10


def _orth(nao, nemb, seed):
    rng = np.random.default_rng(seed)
    return np.linalg.qr(rng.standard_normal((nao, nemb)))[0]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------- DF factors
@pytest.fixture(scope="module")
def h8():
    return Mole(atom=H8, basis="sto-3g"), JMole(atom=H8, basis="sto-3g")


@pytest.fixture(scope="module")
def h64():
    mol = Mole(atom=H64, basis="sto-3g", unit="angstrom")
    jmol = JMole(atom=H64, basis="sto-3g", unit="angstrom")
    jsdf = JSparseDF(jmol)
    B = np.array(jsdf.dft.B)
    return mol, jmol, jsdf, B


@pytest.mark.parametrize("atom", [WATER, H8], ids=["water", "h8"])
@pytest.mark.parametrize(
    "spec", [None, "etb", "etb:6.0", "autoaux:2.5", "cholesky",
             "cholesky:1e-6", "weigend", "auxmol"],
)
def test_dftensor_matches_jax(atom, spec):
    mol, jmol = Mole(atom=atom, basis="sto-3g"), JMole(atom=atom,
                                                       basis="sto-3g")
    if spec == "auxmol":
        dft = tdf.DFTensor(mol, Mole(atom=atom, basis="6-31g"))
        jdft = jdf.DFTensor(jmol, JMole(atom=atom, basis="6-31g"))
    else:
        dft, jdft = tdf.DFTensor(mol, spec), jdf.DFTensor(jmol, spec)
    assert dft.naux == jdft.naux
    assert dft.B.shape == jdft.B.shape
    # the factor is unique up to a rotation of the aux index: compare B^T B
    assert np.abs(dft.eri_full() - jdft.eri_full()).max() < TOL


def test_etb_auxbasis_and_resolve_match_jax(h8):
    mol, jmol = h8
    for beta in (1.8, 6.0):
        aux = tdf.make_even_tempered_auxbasis(mol, beta)
        jaux = jdf.make_even_tempered_auxbasis(jmol, beta)
        assert aux.nao == jaux.nao and len(aux.shells) == len(jaux.shells)
        for sh, jsh in zip(aux.shells, jaux.shells):
            assert sh.l == jsh.l and np.array_equal(sh.exps, jsh.exps)
            assert np.array_equal(sh.coefs, jsh.coefs)
    assert tdf.resolve_auxbasis(mol, "cholesky:1e-7") == ("cholesky", 1e-7)
    assert tdf.resolve_auxbasis(mol, "weigend") == ("cholesky", 1e-10)
    assert tdf.resolve_auxbasis(mol, "etb:2.0")[0] == "mol"
    with pytest.raises(ValueError, match="unknown auxbasis"):
        tdf.resolve_auxbasis(mol, "no-such-set")


def test_cholesky_factor_computes_its_own_eri(h8):
    mol, jmol = h8
    B = tdf.cholesky_df_factor(mol, tol=1e-8)
    assert np.array_equal(B, jdf.cholesky_df_factor(jmol, tol=1e-8))


# ------------------------------------------------------- dense transforms
@pytest.mark.parametrize("nf,nemb", [(1, 5), (3, 7)])
def test_df_transform_batched_matches_jax(h8, nf, nemb):
    mol, jmol = h8
    B = jdf.DFTensor(jmol).B
    TA_b = np.stack([_orth(mol.nao, nemb, 10 + k) for k in range(nf)])
    ref = np.asarray(jdf.df_transform_batched(B, TA_b))
    out = tdf.df_transform_batched(torch.as_tensor(B), torch.as_tensor(TA_b))
    assert np.abs(out.numpy() - ref).max() < TOL
    one = tdf.df_fragment_eri(torch.as_tensor(B), torch.as_tensor(TA_b[0]))
    assert np.abs(one.numpy() - ref[0]).max() < TOL


def test_df_transform_aux_chunks_accumulate(monkeypatch):
    """The aux axis is cut only when free memory asks; the cut changes no
    number beyond summation order (37 rows in chunks of 5, 2 left over)."""
    rng = np.random.default_rng(0)
    B = torch.as_tensor(rng.standard_normal((37, 12, 12)))
    TA_b = torch.as_tensor(rng.standard_normal((2, 12, 5)))
    whole = tdf.df_transform_batched(B, TA_b)
    need = 8.0 * 2 * 37 * 5 * (12 + 10)
    monkeypatch.setattr(tdf, "_free_bytes", lambda dev: 2 * need / 7.5)
    cut = tdf.df_transform_batched(B, TA_b)
    assert (cut - whole).abs().max() < 1e-13 * whole.abs().max()


def test_streamed_df_matches_jax(h8):
    mol, jmol = h8
    aux = tdf.make_even_tempered_auxbasis(mol)
    jaux = jdf.make_even_tempered_auxbasis(jmol)
    TA = _orth(mol.nao, 5, 0)
    sdf = tdf.StreamedDF(mol, auxmol=aux, max_memory_gb=1e-4, device=CPU)
    jsdf = jdf.StreamedDF(jmol, auxmol=jaux, max_memory_gb=1e-4)
    assert sdf.naux == jsdf.naux
    assert sum(1 for _ in sdf.iter_blocks()) > 1
    for (rows, blk), (jrows, jblk) in zip(sdf.iter_blocks(),
                                          jsdf.iter_blocks()):
        assert np.array_equal(rows, jrows)
    out = sdf.fragment_eri(TA)
    assert isinstance(out, torch.Tensor)
    assert np.abs(out.numpy() - jsdf.fragment_eri(TA)).max() < TOL
    assert tdf.block_step_size(282, 3460, 50.0) == jdf.block_step_size(
        282, 3460, 50.0)
    with pytest.raises(ValueError, match="StreamedDF"):
        tdf.StreamedDF(mol, "cholesky", device=CPU)


# ---------------------------------------------------------- SparseDF, f64
def test_band_plan_equals_jax(h64, h8):
    mol, jmol, jsdf, B = h64
    sdf = SparseDF.from_factor(mol, B, device=CPU)
    perm, col_idx, b, W = sdf._band_plan()
    jperm, jcol, jb, jW = jsdf._band_plan()
    assert np.array_equal(perm, jperm) and np.array_equal(col_idx, jcol)
    assert (b, W) == (jb, jW)
    assert sdf.band_fraction == jsdf.band_fraction <= 0.6
    # compact regime: no band narrower than the molecule
    assert SparseDF(h8[0], device=CPU)._band_plan() is None
    assert SparseDF(Mole(atom=WATER, basis="sto-3g"),
                    device=CPU)._band_plan() is None


def test_band_gather_layout(h64):
    """[nblk, b*naux, W] with the block row outside the aux index, equal to
    the direct numpy gather of the permuted factor."""
    mol, jmol, jsdf, B = h64
    sdf = SparseDF.from_factor(mol, B, device=CPU)
    perm, col_idx, b, W = sdf._band_plan()
    out = tsdf._band_gather_device(torch.as_tensor(B), perm, col_idx, b)
    naux, nao = B.shape[0], mol.nao
    nblk = col_idx.shape[0]
    Bp = B[:, perm][:, :, perm]
    Bp = np.pad(Bp, ((0, 0), (0, nblk * b - nao), (0, 0)))
    ref = np.stack([
        Bp[:, k * b : (k + 1) * b][:, :, col_idx[k]].transpose(1, 0, 2)
        for k in range(nblk)
    ]).reshape(nblk, b * naux, W)
    assert out.dtype == torch.float64
    assert np.array_equal(out.numpy(), ref)
    # a compact f32 source is widened slab by slab
    out32 = tsdf._band_gather_device(
        torch.as_tensor(B.astype(np.float32)), perm, col_idx, b)
    assert out32.dtype == torch.float64
    assert np.array_equal(out32.numpy(),
                          ref.astype(np.float32).astype(np.float64))


@pytest.mark.parametrize("nemb,seed", [(12, 7), (10, 3)])
def test_fragment_eri_banded_matches_jax_and_dense(h64, nemb, seed):
    mol, jmol, jsdf, B = h64
    sdf = SparseDF.from_factor(mol, B, device=CPU)
    TA = _orth(mol.nao, nemb, seed)
    out = sdf.fragment_eri_banded(TA).numpy()
    assert np.abs(out - np.asarray(jsdf.fragment_eri_banded(TA))).max() < TOL
    dense = tdf.df_fragment_eri(torch.as_tensor(B), torch.as_tensor(TA))
    assert np.abs(out - dense.numpy()).max() < 1e-8
    assert sdf.last_reach_fraction == sdf.band_fraction
    # the class keeps no dense device copy in the banded regime
    assert not hasattr(sdf, "_B_dev_cache")


@pytest.mark.parametrize("chunk", [None, "1"], ids=["auto", "chunk1"])
def test_transform_all_banded_matches_jax(h64, monkeypatch, chunk):
    """Two equal-nemb fragments fold into one first GEMM; a third of
    another width makes a second bucket."""
    mol, jmol, jsdf, B = h64
    if chunk:
        monkeypatch.setenv("QUEMB_TPU_SDF_CHUNK", chunk)
    sdf = SparseDF.from_factor(mol, B, device=CPU)
    TAs = [_orth(mol.nao, 12, 7), _orth(mol.nao, 12, 8),
           _orth(mol.nao, 9, 9)]
    outs = sdf.transform_all(TAs)
    refs = jsdf.transform_all(TAs)
    dense = [tdf.df_fragment_eri(torch.as_tensor(B), torch.as_tensor(TA))
             for TA in TAs]
    for out, ref, d in zip(outs, refs, dense):
        assert isinstance(out, torch.Tensor)
        assert np.abs(out.numpy() - np.asarray(ref)).max() < TOL
        assert np.abs(out.numpy() - d.numpy()).max() < 1e-8
    fetched = sdf.transform_all(TAs[:1], fetch=True)
    assert isinstance(fetched[0], np.ndarray)
    assert np.array_equal(fetched[0], outs[0].numpy())
    assert sdf._banded_chunk(12) == (1 if chunk else int(
        4.0e9 // (8.0 * 64 * sdf.naux * 12)))


@pytest.mark.parametrize("eps", [None, 1e-3, 1e-12],
                         ids=["default", "loose", "tight"])
def test_fragment_eri_union_matches_jax(h8, eps):
    mol, jmol = h8
    sdf = SparseDF(mol, screen_eps=eps, device=CPU)
    jsdf = JSparseDF(jmol, screen_eps=eps)
    assert (sdf.mo_eps, sdf.ao_eps) == (jsdf.mo_eps, jsdf.ao_eps)
    rng = np.random.default_rng(1)
    TA = np.zeros((mol.nao, 3))
    TA[:3] = rng.standard_normal((3, 3))
    out = sdf.fragment_eri(TA).numpy()
    ref = np.asarray(jsdf.fragment_eri(TA))
    assert sdf.last_reach_fraction == jsdf.last_reach_fraction
    assert np.abs(out - ref).max() < TOL
    if eps == 1e-3:
        assert sdf.last_reach_fraction < 1.0  # the screen bit


@pytest.mark.parametrize("pad", [None, "32"], ids=["nopad", "pad32"])
def test_transform_all_union_matches_jax(h8, monkeypatch, pad):
    """Union-gather branch on H8; the reach-set pad changes no number."""
    mol, jmol = h8
    if pad:
        monkeypatch.setenv("QUEMB_TPU_SDF_PAD", pad)
    sdf = SparseDF(mol, device=CPU)
    jsdf = JSparseDF(jmol)
    TAs = [_orth(mol.nao, 4, 21), _orth(mol.nao, 4, 22),
           _orth(mol.nao, 6, 23)]
    outs = sdf.transform_all(TAs)
    refs = jsdf.transform_all(TAs)
    for out, ref in zip(outs, refs):
        assert np.abs(out.numpy() - np.asarray(ref)).max() < TOL
    assert sdf.last_reach_fraction == pytest.approx(
        jsdf.last_reach_fraction)


@pytest.mark.parametrize("as_tensor", [False, True], ids=["host", "device"])
def test_from_factor_matches_constructor(h64, as_tensor):
    mol, jmol, jsdf, B = h64
    given = torch.as_tensor(B) if as_tensor else B
    sdf = SparseDF.from_factor(mol, given, device=CPU)
    assert sdf.naux == jsdf.naux and sdf.tier == "f64"
    TA = _orth(mol.nao, 10, 3)
    assert np.abs(sdf.fragment_eri_banded(TA).numpy()
                  - np.asarray(jsdf.fragment_eri_banded(TA))).max() < TOL
    assert np.abs(sdf.fragment_eri(TA).numpy()
                  - np.asarray(jsdf.fragment_eri(TA))).max() < TOL
    with pytest.raises(ValueError, match="tier"):
        SparseDF.from_factor(mol, B, tier="f16", device=CPU)
    with pytest.raises(ValueError, match="device_upload"):
        SparseDF.from_factor(mol, B, device_upload="bf16", device=CPU)


@pytest.mark.parametrize("as_tensor", [False, True], ids=["host", "device"])
def test_from_factor_f32_widen(h64, as_tensor):
    """The factor is rounded to f32 and widened: both views bit-equal, the
    banded and union paths agree with the JAX package on the same rounded
    factor and with a host transform of it."""
    mol, jmol, jsdf, B = h64
    given = torch.as_tensor(B) if as_tensor else B
    sdf = SparseDF.from_factor(mol, given, device_upload="f32-widen",
                               device=CPU)
    Bq = B.astype(np.float32).astype(np.float64)
    assert _np(sdf.dft.B).dtype == np.float64
    assert np.array_equal(_np(sdf.dft.B), Bq)
    jq = JSparseDF.from_factor(jmol, B, device_upload="f32-widen")
    TA = _orth(mol.nao, 10, 7)
    band = sdf.fragment_eri_banded(TA).numpy()
    assert np.abs(band - np.asarray(jq.fragment_eri_banded(TA))).max() < TOL
    Bij = np.einsum("pmi,mj->pij", np.einsum("pmn,ni->pmi", Bq, TA), TA)
    ref = np.einsum("pij,pkl->ijkl", Bij, Bij)
    assert np.abs(band - ref).max() < TOL
    assert np.abs(sdf.fragment_eri(TA).numpy() - ref).max() < TOL


def test_onfly_sparse_df_matches_jax(h8):
    mol, jmol = h8
    sdf = OnFlySparseDF(mol, max_memory_gb=1e-5, device=CPU)
    jsdf = JOnFly(jmol, max_memory_gb=1e-5)
    assert sdf.naux == jsdf.naux
    for seed, nemb in ((31, 4), (32, 6)):
        TA = _orth(mol.nao, nemb, seed)
        out = sdf.fragment_eri(TA)
        assert isinstance(out, torch.Tensor)
        assert np.abs(out.numpy() - jsdf.fragment_eri(TA)).max() < TOL
        assert sdf.last_reach_fraction == jsdf.last_reach_fraction
    with pytest.raises(ValueError, match="on-fly-sparse-DF"):
        OnFlySparseDF(mol, "cholesky", device=CPU)


def test_sparse_df_defaults_and_device(h8):
    mol, _ = h8
    sdf = SparseDF(mol, device=CPU)
    assert sdf.mo_eps == 1e-5 and sdf.ao_eps == 1e-10
    legacy = SparseDF(mol, screen_eps=1e-7, device=CPU)
    assert legacy.mo_eps == 1e-7 and legacy.ao_eps == 1e-7
    if not torch.cuda.is_available():
        for make in (lambda: SparseDF(mol),
                     lambda: OnFlySparseDF(mol),
                     lambda: tdf.StreamedDF(mol)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()


# ------------------------------------------------------ the slice, H8 BE2
ROUTES = ("int-direct-DF", "out-core-DF", "sparse-DF", "on-fly-sparse-DF")


@pytest.fixture(scope="module")
def h8_be(h8):
    mol, jmol = h8
    mf = RHF(mol, device="cpu")
    mf.kernel()
    jmf = JRHF(jmol)
    jmf.kernel()
    fobj = qt.fragmentate(mol, n_BE=2, print_frags=False)
    jfobj = qj.fragmentate(jmol, n_BE=2, print_frags=False)
    return mol, mf, fobj, jmf, jfobj


@pytest.mark.parametrize("solver", ["CCSD", "FCI"])
@pytest.mark.parametrize("route", ROUTES)
def test_h8_be2_energy_matches_jax(h8_be, route, solver, monkeypatch):
    """The port from its own converged mean field against the JAX package
    on its own, 1e-8 Ha."""
    monkeypatch.delenv("QUEMB_TPU_CCSD_F32_ONLY", raising=False)
    mol, mf, fobj, jmf, jfobj = h8_be
    be = qt.BE(mf, fobj, int_transform=route, device="cpu")
    jbe = qj.BE(jmf, jfobj, int_transform=route)
    for fr, jfr in zip(be.fragments, jbe.fragments):
        assert isinstance(fr.eri, torch.Tensor)
    be.oneshot(solver)
    jbe.oneshot(solver)
    assert abs(be.ebe_hf - jbe.ebe_hf) < 1e-8
    assert abs(be.ebe_tot - jbe.ebe_tot) < 1e-8


def test_h8_sparse_df_energy_against_dense_df(h8_be, monkeypatch):
    """sparse-DF at a tight screen reproduces int-direct-DF on the same
    auxiliary basis at the bound the screen gives: ERIs to 1e-9, energies
    to 1e-8 Ha."""
    monkeypatch.delenv("QUEMB_TPU_CCSD_F32_ONLY", raising=False)
    mol, mf, fobj, _, _ = h8_be
    be_df = qt.BE(mf, fobj, int_transform="int-direct-DF", device="cpu")
    be_sp = qt.BE(mf, fobj, int_transform="sparse-DF", screen_eps=1e-8,
                  device="cpu")
    assert be_sp.MO_coeff_epsilon == be_sp.AO_coeff_epsilon == 1e-8
    for fr_d, fr_s in zip(be_df.fragments, be_sp.fragments):
        assert (fr_d.eri - fr_s.eri).abs().max() < 1e-9
    for solver in ("MP2", "CCSD"):
        be_df.oneshot(solver)
        be_sp.oneshot(solver)
        assert abs(be_sp.ebe_tot - be_df.ebe_tot) < 1e-8
    # the production screens stay inside the reference's envelope
    be_prod = qt.BE(mf, fobj, int_transform="sparse-DF", device="cpu")
    be_prod.oneshot("MP2")
    be_df.oneshot("MP2")
    assert abs(be_prod.ebe_tot - be_df.ebe_tot) < 5e-5


@pytest.mark.parametrize("route", ROUTES)
def test_df_routes_never_read_the_dense_eri(h8, route, monkeypatch):
    """A DF mean field whose get_eri raises goes through every DF route."""
    monkeypatch.delenv("QUEMB_TPU_CCSD_F32_ONLY", raising=False)
    mol, _ = h8
    mf = RHF(mol, with_df=True, auxbasis="etb:6.0", device="cpu")
    mf.kernel()

    def boom():
        raise AssertionError("a DF route read the dense AO ERI")

    monkeypatch.setattr(mf, "get_eri", boom)
    fobj = qt.fragmentate(mol, n_BE=2, print_frags=False)
    be = qt.BE(mf, fobj, int_transform=route, auxbasis="etb:6.0",
               device="cpu")
    assert abs(mf.e_tot - be.ebe_hf) < 1e-8
    be.oneshot("MP2")
    assert np.isfinite(be.ebe_tot)


def test_be_reuses_the_mean_fields_factor(h8, monkeypatch):
    """Same aux on both sides: the factor is the mean field's, not rebuilt;
    another aux is built anew and gives another energy."""
    mol, _ = h8
    mf = RHF(mol, with_df=True, auxbasis="etb:6.0", device="cpu")
    mf.kernel()
    fobj = qt.fragmentate(mol, n_BE=2, print_frags=False)
    be = qt.BE(mf, fobj, int_transform="int-direct-DF", auxbasis="ETB:6.0",
               device="cpu")
    assert be._df_factor() is mf.get_df_B()
    other = qt.BE(mf, fobj, int_transform="int-direct-DF", device="cpu")
    assert other._df_factor() is not mf.get_df_B()
    assert other._df_factor().shape[0] > mf.get_df_B().shape[0]
    with pytest.raises(ValueError, match="int_transform"):
        qt.BE(mf, fobj, int_transform="no-such-route", device="cpu")
