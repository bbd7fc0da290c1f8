"""Periodic BE: the port's fragment energies, ``kbe.BE``, periodic
fragmentation and k-point mean-field interchange against the JAX
package's, on the CPU.

- ``embed/energy.py``: ``fragment_hf_energy`` and ``fragment_energy``
  (cumulant and not) against the JAX functions at 1e-12 on seeded
  symmetric inputs, and against the port's batched rows
  (``solvers/dispatch.py``) at batch 1;
- ``kbe.BE`` on the H4 cell of ``tests/test_kbe.py:99-118``, each package
  from its own KRHF: chemgen and autogen BE2, HF-in-HF (< 1e-7, the JAX
  test's bar) and ``ebe_hf``, one-shot CCSD and MP2, and
  ``optimize(only_chem=True)``: each energy within 1e-8 Ha of the JAX
  package's (the two KRHFs agree to a few 1e-9 Ha here);
- ``save``/``from_restart_file`` and ``dump_kscf``/``load_kscf`` across
  the packages: each package reads the other's file with its arrays
  unchanged; a port -> JAX -> port round trip gives the same ``ebe_tot``
  within 1e-10, and the JAX package from the port's file within 5e-8
  (its own rounding: its J/K and embedding ERIs are up to 1.5e-8 from
  exact sums on these cells, the port's 1e-11);
- ``fragmentate`` for ``kpt=[1, 1, 3]`` against the JAX package's, index
  for index, and against the reference's polyacetylene BE2/BE3 autogen
  structures (``tests/data/kbe_autogen_expected.py``);
- ``kbe.BE`` and ``load_kscf`` raise without a card when no device is
  named (neither by the call nor by the mean field).

The card's twin of the H4 one-shot is ``tests/test_torch_kbe_card.py``.
The gated test (``QUEMB_TPU_EXPENSIVE_TESTS=true``) runs the polyacetylene
kBE2 case of ``chip_smoke.py`` phase 19 through the port on the CPU, its
matched energies held to the JAX package's at 1e-6 Ha.
"""

import copy
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from quemb_tpu import kbe as jkbe
from quemb_tpu import mf_interfaces as jmfi
from quemb_tpu.embed import energy as jenergy
from quemb_tpu_torch import kbe
from quemb_tpu_torch import mf_interfaces as mfi
from quemb_tpu_torch.embed import energy
from quemb_tpu_torch.solvers import dispatch

torch.set_num_threads(1)
try:
    # the host lattice sums and solves of both packages run numpy BLAS;
    # one thread per test worker keeps the workers from oversubscribing
    from threadpoolctl import threadpool_limits
except ImportError:
    pass
else:
    threadpool_limits(limits=1, user_api="blas")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "data"))
from kbe_autogen_expected import EXPECTED  # noqa: E402

CPU = dict(device="cpu")
LAT = np.diag([6.0, 6.0, 4.0])
H4 = "H 0 0 0; H 0 0 1.0; H 0 0 2.0; H 0 0 3.0"
KMESH = [1, 1, 3]
TOL = 1e-8
#: the same state through the two packages' arithmetic: the JAX package's
#: J/K and embedding ERIs carry up to 1.5e-8 of rounding on these cells
#: (tests/test_torch_kbe_integrals.py)
XTOL = 5e-8


# ------------------------------------------------------ fragment energies
def _random_fragment(seed, n=6, nsocc=2):
    """A fragment's energy inputs, seeded: symmetric h1/veff/veff0, an ERI
    with the 8-fold symmetry, orthonormal orbitals and centers."""
    rng = np.random.default_rng(seed)

    def sym(a):
        return 0.5 * (a + a.T)

    eri = rng.standard_normal((n,) * 4)
    for perm in ((1, 0, 2, 3), (0, 1, 3, 2), (2, 3, 0, 1)):
        eri = 0.5 * (eri + eri.transpose(perm))
    C = np.linalg.qr(rng.standard_normal((n, n)))[0]
    rdm1 = sym(rng.standard_normal((n, n)))
    rdm2 = rng.standard_normal((n,) * 4)
    fr = SimpleNamespace(
        h1=sym(rng.standard_normal((n, n))),
        veff=sym(rng.standard_normal((n, n))),
        veff0=sym(rng.standard_normal((n, n))), eri=eri, _mo_coeffs=C,
        mo_coeffs=C, nsocc=nsocc, weight_and_relAO_per_center=(0.7, [0, 2]))
    return fr, rdm1, rdm2


def _on_port(fr):
    out = copy.copy(fr)
    out.eri = torch.as_tensor(fr.eri)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_fragment_energies_against_jax_and_batched_rows(seed):
    fr, rdm1, rdm2 = _random_fragment(seed)
    pfr = _on_port(fr)
    assert abs(energy.fragment_hf_energy(pfr)
               - jenergy.fragment_hf_energy(fr)) < 1e-12
    w, idx = fr.weight_and_relAO_per_center
    center_w = np.zeros((1, fr.h1.shape[0]))
    center_w[0, idx] = w
    occ = np.zeros((1, fr.h1.shape[0]))
    occ[0, : fr.nsocc] = 1.0
    t = torch.as_tensor
    for cumulant in (True, False):
        got = energy.fragment_energy(pfr, rdm1, rdm2, use_cumulant=cumulant)
        ref = jenergy.fragment_energy(fr, rdm1, rdm2, use_cumulant=cumulant)
        assert np.abs(np.array(got) - np.array(ref)).max() < 1e-12
        args = [t(fr.mo_coeffs)[None], t(fr.h1)[None],
                t(fr.veff0 if cumulant else fr.veff)[None], pfr.eri[None],
                t(rdm1)[None], t(rdm2)[None]]
        rows = (dispatch._batched_energy_rows(*args, t(occ), t(center_w))
                if cumulant else
                dispatch._batched_energy_rows_nc(*args, t(center_w)))
        batched = [float(r[0]) for r in rows]
        assert np.abs(np.array(got) - np.array(batched)).max() < 1e-12


# ------------------------------------------------------------ H4 kBE2
@pytest.fixture(scope="module")
def h4():
    """The H4 cell's KRHF through both packages, each on its own KGDF."""
    cell = kbe.Cell(atom=H4, a=LAT, basis="sto-3g")
    jcell = jkbe.Cell(atom=H4, a=LAT, basis="sto-3g")
    kpts = cell.make_kpts(KMESH)
    mf = kbe.KRHF(cell, kpts, omega=0.6, conv_tol=1e-11, **CPU)
    mf.kernel()
    jmf = jkbe.KRHF(jcell, kpts, omega=0.6, conv_tol=1e-11)
    jmf.kernel()
    assert mf.converged
    return SimpleNamespace(cell=cell, jcell=jcell, kpts=kpts, mf=mf, jmf=jmf)


def _bes(h4, frag_type):
    fobj = kbe.fragmentate(mol=h4.cell, kpt=KMESH, n_BE=2,
                           frag_type=frag_type)
    jfobj = jkbe.fragmentate(mol=h4.jcell, kpt=KMESH, n_BE=2,
                             frag_type=frag_type)
    return (kbe.BE(h4.mf, fobj, kpts=h4.kpts, **CPU),
            jkbe.BE(h4.jmf, jfobj, kpts=h4.kpts))


@pytest.mark.parametrize("frag_type", ["chemgen", "autogen"])
def test_kbe_h4_oneshot_against_jax(h4, frag_type):
    be, jbe = _bes(h4, frag_type)
    assert be.device == torch.device("cpu")
    assert all(fr.eri.dtype == torch.float64 and fr.eri.device == be.device
               for fr in be.fragments)
    assert abs(h4.mf.e_tot - (be.ebe_hf + be.ek)) < 1e-7
    assert abs(be.ek - jbe.ek) < 1e-12
    assert abs(be.ebe_hf - jbe.ebe_hf) < TOL
    for solver in ("CCSD", "MP2"):
        be.oneshot(solver=solver)
        jbe.oneshot(solver=solver)
        assert abs(be.ebe_tot - jbe.ebe_tot) < TOL, solver


def test_kbe_h4_chempot_matching_against_jax(h4):
    be, jbe = _bes(h4, "chemgen")
    be.optimize(solver="CCSD", only_chem=True)
    jbe.optimize(solver="CCSD", only_chem=True)
    assert abs(be.ebe_tot - jbe.ebe_tot) < TOL


def test_save_restart_across_packages(h4, tmp_path):
    """The port's save file restarts the JAX package's kbe.BE with the
    port's arrays, at the port's one-shot MP2 energy; the JAX BE's own
    save of that state restarts the port at its energy again."""
    be, _ = _bes(h4, "chemgen")
    be.oneshot(solver="MP2")
    be.save(str(tmp_path / "port.npz"))
    jbe = jkbe.BE.from_restart_file(
        h4.jmf, jkbe.fragmentate(mol=h4.jcell, kpt=KMESH, n_BE=2),
        restart_file=str(tmp_path / "port.npz"))
    for key in ("W", "lmo_coeff", "hcore", "S", "C", "hf_dm", "hf_veff"):
        assert np.array_equal(getattr(jbe, key), getattr(be, key)), key
    jbe.oneshot(solver="MP2")
    assert abs(jbe.ebe_tot - be.ebe_tot) < XTOL
    jbe.save(str(tmp_path / "jax.npz"))
    back = kbe.BE.from_restart_file(h4.mf, be.fobj,
                                    restart_file=str(tmp_path / "jax.npz"))
    assert back.device == torch.device("cpu")
    back.oneshot(solver="MP2")
    assert abs(back.ebe_tot - be.ebe_tot) < 1e-10


def test_dump_load_kscf_across_packages(h4, tmp_path):
    """A KRHF dumped by the port loads in the JAX package with its arrays
    unchanged, and the JAX package's dump of it loads back into the port
    unchanged; kbe.BE gives the port's one-shot MP2 energy from either.
    The loaded mean fields reuse the built KGDF of the same cell, so no
    second build is paid."""
    mfi.dump_kscf(h4.mf, str(tmp_path / "port.npz"))
    jcell2, jmf2 = jmfi.load_kscf(str(tmp_path / "port.npz"))
    jmfi.dump_kscf(jmf2, str(tmp_path / "jax.npz"))
    cell2, mf2 = mfi.load_kscf(str(tmp_path / "jax.npz"), **CPU)
    assert isinstance(mf2, kbe.KRHF) and mf2.device == torch.device("cpu")
    assert mf2.with_df.device == torch.device("cpu")
    assert np.array_equal(cell2.a, h4.cell.a) and cell2.nao == h4.cell.nao
    for dst in (jmf2, mf2):
        assert dst.e_tot == h4.mf.e_tot
        for key in ("mo_coeff", "mo_energy", "hf_veff"):
            assert np.array_equal(getattr(dst, key), getattr(h4.mf, key))
        assert np.array_equal(dst.get_ovlp(), h4.mf.get_ovlp())
        assert np.array_equal(dst.get_hcore(), h4.mf.get_hcore())
    jmf2.with_df, mf2.with_df = h4.jmf.with_df, h4.mf.with_df
    etot = []
    for b in (kbe.BE(h4.mf, kbe.fragmentate(mol=h4.cell, kpt=KMESH,
                                            n_BE=2), **CPU),
              kbe.BE(mf2, kbe.fragmentate(mol=cell2, kpt=KMESH, n_BE=2)),
              jkbe.BE(jmf2, jkbe.fragmentate(mol=jcell2, kpt=KMESH,
                                             n_BE=2))):
        b.oneshot(solver="MP2")
        etot.append(b.ebe_tot)
    assert abs(etot[1] - etot[0]) < 1e-10
    assert abs(etot[2] - etot[0]) < XTOL


# ------------------------------------------------------- fragmentation
#: tests/test_kbe_frag_oracle.py: the polyacetylene cell
POLY_LAT = np.diag([8.0, 8.0, 2.455 * 2])
POLY = """
H      1.4285621630072645    0.0    -0.586173422487319
C      0.3415633681566205    0.0    -0.5879921146011252
H     -1.4285621630072645    0.0     0.586173422487319
C     -0.3415633681566205    0.0     0.5879921146011252
H      1.4285621630072645    0.0     1.868826577512681
C      0.3415633681566205    0.0     1.867007885398875
H     -1.4285621630072645    0.0     3.041173422487319
C     -0.3415633681566205    0.0     3.0429921146011254
"""
FRAG_FIELDS = ("AO_per_frag", "AO_per_edge_per_frag",
               "ref_frag_idx_per_edge_per_frag",
               "relAO_per_edge_per_frag", "relAO_in_ref_per_edge_per_frag",
               "weight_and_relAO_per_center_per_frag",
               "relAO_per_origin_per_frag", "motifs_per_frag")


def _plain(x):
    """Nested lists/tuples of numbers as Python ints and floats."""
    if isinstance(x, (list, tuple, np.ndarray)):
        return [_plain(y) for y in x]
    return x.item() if isinstance(x, np.generic) else x


@pytest.mark.parametrize("n_BE", [2, 3])
def test_fragmentate_against_jax_and_oracle(n_BE):
    fp = kbe.fragmentate(mol=kbe.Cell(atom=POLY, a=POLY_LAT,
                                      basis="sto-3g"),
                         kpt=KMESH, n_BE=n_BE, frag_type="autogen",
                         frozen_core=True)
    jfp = jkbe.fragmentate(mol=jkbe.Cell(atom=POLY, a=POLY_LAT,
                                         basis="sto-3g"),
                           kpt=KMESH, n_BE=n_BE, frag_type="autogen",
                           frozen_core=True)
    for field in FRAG_FIELDS:
        assert _plain(getattr(fp, field)) == _plain(getattr(jfp, field)), \
            field
    assert (fp.n_frag, fp.ncore, fp.unitcell_nkpt, list(fp.kpt)) == \
        (jfp.n_frag, jfp.ncore, jfp.unitcell_nkpt, list(jfp.kpt))
    # the reference's structures, as tests/test_kbe_frag_oracle.py views
    # them: fragment AO sets, center AO sets, edge -> referenced fragment
    exp = EXPECTED[f"polyacetylene_113_be{n_BE}"]
    ref_frags = [frozenset(a) for a in exp["AO_per_frag"]]
    got_frags = [frozenset(int(i) for i in a) for a in fp.AO_per_frag]
    assert sorted(map(sorted, got_frags)) == sorted(map(sorted, ref_frags))
    for i, fs in enumerate(got_frags):
        j = ref_frags.index(fs)
        rel = fp.weight_and_relAO_per_center_per_frag[i][1]
        ref_rel = exp["weight_and_relAO_per_center_per_frag"][j][1]
        assert {int(fp.AO_per_frag[i][r]) for r in rel} == \
            {exp["AO_per_frag"][j][r] for r in ref_rel}
        got_edges = {frozenset(int(x) for x in e): got_frags[r] for e, r in
                     zip(fp.AO_per_edge_per_frag[i],
                         fp.ref_frag_idx_per_edge_per_frag[i])}
        ref_edges = {frozenset(e): ref_frags[r] for e, r in
                     zip(exp["AO_per_edge_per_frag"][j],
                         exp["ref_frag_idx_per_edge_per_frag"][j])}
        assert got_edges == ref_edges


# ------------------------------------------------------------- devices
def test_no_card_no_default_device(h4, tmp_path):
    """kbe.BE follows its mean field's device; with neither naming one,
    and for load_kscf without a device, the card is asked for."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    mf = copy.copy(h4.mf)
    mf.device = None  # a mean field that was given no device
    fobj = kbe.fragmentate(mol=h4.cell, kpt=KMESH, n_BE=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kbe.BE(mf, fobj)
    path = str(tmp_path / "k.npz")
    mfi.dump_kscf(h4.mf, path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mfi.load_kscf(path)


#: the JAX package's matched polyacetylene kBE2 energies on the CPU
#: (``tools/jax_references.py polyacetylene-kbe``), the fit-free KRHF
#: anchor (tests/test_kbe.py:137) and the reference implementation's
#: matched energies (tests/test_kbe.py:152, BASELINE.md:25)
POLY_ETOT_JAX = {"chemgen": -152.19198657970574,
                 "autogen": -152.19533464920124}
POLY_KRHF_EXACT = -150.07420498113717
POLY_ETOT_PUBLISHED = {"chemgen": -152.19262755,
                       "autogen": -152.1959745442392}


@pytest.mark.skipif(
    os.environ.get("QUEMB_TPU_EXPENSIVE_TESTS", "").lower() != "true",
    reason="polyacetylene kBE2 through the port on the CPU takes ~4 min",
)
def test_kbe2_polyacetylene_against_jax():
    """chip_smoke.py phase 19 on the CPU: the KRHF converges within 2.5e-4
    Ha of the fit-free anchor, HF-in-HF is below 1e-9 Ha, and the matched
    chemgen and autogen ebe_tot lie within 1e-6 Ha of the JAX package's
    and 1.5e-3 Ha of the reference implementation's."""
    cell = kbe.Cell(atom=POLY, a=POLY_LAT, basis="sto-3g")
    kpts = cell.make_kpts(KMESH)
    mf = kbe.KRHF(cell, kpts, omega=0.6, conv_tol=1e-11, **CPU)
    mf.kernel()
    assert mf.converged
    assert abs(mf.e_tot - POLY_KRHF_EXACT) < 2.5e-4
    for frag_type in ("chemgen", "autogen"):
        be = kbe.BE(mf, kbe.fragmentate(mol=cell, kpt=KMESH, n_BE=2,
                                        frag_type=frag_type,
                                        frozen_core=True), kpts=kpts)
        assert abs(mf.e_tot - (be.ebe_hf + be.ek)) < 1e-9
        be.optimize(solver="CCSD")
        assert abs(be.ebe_tot - POLY_ETOT_JAX[frag_type]) < 1e-6
        assert abs(be.ebe_tot - POLY_ETOT_PUBLISHED[frag_type]) < 1.5e-3
