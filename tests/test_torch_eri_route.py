"""The in-core route's choice between the quarter transform of the dense
AO ERI and the host pivoted-Cholesky factor (``api.BE._incore_via_cd``).

"auto" chooses by size: the quarter transform whenever the AO ERI (nothing
more when the mean field already holds it on the device) and twice one
widest fragment's intermediates fit in the free memory, the factor only
where they do not.  ``QUEMB_TPU_INCORE_CD=1/0`` forces either.  On the
CPU the free memory is unbounded, so the size rule is driven here by
patching ``api._free_bytes``.  The ``eri`` span counts the fragments each
route transformed (``eri.direct``, ``eri.cd``); the two routes' fragment
ERIs agree to 1e-10 an element on H8 and to 1e-9 on octane BE2.

The ``gpu`` tests take the card's default route for octane BE2 and hold
it to the forced factor route:

    python -m pytest --noconftest -m gpu tests/test_torch_eri_route.py
"""

import os

import pytest
import torch

import quemb_tpu_torch as qt
from quemb_tpu_torch import api
from quemb_tpu_torch.chem.mole import Mole
from quemb_tpu_torch.chem.scf import RHF, load_fixture
from quemb_tpu_torch.ops import eri_transform
from quemb_tpu_torch.utils import profiling as P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OCTANE_FIXTURE = os.path.join(ROOT, "fixtures", "octane_sto3g_hf.npz")
OCTANE_XYZ = os.path.join(ROOT, "tests", "data", "xyz", "octane.xyz")
H8 = "; ".join(f"H 0 0 {i * 1.0}" for i in range(8))


@pytest.fixture(autouse=True)
def _auto_route(monkeypatch):
    for var in ("QUEMB_TPU_INCORE_CD", "QUEMB_TPU_CCSD_F32_ONLY"):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def h8():
    mol = Mole(atom=H8, basis="sto-3g")
    mf = RHF(mol, device="cpu")
    mf.kernel()
    be = qt.BE(mf, qt.fragmentate(mol, n_BE=2, print_frags=False),
               device="cpu")
    return mf, be


@pytest.fixture(scope="module")
def octane():
    mf = load_fixture(OCTANE_FIXTURE, OCTANE_XYZ, device="cpu")
    be = qt.BE(mf, qt.fragmentate(mf.mol, n_BE=2, print_frags=False),
               device="cpu")
    return mf, be


def _sizes(be):
    """The AO ERI's bytes and one widest fragment's intermediates."""
    nao = be.S.shape[0]
    n = max(fr.nao for fr in be.fragments)
    return 8.0 * nao ** 4, api._quarter_bytes(n, nao)


def _eri_counters(be):
    trace = next(t for t in P.traces() if t.id == be.trace_id)
    (eri,) = [s for s in trace.spans if s.name == "eri"]
    names = {s.name for s in trace.spans}
    return {k: v for k, v in eri.counters.items() if k.startswith("eri.")}, \
        "cd_factor" in names


def _free(monkeypatch, nbytes):
    monkeypatch.setattr(api, "_free_bytes", lambda device: float(nbytes))


def test_auto_takes_the_quarter_transform_on_unbounded_memory(h8):
    _, be = h8
    assert api._free_bytes(be.device) == float("inf")
    assert be._incore_via_cd() is False


@pytest.mark.parametrize("room, via_cd", [(0, False), (-1, True)])
def test_auto_by_size_with_the_eri_resident(h8, monkeypatch, room, via_cd):
    """The mean field's J/K left its ERI on the device: only twice one
    widest fragment's intermediates have to fit."""
    mf, be = h8
    assert mf._eri_dev is not None
    _, per = _sizes(be)
    _free(monkeypatch, 2 * per + room)
    assert be._incore_via_cd() is via_cd


@pytest.mark.parametrize("room, via_cd", [(0, False), (-1, True)])
def test_auto_by_size_with_the_eri_on_the_host(h8, monkeypatch, room,
                                               via_cd):
    """No device copy yet: the AO ERI has to fit beside the
    intermediates."""
    mf, be = h8
    monkeypatch.setattr(mf, "_eri_dev", None)
    eri, per = _sizes(be)
    _free(monkeypatch, eri + 2 * per + room)
    assert be._incore_via_cd() is via_cd
    _free(monkeypatch, 2 * per)
    assert be._incore_via_cd() is True


@pytest.mark.parametrize("mode, via_cd", [
    ("1", True), ("true", True), ("yes", True),
    ("0", False), ("false", False), ("no", False),
])
@pytest.mark.parametrize("free", [0.0, float("inf")])
def test_environment_forces_the_route(h8, monkeypatch, mode, via_cd, free):
    _, be = h8
    monkeypatch.setenv("QUEMB_TPU_INCORE_CD", mode)
    _free(monkeypatch, free)
    assert be._incore_via_cd() is via_cd


@pytest.mark.parametrize("route", ["auto", "small-memory", "forced-cd",
                                   "forced-direct"])
def test_eri_span_counts_the_route_taken(h8, monkeypatch, route):
    mf, _ = h8
    if route == "small-memory":
        _free(monkeypatch, 1.0)
    elif route == "forced-cd":
        monkeypatch.setenv("QUEMB_TPU_INCORE_CD", "1")
    elif route == "forced-direct":
        monkeypatch.setenv("QUEMB_TPU_INCORE_CD", "0")
        _free(monkeypatch, 1.0)
    be = qt.BE(mf, qt.fragmentate(mf.mol, n_BE=2, print_frags=False),
               device="cpu")
    counters, factored = _eri_counters(be)
    n = len(be.fragments)
    if route in ("small-memory", "forced-cd"):
        assert counters == {"eri.cd": n} and factored
    else:
        assert counters == {"eri.direct": n} and not factored
    assert abs(be.ebe_hf - mf.e_tot) < 1e-9


def test_direct_reads_the_mean_fields_eri(h8, monkeypatch):
    """The quarter transform runs on the mean field's own device tensor,
    not on a new copy of the AO ERI."""
    mf, be = h8
    seen = []
    orig = eri_transform.incore_transform_batched

    def spy(eri_ao, TA_b):
        seen.append(eri_ao)
        return orig(eri_ao, TA_b)

    monkeypatch.setattr(eri_transform, "incore_transform_batched", spy)
    be._fragment_eris()
    assert seen and all(t is mf.get_eri_dev() for t in seen)


@pytest.mark.parametrize("system, tol", [("H8", 1e-10), ("octane", 1e-9)])
def test_direct_and_cd_fragment_eris_agree(h8, octane, monkeypatch, system,
                                           tol):
    """The exact quarter transform against the factor, whose residual is
    at most 1e-10 on each AO diagonal element: the fragments' elements
    agree to 1e-10 on H8; on octane BE2, where the transform sums more
    such residuals, to 1.4e-10 (bar 1e-9)."""
    _, be = h8 if system == "H8" else octane
    direct = [fr.eri.clone() for fr in be.fragments]
    monkeypatch.setenv("QUEMB_TPU_INCORE_CD", "1")
    try:
        be._fragment_eris()
        for d, fr in zip(direct, be.fragments):
            assert d.shape == fr.eri.shape
            assert float((d - fr.eri).abs().max()) < tol
    finally:
        for d, fr in zip(direct, be.fragments):
            fr.eri = d


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_takes_the_resident_eri_and_matches_cd(monkeypatch):
    """On the card "auto" transforms octane BE2's fragments from the mean
    field's device ERI, with no new copy of it, and the one-shot energy
    equals the forced factor route's within 1e-9 Ha."""
    cuda = _card()
    mf = load_fixture(OCTANE_FIXTURE, OCTANE_XYZ, device=cuda)
    fobj = qt.fragmentate(mf.mol, n_BE=2, print_frags=False)
    seen = []
    orig = eri_transform.incore_transform_batched

    def spy(eri_ao, TA_b):
        seen.append(eri_ao)
        return orig(eri_ao, TA_b)

    monkeypatch.setattr(eri_transform, "incore_transform_batched", spy)
    be = qt.BE(mf, fobj, device=cuda)
    assert seen and all(t is mf.get_eri_dev() for t in seen)
    assert mf.get_eri_dev().device.type == "cuda"
    counters, factored = _eri_counters(be)
    assert counters == {"eri.direct": len(be.fragments)} and not factored
    be.oneshot("CCSD")

    monkeypatch.setenv("QUEMB_TPU_INCORE_CD", "1")
    be_cd = qt.BE(mf, qt.fragmentate(mf.mol, n_BE=2, print_frags=False),
                  device=cuda)
    counters, factored = _eri_counters(be_cd)
    assert counters == {"eri.cd": len(be_cd.fragments)} and factored
    be_cd.oneshot("CCSD")
    assert abs(be.ebe_hf - be_cd.ebe_hf) < 1e-9
    assert abs(be.ebe_tot - be_cd.ebe_tot) < 1e-9
