"""The fragment SCF's trips replayed as a CUDA graph on a card.

On a card, :func:`rhf_orthonormal` runs the first trip of a bucket as
the loop does and replays the rest as one captured trip.  The replayed
SCF has to give what the loop gives, bit for bit, with the same trips,
flag reads and eigh counts on the tracer, on a fresh capture and on one
kept from an earlier call.  On the CPU nothing is captured.
"""

import pytest
import torch

from quemb_tpu_torch.embed import fragment_scf
from quemb_tpu_torch.utils.profiling import span

COUNTERS = ("iters", "syncs", "eigh.kernel", "jacobi_eigh.launches")


def _bucket(nf=5, n=12, nocc=4, seed=3, device="cpu"):
    """A seeded bucket: symmetric one-electron matrices and a two-electron
    tensor with the 8-fold symmetry, weak enough that every SCF
    converges, and a core-guess density."""
    g = torch.Generator().manual_seed(seed)
    X = torch.randn(nf, n, n, generator=g, dtype=torch.float64)
    h = X + X.transpose(1, 2) + torch.diag_embed(
        torch.arange(n, dtype=torch.float64).expand(nf, n))
    B = torch.randn(nf, 6, n, n, generator=g, dtype=torch.float64)
    B = 0.05 * (B + B.transpose(2, 3))
    eri = torch.einsum("flpq,flrs->fpqrs", B, B)
    _, C = torch.linalg.eigh(h)
    dm0 = 2.0 * C[..., :nocc] @ C[..., :nocc].transpose(1, 2)
    return h.to(device), eri.to(device), nocc, dm0.to(device)


def _solve(bucket):
    with span("scf_test") as sp:
        out = fragment_scf.rhf_orthonormal(*bucket)
    return out, sp


def _counts(name):
    from quemb_tpu_torch.utils.profiling import traces

    for tr in reversed(traces()):
        for s in tr.spans:
            if s.name == name:
                return {k: s.counters.get(k, 0) for k in COUNTERS}
    raise AssertionError(f"no span {name!r}")


def test_cpu_loop_captures_nothing(monkeypatch):
    """On the CPU the loop runs every trip and keeps no graph."""
    bucket = _bucket()
    monkeypatch.setattr(fragment_scf, "_CAPTURED", type(
        fragment_scf._CAPTURED)())
    assert not fragment_scf._graphs(bucket[0])
    (e, C, e_el, it), _ = _solve(bucket)
    c = _counts("scf_test")
    assert int(it.max()) == c["iters"] > 2
    assert bool((it < fragment_scf.MAX_CYCLE).all())
    assert not fragment_scf._CAPTURED


@pytest.mark.gpu
@pytest.mark.parametrize("n", [12, 41])
def test_replayed_trips_equal_the_loop(monkeypatch, n):
    """Replayed trips give the loop's orbital energies, orbitals,
    energies and iteration counts bit for bit, and the same counts of
    trips, flag reads, eighs and kernel launches, first from a fresh
    capture and then from the kept one with other inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(fragment_scf, "_CAPTURED", type(
        fragment_scf._CAPTURED)())
    for seed in (3, 4):
        bucket = _bucket(n=n, seed=seed, device="cuda")
        monkeypatch.setattr(fragment_scf, "GRAPHS", False)
        loop, _ = _solve(bucket)
        want = _counts("scf_test")
        monkeypatch.setattr(fragment_scf, "GRAPHS", True)
        graph, _ = _solve(bucket)
        got = _counts("scf_test")
        assert len(fragment_scf._CAPTURED) == 1
        assert got == want and want["iters"] > 2
        for a, b in zip(graph, loop):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_captures_kept_within_their_bytes(monkeypatch):
    """Nine bucket shapes, as many as a thiophene dimer matching job
    meets, are all kept, and a second pass over them captures nothing
    anew; with no bytes to spare only the newest capture is kept."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(fragment_scf, "_CAPTURED", type(
        fragment_scf._CAPTURED)())
    made = []

    class Counted(fragment_scf._Captured):
        def __init__(self, *args):
            made.append(args[0].shape)
            super().__init__(*args)

    monkeypatch.setattr(fragment_scf, "_Captured", Counted)
    buckets = [_bucket(nf=nf, n=n, device="cuda")
               for nf in (1, 2, 3) for n in (8, 10, 12)]
    for _ in range(2):
        for b in buckets:
            fragment_scf.rhf_orthonormal(*b)
    assert len(made) == len(fragment_scf._CAPTURED) == 9
    monkeypatch.setattr(fragment_scf, "GRAPH_CACHE_BYTES", 0)
    fragment_scf.rhf_orthonormal(*buckets[0])
    assert len(fragment_scf._CAPTURED) == 1 and len(made) == 9
