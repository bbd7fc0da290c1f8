"""The tracer of quemb_tpu_torch (``utils/profiling.py``): the spans of a
BE job, their counters, their place on the profiler's clock, the
recorder's bound and the mesh's shard threads.

An H8 STO-3G BE2 job, ``fragmentate`` -> ``BE`` -> ``optimize(solver=
"CCSD")``, on the CPU.  There the in-core route runs quarter transforms,
so the ``cd_factor`` span of the host Cholesky factor is absent.
"""

import threading

import pytest
import torch

import quemb_tpu_torch as qt
from quemb_tpu_torch.chem.mole import Mole
from quemb_tpu_torch.chem.scf import RHF
from quemb_tpu_torch.matching import beopt
from quemb_tpu_torch.parallel.mesh import make_fragment_mesh, \
    run_on_shards, set_mesh
from quemb_tpu_torch.solvers import dispatch
from quemb_tpu_torch.utils import profiling as P

H8 = "; ".join(f"H 0 0 {i * 1.0}" for i in range(8))
CPU = dict(device="cpu")

CONSTRUCT = {"mean_field", "localize", "BE.initialize"}
INITIALIZE = {"schmidt", "eri", "fragment_init"}
STAGES = {"inputs", "scf", "mo_transform", "ccsd", "rdm", "energy", "error"}


@pytest.fixture(scope="module")
def mean_field():
    mol = Mole(atom=H8, basis="sto-3g")
    mf = RHF(mol, **CPU)
    mf.kernel()
    return mol, mf


@pytest.fixture(scope="module")
def job(mean_field):
    """One job, its trace and the calls of ``be_func`` made in it."""
    mol, mf = mean_field
    calls = []
    orig = beopt.be_func

    def counted(*args, **kwargs):
        calls.append(1)
        return orig(*args, **kwargs)

    beopt.be_func = counted
    try:
        be = qt.BE(mf, qt.fragmentate(mol, n_BE=2, print_frags=False),
                   **CPU)
        be.optimize(solver="CCSD")
    finally:
        beopt.be_func = orig
    trace = next(t for t in P.traces() if t.id == be.trace_id)
    return be, trace, len(calls)


def _by_name(trace, name):
    return [s for s in trace.spans if s.name == name]


def test_span_tree_of_a_job(job):
    be, trace, _ = job
    byid = {s.id: s for s in trace.spans}
    assert {s.trace for s in trace.spans} == {be.trace_id}
    names = {s.name for s in trace.spans}
    assert names == ({"fragmentate", "construct", "BE.optimize", "jacobian",
                      "eval"} | CONSTRUCT | INITIALIZE | STAGES)
    assert "cd_factor" not in names
    roots = [s.name for s in trace.spans if s.parent is None]
    assert sorted(roots) == ["BE.optimize", "construct", "fragmentate"]
    want_parent = {**{n: "construct" for n in CONSTRUCT},
                   **{n: "BE.initialize" for n in INITIALIZE},
                   **{n: "eval" for n in STAGES},
                   "jacobian": "BE.optimize", "eval": "BE.optimize"}
    for s in trace.spans:
        if s.parent is None:
            continue
        parent = byid[s.parent]
        assert parent.name == want_parent[s.name], s.name
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    # each stage of the objective counts its host reads
    for ev in _by_name(trace, "eval"):
        kids = [s for s in trace.spans if s.parent == ev.id]
        assert sum(s.counters.get("syncs", 0) for s in kids) > 0


def test_eval_spans_count_the_objective_calls(job):
    _, trace, calls = job
    assert calls >= 2
    assert len(_by_name(trace, "eval")) == calls


def test_timer_reads_its_span(mean_field):
    mol, mf = mean_field
    be = qt.BE(mf, qt.fragmentate(mol, n_BE=2, print_frags=False), **CPU)
    before = P.timer.times["BE.oneshot"]
    be.oneshot(solver="MP2")
    trace = next(t for t in P.traces() if t.id == be.trace_id)
    (sp,) = _by_name(trace, "BE.oneshot")
    assert P.timer.times["BE.oneshot"] - before == pytest.approx(
        sp.seconds, abs=1e-12)


def _spy(monkeypatch, name):
    """Record what ``dispatch.<name>`` returns."""
    seen = []
    orig = getattr(dispatch, name)

    def spy(*args, **kwargs):
        out = orig(*args, **kwargs)
        seen.append(out)
        return out

    monkeypatch.setattr(dispatch, name, spy)
    return seen


def test_lane_counters_of_a_two_lane_bucket(job, monkeypatch):
    """Two lanes that converge at different steps: the CCSD span counts
    the loop's trips and the lanes' own iteration counts, and the SCF
    span its trips."""
    be, _, _ = job
    frs = [be.fragments[0], be.fragments[2]]
    ccsd = _spy(monkeypatch, "_rccsd_from_mo_batched")
    scf = _spy(monkeypatch, "rhf_orthonormal")
    with P.span("probe") as probe:
        dispatch._solve_bucket_batched(frs, "CCSD", True, True, False)
    trace = next(t for t in P.traces() if t.id == probe.trace)
    it = ccsd[0][2].tolist()
    assert len(it) == 2 and it[0] != it[1]
    (cc,) = _by_name(trace, "ccsd")
    assert cc.counters["iters"] == max(it)
    assert cc.counters["lane_iters"] == sum(it)
    assert cc.counters["lanes"] == 2
    lane_use = 100.0 * cc.counters["lane_iters"] / (
        cc.counters["iters"] * cc.counters["lanes"])
    assert lane_use == pytest.approx(100.0 * sum(it) / (2 * max(it)))
    assert lane_use < 100.0
    (sc,) = _by_name(trace, "scf")
    assert sc.counters["iters"] == int(scf[0][3].max())


def test_spans_lie_on_the_profilers_clock(job):
    be, _, _ = job
    with P.span("probe") as probe:      # opened before the profiler: no range
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            be.oneshot(solver="CCSD")
    ranges: dict[str, list] = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("quemb."):
            ranges.setdefault(e.name()[len("quemb."):], []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    trace = next(t for t in P.traces() if t.id == probe.trace)
    mine = [s for s in trace.spans if s.id != probe.id]
    assert {s.name for s in mine} == set(ranges) >= STAGES - {"error"}
    for name, got in ranges.items():
        want = sorted((s.start_ns, s.end_ns) for s in mine if s.name == name)
        assert len(want) == len(got), name
        for (a, b), (c, d) in zip(want, sorted(got)):
            assert abs(a - c) < 1_000_000 and abs(b - d) < 1_000_000, name


def test_no_record_function_without_a_profiler(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name))
    with P.span("quiet"):
        pass
    assert opened == []


def test_recorder_keeps_the_newest_traces():
    first = None
    for _ in range(P.KEEP + 20):
        with P.span("root") as sp:
            P.count("n")
        first = sp.trace if first is None else first
    kept = P.traces()
    assert len(kept) == P.KEEP
    assert kept[-1].id == sp.trace
    assert first not in {t.id for t in kept}
    assert kept[-1].spans[0].counters == {"n": 1}


def test_counters_and_totals():
    before = P.total("probe.count")
    with P.span("outer") as outer:
        P.count("probe.count", 3)
        with P.span("inner") as inner:
            P.count("probe.count")
    P.count("probe.count", 2)           # no span open: the total alone
    assert P.total("probe.count") - before == 6
    trace = next(t for t in P.traces() if t.id == outer.trace)
    got = {s.name: dict(s.counters) for s in trace.spans}
    assert got == {"outer": {"probe.count": 3}, "inner": {"probe.count": 1}}
    assert inner.trace == outer.trace
    with pytest.raises(TypeError):
        trace.spans[0].counters["probe.count"] = 0


def test_shard_threads_attach_to_the_callers_span():
    main = threading.get_ident()
    threads = []

    def work(chunk, device):
        threads.append(threading.get_ident())
        with P.span("shard"):
            P.count("items", len(chunk))
        return len(chunk)

    with P.span("caller") as caller:
        out = run_on_shards(work, [[1, 2], [3]], [None, None])
    assert out == [2, 1] and main not in threads
    trace = next(t for t in P.traces() if t.id == caller.trace)
    shards = _by_name(trace, "shard")
    assert len(shards) == 2
    assert all(s.parent == caller.id for s in shards)
    assert sorted(s.counters["items"] for s in shards) == [1, 2]


def test_mesh_shards_of_an_evaluation_join_its_trace(job):
    be, _, _ = job
    set_mesh(make_fragment_mesh(["cpu", "cpu"]))
    try:
        with P.span("probe") as probe:
            be.oneshot(solver="CCSD")
    finally:
        set_mesh(None)
    trace = next(t for t in P.traces() if t.id == probe.trace)
    (ev,) = _by_name(trace, "eval")
    scf = [s for s in trace.spans if s.name == "scf" and s.parent == ev.id]
    assert len(scf) == 2
    assert all(s.counters["iters"] > 0 for s in scf)
