"""The tracer's spans and counters for IAO localization, the frozen core
and the buckets of the objective (``utils/profiling.py``), and the
benchmark's readers of them (``portbench/metrics/iao_s.py``,
``pad_share.py``, ``large_path_share.py``).

A methyl thiocyanate (CH3SCN) 6-31G BE2 job with IAOs on STO-3G and a
frozen core, on the CPU: two fragments of 34 and 31 orbitals, which the
objective solves as one bucket padded to 34.
"""

import pytest

import quemb_tpu_torch as qt
from portbench.lib import registry
from portbench.lib.trace import Spans, Timeline, TraceData
from quemb_tpu_torch.chem.mole import Mole
from quemb_tpu_torch.chem.scf import RHF
from quemb_tpu_torch.solvers import dispatch
from quemb_tpu_torch.utils import profiling as P

#: methyl thiocyanate, Angstrom: C-S 1.82, S-C 1.70, C-N 1.16, C-S-C 100
CH3SCN = [
    ("C", (-1.82000, 0.00000, 0.00000)),
    ("S", (0.00000, 0.00000, 0.00000)),
    ("C", (0.29520, 1.67417, 0.00000)),
    ("N", (0.49663, 2.81655, 0.00000)),
    ("H", (-2.18406, 1.02787, 0.00000)),
    ("H", (-2.18406, -0.51393, 0.89016)),
    ("H", (-2.18406, -0.51394, -0.89016)),
]


@pytest.fixture(scope="module")
def job():
    mol = Mole(atom=CH3SCN, basis="6-31g")
    mf = RHF(mol, device="cpu")
    mf.kernel()
    fobj = qt.fragmentate(mol, n_BE=2, iao_valence_basis="sto-3g",
                          frozen_core=True, print_frags=False)
    be = qt.BE(mf, fobj, lo_method="IAO", device="cpu")
    be.oneshot(solver="CCSD")
    trace = next(t for t in P.traces() if t.id == be.trace_id)
    return be, trace


def _by_name(trace, name):
    return [s for s in trace.spans if s.name == name]


def test_iao_and_core_spans_lie_in_construction(job):
    _, trace = job
    byid = {s.id: s for s in trace.spans}

    def chain(s):
        out = []
        while s.parent is not None:
            s = byid[s.parent]
            out.append(s.name)
        return out

    (iao,) = _by_name(trace, "iao")
    (core,) = _by_name(trace, "core")
    assert chain(iao) == ["localize", "construct"]
    assert chain(core) == ["mean_field", "construct"]
    assert iao.seconds > 0 and core.seconds > 0


def test_counters_of_a_padded_bucket(job):
    be, trace = job
    widths = sorted(fr.nao for fr in be.fragments)
    assert widths == [31, 34]
    (cc,) = _by_name(trace, "ccsd")
    assert cc.counters["lanes"] == 2
    assert cc.counters["orbs"] == 31 + 34
    assert cc.counters["pad_orbs"] == 2 * 34 - (31 + 34)
    # no lane is wider than the batched width
    assert cc.counters.get("large", 0) == 0


def test_large_path_counts_each_fragment(job, monkeypatch):
    """The plan a card makes of fragments wider than the batched width,
    here lowered below both widths: one bucket a fragment, each counted
    as ``large`` and a lane, and neither as ``orbs``."""
    be, _ = job
    monkeypatch.setattr(dispatch, "_NEMB_BATCHED_MAX", 30)
    monkeypatch.setattr(dispatch, "_solved_alone", lambda *a: True)
    with P.span("probe") as probe:
        dispatch.be_func(None, be.fragments, be.Nocc, "CCSD", eeval=True)
    trace = next(t for t in P.traces() if t.id == probe.trace)
    found = _by_name(trace, "ccsd")
    assert len(found) == 2
    assert all(s.counters["large"] == s.counters["lanes"] == 1
               for s in found)
    assert not any("orbs" in s.counters for s in found)


# the readers, on a synthetic window of two jobs

T0 = 1_790_000_000 * 10 ** 9           # Unix-epoch ns
MS = 10 ** 6


def _trace(tid, t0, buckets, iao_ms=40):
    """A job: construction with an ``iao`` span of ``iao_ms``, then one
    evaluation with a ``ccsd`` span per bucket, each given its
    counters."""
    spans, ids = [], iter(range(tid * 100, tid * 100 + 100))

    def add(name, parent, a, b, **counters):
        sid = next(ids)
        spans.append(P.SpanRecord(name, tid, sid, parent, t0 + a * MS,
                                  t0 + b * MS, counters))
        return sid

    c = add("construct", None, 0, 200)
    loc = add("localize", c, 10, 10 + iao_ms)
    add("iao", loc, 10, 10 + iao_ms)
    o = add("BE.optimize", None, 200, 400)
    ev = add("eval", o, 200, 300)
    for k, counters in enumerate(buckets):
        add("ccsd", ev, 200 + 10 * k, 205 + 10 * k, **counters)
    return P.Trace(tid, tuple(spans))


def _data(jobs=2, timeline=True):
    first_kernel_us = (T0 + 10_000 * MS) / 1e3
    tl = Timeline(jobs=1, window_us=1e6,
                  kernels=[("k", first_kernel_us, first_kernel_us + 5.0)],
                  busy_us=5.0) if timeline else None
    return TraceData(jobs=jobs, job_s=0.5, construct_s=[0.2] * jobs,
                     spans=Spans(), timeline=tl, profile=None,
                     peak_mem_bytes=0)


def _read(name, data):
    return registry.metric_reader(name)(data)


#: a padded bucket of three lanes (widths 40, 38, 36 in 40) and the two
#: large-path fragments of 51
MIXED = [dict(lanes=3, orbs=114, pad_orbs=6),
         dict(lanes=1, large=1), dict(lanes=1, large=1)]


def _recorded(monkeypatch, buckets, iao_ms=(40, 60)):
    found = [_trace(1, T0, buckets, iao_ms[0]),
             _trace(2, T0 + 1_000 * MS, buckets, iao_ms[1])]
    monkeypatch.setattr(P, "traces", lambda: tuple(found))


def test_readers_of_a_mixed_evaluation(monkeypatch):
    _recorded(monkeypatch, MIXED)
    data = _data()
    assert _read("iao_s", data) == pytest.approx(0.05)
    assert _read("pad_share", data) == pytest.approx(100.0 * 6 / 120)
    assert _read("large_path_share", data) == pytest.approx(100.0 * 2 / 5)


def test_batched_alone_reads_no_large_path(monkeypatch):
    _recorded(monkeypatch, [dict(lanes=6, orbs=244, pad_orbs=8)])
    data = _data()
    assert _read("large_path_share", data) == 0.0
    assert _read("pad_share", data) == pytest.approx(100.0 * 8 / 252)


@pytest.mark.parametrize("name", ["iao_s", "pad_share", "large_path_share"])
def test_readers_find_nothing_where_nothing_was_recorded(monkeypatch, name):
    # a program that predates the counters, and a window without a
    # device timeline
    _recorded(monkeypatch, [dict(lanes=6, lane_iters=90, iters=15)])
    if name != "iao_s":
        assert _read(name, _data()) is None
    _recorded(monkeypatch, MIXED)
    assert _read(name, _data(timeline=False)) is None
    assert _read(name, _data(jobs=3)) is None
