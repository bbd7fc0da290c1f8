"""The readers of the program's own spans and counters
(``portbench/lib/program.py`` and the metrics that use it), on a
synthetic recorder and trace: each reader's value, and nothing where
there is nothing to read."""

from types import SimpleNamespace

import pytest

from portbench.lib import registry
from portbench.lib.trace import Profile, Spans, Timeline, TraceData
from quemb_tpu_torch.utils import profiling

READERS = ["cd_factor_s", "scf_s", "scf_iters_per_eval", "ccsd_s",
           "ccsd_iters_per_eval", "ccsd_lane_use", "syncs_per_eval",
           "ccsd_idle_share"]

T0 = 1_790_000_000 * 10 ** 9           # Unix-epoch ns
MS = 10 ** 6


def _job(tid: int, t0: int) -> profiling.Trace:
    """One job: construction with a 100 ms factor, a Jacobian, and two
    evaluations, each with an SCF of 20 ms and a CCSD of 50 ms."""
    spans, ids = [], iter(range(tid * 100, tid * 100 + 100))

    def add(name, parent, a, b, **counters):
        sid = next(ids)
        spans.append(profiling.SpanRecord(name, tid, sid, parent, t0 + a * MS,
                                          t0 + b * MS, counters))
        return sid

    add("fragmentate", None, 0, 1)
    c = add("construct", None, 1, 200)
    i = add("BE.initialize", c, 10, 200)
    e = add("eri", i, 20, 150, syncs=2)
    add("cd_factor", e, 30, 130)
    o = add("BE.optimize", None, 200, 400)
    add("jacobian", o, 200, 230, syncs=30)
    for k in range(2):
        a = 230 + 80 * k
        ev = add("eval", o, a, a + 80)
        add("scf", ev, a, a + 20, iters=10, syncs=31)
        add("ccsd", ev, a + 20, a + 70, iters=15, lanes=6, lane_iters=80,
            syncs=16)
        add("rdm", ev, a + 70, a + 75, syncs=3)
    return profiling.Trace(tid, tuple(spans))


def _op(name, start_us, end_us, device_us=0.0):
    return SimpleNamespace(name=name, device_time_total=device_us,
                           time_range=SimpleNamespace(start=start_us,
                                                      end=end_us))


def _data(jobs=2, timeline=True):
    # the job profiled after the window starts 10 s after the first job
    first_kernel_us = (T0 + 10_000 * MS) / 1e3
    tl = Timeline(jobs=1, window_us=1e6,
                  kernels=[("k", first_kernel_us, first_kernel_us + 5.0)],
                  busy_us=5.0) if timeline else None
    ops = [_op("quemb.eval", 0, 100), _op("quemb.ccsd", 10, 60, 20_000.0),
           _op("quemb.eval", 100, 200), _op("quemb.ccsd", 110, 160, 20_000.0)]
    prof = Profile(ops=ops, busy_us=1.0, gaps=[], dtypes={})
    return TraceData(jobs=jobs, job_s=0.5, construct_s=[0.2] * jobs,
                     spans=Spans(), timeline=tl, profile=prof,
                     peak_mem_bytes=0)


@pytest.fixture
def recorder(monkeypatch):
    """The warm job, two window jobs, and the profiled job, which ends
    after the first kernel and so is no window job."""
    found = [_job(1, T0 - 5_000 * MS), _job(2, T0), _job(3, T0 + 1_000 * MS),
             _job(4, T0 + 9_900 * MS)]
    monkeypatch.setattr(profiling, "traces", lambda: tuple(found))
    return found


def _read(name, data):
    return registry.metric_reader(name)(data)


def test_each_reader_reads_the_window(recorder):
    data = _data()
    got = {name: _read(name, data) for name in READERS}
    assert got == pytest.approx({
        "cd_factor_s": 0.1, "scf_s": 0.02, "scf_iters_per_eval": 10.0,
        "ccsd_s": 0.05, "ccsd_iters_per_eval": 15.0,
        "ccsd_lane_use": 100.0 * 80 / (15 * 6),
        "syncs_per_eval": 31 + 16 + 3,
        # 20 ms of device time per evaluation in a 50 ms stage
        "ccsd_idle_share": 60.0})


def test_window_is_the_last_jobs_before_the_first_kernel(recorder):
    from portbench.lib.program import window_traces

    assert [tr.id for tr in window_traces(_data(jobs=2))] == [2, 3]
    assert [tr.id for tr in window_traces(_data(jobs=3))] == [1, 2, 3]


@pytest.mark.parametrize("name", READERS)
def test_nothing_without_a_device_timeline(recorder, name):
    assert _read(name, _data(timeline=False)) is None


@pytest.mark.parametrize("name", READERS)
def test_nothing_with_fewer_traces_than_jobs(recorder, name):
    assert _read(name, _data(jobs=4)) is None


@pytest.mark.parametrize("name", READERS)
def test_nothing_from_a_program_without_the_tracer(monkeypatch, name):
    monkeypatch.delattr(profiling, "traces")
    assert _read(name, _data()) is None


def test_nothing_where_the_counter_is_absent(monkeypatch):
    bare = [profiling.Trace(tid, tuple(
        s._replace(counters={}) for s in _job(tid, T0 + tid * MS).spans))
        for tid in (1, 2)]
    monkeypatch.setattr(profiling, "traces", lambda: tuple(bare))
    data = _data()
    for name in ("scf_iters_per_eval", "ccsd_iters_per_eval",
                 "ccsd_lane_use", "syncs_per_eval"):
        assert _read(name, data) is None, name
    assert _read("scf_s", data) == pytest.approx(0.02)
