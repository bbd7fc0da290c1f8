"""The readers of the in-core route's counters, ``eri_direct_share`` and
``eri_s``, on a synthetic recorder and trace: 100 where every fragment
took the quarter transform, 0 where all took the Cholesky factor, the
``eri`` spans' mean wall a job, and nothing from a program that counts
neither."""

import pytest

from portbench.lib import registry
from portbench.lib.trace import Profile, Spans, Timeline, TraceData
from quemb_tpu_torch.utils import profiling

READERS = ["eri_direct_share", "eri_s"]

T0 = 1_790_000_000 * 10 ** 9           # Unix-epoch ns
MS = 10 ** 6


def _job(tid: int, t0: int, eri_ms: int, **counters) -> profiling.Trace:
    """One job: construction whose ``eri`` span lasts ``eri_ms`` and
    carries ``counters``, a ``cd_factor`` inside it where ``eri.cd`` is
    counted, and one evaluation."""
    spans, ids = [], iter(range(tid * 100, tid * 100 + 100))

    def add(name, parent, a, b, **c):
        sid = next(ids)
        spans.append(profiling.SpanRecord(name, tid, sid, parent, t0 + a * MS,
                                          t0 + b * MS, c))
        return sid

    add("fragmentate", None, 0, 1)
    c = add("construct", None, 1, 300)
    i = add("BE.initialize", c, 10, 300)
    e = add("eri", i, 20, 20 + eri_ms, **counters)
    if "eri.cd" in counters:
        add("cd_factor", e, 21, 19 + eri_ms)
    o = add("BE.oneshot", None, 300, 400)
    add("eval", o, 300, 400)
    return profiling.Trace(tid, tuple(spans))


def _data(jobs=2, timeline=True):
    # the job profiled after the window starts 10 s after the first job
    first_kernel_us = (T0 + 10_000 * MS) / 1e3
    tl = Timeline(jobs=1, window_us=1e6,
                  kernels=[("k", first_kernel_us, first_kernel_us + 5.0)],
                  busy_us=5.0) if timeline else None
    prof = Profile(ops=[], busy_us=1.0, gaps=[], dtypes={})
    return TraceData(jobs=jobs, job_s=0.5, construct_s=[0.2] * jobs,
                     spans=Spans(), timeline=tl, profile=prof,
                     peak_mem_bytes=0)


def _record(monkeypatch, *counters, eri_ms=(4, 8, 6)):
    """The warm job and two window jobs, one a set of ``counters`` and
    an ``eri_ms``, then the profiled job, which ends after the first
    kernel and so is no window job."""
    found = [_job(k + 1, T0 + k * 1_000 * MS, ms, **c)
             for k, (c, ms) in enumerate(zip(counters, eri_ms))]
    found.append(_job(9, T0 + 9_900 * MS, 500, **counters[-1]))
    monkeypatch.setattr(profiling, "traces", lambda: tuple(found))


def _read(name, data):
    return registry.metric_reader(name)(data)


DIRECT = {"eri.direct": 6}
CD = {"eri.cd": 6}


@pytest.mark.parametrize("route, share", [
    ((DIRECT, DIRECT, DIRECT), 100.0),
    ((CD, CD, CD), 0.0),
    # the window is the last two jobs: one of each
    ((DIRECT, CD, DIRECT), 50.0),
])
def test_direct_share(monkeypatch, route, share):
    _record(monkeypatch, *route)
    assert _read("eri_direct_share", _data()) == pytest.approx(share)


@pytest.mark.parametrize("route", [(DIRECT,) * 3, (CD,) * 3])
def test_eri_s_is_the_mean_wall_a_job(monkeypatch, route):
    _record(monkeypatch, *route)
    # the window's eri spans last 8 and 6 ms
    assert _read("eri_s", _data()) == pytest.approx(0.007)


@pytest.mark.parametrize("name", READERS)
def test_nothing_without_the_counters(monkeypatch, name):
    """A program that predates the counters: its ``eri`` spans and
    ``cd_factor`` are there, uncounted."""
    _record(monkeypatch, {}, {}, {})
    assert _read(name, _data()) is None


@pytest.mark.parametrize("name", READERS)
def test_nothing_without_a_device_timeline(monkeypatch, name):
    _record(monkeypatch, DIRECT, DIRECT, DIRECT)
    assert _read(name, _data(timeline=False)) is None


@pytest.mark.parametrize("name", READERS)
def test_nothing_with_fewer_traces_than_jobs(monkeypatch, name):
    _record(monkeypatch, DIRECT, DIRECT, DIRECT)
    assert _read(name, _data(jobs=4)) is None


@pytest.mark.parametrize("name", READERS)
def test_nothing_from_a_program_without_the_tracer(monkeypatch, name):
    monkeypatch.delattr(profiling, "traces")
    assert _read(name, _data()) is None


def test_listed_in_every_cell():
    """Both readers are declared for the four cells and read in each."""
    import json

    bench = json.loads((registry.ROOT / "BENCHMARK.json").read_text())
    cells = [w["name"] for w in bench["workloads"]]
    for name in READERS:
        (m,) = [m for m in bench["per_layer"] if m["name"] == name]
        assert m["workloads"] == cells
        assert m["layer"] == "BE construction" and m["moves"] == "solve_s"
        for cell in cells:
            assert name in [p["name"] for p in
                            registry.load_cell(cell).per_layer]
