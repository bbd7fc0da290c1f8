"""The harness finds configurations, traffic, limits and metric readers
by the names in BENCHMARK.json, so that a new one is new files alone."""

import json
import shutil
import time
from pathlib import Path

import pytest

from portbench.lib import harness, registry
from portbench.lib.trace import Spans, TraceData

ROOT = Path(__file__).resolve().parents[2]


def test_every_cell_loads():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = registry.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert {"energy_gap", "potential_form", "failed"} <= set(cell.limits)
        for m in cell.per_layer:
            assert callable(registry.metric_reader(m["name"]))


def test_new_files_are_taken_without_an_edit(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp_path / "portbench"
    conf = json.loads((pb / "configs" / "octane-be2.json").read_text())
    conf["name"] = "dummy"
    (pb / "configs" / "dummy.json").write_text(json.dumps(conf))
    (pb / "traffic" / "dummy-mix.json").write_text(json.dumps(
        {"call": "oneshot", "kwargs": {"solver": "CCSD"},
         "potentials": "none"}))
    (pb / "limits" / "dummy.oneshot.json").write_text(json.dumps(
        {"energy_gap": 1.0, "potential_form": 0, "failed": 0}))
    (pb / "metrics" / "dummy_count.py").write_text(
        "def read(t):\n    return float(t.jobs)\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy", "source": "x",
                             "file": "portbench/configs/dummy.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "dummy.oneshot", "config": "dummy",
                               "traffic": "dummy-mix", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "dummy_count", "unit": "jobs",
                               "better": "lower", "source": "host_clock",
                               "layer": "x", "moves": "solve_s",
                               "workloads": ["dummy.oneshot"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = registry.load_cell("dummy.oneshot", root=tmp_path)
    assert cell.traffic["call"] == "oneshot"
    assert cell.limits["energy_gap"] == 1.0
    assert [m["name"] for m in cell.per_layer] == ["dummy_count"]
    read = registry.metric_reader("dummy_count", root=tmp_path)
    data = TraceData(jobs=4, job_s=1.0, construct_s=[], spans=Spans(),
                     timeline=None, profile=None, peak_mem_bytes=0)
    assert read(data) == 4.0
    # the cells already there still load from the copy
    assert registry.load_cell("octane-be2.match", root=tmp_path).chips == 1


def test_readers_find_nothing_in_an_empty_trace():
    """A reader with nothing to read returns nothing, never 0."""
    data = TraceData(jobs=0, job_s=0.0, construct_s=[], spans=Spans(),
                     timeline=None, profile=None, peak_mem_bytes=0)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        assert registry.metric_reader(m["name"])(data) is None, m["name"]


#: a configuration whose inputs, program side and reference are its own
#: code: a module beside its file, found by the configuration's name
TOY_MODULE = """
import numpy as np


def make_inputs(root, config, seed, device):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal(config["n"])}


class Runner:
    def __init__(self, cell, inputs, device):
        self.x = inputs["x"]
        self.offset = cell.config["offset"]

    def job(self, on_construct=None):
        if on_construct is not None:
            on_construct(0.0)
        return {"total": float(self.x @ self.x) + self.offset}


class Judge:
    def __init__(self, inputs, config, traffic, device):
        self.want = float(np.sum(inputs["x"] ** 2))

    def judge(self, state):
        return {"gap": abs(state["total"] - self.want)}
"""


@pytest.mark.parametrize("offset,correct", [(0.0, True), (1e-6, False)])
def test_configuration_with_code_of_its_own(tmp_path, offset, correct):
    """A configuration that makes its own inputs and brings its own
    mean field and reference runs by new files and entries alone."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp_path / "portbench"
    (pb / "configs" / "toy.json").write_text(json.dumps(
        {"name": "toy", "n": 7, "offset": offset, "reduced": []}))
    (pb / "configs" / "toy.py").write_text(TOY_MODULE)
    (pb / "traffic" / "toy-mix.json").write_text(json.dumps(
        {"call": "none", "kwargs": {}, "potentials": "none"}))
    (pb / "limits" / "toy.mix.json").write_text(json.dumps(
        {"gap": 1e-12, "failed": 0}))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy", "source": "x",
                             "file": "portbench/configs/toy.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "toy.mix", "config": "toy",
                               "traffic": "toy-mix", "chips": 1, "why": "x"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = registry.load_cell("toy.mix", root=tmp_path)
    assert cell.module is not None
    out = harness.run(cell, 2**31 + 5, 0.01, False, "cpu",
                      time.perf_counter())
    assert out["correct"] is correct
    assert out["checks"]["gap"]["limit"] == 1e-12
    assert set(out["metrics"]) == {"solve_s", "setup_s"}
    # the configurations already there have no module and take the default
    assert registry.load_cell("octane-be2.match", root=tmp_path).module \
        is None
