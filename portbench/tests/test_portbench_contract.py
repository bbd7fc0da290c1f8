"""BENCHMARK.json keeps to the benchmark contract's form."""

import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}$")


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(line(w) for w in BENCH["command"])
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert (ROOT / p).is_dir()


def test_entries():
    confs = {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert (ROOT / c["file"]).is_file()
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] \
            == c["reduced"]
    used = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in confs
        assert w["chips"] in (1, 4) and line(w["why"])
        assert (w["config"], w["traffic"]) not in used
        used.add((w["config"], w["traffic"]))
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json"
                ).is_file()
        assert (ROOT / "portbench" / "limits" / f"{w['name']}.json").is_file()
    assert confs == {w["config"] for w in BENCH["workloads"]}


def test_metrics():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["moves"] in e2e and line(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_a_full_check_fits_its_time():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
