"""Finds what belongs to a cell by the names in ``BENCHMARK.json``.

A configuration is the file its ``configs`` entry names; a traffic mix is
``portbench/traffic/<traffic>.json``; a cell's limits for ``correct`` are
``portbench/limits/<cell>.json``; a per-layer metric is read by the
function ``read`` of ``portbench/metrics/<metric>.py``.

A configuration whose inputs, mean field or reference need code of their
own brings a module beside its file, ``portbench/configs/<config>.py``.
It may define any of ``make_inputs(root, config, seed, device)``,
``Runner`` (the program's side: mean field and job, as
:class:`portbench.lib.harness.Runner`) and ``Judge`` (the reference's
side, as :class:`portbench.lib.judge.Judge`); what it leaves out is the
default.  A new cell, configuration, mix or metric is a new file and a
new entry: nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Callable

ROOT = Path(__file__).resolve().parents[2]

#: what a configuration's module may define
HOOKS = ("make_inputs", "Runner", "Judge")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    #: the checkout the cell's files were read from
    root: Path = ROOT
    #: the configuration's own module, or None
    module: ModuleType | None = None

    def hook(self, name: str, default):
        """The configuration module's ``name``, else ``default``."""
        assert name in HOOKS, name
        return getattr(self.module, name, default)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _module(path: Path, prefix: str) -> ModuleType | None:
    if not path.is_file():
        return None
    tag = path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(f"{prefix}_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = _json(root / "BENCHMARK.json")
    work = [w for w in bench["workloads"] if w["name"] == name]
    if not work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=_json(root / conf["file"]),
        traffic=_json(root / "portbench" / "traffic" / f"{w['traffic']}.json"),
        limits=_json(root / "portbench" / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        root=root,
        module=_module(root / "portbench" / "configs" / f"{conf['name']}.py",
                       "portbench_config"),
    )


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    """``read(trace) -> float | None`` of ``portbench/metrics/<name>.py``."""
    return _module(root / "portbench" / "metrics" / f"{name}.py",
                   "portbench_metric").read
