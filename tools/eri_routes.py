"""The fragment-ERI routes of the in-core transform, side by side on one
card: the default ("auto", by size) against the host pivoted-Cholesky
factor (``QUEMB_TPU_INCORE_CD=1``), job by job in turn, in the benchmark's
cells.

    python3 tools/eri_routes.py [--cells CELL[,CELL...]] [--jobs N]
        [--seed S] [--out PATH] [--device cuda|cpu]

For each cell: its seeded inputs and mean field as ``portbench/run.py``
builds them, one warm job a route, then ``N`` jobs a route in turn.  Per
job and route: the job's wall, the program's spans a job (``construct``,
``eri``, ``cd_factor``, ``iao``, ``fragment_init``, ``jacobian``, the
summed ``eval``), the ``eri`` span's route counters, the card's peak
memory over the job and the job's total energy.  Prints one JSON line a
cell with the medians a route, and writes every job's line to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CELLS = ("octane-be2.oneshot", "octane-be2.match", "octane-be3.chempot",
         "thiophene-dimer-be2-iao.match")
STAGES = ("construct", "eri", "cd_factor", "iao", "fragment_init",
          "jacobian", "eval")
ROUTES = {"auto": None, "cd": "1"}


def _set_route(route: str) -> None:
    value = ROUTES[route]
    if value is None:
        os.environ.pop("QUEMB_TPU_INCORE_CD", None)
    else:
        os.environ["QUEMB_TPU_INCORE_CD"] = value


def _job(runner, route: str) -> dict:
    import torch

    from quemb_tpu_torch.utils import profiling

    card = runner.device.startswith("cuda")
    sync = torch.cuda.synchronize if card else (lambda: None)
    _set_route(route)
    sync()
    if card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = runner.job()
    sync()
    wall = time.perf_counter() - t0
    trace = profiling.traces()[-1]
    peak = torch.cuda.max_memory_allocated() if card else 0
    row = {"route": route, "wall_s": wall, "e_tot": state["e_tot"],
           "peak_gib": peak / 2 ** 30}
    for name in STAGES:
        row[name] = sum(s.seconds for s in trace.spans if s.name == name)
    (eri,) = [s for s in trace.spans if s.name == "eri"]
    row["counters"] = {k: v for k, v in eri.counters.items()
                       if k.startswith("eri.")}
    return row


def cell_rows(name: str, jobs: int, seed: int, device: str) -> list[dict]:
    import torch

    from portbench.lib import harness, registry
    from portbench.lib import inputs as inp

    torch.backends.cuda.matmul.allow_tf32 = False
    cell = registry.load_cell(name)
    make_inputs = cell.hook("make_inputs", inp.make_inputs)
    runner = cell.hook("Runner", harness.Runner)(
        cell, make_inputs(cell.root, cell.config, seed, device), device)
    for route in ROUTES:                          # warm, discarded
        _job(runner, route)
    rows = []
    for _ in range(jobs):
        for route in ROUTES:
            rows.append({"cell": name, **_job(runner, route)})
    _set_route("auto")
    return rows


def summary(name: str, rows: list[dict]) -> dict:
    out = {"cell": name}
    for route in ROUTES:
        mine = [r for r in rows if r["route"] == route]
        out[route] = {k: statistics.median(r[k] for r in mine)
                      for k in ("wall_s", "peak_gib", *STAGES)}
        out[route]["counters"] = mine[-1]["counters"]
        out[route]["e_tot"] = [r["e_tot"] for r in mine]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--seed", type=int, default=2300017001)
    ap.add_argument("--out", default="profile_out/eri_routes.jsonl")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        for k, name in enumerate(args.cells.split(",")):
            rows = cell_rows(name, args.jobs, args.seed + k, args.device)
            for r in rows:
                f.write(json.dumps(r) + "\n")
            print(json.dumps(summary(name, rows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
