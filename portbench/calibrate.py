"""Readings that the limits of ``correct`` are set from, many seeds in one
process: for each seed one job of the cell, judged by the reference; then
the same for the control (the program's f32 CCSD tier) and for a fault
planted in the program (:mod:`portbench.lib.faults`).

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--fault step_unchanged --fault-seeds 7,8]

Prints one JSON line per seed: the judge's numbers, the job's and the
judge's walls.
"""

import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.lib import harness, registry  # noqa: E402
from portbench.lib import inputs as inp  # noqa: E402
from portbench.lib.faults import FAULTS, planted  # noqa: E402

DEVICE = "cuda:0"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", choices=sorted(FAULTS))
    ap.add_argument("--fault-seeds", default="")
    args = ap.parse_args()
    harness.cache_dirs(registry.ROOT)
    import torch

    from portbench.lib.judge import Judge

    torch.backends.cuda.matmul.allow_tf32 = False
    cell = registry.load_cell(args.workload)
    make_inputs = cell.hook("make_inputs", inp.make_inputs)
    runner_cls = cell.hook("Runner", harness.Runner)
    judge_cls = cell.hook("Judge", Judge)

    def seeds(text):
        return [int(s) for s in text.split(",") if s]

    plan = [(s, None) for s in seeds(args.seeds)]
    plan += [(s, "control") for s in seeds(args.control_seeds)]
    if args.fault:
        plan += [(s, args.fault) for s in seeds(args.fault_seeds)]
    for seed, kind in plan:
        if kind == "control":
            os.environ["QUEMB_TPU_CCSD_F32_ONLY"] = "1"
        else:
            os.environ.pop("QUEMB_TPU_CCSD_F32_ONLY", None)
        inputs = make_inputs(cell.root, cell.config, seed, DEVICE)
        runner = runner_cls(cell, inputs, DEVICE)
        fault = (planted(kind) if kind not in (None, "control")
                 else contextlib.nullcontext())
        t0 = time.perf_counter()
        with fault:
            state = runner.job()
        t1 = time.perf_counter()
        del runner
        numbers = judge_cls(inputs, cell.config, cell.traffic,
                            DEVICE).judge(state)
        print(json.dumps({"cell": cell.name, "seed": seed,
                          "control": kind == "control", "fault": kind
                          if kind not in (None, "control") else None,
                          **numbers, "job_s": t1 - t0,
                          "judge_s": time.perf_counter() - t1}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
