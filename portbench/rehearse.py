"""CPU rehearsal of the benchmark: each cell's job at full size on the
CPU with the plain reference, so that a first run on the card is not
spent on paths or shapes.

    python3 portbench/rehearse.py [--cells a,b] [--seed n]

Prints each cell's result object.  Its times are the CPU's, never a
device metric: the harness labels such a result ``platform: cpu``.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.lib import harness, registry  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", default="")
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    bench = json.loads((registry.ROOT / "BENCHMARK.json").read_text())
    names = (args.cells.split(",") if args.cells
             else [w["name"] for w in bench["workloads"]])
    for name in names:
        t0 = time.perf_counter()
        out = harness.run(registry.load_cell(name), args.seed, 0.0,
                          False, "cpu", t0)
        out["rehearsal_wall_s"] = time.perf_counter() - t0
        print(name, json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
