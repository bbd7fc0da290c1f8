"""The benchmark of quemb_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

prints, as its last line, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device`` (and ``breakdown`` when
traced), then ``checks``: each number the judge compared, with its limit.
Needs a CUDA card; exits with 2 without one.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.lib.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
