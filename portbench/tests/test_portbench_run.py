"""A whole run on the CPU, past the harness's look for a card: the sound
program is judged correct and its result line has the contract's keys;
the control (the program's f32 CCSD tier) and each fault the cell can
have, planted in the program, are judged not correct.

The runs share one seed, so the reference's evaluation at a potential
is worked out once for the module.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench.lib import harness, registry
from portbench.lib.faults import planted
from portbench.lib.judge import Judge

ROOT = Path(__file__).resolve().parents[2]
SEED = 4242
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture(scope="module", autouse=True)
def shared_reference():
    memo = {}
    orig = Judge.evaluate

    def evaluate(self, heffs):
        key = b"".join(h.tobytes() for h in heffs)
        if key not in memo:
            memo[key] = orig(self, heffs)
        return memo[key]

    Judge.evaluate = evaluate
    yield
    Judge.evaluate = orig


def cpu_run(trace=False):
    cell = registry.load_cell("octane-be2.match")
    return harness.run(cell, SEED, 0.0, trace, "cpu", time.perf_counter())


def test_sound_run_is_correct_and_has_the_contract_keys():
    out = cpu_run(trace=True)
    assert list(out) == KEYS
    json.dumps(out)
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] == 1
    assert set(out["metrics"]) == {"construct_s", "jacobian_s",
                                   "evals_per_solve", "eval_s"}
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())
    assert out["device"]["platform"] == "cpu"


def test_untraced_metrics_are_the_end_to_end_ones():
    out = cpu_run()
    assert set(out["metrics"]) == {"solve_s", "setup_s"}
    assert out["correct"] is True


def test_control_is_not_correct(monkeypatch):
    monkeypatch.setenv("QUEMB_TPU_CCSD_F32_ONLY", "1")
    out = cpu_run()
    assert out["correct"] is False
    assert out["checks"]["energy_gap"]["value"] > \
        out["checks"]["energy_gap"]["limit"]


def test_step_that_leaves_its_state_unchanged():
    with planted("step_unchanged"):
        out = cpu_run()
    assert out["correct"] is False
    assert out["checks"]["match_error"]["value"] > \
        out["checks"]["match_error"]["limit"]


@pytest.mark.parametrize("fault", ["half_batch", "altered_answer"])
def test_fault_is_not_correct(fault):
    with planted(fault):
        out = cpu_run()
    assert out["correct"] is False


def test_no_card_no_result():
    """Without a card the command exits with 2 and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "octane-be2.match",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 2 and p.stdout == ""


@pytest.mark.gpu
def test_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for cell in ("octane-be2.match", "octane-be3.chempot"):
        p = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload", cell,
             "--seed", "2147483659", "--seconds", "3", "--trace", "0"],
            cwd=ROOT, capture_output=True, text=True, timeout=360)
        assert p.returncode == 0, p.stderr[-2000:]
        out = json.loads(p.stdout.strip().splitlines()[-1])
        assert list(out) == KEYS and out["correct"] is True
