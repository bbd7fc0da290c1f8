"""The octane one-shot cell on the CPU, past the harness's look for a
card: a sound job is judged correct with the numbers its limits name,
and the control (the program's f32 CCSD tier) is not."""

import time

import pytest

from portbench.lib import harness, registry
from portbench.lib.judge import Judge

SEED = 2**31 + 4243


@pytest.fixture(scope="module", autouse=True)
def shared_reference():
    """Both runs are judged at the zero potential: worked out once."""
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


def cpu_run():
    cell = registry.load_cell("octane-be2.oneshot")
    return harness.run(cell, SEED, 0.0, False, "cpu", time.perf_counter())


def test_sound_oneshot_is_correct():
    out = cpu_run()
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["checks"]) == {"energy_gap", "potential_form", "failed"}
    assert set(out["metrics"]) == {"solve_s", "setup_s"}


def test_control_is_not_correct(monkeypatch):
    monkeypatch.setenv("QUEMB_TPU_CCSD_F32_ONLY", "1")
    out = cpu_run()
    assert out["correct"] is False
    assert out["checks"]["energy_gap"]["value"] > \
        out["checks"]["energy_gap"]["limit"]
