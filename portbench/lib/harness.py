"""One run of one cell: set-up, a measured window of jobs, the judge.

Set-up (``setup_s``, from the first line of ``run.py`` to the start of the
window): import torch and the program, bind the card, make the cell's
inputs from the seed (:mod:`portbench.lib.inputs`), build the mean field
with ``RHF.from_arrays`` and run one job, which is discarded.

A job is what a user runs once the mean field exists: ``fragmentate``, a
new ``BE`` on the card, the traffic's call (``optimize`` or ``oneshot``)
with its arguments, and the energy read to the host.  Jobs run back to
back, one at a time.  The window opens as the first job after the warm
one starts and closes when the first job to finish after ``--seconds``
finishes; ``solve_s`` is its length over the jobs completed in it.  A
traced run then reads the device over two more jobs (:mod:`.trace`):
one profiled for device activity alone, for the device's busy time
(over the window's wall per job, the idle share) and the launches, and
one profiled with host ops and their shapes, for the shares of eigh and
the GEMMs and for what the host did in the gaps.

Then the program's state is freed and the plain reference
(:mod:`portbench.lib.judge`) judges a sample of the run's jobs, drawn
from the seed, by the numbers and limits of ``portbench/limits/<cell>.json``.

What makes the inputs, the program's mean field and job, and the
reference's judge is the default below unless the configuration's own
module provides it (:mod:`portbench.lib.registry`).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

from portbench.lib import registry

#: top-level module names that no run may load
FORBIDDEN = {"jax", "jaxlib", "flax", "quemb_tpu"}

#: jobs of the window that the reference judges, drawn from the seed
JUDGE_JOBS = 3

#: program calls that a traced run wraps in spans
SPANS = {
    "jacobian": "quemb_tpu_torch.api:get_be_error_jacobian",
    "eval": "quemb_tpu_torch.matching.beopt:be_func",
}


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cache_dirs(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")


def forbidden_modules() -> set[str]:
    return {m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN


class Runner:
    """The program, its mean field and the traffic's job.  A configuration
    whose mean field or job differs brings a subclass in its module."""

    def __init__(self, cell: registry.Cell, inputs: dict, device: str):
        import quemb_tpu_torch as qt

        self.qt = qt
        self.cell = cell
        self.device = device
        self.mol, self.mf = self.mean_field(inputs)
        be = dict(cell.config["be"])
        self.frag_kwargs = {"n_BE": be.pop("n_BE"),
                            "frag_type": be.pop("frag_type", "chemgen")}
        self.be_kwargs = be
        self.call = cell.traffic["call"]
        self.call_kwargs = cell.traffic["kwargs"]

    def mean_field(self, inputs: dict):
        """The molecule and its RHF, built from the inputs' arrays."""
        from quemb_tpu_torch.chem.mole import Mole
        from quemb_tpu_torch.chem.scf import RHF

        mol = Mole(atom=list(zip(inputs["symbols"], inputs["coords"])),
                   basis=self.cell.config["molecule"]["basis"])
        mf = RHF.from_arrays(
            mol, inputs["hcore"], inputs["S"], inputs["eri"], inputs["C"],
            inputs["moe"], inputs["e_tot"], device=self.device)
        return mol, mf

    def state(self, be) -> dict:
        """What the judge reads of a finished job: its total energy, and
        per fragment its sites and the potential it was last solved at."""
        return {"e_tot": float(be.ebe_tot),
                "frags": [(list(fr.AO_in_frag), np.array(fr.heff))
                          for fr in be.fragments]}

    def job(self, on_construct=None) -> dict:
        import torch

        rf = torch.profiler.record_function
        with contextlib.redirect_stdout(io.StringIO()):
            with rf("portbench.fragmentate"):
                fobj = self.qt.fragmentate(self.mol, print_frags=False,
                                           **self.frag_kwargs)
            t0 = time.perf_counter()
            with rf("portbench.construct"):
                be = self.qt.BE(self.mf, fobj, device=self.device,
                                **self.be_kwargs)
            if on_construct is not None:
                on_construct(time.perf_counter() - t0)
            getattr(be, self.call)(**self.call_kwargs)
        return self.state(be)


class JobLog:
    """Where each job of the window spent its wall: the BE constructor,
    the process's CPU seconds, the garbage collector, and new segments
    the card's allocator asked the driver for.  Written to standard
    error, so that a job that stalls shows where its time went.  (The
    card's machine shows no machine-wide CPU time, whose counters stand
    still while the process uses some 160 CPU seconds a window, and read
    no involuntary context switch or page fault in any run: those are
    not read.)"""

    FIELDS = ("wall_s", "construct_s", "cpu_s", "gc_s", "new_segments")

    def __init__(self, on_card: bool):
        self.on_card = on_card
        self.rows: list[tuple] = []
        self._gc_s, self._gc_t0 = 0.0, None
        gc.callbacks.append(self._on_gc)

    def _on_gc(self, phase, info):
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            self._gc_s += time.perf_counter() - self._gc_t0
            self._gc_t0 = None

    def _mark(self) -> tuple:
        segments = 0
        if self.on_card:
            import torch

            segments = torch.cuda.memory_stats().get(
                "segment.all.allocated", 0)
        return (time.perf_counter(), time.process_time(), self._gc_s,
                segments)

    def start(self) -> None:
        self._m0 = self._mark()

    def stop(self, construct_s: float) -> None:
        m, m0 = self._mark(), self._m0
        self.rows.append((m[0] - m0[0], construct_s,
                          *(a - b for a, b in zip(m[1:], m0[1:]))))

    def close(self, log) -> None:
        gc.callbacks.remove(self._on_gc)
        if not self.rows:
            return
        cols = list(zip(*self.rows))
        for name, col in zip(self.FIELDS[:2], cols[:2]):
            print(f"job {name}: " + " ".join(f"{v:.3f}" for v in col),
                  file=log)
        print("window totals: " + ", ".join(
            f"{k} {sum(c):.6g}" for k, c in zip(self.FIELDS[2:], cols[2:])),
            file=log)
        median = float(np.median(cols[0]))
        for i, row in enumerate(self.rows):
            if row[0] > 1.5 * median:
                print(f"slow job {i} of {len(self.rows)} (median "
                      f"{median:.3f} s): " + ", ".join(
                          f"{k} {v:.6g}" for k, v in zip(self.FIELDS, row)),
                      file=log)


def cards_used() -> int:
    """Cards on which this process allocated memory."""
    import torch

    return sum(torch.cuda.max_memory_allocated(i) > 0
               for i in range(torch.cuda.device_count()))


def run(cell: registry.Cell, seed: int, seconds: float, trace: bool,
        device: str, t_start: float, log=sys.stderr) -> dict:
    """One run of ``cell``; returns the result line's object."""
    import torch

    from portbench.lib import inputs as inp
    from portbench.lib import trace as tr
    from portbench.lib.judge import Judge

    make_inputs = cell.hook("make_inputs", inp.make_inputs)
    runner_cls = cell.hook("Runner", Runner)
    judge_cls = cell.hook("Judge", Judge)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = device.startswith("cuda")
    inputs = make_inputs(cell.root, cell.config, seed, device)
    runner = runner_cls(cell, inputs, device)
    runner.job()                                  # warm, discarded

    def sync():
        if on_card:
            torch.cuda.synchronize()

    spans = tr.Spans()
    construct: list[float] = []
    states, failed, attempted = [], 0, 0

    def one_job():
        nonlocal failed
        try:
            states.append(runner.job(construct.append))
        except Exception as exc:              # a job that raises has failed
            failed += 1
            print(f"job {attempted} raised {exc!r}", file=log)
        sync()

    stack = contextlib.ExitStack()
    if trace:
        stack.enter_context(spans.wrapped(SPANS))
    jobs = JobLog(on_card)
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    w0 = time.perf_counter()
    with stack:
        while True:
            attempted += 1
            n = len(construct)
            jobs.start()
            one_job()
            jobs.stop(construct[-1] if len(construct) > n else float("nan"))
            if time.perf_counter() - w0 >= seconds:
                break
    window_s = time.perf_counter() - w0
    span_jobs, window_construct = attempted, list(construct)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    jobs.close(log)

    # The device is read over two more jobs after the window, so that the
    # profiler, after which later launches may run slower, touches none of
    # the window's jobs.  Off the card there is no device to read.
    t_parse, timeline, profile, walls = 0.0, None, None, []
    if trace and on_card:
        acts = torch.profiler.ProfilerActivity
        # device activity alone: busy time, launches
        prof = torch.profiler.profile(activities=[acts.CUDA])
        prof.start()
        attempted += 1
        t0 = time.perf_counter()
        one_job()
        walls.append(time.perf_counter() - t0)
        prof.stop()
        t_parse = time.perf_counter()
        timeline = tr.timeline(prof, jobs=1, wall_s=walls[0])
        t_parse = time.perf_counter() - t_parse
        # host ops with their shapes: eigh's and the GEMMs' device time,
        # and what the host did in the gaps, in spans of their own
        prof = torch.profiler.profile(activities=[acts.CPU, acts.CUDA],
                                      record_shapes=True)
        prof.start()
        attempted += 1
        t0 = time.perf_counter()
        with tr.Spans().wrapped(SPANS), torch.profiler.record_function(tr.JOB):
            one_job()
        walls.append(time.perf_counter() - t0)
        prof.stop()
        t1 = time.perf_counter()
        profile = tr.parse(prof)
        del prof
        t_parse += time.perf_counter() - t1
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules that no run may load: {sorted(found)}")

    data = tr.TraceData(jobs=span_jobs, job_s=window_s / span_jobs,
                        construct_s=window_construct,
                        spans=spans, timeline=timeline, profile=profile,
                        peak_mem_bytes=peak)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = registry.metric_reader(m["name"], cell.root)(data)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {"solve_s": {"value": window_s / span_jobs, "unit": "s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    if on_card:
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": cards_used(), "memory_peak_bytes": peak}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}

    # the program's state goes before the reference runs
    del runner
    if on_card:
        torch.cuda.empty_cache()
    rng = np.random.default_rng([seed, attempted])
    sample = sorted(rng.choice(len(states), min(len(states), JUDGE_JOBS),
                               replace=False)) if states else []
    t_judge = time.perf_counter()
    judge = judge_cls(inputs, cell.config, cell.traffic, device)
    limits = cell.limits
    judged = [judge.judge(states[i]) for i in sample]
    wrong = sum(any(v > limits[k] for k, v in j.items()) for j in judged)
    checks = {k: {"value": max([j[k] for j in judged], default=0.0),
                  "limit": limits[k]} for k in limits if k != "failed"}
    checks["failed"] = {"value": float(failed + wrong),
                        "limit": limits["failed"]}
    correct = bool(judged) and all(
        c["value"] <= c["limit"] for c in checks.values())

    out = {"correct": correct, "attempted": attempted,
           "failed": failed + wrong, "metrics": metrics, "device": dev}
    if timeline is not None:
        dev["busy_s"] = timeline.busy_us * 1e-6
        dev["window_s"] = timeline.window_us * 1e-6
    if timeline is not None and profile is not None:
        out["breakdown"] = {"device_ops": tr.device_ops(timeline),
                            "idle_gaps": tr.idle_gaps(profile)}
    print(f"jobs {span_jobs} in {window_s!r} s; judged jobs "
          f"{[int(i) for i in sample]} in {time.perf_counter() - t_judge!r}"
          f" s; profiled job walls {walls} s; traces read in {t_parse!r} s",
          file=log)
    # the contract's place for each number compared and its limit: last
    out["checks"] = checks
    return out


def main(argv, t_start: float) -> int:
    args = parse_args(argv)
    cache_dirs(registry.ROOT)
    cell = registry.load_cell(args.workload)
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"needs {cell.chips} CUDA card(s); found {found}",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    out = run(cell, args.seed, args.seconds, bool(args.trace), "cuda:0",
              t_start)
    for k, c in out["checks"].items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0
