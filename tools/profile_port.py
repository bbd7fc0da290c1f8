"""Profile the PyTorch/CUDA port at octane on one NVIDIA card.

    python3 tools/profile_port.py [--trace PATH]

Two parts, each printed as one JSON line (plus the profiler tables):

- ``kernel``: the screened first transform at octane fragment 0 (the
  octane Cholesky factor, naux 777, nao 58), the CUDA kernel, its plain
  torch version, and the kernel with blocks 1 and 2 of 4 dropped from
  the reach.  Per version: device microseconds per call from
  ``torch.profiler`` over 20 calls, and CUDA-event milliseconds per call,
  single and over 10 back-to-back calls (median of 20 each);
- ``objective``: the f64 route ``BE(mf, fobj)`` at CCSD tolerance 1e-6,
  ``be_func`` with ``eeval=True`` at the seeded potential of
  ``chip_smoke.py`` (two warm-up evaluations first): the unprofiled wall,
  the stages of the fused objective each timed to a
  ``torch.cuda.synchronize()`` with their iteration counts, and one
  evaluation under ``torch.profiler`` (device events and their summed
  time, the top operators and the top device kernels).

Device time is summed over the profiler's device events (kernels, copies,
memsets) without its own buffer events; an operator's row in
``key_averages()`` repeats the time of the kernels it launched, so those
rows are never added up.

``--trace PATH`` also writes the objective's Chrome trace there.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import FIXTURE, XYZ, card_line, fragment_bases  # noqa: E402

N_MEDIAN = 20  # timings per version; the median is reported
N_PROFILED = 20  # calls of each kernel version under the profiler
TOP_OPS = 12  # operators and kernels listed by device time
#: device events the profiler records for its own buffers
PROFILER_OVERHEAD = {"Activity Buffer Request", "Buffer Flush"}


def _profile(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof


def _device_us(prof) -> dict:
    """Microseconds of device time per event name, summed."""
    out = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and e.name not in PROFILER_OVERHEAD):
            key = e.name[:60]
            out[key] = out.get(key, 0.0) + e.time_range.elapsed_us()
    return out


def _device_count(prof) -> int:
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name not in PROFILER_OVERHEAD)


def _event_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def profile_kernel(mf, fobj, card):
    from quemb_tpu_torch.ops import screened_df as sd
    from quemb_tpu_torch.ops.df import cholesky_df_factor
    from quemb_tpu_torch.ops.sparse_df import SparseDF

    cuda = torch.device("cuda")
    sd.build_library()
    B = cholesky_df_factor(mf.mol, tol=1.0e-10, eri=mf.get_eri())
    sdf = SparseDF.from_factor(mf.mol, B, device=cuda)
    B32 = sdf.factor.B32
    TA_eff, reach = sdf.screen(fragment_bases(mf, fobj)[0])
    TA32 = torch.as_tensor(TA_eff.astype(np.float32), device=cuda)
    rowmask = sd.block_rowmask(reach, torch.float32, cuda)
    reach2 = reach.copy()
    reach2[16:48] = False  # blocks 1 and 2 of 4
    versions = {
        "kernel": lambda: sd.screened_first_transform(B32, TA32, reach),
        "plain": lambda: sd.screened_first_transform_plain(
            B32, TA32, rowmask),
        "kernel_2of4_blocks": lambda: sd.screened_first_transform(
            B32, TA32, reach2),
    }
    for fn in versions.values():  # warm up
        fn()
        fn()
    torch.cuda.synchronize()
    out = {}
    for name, fn in versions.items():
        single = [_event_ms(fn, 1) for _ in range(N_MEDIAN)]
        loop = [_event_ms(fn, 10) for _ in range(N_MEDIAN)]

        def calls(fn=fn):
            for _ in range(N_PROFILED):
                fn()

        prof = _profile(calls)
        kernels = {k: us / N_PROFILED
                   for k, us in _device_us(prof).items()}
        out[name] = dict(
            event_ms_single=float(np.median(single)),
            event_ms_loop10=float(np.median(loop)),
            device_us_per_call=float(sum(kernels.values())),
            device_kernels_us=kernels,
        )
    print(json.dumps({"part": "kernel", "shape": [*B32.shape,
                      TA32.shape[1], int(reach.sum())],
                      "card": card, **out}), flush=True)


def profile_objective(mf, fobj, card, trace):
    import quemb_tpu_torch as qt
    from quemb_tpu_torch.embed.fragment_scf import rhf_orthonormal
    from quemb_tpu_torch.solvers import dispatch as D
    from quemb_tpu_torch.solvers.rccsd import _rccsd_from_mo_batched

    os.environ["QUEMB_TPU_CCSD_CONV_TOL"] = "1e-6"
    be = qt.BE(mf, fobj, device=torch.device("cuda"))
    pot = np.random.default_rng(0).standard_normal(len(be.pot)) * 1e-3

    def evaluate():
        return D.be_func(pot, be.fragments, be.Nocc, "CCSD", eeval=True,
                         return_vec=True)

    for _ in range(2):
        evaluate()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    evaluate()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    # the fused objective's stages on the (single) merged bucket
    (pairs,) = D.form_merge_classes(be.fragments)
    frs = [fr for fr, _ in pairs]
    pads = tuple(p for _, p in pairs)
    dev = D._bucket_dev(frs, pads)
    heff = torch.as_tensor(np.stack([
        D._pad_frag_op(fr.heff, *p) for fr, p in pairs
    ]), device=dev["fock"].device)
    nsocc = frs[0].nsocc + pads[0][0]
    nemb = frs[0].nao + sum(pads[0])

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t

    stages = {}
    for _ in range(2):  # the second pass is reported
        (moe, C, _, it_scf), stages["fragment_scf_s"] = timed(
            lambda: rhf_orthonormal(dev["fock"] + heff, dev["eri"], nsocc,
                                    dev["dm0"]))
        eri_mo, stages["mo_eri_s"] = timed(
            lambda: D._batched_mo_eri(dev["eri"], C))
        (t1, t2, it_cc, _), stages["rccsd_s"] = timed(
            lambda: _rccsd_from_mo_batched(eri_mo, moe, nsocc))
        (r1, r2), stages["urlx_rdms_s"] = timed(
            lambda: D._rdm12_urlx_batched(t1, t2))
        mask = torch.zeros((len(frs), nemb), dtype=torch.float64,
                           device=C.device)
        _, stages["energy_rows_s"] = timed(
            lambda: D._batched_energy_rows(C, dev["h1"], dev["veff0"],
                                           dev["eri"], r1, r2, mask, mask))

    prof = _profile(evaluate)
    ka = prof.key_averages()
    kernels = _device_us(prof)
    ops = sorted((e for e in ka if e.key.startswith("aten::")),
                 key=lambda e: e.self_device_time_total, reverse=True)
    print(json.dumps({
        "part": "objective", "card": card,
        "bucket": [len(frs), nemb, nsocc],
        "wall_s": wall, **stages,
        "scf_iters": it_scf.tolist(), "ccsd_iters": it_cc.tolist(),
        "profiled_device_events": _device_count(prof),
        "profiled_device_ms": sum(kernels.values()) / 1e3,
        "top_ops": [dict(name=e.key, calls=e.count,
                         device_ms=e.self_device_time_total / 1e3)
                    for e in ops[:TOP_OPS]],
        "top_kernels_ms": {
            k: us / 1e3 for k, us in sorted(
                kernels.items(), key=lambda kv: -kv[1])[:TOP_OPS]
        },
    }), flush=True)
    print(ka.table(sort_by="self_device_time_total", row_limit=18,
                   max_name_column_width=60))
    if trace:
        prof.export_chrome_trace(trace)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", help="write the objective's Chrome trace")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_port: torch.cuda.is_available() is false")
    import quemb_tpu_torch as qt
    from quemb_tpu_torch.chem.scf import load_fixture

    card = card_line()
    print(card, flush=True)
    mf = load_fixture(FIXTURE, XYZ)
    fobj = qt.fragmentate(mf.mol, n_BE=2, frag_type="chemgen",
                          print_frags=False)
    profile_kernel(mf, fobj, card)
    profile_objective(mf, fobj, card, args.trace)


if __name__ == "__main__":
    main()
