"""Profile the PyTorch/CUDA port at octane on one NVIDIA card.

    python3 tools/profile_port.py [--parts NAME[,NAME...]] [--trace PATH]

Four parts (all of them unless ``--parts`` names some), printed as JSON
lines (plus the profiler tables):

- ``kernel``: the screened first transform, one line a case: octane
  fragment 0 (the octane Cholesky factor, naux 777, nao 58) and the
  synthetic C40H82 factor of ``chip_smoke.py`` (naux 3460, nao 282,
  nemb 42) with a centred window of 8, 10, 11, 12, 14 and all 18 of its
  blocks kept.  Versions: the CUDA kernel, its plain torch version and
  one library call (``torch.matmul`` on the masked basis, TF32 off), and
  at octane the kernel with blocks 1 and 2 of 4 dropped from the reach.
  Per version: device microseconds per call from ``torch.profiler`` over
  20 calls, by kernel name and summed; with the call's bound;
- ``kernel_parts``: what holds the kernel back: device microseconds per
  call (CUDA events around 10 calls queued behind a sleep, median of 10)
  of the kernel as built and of variants of its source, built side by
  side.  At octane fragment 0 and at the C40 window (8 of 18 blocks): the
  TMA copies taken out (the math alone), the math taken out (the copies
  and the write-back alone), and both (staging TA, the barriers and the
  write-back).  At the C40 window also the routes the design did not
  take: FP32 FMAs on the CUDA cores (with and without the copies), 8-byte
  ``cp.async`` gathers, one 1D bulk copy a row, and stores straight from
  the accumulators.  Variants that compute the whole transform are held
  to the plain version (``max_rel_err``);
- ``objective``: the f64 route ``BE(mf, fobj)`` at CCSD tolerance 1e-6,
  ``be_func`` with ``eeval=True`` at the seeded potential of
  ``chip_smoke.py`` (two warm-up evaluations first): the unprofiled wall,
  the stages of the objective each timed to a
  ``torch.cuda.synchronize()`` with their iteration counts, and one
  evaluation under ``torch.profiler`` (device events and their summed
  time, the top operators and the top device kernels);
- ``matching``: where a matching run's time goes, on the same route.  The
  analytic Jacobian by ``jac_solver`` (HF, MP2, CCSD): its wall, and within
  it the fragment SCF, the CPHF solves and (MP2, CCSD) the rest of the
  response, each timed to a ``torch.cuda.synchronize()``.  Then
  ``be.optimize(solver="CCSD")`` from zero potential, after a one-shot
  solve: its wall, the Jacobian's, every objective evaluation's wall and
  error norm, the wall inside the fragment SCF and inside the CCSD
  iteration of each evaluation (each call timed between two
  synchronisations, which the plain run does not have), with the matched
  energies and their distance from the reference's.  Three such runs: at
  CCSD tolerance 1e-6, at 1e-8, and on the f32 tier (sparse-DF with the
  screened-DF kernel, f32 amplitudes) with at most 10 quasi-Newton steps.

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

from chip_smoke import (  # noqa: E402
    ECORR_MATCHED_REF, ETOT_MATCHED_REF, FIXTURE, XYZ, c40_case, call_bound,
    card_line, device_ms, fragment_bases,
)

N_PROFILED = 20  # calls of each kernel version under the profiler
N_PARTS_TIMINGS = 10  # event timings of each kernel build; the median
TOP_OPS = 12  # operators and kernels listed by device time
#: kept blocks of the C40 cases of part ``kernel``, a centred window each
#: (8: chip_smoke's window, 18: every block, the ragged tail included)
C40_KEPT = (8, 10, 11, 12, 14, 18)
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


def _device_per_call(fn) -> dict:
    """Device microseconds per call of ``fn`` under the profiler, by
    kernel name and summed."""
    def calls():
        for _ in range(N_PROFILED):
            fn()

    kernels = {k: us / N_PROFILED
               for k, us in _device_us(_profile(calls)).items()}
    return dict(device_us_per_call=float(sum(kernels.values())),
                device_kernels_us=kernels)


def _profile_shape(sd, name, B, TA, reach, card, extra=()):
    naux, nao, _ = B.shape
    rowmask = sd.block_rowmask(reach, torch.float32, B.device)
    TA_masked = TA * rowmask[:, None]
    Bv = B.view(naux * nao, nao)
    versions = {
        "kernel": lambda: sd.screened_first_transform(B, TA, reach),
        "plain": lambda: sd.screened_first_transform_plain(B, TA, rowmask),
        "library": lambda: torch.matmul(Bv, TA_masked),
        **{k: (lambda r=r: sd.screened_first_transform(B, TA, r))
           for k, r in extra},
    }
    torch.backends.cuda.matmul.allow_tf32 = False
    for fn in versions.values():  # warm up
        fn()
        fn()
    torch.cuda.synchronize()
    out = {k: _device_per_call(fn) for k, fn in versions.items()}
    print(json.dumps({"part": "kernel", "case": name,
                      "shape": [naux, nao, TA.shape[1],
                                int(sd.kept_blocks(reach).size)],
                      **call_bound(sd, naux, nao, TA.shape[1], reach),
                      "card": card, **out}), flush=True)


def _octane_case(sd, mf, fobj):
    """The octane Cholesky factor on the card, fragment 0's screened basis
    and its reach."""
    from quemb_tpu_torch.ops.df import cholesky_df_factor
    from quemb_tpu_torch.ops.sparse_df import SparseDF

    cuda = torch.device("cuda")
    B = cholesky_df_factor(mf.mol, tol=1.0e-10, eri=mf.get_eri())
    sdf = SparseDF.from_factor(mf.mol, B, device=cuda)
    TA_eff, reach = sdf.screen(fragment_bases(mf, fobj)[0])
    TA32 = torch.as_tensor(TA_eff.astype(np.float32), device=cuda)
    return sdf.factor.B32, TA32, reach


def profile_kernel(mf, fobj, card):
    from quemb_tpu_torch.ops import screened_df as sd

    sd.build_library()
    B32, TA32, reach = _octane_case(sd, mf, fobj)
    reach2 = reach.copy()
    reach2[16:48] = False  # blocks 1 and 2 of 4
    _profile_shape(sd, "octane_frag0", B32, TA32, reach, card,
                   extra=[("kernel_2of4_blocks", reach2)])
    B, TA, _ = c40_case(sd, torch.device("cuda"))
    nblk = -(-B.shape[1] // sd.NU_BLOCK)
    for k in C40_KEPT:
        reach = np.zeros(B.shape[1], bool)
        start = (nblk - k) // 2
        reach[sd.NU_BLOCK * start:sd.NU_BLOCK * (start + k)] = True
        _profile_shape(sd, f"c40_{k}of{nblk}", B, TA, reach, card)
    del B, TA
    torch.cuda.empty_cache()


#: source edits for ``kernel_parts``: each variant of the kernel is its
#: source with the edits of its entry applied in turn
_NO_COPY = ("    mbar_arrive_expect_tx(&bars[slot], kb * BLOCK_TILE * 4);\n"
            "    for (int jj = 0; jj < kb; ++jj)",
            "    mbar_arrive_expect_tx(&bars[slot], 0);\n"
            "    for (int jj = 0; jj < 0; ++jj)")
_NO_MATH = ("    for (int j = j0; j < j1; ++j) {\n      const int o = gq",
            "    for (int j = j0; j < j0; ++j) {\n      const int o = gq")
# the TMA loads of one step, which the copy routes below replace
_TMA_STEP = """\
    float* dst = ring + slot * slot_floats;
    mbar_arrive_expect_tx(&bars[slot], kb * BLOCK_TILE * 4);
    for (int jj = 0; jj < kb; ++jj)
      for (int gg = 0; gg < G; ++gg)
        tma_load_2d(dst + (jj * G + gg) * box_floats, &tmap,
                    gg * nao - (gg * nao) % 4 + NU_BLOCK * blk_s[j0 + jj], y,
                    &bars[slot]);
"""
_TILE_ROWS = """\
    float* dst = ring + slot * slot_floats;
    const long long r0 = static_cast<long long>(y) * G;
    const int nrow = static_cast<int>(
        min(static_cast<long long>(ROW_TILE), rows - r0));
"""
# every thread, not thread 0 alone, issues a step's copies
_EVERY_THREAD_COPIES = (
    ("  if (tid == 0)\n    for (int s = 0; s < STAGES; ++s) issue(s, s);",
     "  for (int s = 0; s < STAGES; ++s) issue(s, s);"),
    ("    if (tid == 0) issue(step + STAGES, slot);",
     "    issue(step + STAGES, slot);"),
)
# one 1D bulk copy (TMA) of 20 floats a row and kept block, spread over the
# threads, onto the same mbarrier; every row's box starts on the 16-byte
# boundary at or before its block, as the 2D boxes do
_BULK_PER_ROW = (*_EVERY_THREAD_COPIES, (_TMA_STEP, _TILE_ROWS + r"""
    if (tid == 0) mbar_arrive_expect_tx(&bars[slot], kb * nrow * BOX_W * 4);
    for (int e = tid; e < kb * nrow; e += THREADS) {
      const int jj = e / nrow, r = e % nrow, h = r % G;
      const float* src = p.B + (r0 + r - h) * nao + h * nao - h * nao % 4 +
                         NU_BLOCK * blk_s[j0 + jj];
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n" ::"r"(
              smem_u32(dst + (jj * G + h) * box_floats + (r / G) * BOX_W)),
          "l"(src), "r"(BOX_W * 4), "r"(smem_u32(&bars[slot]))
          : "memory");
    }
"""))
# 8-byte cp.async gathers of each row's kept columns (nao even), one
# commit group a step, waited for two steps later
_GATHER = (
    *_EVERY_THREAD_COPIES,
    ("    if (step >= my_steps) return;",
     "    if (step >= my_steps) {\n"
     "      asm volatile(\"cp.async.commit_group;\\n\" ::: \"memory\");\n"
     "      return;\n    }"),
    (_TMA_STEP, _TILE_ROWS + r"""
    for (int e = tid; e < kb * nrow * (NU_BLOCK / 2); e += THREADS) {
      const int jj = e / (nrow * (NU_BLOCK / 2));
      const int r = e / (NU_BLOCK / 2) % nrow;
      const int k = 2 * (e % (NU_BLOCK / 2));
      const int nu = NU_BLOCK * blk_s[j0 + jj] + k;
      float* d = dst + (jj * G + r % G) * box_floats + (r / G) * BOX_W +
                 (r % G) * nao % 4 + k;
      if (nu < nao)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                         smem_u32(d)),
                     "l"(p.B + (r0 + r) * nao + nu)
                     : "memory");
      else
        d[0] = d[1] = 0.0f;
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
"""),
    ("    mbar_wait(&bars[slot], (step / STAGES) & 1);",
     "    asm volatile(\"cp.async.wait_group 1;\\n\" ::: \"memory\");\n"
     "    __syncthreads();"),
)
# FP32 FMAs on the CUDA cores instead of 3xTF32 on the tensor cores: TA
# staged as FP32, the same warp tiles and accumulator layout
_FP32_FMA = (
    ("              tf32_split(v[u], ta_big[cc * ts + kr], "
     "ta_small[cc * ts + kr]);",
     "              ta_big[cc * ts + kr] = __float_as_uint(v[u]);"),
    ("      block_mma<CN>(acc,", "      block_fma<CN>(acc,"),
    ("// ---- the kernel ", r"""template <int CN>
__device__ __forceinline__ void block_fma(float (&acc)[MT][CN][4],
                                          const float* b, const uint32_t* tb,
                                          const uint32_t*, int ts, int gq,
                                          int tq) {
  const float* t = reinterpret_cast<const float*>(tb) - gq * ts - tq;
#pragma unroll
  for (int k = 0; k < NU_BLOCK; ++k) {
    float a[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        a[mt][h] = b[(16 * mt + gq + 8 * h) * BOX_W + k];
#pragma unroll
    for (int nt = 0; nt < CN; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float x = t[(8 * nt + 2 * tq + c) * ts + k];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            acc[mt][nt][2 * h + c] = fmaf(a[mt][h], x, acc[mt][nt][2 * h + c]);
      }
  }
}

// ---- the kernel """),
)
# 4-byte stores straight from the accumulator fragments to device memory,
# not through the ring slot
_DIRECT_STORES = (
    ("                slot_s[r * w + col] = acc[mt][nt][2 * h + c];",
     "{\n"
     "                float* gp = p.out + (row0 + r) * nemb + c0 + col;\n"
     "                *gp = p.accumulate ? *gp + acc[mt][nt][2 * h + c]\n"
     "                                   : acc[mt][nt][2 * h + c];\n"
     "              }"),
    ("      if (w == nemb) {", "      if (w < 0) {"),
    ("        for (int e = tid; e < nr * w; e += THREADS) {",
     "        for (int e = tid; e < 0; e += THREADS) {"),
)
#: variants timed at both shapes: the kernel as built and with its copies,
#: its math or both taken out
KERNEL_PARTS = {"as_built": (), "math_only": (_NO_COPY,),
                "copies_only": (_NO_MATH,), "neither": (_NO_COPY, _NO_MATH)}
#: the routes the design did not take, timed at the C40 window (their
#: copies read only the columns of the window's blocks, none past nao)
KERNEL_ROUTES = {"fp32_fma": _FP32_FMA,
                 "fp32_fma_math_only": (*_FP32_FMA, _NO_COPY),
                 "cp_async_gather": _GATHER,
                 "bulk_copy_per_row": _BULK_PER_ROW,
                 "direct_stores": _DIRECT_STORES}
#: variants that compute the whole transform, held to the plain version
COMPLETE = {"as_built", "fp32_fma", "cp_async_gather", "bulk_copy_per_row",
            "direct_stores"}


def _variant_libraries(sd, variants):
    """Each variant's source (the kernel's with its edits applied), built
    into build/ by concurrent ``nvcc`` runs and bound like the kernel."""
    import ctypes
    import subprocess

    procs = {}
    for name, edits in variants.items():
        src = sd._SRC.read_text()
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(
                    f"kernel_parts: {name}: source edit not found once")
            src = src.replace(old, new)
        cu = sd._BUILD_DIR / f"variant_{name}.cu"
        cu.write_text(src)
        so = cu.with_suffix(".so")
        procs[name] = (so, subprocess.Popen(
            [sd._nvcc(), *sd._NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"kernel_parts: {name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(so))
        fn = lib.screened_first_transform_f32
        fn.argtypes = sd._library().screened_first_transform_f32.argtypes
        fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def profile_kernel_parts(mf, fobj, card):
    from quemb_tpu_torch.ops import screened_df as sd

    built = sd._library()
    libs = _variant_libraries(sd, {k: e for k, e in {
        **KERNEL_PARTS, **KERNEL_ROUTES}.items() if e})
    libs["as_built"] = built
    cases = {"octane_frag0": (_octane_case(sd, mf, fobj), KERNEL_PARTS),
             "c40_8of18": (c40_case(sd, torch.device("cuda")),
                           {**KERNEL_PARTS, **KERNEL_ROUTES})}
    try:
        for case, ((Bx, TAx, r), variants) in cases.items():
            ref = sd.screened_first_transform_plain(
                Bx, TAx, sd.block_rowmask(r, Bx.dtype, Bx.device))
            scale = float(ref.abs().max())
            out, rel_err = {}, {}
            for k in variants:
                sd._LIB = libs[k]
                got = sd.screened_first_transform(Bx, TAx, r)
                if k in COMPLETE:
                    rel_err[k] = float((got - ref).abs().max()) / scale
                del got
                out[k] = 1e3 * float(np.median([device_ms(
                    lambda: sd.screened_first_transform(Bx, TAx, r)
                ) for _ in range(N_PARTS_TIMINGS)]))
            print(json.dumps({"part": "kernel_parts", "case": case,
                              "launch_blocks": [int(p.size) for p in
                                                sd.plan_launches(
                                                    TAx.shape[1],
                                                    sd.kept_blocks(r))],
                              "event_us_per_call": out,
                              "max_rel_err": rel_err, "card": card}),
                  flush=True)
            del ref
    finally:
        sd._LIB = built
    del cases
    torch.cuda.empty_cache()


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

    # the objective's stages on the (single) merged bucket
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


class _Stopwatch:
    """Wall seconds and call count of a function, each call timed between
    two ``torch.cuda.synchronize()``; put in place of ``module.name``
    while a ``with`` block runs."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.inner = getattr(module, name)
        self.seconds, self.calls = 0.0, 0

    def __call__(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ret = self.inner(*args, **kwargs)
        torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return ret

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.inner)


#: quasi-Newton steps allowed to the f32 tier's matching run, which may
#: never reach the error norm it is asked for
F32_MAX_ITER = 10


def _timed_optimize(qt, be, what, card, **optimize_kw):
    """``be.optimize(solver="CCSD")`` with its Jacobian, every objective
    evaluation and, inside each, the fragment SCF and the CCSD iteration
    on the stopwatch; one JSON line."""
    from quemb_tpu_torch.matching import beopt
    from quemb_tpu_torch.solvers import dispatch as D

    be.oneshot("CCSD")  # first-use costs of the solve stay out of the run
    evals = []
    with _Stopwatch(D, "rhf_orthonormal") as scf, \
            _Stopwatch(D, "_rccsd_from_mo_batched") as cc, \
            _Stopwatch(qt.api, "get_be_error_jacobian") as jac_run:

        def timed_be_func(*args, **kwargs):
            scf0, cc0 = scf.seconds, cc.seconds
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ret = D.be_func(*args, **kwargs)
            torch.cuda.synchronize()
            evals.append(dict(wall_s=time.perf_counter() - t0,
                              fragment_scf_s=scf.seconds - scf0,
                              rccsd_s=cc.seconds - cc0,
                              error_norm=float(ret[0])))
            return ret

        beopt.be_func = timed_be_func
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            be.optimize(solver="CCSD", only_chem=False, **optimize_kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            beopt.be_func = D.be_func
    eval_s, scf_s, cc_s = (sum(e[k] for e in evals)
                           for k in ("wall_s", "fragment_scf_s", "rccsd_s"))
    print(json.dumps({
        "part": "matching", "what": what, "card": card,
        "ccsd_conv_tol": os.environ.get("QUEMB_TPU_CCSD_CONV_TOL"),
        "wall_s": wall, "jacobian_s": jac_run.seconds,
        "evaluations": len(evals), "evaluations_s": eval_s,
        "host_qn_s": wall - jac_run.seconds - eval_s,
        "fragment_scf_s": scf_s,
        "fragment_scf_share_of_evaluations": scf_s / eval_s,
        "rccsd_s": cc_s, "rccsd_share_of_evaluations": cc_s / eval_s,
        "per_evaluation": evals,
        "etot": be.ebe_tot, "ecorr": be.ebe_tot - be.ebe_hf,
        "etot_dev": be.ebe_tot - ETOT_MATCHED_REF,
        "ecorr_dev": be.ebe_tot - be.ebe_hf - ECORR_MATCHED_REF,
    }), flush=True)


def profile_matching(mf, fobj, card):
    import quemb_tpu_torch as qt
    from quemb_tpu_torch.matching import cphf

    cuda = torch.device("cuda")
    os.environ["QUEMB_TPU_CCSD_CONV_TOL"] = "1e-6"
    be = qt.BE(mf, fobj, device=cuda)

    def jacobian(jac_solver):
        with _Stopwatch(cphf, "run_fragment_scf") as scf, \
                _Stopwatch(cphf, "_cphf_solve") as solve:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            J = be.get_be_error_jacobian(jac_solver)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return J, dict(wall_s=wall, fragment_scf_s=scf.seconds,
                       cphf_solve_s=solve.seconds,
                       rest_s=wall - scf.seconds - solve.seconds)

    jac = {}
    for jac_solver in ("HF", "HF", "MP2", "CCSD"):  # the first HF warms up
        J, jac[jac_solver] = jacobian(jac_solver)
        if not np.all(np.isfinite(J)):
            raise AssertionError(f"{jac_solver} Jacobian is not finite")
    print(json.dumps({"part": "matching", "what": "jacobian", "card": card,
                      "shape": list(J.shape), "n_frag": fobj.n_frag,
                      **jac}), flush=True)

    _timed_optimize(qt, be, "optimize", card)
    # the same run with the CCSD amplitudes converged further
    os.environ["QUEMB_TPU_CCSD_CONV_TOL"] = "1e-8"
    _timed_optimize(qt, qt.BE(mf, fobj, device=cuda), "optimize_tight_ccsd",
                    card)
    del os.environ["QUEMB_TPU_CCSD_CONV_TOL"]
    # the f32 tier (f32 ERIs from the screened-DF kernel, f32 amplitudes)
    # asked for the same error norm, with few steps allowed
    os.environ["QUEMB_TPU_CCSD_F32_ONLY"] = "1"
    try:
        be32 = qt.BE(mf, fobj, int_transform="sparse-DF",
                     auxbasis="cholesky", device=cuda)
        _timed_optimize(qt, be32, "optimize_f32_tier", card,
                        max_iter=F32_MAX_ITER)
    finally:
        del os.environ["QUEMB_TPU_CCSD_F32_ONLY"]


PARTS = ("kernel", "kernel_parts", "objective", "matching")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", help="write the objective's Chrome trace")
    ap.add_argument("--parts", default=",".join(PARTS),
                    help="comma-separated parts to run (default: all)")
    args = ap.parse_args()
    parts = args.parts.split(",")
    if not set(parts) <= set(PARTS):
        ap.error(f"--parts: choose from {', '.join(PARTS)}")
    if not torch.cuda.is_available():
        raise SystemExit("profile_port: torch.cuda.is_available() is false")
    import quemb_tpu_torch as qt
    from quemb_tpu_torch.chem.scf import load_fixture

    card = card_line()
    print(card, flush=True)
    mf = load_fixture(FIXTURE, XYZ)
    fobj = qt.fragmentate(mf.mol, n_BE=2, frag_type="chemgen",
                          print_frags=False)
    if "kernel" in parts:
        profile_kernel(mf, fobj, card)
    if "kernel_parts" in parts:
        profile_kernel_parts(mf, fobj, card)
    if "objective" in parts:
        profile_objective(mf, fobj, card, args.trace)
    if "matching" in parts:
        profile_matching(mf, fobj, card)


if __name__ == "__main__":
    main()
