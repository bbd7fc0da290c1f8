"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ``quemb_tpu_torch`` (and nothing of JAX) through octane (C8H18,
STO-3G) BE2-CCSD from the committed RHF fixture, in phases; each prints
one line, and any failure raises (non-zero exit, no ``ok`` line):

0. the device: CUDA name, and ``nvidia-smi`` name and power limit;
1. build the screened-DF CUDA kernel from ``quemb_tpu_torch/csrc``;
2. kernel against its plain torch version on the card, on every octane
   fragment's screened basis against the octane Cholesky factor, on a
   synthetic case with skipped and partly reachable blocks, and on a
   synthetic factor at C40H82 shapes (a window of 8 of 18 blocks, and the
   same with the ragged tail block); at octane fragment 0 and at the C40
   window, device times of the kernel, the plain version and one library
   call (``torch.matmul`` on the masked basis, TF32 off), warm and with
   the L2 flushed, beside the call's bound;
3. the f32 tier: ``BE(..., int_transform="sparse-DF",
   auxbasis="cholesky")`` under ``QUEMB_TPU_CCSD_F32_ONLY=1``, which must
   launch the kernel once per fragment, then a one-shot CCSD;
4. the f64 route ``BE(mf, fobj)`` and its one-shot CCSD;
5. three objective evaluations (``be_func``) at a seeded potential.

The last lines are the kernel report (JSON), the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "fixtures", "octane_sto3g_hf.npz")
XYZ = os.path.join(HERE, "tests", "data", "xyz", "octane.xyz")
#: one-shot octane BE2-CCSD correlation energy of the JAX package
#: (BENCH_r05.json ``oneshot_ecorr``, CCSD tolerance 1e-6)
ECORR_REF = -0.5499458109
#: kernel against plain version, relative to max|plain|: the kernel sums
#: 3xTF32 products (FP32 to about 1e-6 relative), the plain version FP32
#: products, in different orders
KERNEL_REL_TOL = 1e-5
N_TIMINGS = 20  # timings of each version; the median is reported
CALLS_PER_TIMING = 10  # back-to-back calls between two CUDA events
#: device cycles of sleep queued before a timing, so that the host has
#: enqueued every timed call before the first one starts
SLEEP_CYCLES = 2_000_000
FLUSH_BYTES = 256 << 20  # written between cold calls: 5x the 50 MB L2
#: H100 SXM peaks (NVIDIA data sheet): HBM3 rate and FP32 rate
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
#: C40H82 / STO-3G at etb 6.0 (BENCH_r05.json ``chain_demo``): naux, nao
#: and the padded nemb; a window of 8 of its 18 blocks is kept, close to
#: the chain's mean reach fraction 0.4539
C40_SHAPE = (3460, 282, 42)
C40_WINDOW = range(5, 13)
C40_TAIL_BLOCK = 17  # AOs 272-281: the ragged last block


def phase(n, **facts):
    print(json.dumps({"phase": n, **facts}), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def device_ms(fn, calls=CALLS_PER_TIMING, flush=None) -> float:
    """Device milliseconds per call, from CUDA events around ``calls``
    back-to-back calls queued behind a sleep (so the host's enqueue time
    is hidden); ``flush`` is first overwritten to evict the L2."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if flush is not None:
        flush.add_(1.0)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def call_bound(sd, naux, nao, nemb, reach) -> dict:
    """Bytes and FLOP of one call (the kept columns of B and rows of TA
    read once, the output written once) and the least time the card takes
    for them, at the H100's HBM and FP32 peaks."""
    kept = sum(min(sd.NU_BLOCK, nao - sd.NU_BLOCK * b)
               for b in sd.kept_blocks(reach).tolist())
    rows = naux * nao
    nbytes = 4 * (rows * kept + kept * nemb + rows * nemb)
    flop = 2 * rows * kept * nemb
    t_bytes, t_flop = nbytes / HBM_BYTES_PER_S, flop / FP32_FLOP_PER_S
    return dict(bytes=nbytes, flop=flop, bound_ms=1e3 * max(t_bytes, t_flop),
                bound_by="bytes" if t_bytes >= t_flop else "operations")


def time_versions(sd, B, TA, reach, flush) -> dict:
    """Warm and cold device ms of the kernel, the plain version and the
    library call on the same inputs (in turns; medians), with the bound.
    The row mask and the masked basis are built outside the timed
    region."""
    naux, nao, _ = B.shape
    rowmask = sd.block_rowmask(reach, torch.float32, B.device)
    TA_masked = TA * rowmask[:, None]
    Bv = B.view(naux * nao, nao)
    versions = {
        "": lambda: sd.screened_first_transform(B, TA, reach),
        "plain_": lambda: sd.screened_first_transform_plain(B, TA, rowmask),
        "library_": lambda: torch.matmul(Bv, TA_masked),
    }
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for fn in versions.values():  # warm up
            fn()
        times = {f"{k}{w}": [] for k in versions for w in ("ms", "cold_ms")}
        for _ in range(N_TIMINGS):
            for k, fn in versions.items():
                times[f"{k}ms"].append(device_ms(fn))
                times[f"{k}cold_ms"].append(device_ms(fn, 1, flush))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    out = {k: float(np.median(v)) for k, v in times.items()}
    out.update(call_bound(sd, naux, nao, TA.shape[1], reach))
    out["roofline_share_cold"] = out["bound_ms"] / out["cold_ms"]
    out["shape"] = [naux, nao, TA.shape[1], int(sd.kept_blocks(reach).size)]
    return out


def fragment_bases(mf, fobj):
    """Schmidt bases TA of every fragment, built as BE builds them."""
    from quemb_tpu_torch.embed.fragment import Fragment
    from quemb_tpu_torch.lo.lowdin import lowdin_orth

    S = mf.get_ovlp()
    W = lowdin_orth(torch.as_tensor(S, device="cuda")).cpu().numpy()
    lmo = W.T @ S @ mf.mo_coeff
    TAs = []
    for i in range(fobj.n_frag):
        fr = Fragment.from_frag_part(fobj, i)
        fr.sd(W, lmo, mf.mol.nelectron // 2, thr_bath=1.0e-10)
        TAs.append(fr.TA)
    return TAs


def c40_case(sd, device):
    """The synthetic factor at C40 shapes, from a seeded generator on the
    card, a basis, and the reach of the window of kept blocks."""
    naux, nao, nemb = C40_SHAPE
    gen = torch.Generator(device=device).manual_seed(0)
    B = torch.randn((naux, nao, nao), generator=gen, device=device)
    TA = torch.randn((nao, nemb), generator=gen, device=device)
    reach = np.zeros(nao, bool)
    reach[sd.NU_BLOCK * C40_WINDOW.start:sd.NU_BLOCK * C40_WINDOW.stop] = 1
    return B, TA, reach


def check_kernel(sd, B, TA, reach):
    """Kernel and plain version on the same card inputs; returns max|err|."""
    out = sd.screened_first_transform(B, TA, reach)
    ref = sd.screened_first_transform_plain(
        B, TA, sd.block_rowmask(reach, B.dtype, B.device)
    )
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    if not (np.isfinite(err) and err <= KERNEL_REL_TOL * scale):
        raise AssertionError(
            f"kernel disagrees: max|err| {err:.3e} > {KERNEL_REL_TOL:g} x "
            f"max|ref| {scale:.3e} (shape {tuple(out.shape)})"
        )
    return err


def main():
    # ---- 0. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    import quemb_tpu_torch as qt
    from quemb_tpu_torch.chem.scf import load_fixture
    from quemb_tpu_torch.ops import screened_df as sd
    from quemb_tpu_torch.ops.df import cholesky_df_factor
    from quemb_tpu_torch.ops.sparse_df import SparseDF
    from quemb_tpu_torch.solvers.dispatch import be_func

    kind = torch.cuda.get_device_name(0)
    card = card_line()
    phase(0, device=kind, nvidia_smi=card, torch=torch.__version__,
          cuda=torch.version.cuda)

    # ---- 1. build the kernel
    build = sd.build_library()
    ptxas = [ln for ln in build["ptxas"] if "Used" in ln or "spill" in ln]
    spills = [ln for ln in ptxas
              if any(int(n) for n in re.findall(r"(\d+) bytes spill", ln))]
    phase(1, build_seconds=build["seconds"], cached=build["cached"],
          ptxas=ptxas)
    if spills:
        raise AssertionError(f"the kernel spills registers: {spills}")

    # ---- 2. kernel against the plain version on the card
    cuda = torch.device("cuda")
    mf = load_fixture(FIXTURE, XYZ)
    mol = mf.mol
    fobj = qt.fragmentate(mol, n_BE=2, frag_type="chemgen",
                          print_frags=False)
    B = cholesky_df_factor(mol, tol=1.0e-10, eri=mf.get_eri())
    sdf = SparseDF.from_factor(mol, B, device=cuda)
    B32 = sdf.factor.B32
    max_err = 0.0
    shapes = []
    screened = []
    for TA in fragment_bases(mf, fobj):
        TA_eff, reach = sdf.screen(TA)
        TA32 = torch.as_tensor(TA_eff.astype(np.float32), device=cuda)
        screened.append((TA32, reach))
        max_err = max(max_err, check_kernel(sd, B32, TA32, reach))
        shapes.append([*B32.shape, TA32.shape[1], int(reach.sum())])
    # synthetic: nao 70 (five 16-blocks, the last one ragged), blocks 1
    # and 3 unreachable, block 4 reachable through one AO only
    rng = np.random.default_rng(0)
    nao_s, naux_s, nemb_s = 70, 64, 37
    reach = np.ones(nao_s, bool)
    reach[16:32] = False
    reach[48:70] = False
    reach[66] = True
    Bs = torch.as_tensor(
        rng.standard_normal((naux_s, nao_s, nao_s)).astype(np.float32),
        device=cuda,
    )
    TAs = torch.as_tensor(
        rng.standard_normal((nao_s, nemb_s)).astype(np.float32), device=cuda
    )
    if sd.kept_blocks(reach).tolist() != [0, 2, 4]:
        raise AssertionError("synthetic case: kept blocks are not 0, 2, 4")
    max_err = max(max_err, check_kernel(sd, Bs, TAs, reach))
    # synthetic factor at C40 shapes, from a seeded generator on the card:
    # a window of 8 of 18 blocks, then the same with the ragged tail block
    Bc, TAc, reach_c40 = c40_case(sd, cuda)
    reach_tail = reach_c40.copy()
    reach_tail[sd.NU_BLOCK * C40_TAIL_BLOCK + 3] = True
    if sd.kept_blocks(reach_tail).tolist() != [*C40_WINDOW, C40_TAIL_BLOCK]:
        raise AssertionError("C40 case: kept blocks are not the window + 17")
    c40_err = max(check_kernel(sd, Bc, TAc, r) for r in (reach_c40,
                                                          reach_tail))
    # device times at octane fragment 0 and at the C40 window
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=cuda)
    flush.zero_()
    TA32, reach = screened[0]
    timed = {
        "octane_frag0": time_versions(sd, B32, TA32, reach, flush),
        "c40_8of18": time_versions(sd, Bc, TAc, reach_c40, flush),
    }
    phase(2, octane_shapes=shapes, synthetic=[naux_s, nao_s, nao_s, nemb_s],
          c40=[*Bc.shape, TAc.shape[1]], max_abs_err=max_err,
          c40_max_abs_err=c40_err, tol_rel=KERNEL_REL_TOL, timed=timed,
          timings=N_TIMINGS, calls_per_timing=CALLS_PER_TIMING, card=card)
    max_err = max(max_err, c40_err)
    del sdf, B32, Bs, TAs, screened, Bc, TAc, flush
    torch.cuda.empty_cache()

    # ---- 3. main path, f32 tier: the kernel runs once per fragment
    os.environ["QUEMB_TPU_CCSD_F32_ONLY"] = "1"
    sd.LAUNCHES = 0
    t0 = time.perf_counter()
    be32 = qt.BE(mf, fobj, int_transform="sparse-DF", auxbasis="cholesky",
                 device=cuda)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    launches = sd.LAUNCHES
    if launches != fobj.n_frag:
        raise AssertionError(
            f"{launches} kernel launches for {fobj.n_frag} fragments"
        )
    hf32 = be32.ebe_hf - mf.e_tot
    if not abs(hf32) < 1e-4:
        raise AssertionError(f"f32 tier HF-in-HF {hf32:.3e} >= 1e-4 Ha")
    t0 = time.perf_counter()
    be32.oneshot("CCSD")
    oneshot32_s = time.perf_counter() - t0
    ecorr32 = be32.ebe_tot - be32.ebe_hf
    if not abs(ecorr32 - ECORR_REF) < 1e-4:
        raise AssertionError(
            f"f32 tier E_corr {ecorr32:.10f}: |dev| >= 1e-4 Ha"
        )
    phase(3, kernel_launches=launches, n_frag=fobj.n_frag,
          hf_in_hf=hf32, ecorr=ecorr32, ecorr_dev=ecorr32 - ECORR_REF,
          init_s=init_s, oneshot_s=oneshot32_s, card=card)
    del os.environ["QUEMB_TPU_CCSD_F32_ONLY"]
    del be32

    # ---- 4. main path, f64 route (Cholesky-factor transform on CUDA)
    os.environ["QUEMB_TPU_CCSD_CONV_TOL"] = "1e-6"
    t0 = time.perf_counter()
    be = qt.BE(mf, fobj, device=cuda)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    hf64 = be.ebe_hf - mf.e_tot
    if not abs(hf64) < 1e-6:
        raise AssertionError(f"f64 HF-in-HF {hf64:.3e} >= 1e-6 Ha")
    t0 = time.perf_counter()
    be.oneshot("CCSD")
    oneshot_s = time.perf_counter() - t0
    ecorr = be.ebe_tot - be.ebe_hf
    if not abs(ecorr - ECORR_REF) < 1e-6:
        raise AssertionError(f"f64 E_corr {ecorr:.10f}: |dev| >= 1e-6 Ha")
    phase(4, hf_in_hf=hf64, ecorr=ecorr, ecorr_dev=ecorr - ECORR_REF,
          init_s=init_s, oneshot_s=oneshot_s, card=card)

    # ---- 5. objective evaluations at a seeded matching potential
    pot = np.random.default_rng(0).standard_normal(len(be.pot)) * 1e-3
    walls = []
    for eeval in (True, True, False):
        t0 = time.perf_counter()
        ret = be_func(pot, be.fragments, be.Nocc, "CCSD", eeval=eeval,
                      return_vec=True)
        walls.append(time.perf_counter() - t0)
        ervec = ret[1]
        if not (ervec.shape == (len(pot),) and np.all(np.isfinite(ervec))):
            raise AssertionError("objective error vector is not finite")
        if eeval and not np.isfinite(ret[2][0]):
            raise AssertionError("objective energy is not finite")
    phase(5, first_eeval_s=walls[0], warm_eeval_s=walls[1],
          warm_error_only_s=walls[2], error_norm=float(ret[0]), card=card)

    main = timed["octane_frag0"]
    print(json.dumps({"kernels": [{
        "name": "screened_first_transform",
        "route": "cuda",
        "source": "quemb_tpu_torch/csrc/screened_first_transform.cu",
        "replaces": "quemb_tpu/ops/pallas_df.py:30",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "cold_ms": main["cold_ms"],
        "shapes": {k: {f: v[f] for f in (
            "shape", "ms", "cold_ms", "plain_ms", "plain_cold_ms",
            "library_ms", "library_cold_ms", "bound_ms", "bound_by",
            "roofline_share_cold")} for k, v in timed.items()},
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.exit(main())
