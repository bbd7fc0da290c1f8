"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ``quemb_tpu_torch`` (and nothing of JAX) through octane (C8H18,
STO-3G) BE2-CCSD from the committed RHF fixture, in phases; each prints
one line, and any failure raises (non-zero exit, no ``ok`` line):

0. the device: CUDA name, and ``nvidia-smi`` name and power limit;
1. build the screened-DF CUDA kernel from ``quemb_tpu_torch/csrc``;
2. kernel against its plain torch version on the card, on every octane
   fragment's screened basis against the octane Cholesky factor and on a
   synthetic case with skipped and partly reachable blocks; CUDA-event
   timings of both at the octane shapes (median of 20, each over 10
   back-to-back calls);
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
#: kernel against plain version, relative to max|plain|: both sum the same
#: f32 products (at most 16 per kept block), in different orders
KERNEL_REL_TOL = 1e-5
N_TIMINGS = 20  # timings of each version; the median is reported
CALLS_PER_TIMING = 10  # back-to-back calls between two CUDA events


def phase(n, **facts):
    print(json.dumps({"phase": n, **facts}), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def event_ms(fn) -> float:
    """Milliseconds per call, from CUDA events around back-to-back calls
    (host work of each call included where it outlasts the device's)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(CALLS_PER_TIMING):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / CALLS_PER_TIMING


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
    phase(1, build_seconds=build["seconds"], cached=build["cached"],
          ptxas=[ln for ln in build["ptxas"] if "Used" in ln or "spill" in ln])

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
    nao, naux, nemb = 70, 64, 37
    reach = np.ones(nao, bool)
    reach[16:32] = False
    reach[48:70] = False
    reach[66] = True
    Bs = torch.as_tensor(
        rng.standard_normal((naux, nao, nao)).astype(np.float32), device=cuda
    )
    TAs = torch.as_tensor(
        rng.standard_normal((nao, nemb)).astype(np.float32), device=cuda
    )
    if sd.kept_blocks(reach).tolist() != [0, 2, 4]:
        raise AssertionError("synthetic case: kept blocks are not 0, 2, 4")
    max_err = max(max_err, check_kernel(sd, Bs, TAs, reach))
    # timings at the octane shapes (first fragment), kernel and plain in
    # turns on the same inputs; the row mask of the plain version is
    # built once, outside the timed region
    TA32, reach = screened[0]
    rowmask = sd.block_rowmask(reach, torch.float32, cuda)
    for _ in range(3):  # warm up both
        sd.screened_first_transform(B32, TA32, reach)
        sd.screened_first_transform_plain(B32, TA32, rowmask)
    k_ms, p_ms = [], []
    for _ in range(N_TIMINGS):
        p_ms.append(event_ms(
            lambda: sd.screened_first_transform_plain(B32, TA32, rowmask)
        ))
        k_ms.append(event_ms(
            lambda: sd.screened_first_transform(B32, TA32, reach)
        ))
    kernel_ms = float(np.median(k_ms))
    plain_ms = float(np.median(p_ms))
    phase(2, octane_shapes=shapes, synthetic=[naux, nao, nao, nemb],
          max_abs_err=max_err, tol_rel=KERNEL_REL_TOL,
          kernel_ms_median=kernel_ms, plain_ms_median=plain_ms,
          timings=N_TIMINGS, calls_per_timing=CALLS_PER_TIMING,
          timed_shape=shapes[0], card=card)
    del sdf, B32, Bs, TAs, screened

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

    print(json.dumps({"kernels": [{
        "name": "screened_first_transform",
        "route": "cuda",
        "source": "quemb_tpu_torch/csrc/screened_first_transform.cu",
        "replaces": "quemb_tpu/ops/pallas_df.py:30",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.exit(main())
