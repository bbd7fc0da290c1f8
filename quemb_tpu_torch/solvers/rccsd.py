"""Closed-shell CCSD amplitude iteration, batched over fragments.

JAX counterpart: ``quemb_tpu/solvers/rccsd.py`` (``_rdiis_stage``,
``_rccsd_iterate``, ``_rccsd_from_mo_batched``, ``rccsd_large``).  The
DIIS-accelerated loop drives
:func:`quemb_tpu_torch.solvers.rccsd_mat.rccsd_update_mat` over a bucket
held as a leading batch dimension (one fragment for ``rccsd_large``).  Where the JAX module
vmaps a ``lax.while_loop``, this one runs a Python loop until every lane
has converged, and freezes a converged lane's state as ``vmap`` does, so
that no lane drifts while the others iterate.  Each iteration reads one
flag back to the host to decide whether to go on.

Two precisions: f64 to ``QUEMB_TPU_CCSD_CONV_TOL``, or, under the f32-only
capacity tier (``QUEMB_TPU_CCSD_F32_ONLY=1``), blocks built and iterated
in f32 to ``QUEMB_TPU_CCSD_F32_TOL`` (default 1e-5).  The JAX module's
mixed f32-then-f64 stage is not ported.
"""

from __future__ import annotations

import os

import torch

from quemb_tpu_torch.solvers.ccsd import DIIS_SPACE, _default_conv_tol, \
    _diis_coeffs, _f32_only
from quemb_tpu_torch.solvers.rccsd_mat import rccsd_fused_blocks, \
    rccsd_update_mat

MAX_CYCLE = 150  # the JAX function's default ``max_cycle``


def _max_cycle() -> int:
    """Iteration cap (env ``QUEMB_TPU_CCSD_MAX_CYCLE``, default 150): the
    JAX function's ``max_cycle`` argument.  Small-gap fragments (the
    strained model chain of ``utils.geometry.alkane_atoms``) need more."""
    return int(os.environ.get("QUEMB_TPU_CCSD_MAX_CYCLE", MAX_CYCLE))


def _rdiis_stage(fb, moe_o, moe_v, t1_0, T2p_0, conv_tol):
    """DIIS-accelerated RCCSD iteration at the input dtype.

    Shift-append history of the last ``DIIS_SPACE`` amplitudes and f32
    errors; the f32 error Gram is solved in f64, per lane.  Returns
    (t1 [nf, no, nv], T2p [nf, no^2, nv^2], n_it [nf], delta [nf] f64).
    """
    dtype, dev = T2p_0.dtype, T2p_0.device
    nf, no, nv = t1_0.shape
    m = DIIS_SPACE
    t1, T2p = t1_0, T2p_0
    err1 = torch.zeros((nf, m, no, nv), dtype=torch.float32, device=dev)
    err2 = torch.zeros((nf, m, no * no, nv * nv), dtype=torch.float32,
                       device=dev)
    amp1 = torch.zeros((nf, m, no, nv), dtype=dtype, device=dev)
    amp2 = torch.zeros((nf, m, no * no, nv * nv), dtype=dtype, device=dev)
    it = torch.zeros(nf, dtype=torch.long, device=dev)
    delta = torch.full((nf,), float("inf"), dtype=torch.float64, device=dev)
    max_cycle = _max_cycle()
    while True:
        active = (delta > conv_tol) & (it < max_cycle)
        if not bool(active.any()):
            break
        t1n, T2n, _ = rccsd_update_mat(t1, T2p, moe_o, moe_v, fb)
        e1 = t1n - t1
        e2 = T2n - T2p
        step = torch.sqrt(
            (e1.double() ** 2).sum((1, 2)) + (e2.double() ** 2).sum((1, 2))
        )
        err1n = torch.cat([err1[:, 1:], e1.float()[:, None]], 1)
        err2n = torch.cat([err2[:, 1:], e2.float()[:, None]], 1)
        amp1n = torch.cat([amp1[:, 1:], t1n[:, None]], 1)
        amp2n = torch.cat([amp2[:, 1:], T2n[:, None]], 1)
        B = (
            torch.einsum("fmij,fnij->fmn", err1n, err1n)
            + torch.einsum("fmpq,fnpq->fmn", err2n, err2n)
        ).double()
        c = _diis_coeffs(B, torch.clamp(it + 1, max=m))
        c = c.to(dtype)
        use = (it > 0)[:, None, None]
        t1x = torch.where(use, torch.einsum("fm,fmij->fij", c, amp1n), t1n)
        T2x = torch.where(use, torch.einsum("fm,fmpq->fpq", c, amp2n), T2n)
        # converged lanes stay frozen, as under vmap(while_loop)
        a3 = active[:, None, None]
        a4 = active[:, None, None, None]
        t1 = torch.where(a3, t1x, t1)
        T2p = torch.where(a3, T2x, T2p)
        err1 = torch.where(a4, err1n, err1)
        err2 = torch.where(a4, err2n, err2)
        amp1 = torch.where(a4, amp1n, amp1)
        amp2 = torch.where(a4, amp2n, amp2)
        delta = torch.where(active, step, delta)
        it = it + active.long()
    return t1, T2p, it, delta


def _rccsd_iterate(moe_o, moe_v, fb: dict, conv_tol=None):
    """Closed-shell CCSD from MP2-like starting amplitudes, batched.

    Returns spatial (t1 [nf, no, nv], t2 [nf, no, no, nv, nv], n_it,
    delta).
    """
    if conv_tol is None:
        conv_tol = _default_conv_tol()
    nf, no = moe_o.shape
    nv = moe_v.shape[1]
    dtype = fb["Vp"].dtype
    Doovv = (
        (moe_o[:, :, None] + moe_o[:, None, :]).reshape(nf, -1)[:, :, None]
        - (moe_v[:, :, None] + moe_v[:, None, :]).reshape(nf, -1)[:, None, :]
    ).to(dtype)
    t1_0 = torch.zeros((nf, no, nv), dtype=dtype, device=moe_o.device)
    T2p_0 = fb["Vp"] / Doovv
    t1f, T2pf, it, delta = _rdiis_stage(
        fb, moe_o, moe_v, t1_0, T2p_0, conv_tol
    )
    return t1f, T2pf.reshape(nf, no, no, nv, nv), it, delta


def _rccsd_from_mo_batched(eri_mo_b, moe_b, nsocc: int,
                           f32_only: bool = False):
    """Fused-block build + RCCSD iteration for a bucket.

    eri_mo_b [nf, nmo]^4 chemist, moe_b [nf, nmo], both f64.  Returns f64
    spatial (t1_b, t2_b, it, delta).
    """
    if f32_only:
        fb = rccsd_fused_blocks(eri_mo_b.float(), nsocc)
        f32_tol = float(os.environ.get("QUEMB_TPU_CCSD_F32_TOL", "1e-5"))
        t1f, t2f, it, delta = _rccsd_iterate(
            moe_b[:, :nsocc].float(), moe_b[:, nsocc:].float(), fb,
            conv_tol=f32_tol,
        )
        return t1f.double(), t2f.double(), it, delta
    fb = rccsd_fused_blocks(eri_mo_b, nsocc)
    return _rccsd_iterate(moe_b[:, :nsocc], moe_b[:, nsocc:], fb)


def rccsd_large(eri_mo, moe, nsocc: int):
    """Closed-shell CCSD of one large fragment, no batch axis.

    eri_mo [nmo]^4 chemist and moe [nmo], f64 tensors on the device that
    runs it.  Returns (t1 [no, nv], t2 [no, no, nv, nv] there, n_iter,
    delta); the precision follows :func:`_rccsd_from_mo_batched` under
    ``QUEMB_TPU_CCSD_F32_ONLY``.
    """
    t1, t2, it, delta = _rccsd_from_mo_batched(
        eri_mo[None], moe[None], nsocc, f32_only=_f32_only()
    )
    return t1[0], t2[0], int(it[0]), float(delta[0])
