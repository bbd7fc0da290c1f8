"""Closed-shell CCSD amplitude iteration, batched over fragments.

JAX counterpart: ``quemb_tpu/solvers/rccsd.py`` (``_rdiis_stage``,
``_rccsd_iterate``, ``_rccsd_from_mo_batched``, ``rccsd_batched``,
``solve_rccsd``).  The DIIS-accelerated loop drives
:func:`quemb_tpu_torch.solvers.rccsd_mat.rccsd_update_mat` over a bucket
held as a leading batch dimension, which may be one fragment: the JAX
module's large-fragment entry is this loop at batch 1.  Where the JAX module
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

import torch

from quemb_tpu_torch.parallel.mesh import map_batches
from quemb_tpu_torch.solvers.ccsd import _default_conv_tol, _diis_loop, \
    _f32_only, _f32_tol
from quemb_tpu_torch.solvers.rccsd_mat import rccsd_fused_blocks, \
    rccsd_update_mat

#: iteration cap of the closed-shell CCSD (the JAX functions' default
#: ``max_cycle``); a caller that needs more sets it and restores it
MAX_CYCLE = 150


def _rdiis_stage(fb, moe_o, moe_v, t1_0, T2p_0, conv_tol, max_cycle=None):
    """DIIS-accelerated RCCSD iteration at the input dtype, to
    ``conv_tol`` or ``max_cycle`` steps (default ``MAX_CYCLE``;
    :func:`_diis_loop`).  Returns (t1 [nf, no, nv], T2p [nf, no^2,
    nv^2], n_it [nf], delta [nf] f64).
    """
    def step(t1, T2p):
        return rccsd_update_mat(t1, T2p, moe_o, moe_v, fb)[:2]

    return _diis_loop(step, t1_0, T2p_0, conv_tol,
                      MAX_CYCLE if max_cycle is None else max_cycle)


def _rccsd_iterate(moe_o, moe_v, fb: dict, conv_tol=None, max_cycle=None):
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
        fb, moe_o, moe_v, t1_0, T2p_0, conv_tol, max_cycle
    )
    return t1f, T2pf.reshape(nf, no, no, nv, nv), it, delta


def _rccsd_from_mo_batched(eri_mo_b, moe_b, nsocc: int,
                           f32_only: bool = False, max_cycle=None):
    """Fused-block build + RCCSD iteration for a bucket.

    eri_mo_b [nf, nmo]^4 chemist, moe_b [nf, nmo], both f64.  Returns f64
    spatial (t1_b, t2_b, it, delta).
    """
    if f32_only:
        fb = rccsd_fused_blocks(eri_mo_b.float(), nsocc)
        t1f, t2f, it, delta = _rccsd_iterate(
            moe_b[:, :nsocc].float(), moe_b[:, nsocc:].float(), fb,
            conv_tol=_f32_tol(), max_cycle=max_cycle,
        )
        return t1f.double(), t2f.double(), it, delta
    fb = rccsd_fused_blocks(eri_mo_b, nsocc)
    return _rccsd_iterate(moe_b[:, :nsocc], moe_b[:, nsocc:], fb,
                          max_cycle=max_cycle)


def rccsd_batched(eri_mo_b, moe_b, nsocc: int):
    """Batched closed-shell CCSD over a bucket, the fragment axis sharded
    over the active mesh (:mod:`quemb_tpu_torch.parallel.mesh`): eri_mo_b
    [nf, nmo]^4 chemist and moe_b [nf, nmo], f64.  The precision follows
    ``QUEMB_TPU_CCSD_F32_ONLY``.  Returns spatial (t1_b, t2_b, it, delta)
    on the device of ``eri_mo_b``."""
    f32_only = _f32_only()
    return map_batches(
        lambda e, m: _rccsd_from_mo_batched(e, m, nsocc, f32_only=f32_only),
        torch.as_tensor(eri_mo_b, dtype=torch.float64),
        torch.as_tensor(moe_b, dtype=torch.float64),
    )


def solve_rccsd(eri_mo, moe, nsocc: int, conv_tol=1e-9, max_cycle=150):
    """Single-fragment closed-shell CCSD in f64, on the device of
    ``eri_mo`` [nmo]^4 (chemist) and ``moe`` [nmo]; the amplitudes
    converge to ``QUEMB_TPU_CCSD_CONV_TOL`` and a step above
    ``conv_tol`` after ``max_cycle`` iterations warns, as in the JAX
    function.  Returns (t1 [no, nv], t2 [no, no, nv, nv] there, e_corr).
    """
    import warnings

    eri_mo = torch.as_tensor(eri_mo, dtype=torch.float64)
    moe = torch.as_tensor(moe, dtype=torch.float64, device=eri_mo.device)
    t1f, t2f, _, delta = _rccsd_from_mo_batched(
        eri_mo[None], moe[None], nsocc, max_cycle=max_cycle
    )
    if float(delta[0]) > conv_tol:
        warnings.warn(
            f"RCCSD did not converge: |dt| = {float(delta[0]):.2e}"
        )
    no = nsocc
    t1, t2 = t1f[0], t2f[0]
    ovov = eri_mo[:no, no:, :no, no:]
    tf = t2 + torch.einsum("ia,jb->ijab", t1, t1)
    e_corr = torch.einsum("ijab,iajb->", tf, 2.0 * ovov) - torch.einsum(
        "ijab,ibja->", tf, ovov
    )
    return t1, t2, float(e_corr)
