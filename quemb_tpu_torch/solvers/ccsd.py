"""CCSD for embedded fragments: the shared DIIS iteration and the
spin-orbital kernel, with unrelaxed 1/2-RDMs.

JAX counterpart: ``quemb_tpu/solvers/ccsd.py``.  The amplitude equations
are the standard spin-orbital CCSD equations (Stanton, Gauss, Watts,
Bartlett, J. Chem. Phys. 94, 4334 (1991)): :func:`_ccsd_update` in plain
einsums, and the fused-matrix form of
:mod:`quemb_tpu_torch.solvers.ccsd_mat` that the iterations run.  The
spin-orbital kernel is selected by ``QUEMB_TPU_CCSD_SPINORB=1`` (the
production kernel is the closed-shell one of
:mod:`quemb_tpu_torch.solvers.rccsd`); it carries the off-diagonal Fock
blocks that the relaxed densities and UCCSD need.

Differences from the JAX module, none of them in what is computed:

- the DIIS-accelerated amplitude loop (:func:`_diis_loop`, shared with
  the closed-shell kernel) runs over a bucket held as a leading batch
  axis in a Python loop until every lane has converged, freezing a
  converged lane as ``vmap(lax.while_loop)`` does; each iteration reads
  one flag back to the host;
- the bordered DIIS system is solved by ``torch.linalg.solve_ex`` on the
  same masked, scale-normalized system where the JAX module runs an
  unrolled pivoted elimination (a TPU-safe form inside a while loop);
- ``so_blocks_jax`` is :func:`so_blocks`, which builds every bucket's
  blocks, one fragment wide or many; the JAX module's gather build of a
  wide fragment's blocks on the host, which spares a 16 GB chip's memory,
  is not ported;
- mixed f32-then-f64 iteration (``_use_mixed``) is not ported: the f64
  path runs plain f64; the f32-only capacity tier is.
"""

from __future__ import annotations

import os
import warnings

import torch

from quemb_tpu_torch.ops.eri_transform import batched_mo_eri
from quemb_tpu_torch.parallel.mesh import map_batches
from quemb_tpu_torch.solvers.ccsd_mat import ccsd_update_mat, fused_blocks
from quemb_tpu_torch.solvers.rccsd_mat import _p
from quemb_tpu_torch.utils.profiling import count

#: amplitude history length of the CCSD DIIS (the JAX default)
DIIS_SPACE = 6


# --------------------------------------------------- spin-orbital machinery
def _ccsd_update(t1, t2, moe_o, moe_v, oovv, ovvv, ooov, oooo, vvvv,
                 ovov, ovvo, ovoo, vvvo, f_oo_off=None, f_ov=None,
                 f_vv_off=None):
    """One CCSD amplitude update (SGWB intermediates), one fragment.

    Integral blocks are antisymmetrized physicist <pq||rs> slices:
    oovv=<mn||ef>, ovvv=<ma||ef>, ooov=<mn||ie>, oooo=<mn||ij>,
    vvvv=<ab||ef>, ovov=<na||if>, ovvo=<mb||ej>, ovoo=<mb||ij>,
    vvvo=<ab||ej>.

    ``f_*`` are the one-particle Fock blocks (off-diagonal parts for oo/vv,
    full ov block); pass None for canonical orbitals (diagonal Fock).
    """
    es = torch.einsum
    Dov = moe_o[:, None] - moe_v[None, :]
    Doovv = (
        moe_o[:, None, None, None]
        + moe_o[None, :, None, None]
        - moe_v[None, None, :, None]
        - moe_v[None, None, None, :]
    )

    t1t1 = es("ia,jb->ijab", t1, t1)
    t1t1 = t1t1 - t1t1.permute(0, 1, 3, 2)
    tau_t = t2 + 0.5 * t1t1
    tau = t2 + t1t1

    # F intermediates (SGWB eqs. 3-5)
    Fae = es("mf,mafe->ae", t1, ovvv) - 0.5 * es("mnaf,mnef->ae", tau_t,
                                                  oovv)
    Fmi = es("ne,mnie->mi", t1, ooov) + 0.5 * es("inef,mnef->mi", tau_t,
                                                  oovv)
    Fme = es("nf,mnef->me", t1, oovv)
    if f_ov is not None:
        Fae = Fae + f_vv_off.T - 0.5 * es("me,ma->ae", f_ov, t1)
        Fmi = Fmi + f_oo_off + 0.5 * es("me,ie->mi", f_ov, t1)
        Fme = Fme + f_ov

    # W intermediates
    Wmnij = (
        oooo
        + es("je,mnie->mnij", t1, ooov)
        - es("ie,mnje->mnij", t1, ooov)
        + 0.25 * es("ijef,mnef->mnij", tau, oovv)
    )
    Wabef = (
        vvvv
        + es("mb,maef->abef", t1, ovvv)
        - es("ma,mbef->abef", t1, ovvv)
        + 0.25 * es("mnab,mnef->abef", tau, oovv)
    )
    # oovo[m,n,e,j] = <mn||ej> = -<mn||je> = -ooov[m,n,j,e]
    Wmbej = (
        ovvo
        + es("jf,mbef->mbej", t1, ovvv)
        + es("nb,mnje->mbej", t1, ooov)
        - es("jnfb,mnef->mbej", 0.5 * t2 + es("jf,nb->jnfb", t1, t1), oovv)
    )

    # T1
    t1new = (
        es("ie,ae->ia", t1, Fae)
        - es("ma,mi->ia", t1, Fmi)
        + es("imae,me->ia", t2, Fme)
        - es("nf,naif->ia", t1, ovov)
        - 0.5 * es("imef,maef->ia", t2, ovvv)
        + 0.5 * es("mnae,nmie->ia", t2, ooov)
    )
    if f_ov is not None:
        t1new = t1new + f_ov

    # T2
    def P_ab(x):
        return x - x.permute(0, 1, 3, 2)

    def P_ij(x):
        return x - x.permute(1, 0, 2, 3)

    t2new = oovv + P_ab(
        es("ijae,be->ijab", t2, Fae - 0.5 * es("mb,me->be", t1, Fme))
    )
    t2new = t2new - P_ij(
        es("imab,mj->ijab", t2, Fmi + 0.5 * es("je,me->mj", t1, Fme))
    )
    t2new = t2new + 0.5 * es("mnab,mnij->ijab", tau, Wmnij)
    t2new = t2new + 0.5 * es("ijef,abef->ijab", tau, Wabef)
    tmp = es("imae,mbej->ijab", t2, Wmbej) - es(
        "ie,ma,mbej->ijab", t1, t1, ovvo
    )
    t2new = t2new + P_ij(P_ab(tmp))
    t2new = t2new + P_ij(es("ie,abej->ijab", t1, vvvo))
    t2new = t2new - P_ab(es("ma,mbij->ijab", t1, ovoo))

    t1new = t1new / Dov
    t2new = t2new / Doovv

    e_corr = 0.25 * es("ijab,ijab->", oovv, tau)
    if f_ov is not None:
        e_corr = e_corr + es("ia,ia->", f_ov, t1)
    return t1new, t2new, e_corr


def _diis_coeffs(B: torch.Tensor, nvalid: torch.Tensor) -> torch.Tensor:
    """DIIS coefficients [nf, m] from error Gram matrices B [nf, m, m]
    of a shift-append history whose valid entries are the LAST ``nvalid``
    [nf] slots (the JAX function with ``newest_last=True``).

    Invalid slots are masked to identity rows and the Gram block is
    scale-normalized for conditioning.
    """
    nf, m, _ = B.shape
    dt, dev = B.dtype, B.device
    valid = torch.arange(m, device=dev)[None, :] >= (m - nvalid)[:, None]
    B = torch.where(valid[:, :, None] & valid[:, None, :], B, 0.0)
    scale = B.abs().amax((1, 2)).clamp_min(1e-280)
    B = B / scale[:, None, None]
    eye = torch.eye(m, dtype=dt, device=dev)
    B = B + torch.diag_embed((~valid).to(dt)) + 1e-14 * eye
    # scaling B -> B/s leaves the coefficient part of the bordered
    # solution unchanged (only the multiplier rescales)
    border = torch.where(valid, -1.0, 0.0).to(dt)
    Bfull = torch.zeros((nf, m + 1, m + 1), dtype=dt, device=dev)
    Bfull[:, :m, :m] = B
    Bfull[:, m, :m] = border
    Bfull[:, :m, m] = border
    rhs = torch.zeros((nf, m + 1), dtype=dt, device=dev)
    rhs[:, m] = -1.0
    x, _ = torch.linalg.solve_ex(Bfull, rhs)
    return x[:, :m]


def _diis_loop(step, t1_0, T2p_0, conv_tol, max_cycle):
    """DIIS-accelerated fixed-point iteration of the amplitudes at their
    dtype, batched: ``step(t1, T2p) -> (t1n, T2n)`` on [nf, no, nv] and
    [nf, no^2, nv^2].

    Shift-append history of the last ``DIIS_SPACE`` amplitudes and f32
    errors; the f32 error Gram is solved in f64, per lane.  A lane stops
    once its step norm is at most ``conv_tol`` or after ``max_cycle``
    steps, and then stays frozen.  Returns (t1, T2p, n_it [nf], delta [nf]
    f64).  Counts each loop trip (``iters``) and each flag read
    (``syncs``) on the innermost open span of the tracer.
    """
    dtype, dev = T2p_0.dtype, T2p_0.device
    nf, no, nv = t1_0.shape
    m = DIIS_SPACE
    t1, T2p = t1_0, T2p_0
    err1 = torch.zeros((nf, m, no, nv), dtype=torch.float32, device=dev)
    err2 = torch.zeros((nf, m) + tuple(T2p_0.shape[1:]),
                       dtype=torch.float32, device=dev)
    amp1 = torch.zeros((nf, m, no, nv), dtype=dtype, device=dev)
    amp2 = torch.zeros((nf, m) + tuple(T2p_0.shape[1:]), dtype=dtype,
                       device=dev)
    it = torch.zeros(nf, dtype=torch.long, device=dev)
    delta = torch.full((nf,), float("inf"), dtype=torch.float64, device=dev)
    while True:
        active = (delta > conv_tol) & (it < max_cycle)
        count("syncs")
        if not bool(active.any()):
            break
        count("iters")
        t1n, T2n = step(t1, T2p)
        e1 = t1n - t1
        e2 = T2n - T2p
        stepn = torch.sqrt(
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
        delta = torch.where(active, stepn, delta)
        it = it + active.long()
    return t1, T2p, it, delta


def _diis_stage(fb, moe_o, moe_v, t1_0, T2p_0, conv_tol, max_cycle,
                f_blocks=None):
    """DIIS-accelerated spin-orbital amplitude iteration at the dtype of
    the inputs (batched; ``f_blocks`` = (f_oo_off, f_ov, f_vv_off) for a
    non-canonical Fock).  Returns (t1, T2p, n_it, delta)."""
    f_kw = {} if f_blocks is None else dict(
        f_oo_off=f_blocks[0], f_ov=f_blocks[1], f_vv_off=f_blocks[2]
    )

    def step(t1, T2p):
        return ccsd_update_mat(t1, T2p, moe_o, moe_v, fb, **f_kw)[:2]

    return _diis_loop(step, t1_0, T2p_0, conv_tol, max_cycle)


def _default_conv_tol() -> float:
    """Amplitude-norm convergence target (env QUEMB_TPU_CCSD_CONV_TOL)."""
    return float(os.environ.get("QUEMB_TPU_CCSD_CONV_TOL", "1e-9"))


def _f32_tol() -> float:
    """Convergence target of the f32-only tier (env
    QUEMB_TPU_CCSD_F32_TOL)."""
    return float(os.environ.get("QUEMB_TPU_CCSD_F32_TOL", "1e-5"))


def _ccsd_iterate(moe_o, moe_v, fb: dict, conv_tol=None, max_cycle=150):
    """Spin-orbital CCSD from MP2-like starting amplitudes, batched.

    Returns (t1 [nf, no, nv], t2 [nf, no, no, nv, nv], n_it, delta).
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
    t1f, T2pf, it, delta = _diis_stage(
        fb, moe_o, moe_v, t1_0, T2p_0, conv_tol, max_cycle
    )
    return t1f, T2pf.reshape(nf, no, no, nv, nv), it, delta


def _split_spatial(t1f, t2f, nsocc: int, nmo: int):
    """Spatial (alpha-alpha t1, alpha-beta t2) blocks of spin-orbital
    amplitudes, with or without a leading batch axis."""
    nv_sp = nmo - nsocc
    t1_sp = t1f[..., :nsocc, :nv_sp]
    t2_sp = t2f[..., :nsocc, nsocc:2 * nsocc, :nv_sp, nv_sp:]
    return t1_sp, t2_sp


def ccsd_so_kernel(eri_mo, moe, nsocc: int, conv_tol=1e-9, max_cycle=150):
    """Spin-orbital CCSD of one fragment: block build + iteration on the
    device of ``eri_mo``.  Returns spatial (t1, t2, n_iter, norm_dt).

    ``conv_tol`` is not read, as in the JAX function: the iteration runs
    to ``QUEMB_TPU_CCSD_CONV_TOL``.
    """
    nmo = eri_mo.shape[0]
    t1f, t2f, it, delta = _ccsd_from_mo_batched(
        eri_mo[None], moe[None], nsocc, max_cycle=max_cycle,
    )
    t1_sp, t2_sp = _split_spatial(t1f[0], t2f[0], nsocc, nmo)
    return t1_sp, t2_sp, int(it[0]), float(delta[0])


def _anti_block(A, Ax):
    """Antisymmetrized spin-orbital blocks from spatial physicist slices.

    A: [nf, p, q, r, s] spatial <pq|rs> slices; Ax: the slices with the
    3rd/4th orbital SPACES swapped (equal to A when both live in the same
    space), so the exchange <pq|sr> at [p,q,r,s] is Ax[p,q,s,r].  Returns
    [nf, 2p, 2q, 2r, 2s] spin-orbital <pq||rs> blocks in spin-major
    per-axis layout, built by broadcast spin-delta expansion: no gathers
    and nothing written in place, so ``torch.func`` differentiates it.
    """
    I2 = torch.eye(2, dtype=A.dtype, device=A.device)
    d = torch.einsum("wy,xz,fpqrs->fwpxqyrzs", I2, I2, A)
    x = torch.einsum("wz,xy,fpqrs->fwpxqyrzs", I2, I2, _p(Ax, 0, 1, 3, 2))
    nf, p, q, r, s = A.shape
    return (d - x).reshape(nf, 2 * p, 2 * q, 2 * r, 2 * s)


def so_blocks(eri_mo, moe, nsocc: int):
    """Spin-orbital fused-block build of a bucket, gather-free (the JAX
    module's ``so_blocks_jax``).

    eri_mo [nf, nmo]^4 chemist, moe [nf, nmo].  Spin layout per axis:
    (spin, spatial) major -- occupied indices are [alpha occ, beta occ],
    the ordering of the JAX module's gather build.  Returns (fused blocks,
    moe_o [nf, no], moe_v [nf, nv]).
    """
    nmo = eri_mo.shape[1]
    no = 2 * nsocc
    nv = 2 * (nmo - nsocc)
    phys = _p(eri_mo, 0, 2, 1, 3)  # <pq|rs>
    o = slice(0, nsocc)
    v = slice(nsocc, nmo)
    blocks = dict(
        oovv=_anti_block(phys[:, o, o, v, v], phys[:, o, o, v, v]),
        ovvv=_anti_block(phys[:, o, v, v, v], phys[:, o, v, v, v]),
        ooov=_anti_block(phys[:, o, o, o, v], phys[:, o, o, v, o]),
        oooo=_anti_block(phys[:, o, o, o, o], phys[:, o, o, o, o]),
        vvvv=_anti_block(phys[:, v, v, v, v], phys[:, v, v, v, v]),
        ovov=_anti_block(phys[:, o, v, o, v], phys[:, o, v, v, o]),
        ovvo=_anti_block(phys[:, o, v, v, o], phys[:, o, v, o, v]),
        ovoo=_anti_block(phys[:, o, v, o, o], phys[:, o, v, o, o]),
        vvvo=_anti_block(phys[:, v, v, v, o], phys[:, v, v, o, v]),
    )
    moe_o = torch.cat([moe[:, o], moe[:, o]], 1)
    moe_v = torch.cat([moe[:, v], moe[:, v]], 1)
    return fused_blocks(blocks, no, nv), moe_o, moe_v


def _f32_only() -> bool:
    """Capacity tier: run the whole CCSD in f32 (env
    QUEMB_TPU_CCSD_F32_ONLY=1), iterated to QUEMB_TPU_CCSD_F32_TOL; under
    ``BE(int_transform="sparse-DF")`` it also selects the f32 transform
    tier that runs the screened-DF kernel."""
    return os.environ.get("QUEMB_TPU_CCSD_F32_ONLY", "") in (
        "1", "true", "yes",
    )


def _ccsd_from_mo_batched(eri_mo_b, moe_b, nsocc: int, max_cycle: int = 150,
                          f32_only: bool = False):
    """Spin-block build + CCSD iteration for a bucket, eri_mo_b [nf,
    nmo]^4 and moe_b [nf, nmo] in f64.  Under ``f32_only`` the blocks are
    built and iterated in f32 to QUEMB_TPU_CCSD_F32_TOL.  Returns f64
    spin-orbital (t1f, t2f, it, delta)."""
    if f32_only:
        fb, mo, mv = so_blocks(eri_mo_b.float(), moe_b.float(), nsocc)
        t1f, t2f, it, delta = _ccsd_iterate(
            mo, mv, fb, conv_tol=_f32_tol(), max_cycle=max_cycle,
        )
        return t1f.double(), t2f.double(), it, delta
    fb, mo, mv = so_blocks(eri_mo_b, moe_b, nsocc)
    return _ccsd_iterate(mo, mv, fb, max_cycle=max_cycle)


def _ccsd_so_batched(eri_mo_b, moe_b, nsocc: int):
    """Batched spin-orbital CCSD over a bucket on its device (gather-free
    spin-block build -> fused-matrix DIIS iteration).  Returns spatial
    (t1_b, t2_b, it, delta)."""
    nmo = eri_mo_b.shape[1]
    t1f, t2f, it, delta = _ccsd_from_mo_batched(
        eri_mo_b, moe_b, nsocc, f32_only=_f32_only()
    )
    t1_b, t2_b = _split_spatial(t1f, t2f, nsocc, nmo)
    return t1_b, t2_b, it, delta


def ccsd_so_batched(eri_mo_b, moe_b, nsocc: int):
    """:func:`_ccsd_so_batched` with the fragment axis sharded over the
    active mesh (:mod:`quemb_tpu_torch.parallel.mesh`); the results are
    gathered on the device of ``eri_mo_b``.  Returns spatial (t1_b, t2_b,
    it, delta)."""
    return map_batches(lambda e, m: _ccsd_so_batched(e, m, nsocc),
                       eri_mo_b, moe_b)


def solve_ccsd_so(eri_mo, moe, nsocc: int, conv_tol=1e-9, max_cycle=150):
    """Single-fragment CCSD on the device of ``eri_mo`` [nmo]^4 (chemist
    MO integrals, a tensor).  Returns spatial (t1, t2, e_corr) with the
    closed-shell correlation energy recomputed from them."""
    moe = torch.as_tensor(moe, dtype=eri_mo.dtype, device=eri_mo.device)
    t1, t2, _, delta = ccsd_so_kernel(eri_mo, moe, nsocc,
                                      max_cycle=max_cycle)
    if delta > conv_tol:
        warnings.warn(f"CCSD did not converge: |dt| = {delta:.2e}")
    no = nsocc
    ovov = eri_mo[:no, no:, :no, no:]
    t2f = t2 + torch.einsum("ia,jb->ijab", t1, t1)
    e_corr = torch.einsum("ijab,iajb->", t2f, 2.0 * ovov) - torch.einsum(
        "ijab,ibja->", t2f, ovov
    )
    return t1, t2, float(e_corr)


# ----------------------------------------------------- unrelaxed CCSD RDMs
def make_rdm1_ccsd_t1(t1):
    """lambda=0 CCSD 1-RDM (reference ccsd_rdm.py:make_rdm1_ccsd_t1)."""
    nocc, nvir = t1.shape
    nmo = nocc + nvir
    dm = t1.new_zeros((nmo, nmo))
    dm[:nocc, nocc:] = t1
    dm[nocc:, :nocc] = t1.T
    idx = torch.arange(nocc, device=t1.device)
    dm[idx, idx] += 2.0
    return dm


def make_rdm2_urlx(t1, t2, with_dm1=True):
    """Unrelaxed 2-RDM from t1/t2 (reference ccsd_rdm.py:make_rdm2_urlx):
    the bucket form of :mod:`quemb_tpu_torch.solvers.dispatch` for one
    fragment."""
    from quemb_tpu_torch.solvers.dispatch import _rdm12_urlx_batched

    return _rdm12_urlx_batched(t1[None], t2[None], with_dm1=with_dm1)[1][0]


def solve_ccsd(fr, C, moe, with_dm2=True, use_cumulant=True, relax=False):
    """Fragment CCSD entry, on the device of ``fr.eri``.

    Returns (rdm1_mo, rdm2_mo) in the fragment-MO basis.
    """
    if relax:
        raise NotImplementedError("relaxed CCSD density lands later")
    C = torch.as_tensor(C, dtype=fr.eri.dtype, device=fr.eri.device)
    eri_mo = batched_mo_eri(fr.eri[None], C[None])[0]
    t1, t2, _ = solve_ccsd_so(eri_mo, moe, fr.nsocc)
    fr.t1, fr.t2 = t1, t2
    rdm1 = make_rdm1_ccsd_t1(t1)
    rdm2 = make_rdm2_urlx(t1, t2, with_dm1=not use_cumulant) \
        if with_dm2 else None
    return rdm1, rdm2

