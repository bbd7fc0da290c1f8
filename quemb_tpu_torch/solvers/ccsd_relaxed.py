"""Relaxed (lambda / linear-response) CCSD density matrices via adjoint
implicit differentiation.

JAX counterpart: ``quemb_tpu/solvers/ccsd_relaxed.py``.  The response
densities come from their defining property

    gamma1 = dE_elec / dh,     gamma2 = 2 dE_elec / d(eri)

with the amplitudes an implicit function of (h, eri) through the CCSD
fixed point t = U(t; h, eri).  The adjoint (Lambda) system
w = (dE/dt) + (dU/dt)^T w is solved by the transpose fixed-point
iteration, with ``torch.func.vjp`` of the same fused-matrix update that
drives the forward solve (``jax.vjp`` there).  The resulting RDMs satisfy
the energy trace identity E_elec = tr(h g1) + 0.5 eri : g2 to convergence
tolerance, which is what the BE fragment energies consume.

The forward solve runs under ``torch.no_grad()`` (``stop_gradient`` in the
JAX function), and the adjoint loop reads its step norm back to the host
once an iteration, where the JAX function runs a ``lax.while_loop``.
"""

from __future__ import annotations

import torch
from torch.func import grad, vjp

from quemb_tpu_torch.solvers.ccsd import _diis_stage, so_blocks
from quemb_tpu_torch.solvers.ccsd_mat import ccsd_update_mat
from quemb_tpu_torch.utils.profiling import count


def _occupations(nmo: int, nsocc: int, like: torch.Tensor, value: float):
    return torch.cat([like.new_full((nsocc,), value),
                      like.new_zeros(nmo - nsocc)])


def _fock_mo(h_mo, eri_mo, nsocc):
    """MO-basis Fock with the frozen HF density (2 on occupied diag)."""
    occ = _occupations(h_mo.shape[0], nsocc, h_mo, 2.0)
    vj = torch.einsum("pqrr,r->pq", eri_mo, occ)
    vk = torch.einsum("prrq,r->pq", eri_mo, occ)
    return h_mo + vj - 0.5 * vk


def _hbar_pieces(h_mo, eri_mo, nsocc):
    """Fused blocks (a batch of one) + Fock splittings as functions of
    (h, eri): the orbital energies are diag(fock), so the gradient flows
    through them too."""
    fock = _fock_mo(h_mo, eri_mo, nsocc)
    fb, moe_o, moe_v = so_blocks(eri_mo[None], torch.diagonal(fock)[None],
                                 nsocc)
    nmo = h_mo.shape[0]
    no = 2 * nsocc
    # spin-orbital Fock blocks (spin-major layout), by gathers
    f_so = torch.kron(torch.eye(2, dtype=fock.dtype, device=fock.device),
                      fock)
    count("syncs")
    order = torch.tensor(
        list(range(nsocc)) + list(range(nmo, nmo + nsocc))
        + list(range(nsocc, nmo)) + list(range(nmo + nsocc, 2 * nmo)),
        device=fock.device,
    )
    f_so = f_so.index_select(0, order).index_select(1, order)
    f_oo = f_so[:no, :no]
    f_vv = f_so[no:, no:]
    f_ov = f_so[:no, no:]
    f_oo_off = f_oo - torch.diag(torch.diagonal(f_oo))
    f_vv_off = f_vv - torch.diag(torch.diagonal(f_vv))
    return fb, moe_o, moe_v, f_oo_off[None], f_ov[None], f_vv_off[None]


def _update(t1, T2p, x, nsocc):
    h_mo, eri_mo = x
    fb, moe_o, moe_v, f_oo_off, f_ov, f_vv_off = _hbar_pieces(
        h_mo, eri_mo, nsocc
    )
    t1n, T2n, _ = ccsd_update_mat(
        t1[None], T2p[None], moe_o, moe_v, fb,
        f_oo_off=f_oo_off, f_ov=f_ov, f_vv_off=f_vv_off,
    )
    return t1n[0], T2n[0]


def _e_elec(t1, T2p, x, nsocc):
    h_mo, eri_mo = x
    dm = torch.diag(_occupations(h_mo.shape[0], nsocc, h_mo, 2.0))
    e_hf = torch.einsum("pq,qp->", h_mo, dm) + 0.5 * (
        torch.einsum("pqrs,pq,rs->", eri_mo, dm, dm)
        - 0.5 * torch.einsum("pqrs,ps,qr->", eri_mo, dm, dm)
    )
    fb, _, _, _, f_ov, _ = _hbar_pieces(h_mo, eri_mo, nsocc)
    no, nv = t1.shape
    Kk = torch.einsum("ia,jb->ijab", t1, t1)
    tau = T2p + (Kk - Kk.permute(0, 1, 3, 2)).reshape(no * no, nv * nv)
    e_corr = 0.25 * (fb["Vp"][0] * tau).sum() + (f_ov[0] * t1).sum()
    return e_hf + e_corr


def _relaxed_rdm_grads(h_mo, eri_mo, nsocc, max_cycle=150):
    """(dE/dh, dE/deri, E_elec) at the CCSD solution of (h_mo, eri_mo)."""
    x = (h_mo, eri_mo)
    with torch.no_grad():
        fb, moe_o, moe_v, f_oo_off, f_ov, f_vv_off = _hbar_pieces(
            h_mo, eri_mo, nsocc
        )
        no = moe_o.shape[1]
        nv = moe_v.shape[1]
        Doovv = (
            (moe_o[0, :, None] + moe_o[0, None, :]).reshape(-1)[:, None]
            - (moe_v[0, :, None] + moe_v[0, None, :]).reshape(-1)[None, :]
        )
        t1, T2p, _, _ = _diis_stage(
            fb, moe_o, moe_v, h_mo.new_zeros((1, no, nv)),
            fb["Vp"] / Doovv, 1e-10, max_cycle,
            f_blocks=(f_oo_off, f_ov, f_vv_off),
        )
        del fb
    t1, T2p = t1[0], T2p[0]

    # adjoint (Lambda) fixed point: w = dE/dt + (dU/dt)^T w
    e_t = grad(lambda tt: _e_elec(tt[0], tt[1], x, nsocc))((t1, T2p))
    _, u_vjp = vjp(lambda a, b: _update(a, b, x, nsocc), t1, T2p)
    w1, w2 = e_t
    for _ in range(max_cycle):
        d1, d2 = u_vjp((w1, w2))
        w1n = e_t[0] + d1
        w2n = e_t[1] + d2
        count("syncs")
        dl = float(torch.sqrt(((w1n - w1) ** 2).sum()
                              + ((w2n - w2) ** 2).sum()))
        w1, w2 = w1n, w2n
        if not dl > 1e-9:
            break
    del u_vjp

    # total derivative dE/dx = E_x + w^T U_x
    e_x = grad(lambda xx: _e_elec(t1, T2p, xx, nsocc))(x)
    _, ux_vjp = vjp(lambda h, e: _update(t1, T2p, (h, e), nsocc), *x)
    gx_h, gx_eri = ux_vjp((w1, w2))
    g_h = e_x[0] + gx_h
    g_eri = e_x[1] + gx_eri
    with torch.no_grad():
        e_val = _e_elec(t1, T2p, x, nsocc)
    return g_h, g_eri, e_val


def ccsd_relaxed_rdms(h_mo, eri_mo, nsocc: int):
    """Relaxed CCSD 1-/2-RDMs in the MO basis (pyscf conventions:
    E_elec = tr(h g1) + 0.5 sum (pq|rs) g2[p,q,r,s]), as tensors on the
    device of ``h_mo`` and ``eri_mo``, and E_elec as a float."""
    g_h, g_eri, e_val = _relaxed_rdm_grads(h_mo, eri_mo, nsocc)
    rdm1 = 0.5 * (g_h + g_h.T)
    rdm2 = 2.0 * g_eri
    # restore the full 8-fold symmetry the gradient spreads arbitrarily
    rdm2 = 0.5 * (rdm2 + rdm2.permute(1, 0, 3, 2))
    rdm2 = 0.5 * (rdm2 + rdm2.permute(2, 3, 0, 1))
    count("syncs")
    return rdm1, rdm2, float(e_val)
