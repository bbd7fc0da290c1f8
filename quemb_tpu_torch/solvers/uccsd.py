"""UCCSD for embedded fragments (general spin-orbital CCSD).

JAX counterpart: ``quemb_tpu/solvers/uccsd.py``.  Reuses the generalized
spin-orbital CCSD update (non-diagonal Fock) of
:mod:`quemb_tpu_torch.solvers.ccsd_mat`; the three spin ERI blocks (aa,
bb, ab) assemble into one spin-blocked chemist tensor whose zero blocks
encode the spin selection rules.

Everything runs on the device of the fragment ERIs.  The amplitude loop
is a Python loop, as in the JAX function, with its DIIS history (the
last 8 concatenated amplitude steps) on the device; each iteration reads
the step norm and the small error Gram matrix back to the host, where the
bordered DIIS system is solved in numpy as there.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from quemb_tpu_torch.solvers.ccsd_mat import ccsd_update_mat, fused_blocks
from quemb_tpu_torch.solvers.mp2 import _occ_projector

#: length of the UCCSD DIIS history (the JAX function's)
DIIS_SPACE = 8


def _spin_blocked_chemist(Vaa, Vbb, Vab):
    """[na+nb]^4 chemist tensor with the aa, bb, ab and ba blocks of the
    spin ERIs and zeros where spin is not conserved."""
    na = Vaa.shape[0]
    nb = Vbb.shape[0]
    n = na + nb
    V = Vaa.new_zeros((n, n, n, n))
    V[:na, :na, :na, :na] = Vaa
    V[na:, na:, na:, na:] = Vbb
    V[:na, :na, na:, na:] = Vab
    V[na:, na:, :na, :na] = Vab.permute(2, 3, 0, 1)
    return V


def solve_uccsd_so(
    Vaa_mo, Vbb_mo, Vab_mo, f_a_mo, f_b_mo, nocc_a: int, nocc_b: int,
    conv_tol: float = 1e-8, max_cycle: int = 200,
):
    """General spin-orbital CCSD over two spin channels.

    All inputs are in the respective fragment-MO bases; the ERIs are
    tensors, on whose device the solve runs, the Fock blocks tensors or
    arrays.  Returns the spatial amplitude blocks ((t1a, t1b), (t2aa,
    t2ab, t2bb)) as tensors and the correlation energy as a float.
    """
    dev, dt = Vaa_mo.device, Vaa_mo.dtype
    f_a_mo, f_b_mo = (torch.as_tensor(f, dtype=dt, device=dev)
                      for f in (f_a_mo, f_b_mo))
    na = f_a_mo.shape[0]
    nb = f_b_mo.shape[0]
    n = na + nb
    nva, nvb = na - nocc_a, nb - nocc_b
    V = _spin_blocked_chemist(Vaa_mo, Vbb_mo, Vab_mo)
    phys = V.permute(0, 2, 1, 3)
    g = phys - phys.permute(0, 1, 3, 2)
    del V, phys

    f = torch.block_diag(f_a_mo, f_b_mo)
    occ = list(range(nocc_a)) + list(range(na, na + nocc_b))
    occ_set = set(occ)
    order = torch.tensor(occ + [p for p in range(n) if p not in occ_set],
                         device=dev)
    for axis in range(4):
        g = g.index_select(axis, order)
    f = f.index_select(0, order).index_select(1, order)
    no = nocc_a + nocc_b
    nv = n - no

    o, v = slice(0, no), slice(no, n)
    moe = torch.diagonal(f)
    moe_o, moe_v = moe[None, :no], moe[None, no:]
    f_oo_off = (f[o, o] - torch.diag(moe[:no]))[None]
    f_ov = f[o, v][None]
    f_vv_off = (f[v, v] - torch.diag(moe[no:]))[None]
    blocks4 = dict(
        oovv=g[o, o, v, v], ovvv=g[o, v, v, v], ooov=g[o, o, o, v],
        oooo=g[o, o, o, o], vvvv=g[v, v, v, v], ovov=g[o, v, o, v],
        ovvo=g[o, v, v, o], ovoo=g[o, v, o, o], vvvo=g[v, v, v, o],
    )
    fb = fused_blocks({k: b[None] for k, b in blocks4.items()}, no, nv)
    Dov = moe[:no, None] - moe[None, no:]
    Doovv = (
        (moe[:no, None] + moe[None, :no]).reshape(-1)[:, None]
        - (moe[no:, None] + moe[None, no:]).reshape(-1)[None, :]
    )
    t1 = f[o, v] / Dov
    T2p = g[o, o, v, v].reshape(no * no, nv * nv) / Doovv
    del g, blocks4

    n1 = no * nv
    errs: list = []
    amps: list = []
    e_corr = 0.0
    norm_dt = float("inf")
    for it in range(max_cycle):
        t1n, t2n, e = ccsd_update_mat(
            t1[None], T2p[None], moe_o, moe_v, fb, f_oo_off=f_oo_off,
            f_ov=f_ov, f_vv_off=f_vv_off,
        )
        t1n, t2n = t1n[0], t2n[0]
        e_corr = e[0]
        dt_vec = torch.cat([(t1n - t1).reshape(-1), (t2n - T2p).reshape(-1)])
        amp = torch.cat([t1n.reshape(-1), t2n.reshape(-1)])
        errs.append(dt_vec)
        amps.append(amp)
        if len(errs) > DIIS_SPACE:
            errs.pop(0)
            amps.pop(0)
        E = torch.stack(errs)
        gram = (E @ E.T).cpu().numpy()  # the one host read of the step
        norm_dt = float(np.sqrt(gram[-1, -1]))
        if len(errs) > 1:
            nb_ = len(errs)
            B = np.empty((nb_ + 1, nb_ + 1))
            B[-1, :] = -1.0
            B[:, -1] = -1.0
            B[-1, -1] = 0.0
            B[:nb_, :nb_] = gram
            rhs = np.zeros(nb_ + 1)
            rhs[-1] = -1.0
            try:
                c = np.linalg.solve(B, rhs)[:nb_]
                amp = torch.as_tensor(c, dtype=dt, device=dev) @ torch.stack(
                    amps)
            except np.linalg.LinAlgError:
                pass
        t1 = amp[:n1].reshape(no, nv)
        T2p = amp[n1:].reshape(no * no, nv * nv)
        if norm_dt < conv_tol and it > 0:
            break
    else:
        warnings.warn(f"UCCSD did not converge: |dt| = {norm_dt:.2e}")

    t2f = T2p.reshape(no, no, nv, nv)
    t1a = t1[:nocc_a, :nva]
    t1b = t1[nocc_a:, nva:]
    t2aa = t2f[:nocc_a, :nocc_a, :nva, :nva]
    t2ab = t2f[:nocc_a, nocc_a:, :nva, nva:]
    t2bb = t2f[nocc_a:, nocc_a:, nva:, nva:]
    return (t1a, t1b), (t2aa, t2ab, t2bb), float(e_corr)


def make_rdm1_uccsd(t1s, noccs):
    """lambda=0 UCCSD 1-RDMs per spin (occupancy 1)."""
    out = []
    for t1, no in zip(t1s, noccs):
        nmo = no + t1.shape[1]
        dm = _occ_projector(no, nmo, t1)
        dm[:no, no:] = t1
        dm[no:, :no] = t1.T
        out.append(dm)
    return tuple(out)


def make_rdm2_uccsd(t1s, t2s, noccs, with_dm1=False):
    """lambda=0 UCCSD 2-RDM spin blocks (aa, ab, bb) in chemist notation.

    Cumulant-only when with_dm1=False (matching use_cumulant=True).
    """
    t1a, t1b = t1s
    t2aa, t2ab, t2bb = t2s
    na_o, nb_o = noccs
    na = na_o + t1a.shape[1]
    nb = nb_o + t1b.shape[1]
    es = torch.einsum

    def _ss(t1, t2, no, nmo):
        tau = t2 + es("ia,jb->ijab", t1, t1) - es("ib,ja->ijab", t1, t1)
        dm2 = t1.new_zeros((nmo, nmo, nmo, nmo))
        g = 0.5 * tau
        dm2[:no, no:, :no, no:] = g.permute(0, 2, 1, 3)
        dm2[no:, :no, no:, :no] = g.permute(2, 0, 3, 1)
        return dm2

    dm2aa = _ss(t1a, t2aa, na_o, na)
    dm2bb = _ss(t1b, t2bb, nb_o, nb)

    g_ab = 0.5 * (t2ab + es("ia,jb->ijab", t1a, t1b))
    dm2ab = t1a.new_zeros((na, na, nb, nb))
    dm2ab[:na_o, na_o:, :nb_o, nb_o:] = g_ab.permute(0, 2, 1, 3)
    dm2ab[na_o:, :na_o, nb_o:, :nb_o] = g_ab.permute(2, 0, 3, 1)

    if with_dm1:
        # the loops over occupied i (and j) of the JAX function, each a
        # product with the occupied projector P
        dm1a, dm1b = make_rdm1_uccsd((t1a, t1b), noccs)
        Pa, Pb = _occ_projector(na_o, na, t1a), _occ_projector(nb_o, nb, t1b)
        d1a, d1b = dm1a - Pa, dm1b - Pb

        def same_spin(P, d1):
            return (es("pq,rs->pqrs", P, d1) + es("pq,rs->pqrs", d1, P)
                    - es("qr,ps->pqrs", P, d1) - es("ps,rq->pqrs", P, d1)
                    + es("pq,rs->pqrs", P, P) - es("ps,qr->pqrs", P, P))

        dm2aa = dm2aa + same_spin(Pa, d1a)
        dm2bb = dm2bb + same_spin(Pb, d1b)
        dm2ab = dm2ab + (es("pq,rs->pqrs", Pa, d1b)
                         + es("pq,rs->pqrs", d1a, Pb)
                         + es("pq,rs->pqrs", Pa, Pb))
    return dm2aa, dm2ab, dm2bb


def _mo4(V, C1, C2, C3, C4):
    """(pq|rs) C1[p,i] C2[q,j] C3[r,k] C4[s,l] as four single-index
    transforms."""
    out = torch.tensordot(V, C1, dims=([0], [0]))      # q r s i
    out = torch.tensordot(out, C2, dims=([0], [0]))    # r s i j
    out = torch.tensordot(out, C3, dims=([0], [0]))    # s i j k
    out = torch.tensordot(out, C4, dims=([0], [0]))    # i j k l
    return out


def solve_uccsd(fr_a, fr_b, Vab, use_cumulant=True):
    """Fragment-pair UCCSD entry, on the device of the fragment ERIs.

    fr_a/fr_b: alpha/beta fragments after their spin-channel SCFs
    (``mo_coeffs`` set, host arrays).  Vab: the cross-spin ERI block in the
    embedding bases [na, na, nb, nb], a tensor.  Returns (rdm1s, rdm2s,
    e_corr) with tensor RDMs in the fragment-MO bases.
    """
    eri_a = fr_a.eri
    dev, dt = eri_a.device, eri_a.dtype
    Ca, Cb = (torch.as_tensor(fr.mo_coeffs, dtype=dt, device=dev)
              for fr in (fr_a, fr_b))
    Vaa_mo = _mo4(eri_a, Ca, Ca, Ca, Ca)
    Vbb_mo = _mo4(fr_b.eri, Cb, Cb, Cb, Cb)
    Vab_mo = _mo4(Vab, Ca, Ca, Cb, Cb)
    # UCC Fock: h1 + veff0 (reference uccsd_eri.frank_get_fock reduces to
    # this for both frozen and unfrozen cases)
    f_a = fr_a.mo_coeffs.T @ (fr_a.h1 + fr_a.veff0) @ fr_a.mo_coeffs
    f_b = fr_b.mo_coeffs.T @ (fr_b.h1 + fr_b.veff0) @ fr_b.mo_coeffs
    t1s, t2s, e_corr = solve_uccsd_so(
        Vaa_mo, Vbb_mo, Vab_mo, f_a, f_b, fr_a.nsocc, fr_b.nsocc
    )
    rdm1s = make_rdm1_uccsd(t1s, (fr_a.nsocc, fr_b.nsocc))
    rdm2s = make_rdm2_uccsd(
        t1s, t2s, (fr_a.nsocc, fr_b.nsocc), with_dm1=not use_cumulant
    )
    return rdm1s, rdm2s, e_corr
