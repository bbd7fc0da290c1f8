"""Coupled-perturbed HF response + analytic BE Jacobian assembly.

JAX counterpart: ``quemb_tpu/matching/cphf.py``.  Reimplements the
reference's ``shared/external/cphf_utils.py`` (batched CPHF kernel) and
``shared/external/optqn.py:250-491`` (block Jacobian of the matching
conditions), and the unrestricted CP-UHF and UMP2 responses
(:func:`cphf_kernel_batch_u`, :func:`_dPmp2_batch_u`), which no driver
calls, in either package.

All responses of one fragment are computed on the device of ``fr.eri``
with the matching potentials as a leading batch axis, and come back as host
float64 arrays; the index gathers and the assembly of J are host numpy.
Differences from the JAX module, none of them in what is computed:

- the CPHF system A u = b is solved where it is built, by
  ``torch.linalg.solve`` in float64 (LU; A is not symmetric).  The JAX
  module pulls A to the host for this because its backend has no f64 LU.
- the MO integral blocks are slices of ONE full transform of the fragment
  ERI, not a five-operand einsum per block, and the integrals
  differentiated along an orbital rotation dC = C U are four single-index
  contractions of that MO tensor with U (:func:`_rotated_eri_mo`), where
  the JAX module transforms the AO tensor again for every differentiated
  slot.
- ``jax.vmap`` over potentials is a leading axis, processed ``_POT_CHUNK``
  potentials at a time; the unrestricted MP2 response loops over them.
"""

from __future__ import annotations

import numpy as np
import torch

from quemb_tpu_torch.embed.fragment import Fragment
from quemb_tpu_torch.solvers.dispatch import _batched_mo_eri, \
    run_fragment_scf
from quemb_tpu_torch.solvers.uccsd import _mo4
from quemb_tpu_torch.utils.profiling import span

#: potentials per batch of the MP2 and CCSD responses.  The largest
#: per-potential tensors are the rotated MO integrals, nemb^4 doubles each
#: (25 MB at octane's nemb 42), of which about six are alive at once: 16
#: potentials take about 2.4 GB of an H100's 80 GB.
_POT_CHUNK = 16


def _on_device_of(eri: torch.Tensor, *arrays):
    return tuple(
        torch.as_tensor(np.asarray(a) if isinstance(a, (list, tuple)) else a,
                        dtype=eri.dtype, device=eri.device)
        for a in arrays
    )


def _mo_eri(eri, C):
    """(pq|rs) of one fragment in its MOs: one full transform, of which
    the callers slice the ov/oo/vv blocks."""
    return _batched_mo_eri(eri[None], C[None])[0]


def _cphf_solve(eri_mo, moe, C, no: int, vs):
    """us [npot, no*nv] from the MO integrals (tensors on one device)."""
    nv = C.shape[0] - no
    o, v = slice(0, no), slice(no, None)
    Vovov = eri_mo[o, v, o, v]
    Voovv = eri_mo[o, o, v, v]
    A = (
        4.0 * Vovov
        - Vovov.permute(0, 3, 2, 1)
        - Voovv.permute(0, 2, 1, 3)
    ).reshape(no * nv, no * nv)
    denom = (moe[:no, None] - moe[None, no:]).reshape(-1)
    A = A - torch.diag(denom)
    B0s = (C[:, o].T @ vs @ C[:, v]).reshape(len(vs), no * nv)
    # A is non-symmetric: LU, on the device, in float64
    return torch.linalg.solve(A, B0s.T).T


def cphf_kernel_batch(C, moe, eri, no, vs):
    """Solve the CPHF equations A u = b for many perturbations v at once.

    C: [n, n] MOs; moe: orbital energies; eri: dense [n]*4 chemist ERIs in
    the same basis as C, a tensor whose device does the work; no: number
    of occupied; vs: [npot, n, n].  Returns us: [npot, no*nv], a tensor on
    that device.
    """
    C, moe, vs = _on_device_of(eri, C, moe, vs)
    return _cphf_solve(_mo_eri(eri, C), moe, C, no, vs)


def get_rhf_dP_from_u(C, no, u):
    """dP [..., n, n] from u [..., no*nv] (tensors)."""
    nv = C.shape[0] - no
    uov = u.reshape(u.shape[:-1] + (no, nv))
    dP = -C[:, :no] @ uov @ C[:, no:].T
    return dP + dP.transpose(-1, -2)


def _spin_pair(eri: torch.Tensor, X):
    """(X[alpha], X[beta]) as tensors on the device of ``eri``, from a
    stacked array or a pair."""
    return tuple(_on_device_of(eri, X[s])[0] for s in (0, 1))


def cphf_kernel_batch_u(C, moe, eri, no, vs):
    """Coupled-perturbed UHF: alpha/beta responses for many perturbations.

    Own formulation of the reference's CP-UHF surface
    (``shared/external/cphf_utils.py:272-433``), as in the JAX function:
    the two spin channels' occupied-virtual rotations couple through the
    total-density Coulomb response (factor 2, both spins) while exchange
    stays same-spin, so the linear system is one 2x2 spin-blocked matrix,
    solved for all perturbations at once (LU, on the device).

    C = (Ca, Cb), moe = (ea, eb), no = (no_a, no_b); ``eri`` is one
    spinless AO ERI or the (aa, bb, ab) spin triplet, tensors whose device
    does the work; ``vs`` is [npot, n, n] (spinless) or [npot, 2, n, n].
    Returns us [npot, no_a*nv_a + no_b*nv_b], a tensor on that device.
    """
    Vs = tuple(eri) if isinstance(eri, (list, tuple)) else (eri,) * 3
    C, moe = _spin_pair(Vs[0], C), _spin_pair(Vs[0], moe)
    Co = [C[s][:, : no[s]] for s in (0, 1)]
    Cv = [C[s][:, no[s] :] for s in (0, 1)]
    nov = [Co[s].shape[1] * Cv[s].shape[1] for s in (0, 1)]

    blocks = []
    for s in (0, 1):
        Voo = _mo4(Vs[s], Co[s], Cv[s], Co[s], Cv[s])
        Vexch = _mo4(Vs[s], Co[s], Co[s], Cv[s], Cv[s])
        Ass = (
            2.0 * Voo
            - Voo.permute(0, 3, 2, 1)
            - Vexch.permute(0, 2, 1, 3)
        ).reshape(nov[s], nov[s])
        D = (moe[s][: no[s], None] - moe[s][None, no[s] :]).reshape(-1)
        blocks.append(Ass - torch.diag(D))
    Vab = 2.0 * _mo4(Vs[2], Co[0], Cv[0], Co[1], Cv[1]).reshape(nov[0],
                                                                nov[1])
    A = torch.cat([torch.cat([blocks[0], Vab], 1),
                   torch.cat([Vab.T, blocks[1]], 1)])

    vs, = _on_device_of(Vs[0], vs)
    if vs.ndim == 3:  # spinless potentials act on both spins
        vs = torch.stack([vs, vs], 1)
    b = torch.cat([
        (Co[s].T @ vs[:, s] @ Cv[s]).reshape(len(vs), nov[s])
        for s in (0, 1)
    ], 1)
    return torch.linalg.solve(A, b.T).T


def get_uhf_dP_from_u(C, no, u):
    """Per-spin AO density responses [dPa, dPb] from a stacked CP-UHF
    solution u [no_a*nv_a + no_b*nv_b] (a tensor)."""
    C = _spin_pair(u, C)
    nov0 = no[0] * (C[0].shape[1] - no[0])
    out = []
    for s, u_s in ((0, u[:nov0]), (1, u[nov0:])):
        Co, Cv = C[s][:, : no[s]], C[s][:, no[s] :]
        dP = -Co @ u_s.reshape(no[s], -1) @ Cv.T
        out.append(dP + dP.T)
    return out


def _dPmp2_batch_u(C, moe, eri, no, vs):
    """Analytic UMP2 density response per spin for many perturbations.

    Unrestricted analog of :func:`_dPmp2_batch` (the reference surface
    ``shared/external/cpmp2_utils.py:278 get_dPmp2_batch_u``), as in the
    JAX function: CP-UHF orbital response + per-spin Fock derivatives +
    same-/opposite-spin amplitude derivatives, assembled one perturbation
    at a time.  ``eri`` is one spinless AO ERI, a tensor whose device does
    the work; occupations are 1, so there is no restricted x2.  Returns a
    tensor [npot, 2, n, n] of AO-basis densities dP^sigma/dlambda of
    P^sigma = C^sigma (P_HF + P_MP2)^sigma C^sigma^T.
    """
    Cs, moes = _spin_pair(eri, C), _spin_pair(eri, moe)
    n = Cs[0].shape[0]
    nv = [n - no[s] for s in (0, 1)]
    Co = [Cs[s][:, : no[s]] for s in (0, 1)]
    Cv = [Cs[s][:, no[s] :] for s in (0, 1)]
    es = torch.einsum

    def ovov(s, t, c1=None, c2=None, c3=None, c4=None):
        return _mo4(eri, Co[s] if c1 is None else c1,
                    Cv[s] if c2 is None else c2,
                    Co[t] if c3 is None else c3,
                    Cv[t] if c4 is None else c4)

    eia = [moes[s][: no[s], None] - moes[s][None, no[s] :] for s in (0, 1)]

    def Dpair(s, t):
        return eia[s][:, :, None, None] + eia[t][None, None, :, :]

    V = {(s, t): ovov(s, t) for s in (0, 1) for t in (0, 1) if s <= t}
    # amplitudes: same-spin antisymmetrized, opposite-spin plain
    T = {(s, s): (V[(s, s)] - V[(s, s)].permute(0, 3, 2, 1)) / Dpair(s, s)
         for s in (0, 1)}
    T[(0, 1)] = V[(0, 1)] / Dpair(0, 1)

    def pcorr_blocks(s, Tss_l, Tss_r, Tos_l, Tos_r):
        """A[i,m]/A[a,c] halves of the MP2 density quadratics for spin s
        (the caller adds the transpose to complete the product rule)."""
        if s == 0:
            oo = es("iajb,majb->im", Tos_l, Tos_r)
            vv = es("iajb,icjb->ac", Tos_l, Tos_r)
        else:
            oo = es("jbia,jbma->im", Tos_l, Tos_r)
            vv = es("jbia,jbic->ac", Tos_l, Tos_r)
        Poo = -(0.5 * es("iajb,majb->im", Tss_l, Tss_r) + oo)
        Pvv = 0.5 * es("iajb,icjb->ac", Tss_l, Tss_r) + vv
        return torch.block_diag(Poo, Pvv)

    P = []
    for s in (0, 1):
        # for l == r the quadratic is already the full (symmetric) value
        full = pcorr_blocks(s, T[(s, s)], T[(s, s)], T[(0, 1)], T[(0, 1)])
        occ = torch.cat([full.new_ones(no[s]), full.new_zeros(nv[s])])
        P.append(full + torch.diag(occ))

    us = cphf_kernel_batch_u(Cs, moes, eri, no, vs)
    vs, = _on_device_of(eri, vs)
    nov0 = no[0] * nv[0]

    def one(u, Q):
        uov = [u[:nov0].reshape(no[0], nv[0]),
               u[nov0:].reshape(no[1], nv[1])]
        dP_hf = get_uhf_dP_from_u(Cs, no, u)
        vj = torch.tensordot(eri, dP_hf[0] + dP_hf[1], dims=([2, 3], [0, 1]))
        dF, U, dC = [], [], []
        for s in (0, 1):
            vk = torch.tensordot(eri, dP_hf[s], dims=([1, 3], [0, 1]))
            dFs = Q + vj - vk
            dF.append(dFs)
            eo, ev = moes[s][: no[s]], moes[s][no[s] :]
            eye_o = torch.eye(no[s], dtype=eo.dtype, device=eo.device)
            eye_v = torch.eye(nv[s], dtype=eo.dtype, device=eo.device)
            Dij = -eo[:, None] + eo[None, :] + eye_o
            dUoo = (Co[s].T @ dFs @ Co[s]) / Dij * (1.0 - eye_o)
            Dab = -ev[:, None] + ev[None, :] + eye_v
            dUvv = (Cv[s].T @ dFs @ Cv[s]) / Dab * (1.0 - eye_v)
            U.append(torch.cat([torch.cat([dUoo, uov[s]], 1),
                                torch.cat([-uov[s].T, dUvv], 1)]))
            dC.append(Cs[s] @ U[s])
        dmoe = [es("pi,qi,pq->i", Cs[s], Cs[s], dF[s]) for s in (0, 1)]
        deia = [dmoe[s][: no[s], None] - dmoe[s][None, no[s] :]
                for s in (0, 1)]
        dCo = [dC[x][:, : no[x]] for x in (0, 1)]
        dCv = [dC[x][:, no[x] :] for x in (0, 1)]

        def dV(s, t):
            return (ovov(s, t, c1=dCo[s]) + ovov(s, t, c2=dCv[s])
                    + ovov(s, t, c3=dCo[t]) + ovov(s, t, c4=dCv[t]))

        dT = {}
        for s in (0, 1):
            dVss = dV(s, s)
            dD = deia[s][:, :, None, None] + deia[s][None, None, :, :]
            dT[(s, s)] = ((dVss - dVss.permute(0, 3, 2, 1))
                          - T[(s, s)] * dD) / Dpair(s, s)
        dDos = deia[0][:, :, None, None] + deia[1][None, None, :, :]
        dT[(0, 1)] = (dV(0, 1) - T[(0, 1)] * dDos) / Dpair(0, 1)

        out = []
        for s in (0, 1):
            half = pcorr_blocks(s, dT[(s, s)], T[(s, s)], dT[(0, 1)],
                                T[(0, 1)])
            dP_rot = U[s] @ P[s] - P[s] @ U[s]
            out.append(Cs[s] @ (dP_rot + half + half.T) @ Cs[s].T)
        return torch.stack(out)

    return torch.stack([one(u, Q) for u, Q in zip(us, vs)])


def get_vpots_frag(nao, relAO_per_edge, AO_in_frag):
    """Unit perturbation per matching condition + chem-pot (optqn.py:464)."""
    vpots = []
    for edge in relAO_per_edge:
        for j in range(len(edge)):
            for k in range(j, len(edge)):
                v = np.zeros((nao, nao))
                v[edge[j], edge[k]] = v[edge[k], edge[j]] = 1.0
                vpots.append(v)
    v = np.zeros((nao, nao))
    edge_set = {i for sub in relAO_per_edge for i in sub}
    for i in range(len(AO_in_frag)):
        if i not in edge_set:
            v[i, i] = -1.0
    vpots.append(v)
    return vpots


def _fragment_response(fr: Fragment, batch_fn, scale: float):
    """(dPs, dP_mu) as host arrays from a batched response function run at
    the fragment's SCF solution under its current ``heff``."""
    vpots = get_vpots_frag(fr.nao, fr.relAO_per_edge, fr.AO_in_frag)
    moe, C = run_fragment_scf(fr)
    dPs_all = scale * batch_fn(C, moe, fr.eri, fr.nsocc, vpots).cpu().numpy()
    return list(dPs_all[:-1]), dPs_all[-1]


def _dPhf_batch(C, moe, eri, no, vs):
    return get_rhf_dP_from_u(C, no, cphf_kernel_batch(C, moe, eri, no, vs))


def hf_response(fr: Fragment):
    """HF CPHF responses dP per matching condition (optqn.py hfres_func)."""
    return _fragment_response(fr, _dPhf_batch, 1.0)


def _rotated_eri_mo(eri_mo, U):
    """d(pq|rs) of the MO integrals along the orbital rotations dC = C U.

    eri_mo [n]*4 with the 8-fold symmetry of real integrals; U [x, n, n].
    The four differentiated slots are one contraction
    T[x,i,j,k,l] = sum_m U[x,m,i] (mj|kl) and its three index permutations.
    Returns [x, n, n, n, n].
    """
    n = eri_mo.shape[0]
    T = (U.transpose(1, 2) @ eri_mo.reshape(n, -1)).reshape(-1, n, n, n, n)
    T = T + T.transpose(1, 2)
    return T + T.permute(0, 3, 4, 1, 2)


def _fock_response(eri, dP_hf, Q):
    """dF [x, n, n] = Q + J[2 dP] - K[2 dP] / 2 for each potential."""
    vj = torch.einsum("pqrs,xrs->xpq", eri, 2.0 * dP_hf)
    vk = torch.einsum("prqs,xrs->xpq", eri, 2.0 * dP_hf)
    return Q + vj - 0.5 * vk


def _in_chunks(one_chunk, us, vs):
    return torch.cat([
        one_chunk(us[s:s + _POT_CHUNK], vs[s:s + _POT_CHUNK])
        for s in range(0, len(vs), _POT_CHUNK)
    ])


def _dPmp2_batch(C, moe, eri, no, vs):
    """Analytic MP2 density response dP/dlambda for many perturbations.

    Own formulation of the reference's ``get_dPmp2_batch_r``
    (shared/external/cpmp2_utils.py:94): CPHF orbital response + Fock
    derivative + amplitude derivative, with the perturbations as a leading
    axis.  Returns dPs in the AO(embedding) basis, a tensor [npot, n, n],
    with the reference's normalization (x2, before the 0.5 of
    optqn.py:446 mp2res_func).
    """
    C, moe, vs = _on_device_of(eri, C, moe, vs)
    n = C.shape[0]
    nv = n - no
    o, v = slice(0, no), slice(no, None)
    eri_mo = _mo_eri(eri, C)
    Vovov = eri_mo[o, v, o, v]
    Dia = moe[:no, None] - moe[None, no:]
    Diajb = Dia[:, :, None, None] + Dia[None, None, :, :]
    t2 = Vovov / Diajb

    def pmp2(t2l, t2r):
        k = 2.0 * t2r - t2r.permute(0, 3, 2, 1)
        P = t2l.new_zeros(t2l.shape[:-4] + (n, n))
        P[..., o, o] = -torch.einsum("...iajb,majb->...im", t2l, k)
        P[..., v, v] = torch.einsum("...iajb,icjb->...ac", t2l, k)
        return P

    occ = torch.cat([moe.new_ones(no), moe.new_zeros(nv)])
    P = pmp2(t2, t2) + torch.diag(occ)
    eo, ev = moe[:no], moe[no:]
    eye_o = torch.eye(no, dtype=moe.dtype, device=moe.device)
    eye_v = torch.eye(nv, dtype=moe.dtype, device=moe.device)
    Dij = -eo[:, None] + eo[None, :] + eye_o
    Dab = -ev[:, None] + ev[None, :] + eye_v
    us = _cphf_solve(eri_mo, moe, C, no, vs)

    def chunk(u, Q):
        uov = u.reshape(-1, no, nv)
        dF = C.T @ _fock_response(eri, get_rhf_dP_from_u(C, no, u), Q) @ C
        dmoe = torch.diagonal(dF, dim1=-2, dim2=-1)
        dDia = dmoe[:, :no, None] - dmoe[:, None, no:]
        dDiajb = dDia[:, :, :, None, None] + dDia[:, None, None, :, :]
        # full orbital-rotation matrix (oo/vv from dF, ov from CPHF u)
        U = dF.new_zeros(dF.shape)
        U[:, o, o] = dF[:, o, o] / Dij * (1.0 - eye_o)
        U[:, v, v] = dF[:, v, v] / Dab * (1.0 - eye_v)
        U[:, o, v] = uov
        U[:, v, o] = -uov.transpose(1, 2)
        dVovov = _rotated_eri_mo(eri_mo, U)[:, o, v, o, v]
        dt2 = (dVovov - t2 * dDiajb) / Diajb
        dP2 = pmp2(dt2, t2)
        dP_mo = (U @ P - P @ U + dP2 + dP2.transpose(1, 2)) * 2.0
        return C @ dP_mo @ C.T

    return _in_chunks(chunk, us, vs)


def mp2_response(fr: Fragment):
    """CP-MP2 responses per matching condition (ref optqn.py:441)."""
    return _fragment_response(fr, _dPmp2_batch, 0.5)


def _dPccsd_urlx_batch(C, moe, eri, no, vs):
    """Approximate CCSD (t1-urlx) density response per perturbation.

    Own formulation of the reference's ``get_dPccsdurlx_batch_u``
    (shared/external/jac_utils.py:162): the matched density is
    P = P_HF + [Co t1 Cv^T + h.c.] with the one-cycle t1 from MP2 t2;
    its derivative combines CPHF orbital response, the Fock derivative
    through the t2 denominators, and differentiated integrals.  The
    perturbations are a leading axis; returns a tensor [npot, n, n].
    """
    C, moe, vs = _on_device_of(eri, C, moe, vs)
    n = C.shape[0]
    nv = n - no
    o, v = slice(0, no), slice(no, None)
    Co, Cv = C[:, o], C[:, v]
    eia = moe[:no, None] - moe[None, no:]
    eovov = eia[:, :, None, None] + eia[None, None, :, :]
    eri_mo = _mo_eri(eri, C)
    Vovov = eri_mo[o, v, o, v]
    Vvovv = eri_mo[v, o, v, v]
    Voovo = eri_mo[o, o, v, o]
    t2 = Vovov / eovov

    def t1_of(Vov_ov, Voovo_, Vvovv_):
        tt = Vov_ov / eovov
        return (
            2.0 * torch.einsum("...ibjc,...cjba->...ia", tt, Vvovv_)
            - torch.einsum("...jbic,...cjba->...ia", tt, Vvovv_)
            - 2.0 * torch.einsum("...ikbj,...jbka->...ia", Voovo_, tt)
            + torch.einsum("...ikbj,...kbja->...ia", Voovo_, tt)
        ) / eia

    t1 = t1_of(Vovov, Voovo, Vvovv)
    us = _cphf_solve(eri_mo, moe, C, no, vs)

    def chunk(u, Q):
        uov = u.reshape(-1, no, nv)
        A = -_fock_response(eri, get_rhf_dP_from_u(C, no, u), Q)  # -dF
        Aoo = Co.T @ A @ Co
        Avv = Cv.T @ A @ Cv
        tA = torch.einsum("lajb,xli->xiajb", t2, Aoo) - \
            torch.einsum("idjb,xda->xiajb", t2, Avv)
        tA = tA + tA.permute(0, 3, 4, 1, 2)

        # dCo = -Cv uov^T and dCv = Co uov: the rotation dC = C U
        U = A.new_zeros(A.shape)
        U[:, o, v] = uov
        U[:, v, o] = -uov.transpose(1, 2)
        dV = _rotated_eri_mo(eri_mo, U)
        dCo = -Cv @ uov.transpose(1, 2)
        dCv = Co @ uov

        # t1_of is linear in its first argument and jointly linear in the
        # (Voovo, Vvovv) pair, so the derivative splits into three calls
        dt1_mo = (
            t1_of(tA, Voovo, Vvovv)
            + t1_of(dV[:, o, v, o, v], Voovo, Vvovv)
            + t1_of(Vovov, dV[:, o, o, v, o], dV[:, v, o, v, v])
            + (Aoo @ t1 - t1 @ Avv) / eia
        )
        dt1 = Co @ dt1_mo @ Cv.T
        dt1 = dt1 + dCo @ t1 @ Cv.T + Co @ t1 @ dCv.transpose(1, 2)
        dPhf = 2.0 * dCo @ Co.T
        out = dt1 + dPhf
        return out + out.transpose(1, 2)

    return _in_chunks(chunk, us, vs)


def ccsd_response(fr: Fragment):
    """CP-CCSD(urlx) responses per matching condition (ref optqn.py:452)."""
    return _fragment_response(fr, _dPccsd_urlx_batch, 0.5)


def _pair_indices(groups) -> tuple[np.ndarray, np.ndarray]:
    """Upper-triangular (row, col) AO pairs for a list of AO-index groups.

    One pair per matching condition, in condition order: groups in the
    given order, and within a group all pairs (a, b) with a appearing at
    or before b.  Matches the ordering of :func:`get_vpots_frag` (and of
    ``solve_error``'s error vector).
    """
    rows: list[int] = []
    cols: list[int] = []
    for g in groups:
        for j, a in enumerate(g):
            rows.extend([a] * (len(g) - j))
            cols.extend(g[j:])
    return np.asarray(rows, dtype=np.intp), np.asarray(cols, dtype=np.intp)


def frag_jacobian_blocks(fr: Fragment, res_func=hf_response):
    """All Jacobian data of one fragment, read off the stacked responses.

    Computes the fragment's density responses dP for every one of its
    matching potentials (plus the chemical potential) and gathers each
    kind of Jacobian entry with one vectorized index map (the quantities
    the reference assembles entry-by-entry, optqn.py:314):

    - ``edge``  [n_pairs, n_cond]: response of the fragment's own edge
      RDM entries to its own potentials (the diagonal block),
    - ``center`` [n_center_pairs, n_cond]: MINUS the response of the
      origin/center RDM entries -- added to the rows of every fragment
      whose edge refers here,
    - ``trace`` [n_cond]: response of the center-site electron count
      (the chemical-potential row),
    - ``*_mu``: the same three gathers off the chem-pot response.
    """
    dPs, dP_mu = res_func(fr)
    D = np.stack([np.asarray(p) for p in dPs] + [np.asarray(dP_mu)])
    er, ec = _pair_indices(fr.relAO_per_edge)
    n_cond = er.size
    assert n_cond + 1 == D.shape[0]
    origin = sorted(fr.relAO_per_origin)
    cr, cc = _pair_indices([origin])
    edge_aos = {a for e in fr.relAO_per_edge for a in e}
    sites = np.asarray(
        [i for i in range(fr.n_frag) if i not in edge_aos], dtype=np.intp
    )
    E = D[:, er, ec]  # [n_cond + 1, n_pairs]
    Cm = -D[:, cr, cc]  # [n_cond + 1, n_center_pairs]
    tr = (
        D[:, sites, sites].sum(axis=1)
        if sites.size
        else np.zeros(n_cond + 1)
    )
    return {
        "edge": E[:-1].T,
        "edge_mu": E[-1],
        "center": Cm[:-1].T,
        "center_mu": Cm[-1],
        "trace": tr[:-1],
        "trace_mu": tr[-1],
        "n_cond": n_cond,
    }


@span("jacobian")
def get_be_error_jacobian(fragments: list[Fragment], jac_solver="HF"):
    """Analytic Jacobian of the BE matching conditions (optqn.py:250).

    Row/column layout matches the error vector of ``solve_error``: one
    row per edge-pair condition, fragment by fragment, then the
    chemical-potential row; columns are the matching potentials in the
    same order plus the chemical potential.  Each fragment contributes
    its diagonal ``edge`` block, and -- through every fragment whose
    edge points at it -- its ``center`` block on those rows.  One call is
    the tracer's ``jacobian`` span.
    """
    res_funcs = {"HF": hf_response, "MP2": mp2_response,
                 "CCSD": ccsd_response}
    if jac_solver.upper() not in res_funcs:
        raise NotImplementedError(
            f"jac_solver={jac_solver}; available: {sorted(res_funcs)}"
        )
    res_func = res_funcs[jac_solver.upper()]
    blocks = [frag_jacobian_blocks(fr, res_func) for fr in fragments]

    off = np.concatenate(
        [[0], np.cumsum([b["n_cond"] for b in blocks])]
    ).astype(int)
    n = int(off[-1])
    J = np.zeros((n + 1, n + 1))
    for f, (fr, b) in enumerate(zip(fragments, blocks)):
        rows = slice(off[f], off[f + 1])
        J[rows, rows] = b["edge"]
        J[rows, n] = b["edge_mu"]
        J[n, rows] = b["trace"]
        # each edge of this fragment is matched against the center block
        # of the fragment it references; the edge's rows are a contiguous
        # run whose length is that center block's pair count
        r0 = off[f]
        for ref in fr.ref_frag_idx_per_edge:
            rb = blocks[ref]
            m = rb["center"].shape[0]
            J[r0 : r0 + m, off[ref] : off[ref + 1]] += rb["center"]
            J[r0 : r0 + m, n] += rb["center_mu"]
            r0 += m
    J[n, n] = sum(b["trace_mu"] for b in blocks)
    return J
