"""Coupled-perturbed HF response + analytic BE Jacobian assembly.

JAX counterpart: ``quemb_tpu/matching/cphf.py`` (restricted part; its
unrestricted functions are ROADMAP A14).  Reimplements the reference's
``shared/external/cphf_utils.py`` (batched CPHF kernel) and
``shared/external/optqn.py:250-491`` (block Jacobian of the matching
conditions).

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
  potentials at a time.
"""

from __future__ import annotations

import numpy as np
import torch

from quemb_tpu_torch.embed.fragment import Fragment
from quemb_tpu_torch.solvers.dispatch import _batched_mo_eri, \
    run_fragment_scf

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


def get_be_error_jacobian(fragments: list[Fragment], jac_solver="HF"):
    """Analytic Jacobian of the BE matching conditions (optqn.py:250).

    Row/column layout matches the error vector of ``solve_error``: one
    row per edge-pair condition, fragment by fragment, then the
    chemical-potential row; columns are the matching potentials in the
    same order plus the chemical potential.  Each fragment contributes
    its diagonal ``edge`` block, and -- through every fragment whose
    edge points at it -- its ``center`` block on those rows.
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
