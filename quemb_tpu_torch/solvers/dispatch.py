"""Per-objective-evaluation fragment solve pass + error vector.

JAX counterpart: ``quemb_tpu/solvers/dispatch.py``.  Fragments are grouped
into merged, zero-padded buckets (:func:`form_merge_classes`) and each
bucket runs the fused CCSD objective (:func:`_fused_objective_bucket`):
batched fragment SCF -> MO-ERI transform -> closed-shell CCSD -> unrelaxed
RDMs -> embedding-basis 1-RDM -> cumulant energy rows, with the fragment
axis as a leading batch dimension.  The JAX module's other solvers, its
staged path and its large-fragment path (``_solve_bucket_large``) are
ROADMAP A9 and raise.  The fragment axis is not sharded over devices.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from quemb_tpu_torch.embed.fragment import Fragment
from quemb_tpu_torch.embed.fragment_scf import rhf_orthonormal
from quemb_tpu_torch.solvers.ccsd import _default_conv_tol, _f32_only
from quemb_tpu_torch.solvers.rccsd import _rccsd_from_mo_batched

#: largest padded embedding dimension of the batched bucket path; larger
#: buckets belong to the fragment-at-a-time path of ROADMAP A9
_NEMB_BATCHED_MAX = 48


def _batched_mo_eri(eri_b, C_b):
    """Four sequential single-index transforms of [nf, n]^4 tensors by
    C_b [nf, n, k] (each step contracts the last axis and rolls it to the
    front, behind the batch axis)."""
    out = eri_b
    nf = eri_b.shape[0]
    for _ in range(4):
        shp = out.shape[:-1]
        out = (out.reshape(nf, -1, out.shape[-1]) @ C_b).reshape(
            shp + (C_b.shape[-1],)
        )
        out = out.movedim(-1, 1)
    return out


def _batched_energy_rows(mo_b, h1_b, veff0_b, eri_b, rdm1_b, rdm2_b,
                         occ_mask_b, center_w_b):
    """Cumulant fragment energies for a bucket.

    center_w_b: [nf, nemb] weight per embedding row (w on center rows,
    0 elsewhere).  Returns (e1, e2, ec) per fragment.
    """
    moT = mo_b.transpose(1, 2)
    rdm1_emb = mo_b @ (0.5 * rdm1_b) @ moT
    hf_1rdm = (mo_b * occ_mask_b[:, None, :]) @ moT
    delta = 2.0 * (rdm1_emb - hf_1rdm)
    e1 = (h1_b * delta).sum(-1)
    ec = (veff0_b * delta).sum(-1)
    rdm2_emb = _batched_mo_eri(0.5 * rdm2_b, moT)
    e2 = (rdm2_emb * eri_b).sum((-3, -2, -1))
    return (
        (center_w_b * e1).sum(-1),
        (center_w_b * e2).sum(-1),
        (center_w_b * ec).sum(-1),
    )


def _batched_rdm1_emb(C_b, rdm1_b):
    return (C_b @ rdm1_b @ C_b.transpose(1, 2)) * 0.5


def _rdm12_urlx_batched(t1_b, t2_b):
    """Batched unrelaxed CCSD 1- and 2-RDMs in the cumulant form (broadcast
    form of the reference's ccsd_rdm.py:make_rdm2_urlx, without the
    mean-field 2-RDM part)."""
    nf, nocc, nvir = t1_b.shape
    nmo = nocc + nvir
    o, v = slice(0, nocc), slice(nocc, nmo)
    goovv = (torch.einsum("fia,fjb->fijab", t1_b, t1_b) + t2_b) * 0.5
    dovov = (
        goovv.permute(0, 1, 3, 2, 4) * 2 - goovv.permute(0, 2, 3, 1, 4)
    )
    blk = dovov + dovov.permute(0, 3, 4, 1, 2)
    dm2 = t1_b.new_zeros((nf, nmo, nmo, nmo, nmo))
    dm2[:, o, v, o, v] = blk
    dm2[:, v, o, v, o] = blk.permute(0, 2, 1, 4, 3)
    dm1 = t1_b.new_zeros((nf, nmo, nmo))
    dm1[:, o, v] = t1_b
    dm1[:, v, o] = t1_b.transpose(1, 2)
    idx = torch.arange(nocc, device=t1_b.device)
    dm1[:, idx, idx] += 2.0
    return dm1, dm2


def _fused_objective_bucket(
    fock_b, heff_b, eri_b, dm0_b, h1_b, veff0_b, occ_mask_b, center_w_b,
    nsocc: int, f32_only: bool, eeval: bool,
):
    """A whole CCSD objective evaluation for one bucket.

    Fragment SCF -> MO-ERI transform -> RCCSD -> urlx RDMs ->
    embedding-basis 1-RDM -> cumulant energy rows.  With ``eeval=False``
    (error-only evaluations) the 2-RDM and the energy rows are skipped.
    """
    h_b = fock_b + heff_b
    moe_b, C_b, _, _ = rhf_orthonormal(h_b, eri_b, nsocc, dm0_b)
    eri_mo_b = _batched_mo_eri(eri_b, C_b)
    t1_b, t2_b, _, delta = _rccsd_from_mo_batched(
        eri_mo_b, moe_b, nsocc, f32_only=f32_only
    )
    rdm1_b, rdm2_b = _rdm12_urlx_batched(t1_b, t2_b)
    rdm1_emb_b = _batched_rdm1_emb(C_b, rdm1_b)
    if eeval:
        e1, e2, ec = _batched_energy_rows(
            C_b, h1_b, veff0_b, eri_b, rdm1_b, rdm2_b, occ_mask_b,
            center_w_b,
        )
    else:
        e1 = e2 = ec = fock_b.new_zeros(fock_b.shape[0])
        rdm2_b = None
    return (
        e1, e2, ec, rdm1_emb_b, rdm1_b, rdm2_b, moe_b, C_b, t1_b, t2_b,
        delta,
    )


# Orbital energy magnitude assigned to bucket-merge padding dimensions:
# pad VIRTUALS carry +_PAD_SHIFT on the h diagonal (sort above every
# physical orbital, never occupied), pad OCCUPIEDS carry -_PAD_SHIFT and
# dm0 occupation 2 (sort below everything, always filled).  Both are
# exactly decoupled (zero integrals/off-diagonals), so amplitudes and
# correlated RDMs on them vanish identically, the occupied pads' HF
# density cancels in every energy row, and merged-bucket results equal
# unpadded ones.
_PAD_SHIFT = 1.0e6


def _pad_frag_op(a, p_occ: int, p_vir: int, diag_occ: float = 0.0,
                 diag_vir: float = 0.0):
    """Pad every embedding axis of a per-fragment operand (numpy array or
    torch tensor) with trailing zeros (occupied pads first, then virtual
    pads; 2-D operands get ``diag_occ``/``diag_vir`` on the respective new
    diagonal entries).  A tensor is padded where it lies."""
    pad = p_occ + p_vir
    if pad == 0:
        return a
    n = a.shape[0]
    shape = tuple(d + pad for d in a.shape)
    if isinstance(a, torch.Tensor):
        out = a.new_zeros(shape)
    else:
        out = np.zeros(shape, a.dtype)
    out[tuple(slice(0, n) for _ in a.shape)] = a
    if a.ndim == 2:
        for i in range(n, n + p_occ):
            out[i, i] = diag_occ
        for i in range(n + p_occ, n + pad):
            out[i, i] = diag_vir
    return out


def _bucket_dev(frs: list[Fragment], pads: tuple[tuple[int, int], ...]):
    """Stacked, padded device operands of a merged bucket.

    fock/eri/dm0/h1/veff0 are fixed after BE construction; only heff
    changes between objective evaluations, so the stacks are built once
    and kept on the bucket's first fragment, keyed by the fragments'
    tokens and pads.  Replacing ``fr.eri`` invalidates the entry.
    """
    key = tuple(fr._cache_token for fr in frs) + pads
    hit = getattr(frs[0], "_bucket_cache", None)
    if hit is not None and hit["key"] == key and hit["eri"] is frs[0].eri:
        return hit["dev"]
    dev = frs[0].eri.device

    def stack(name, **diag):
        return torch.as_tensor(np.stack([
            _pad_frag_op(getattr(fr, name), po, pv, **diag)
            for fr, (po, pv) in zip(frs, pads)
        ]), device=dev)

    out = dict(
        eri=torch.stack([
            _pad_frag_op(fr.eri, po, pv) for fr, (po, pv) in zip(frs, pads)
        ]),
        fock=stack("fock", diag_occ=-_PAD_SHIFT, diag_vir=_PAD_SHIFT),
        dm0=stack("dm0", diag_occ=2.0),
        h1=stack("h1"),
        veff0=stack("veff0"),
    )
    frs[0]._bucket_cache = dict(key=key, eri=frs[0].eri, dev=out)
    return out


def _solve_bucket_batched(frs, solver, eeval, use_cumulant, relax_density,
                          pads):
    """Solve one merged bucket through the fused objective.

    Only batched closed-shell CCSD with cumulant energies (the matching
    path) is ported: the JAX module's ``_solve_bucket_batched`` and its
    ``_maybe_fused_objective`` in one.  Returns the bucket's summed
    ``[e1, e2, ec]`` with ``eeval``, else None; per-fragment results are
    written back onto the fragments.
    """
    if solver != "CCSD" or relax_density or not use_cumulant:
        raise NotImplementedError(
            f"solver={solver!r}, relax_density={relax_density}, "
            f"use_cumulant={use_cumulant}: only the fused cumulant CCSD"
            " path is ported; the rest is ROADMAP A9"
        )
    nsocc = frs[0].nsocc + pads[0][0]
    nemb = frs[0].nao + pads[0][0] + pads[0][1]
    if nemb > _NEMB_BATCHED_MAX:
        raise NotImplementedError(
            f"nemb={nemb} > {_NEMB_BATCHED_MAX}: the fragment-at-a-time"
            " large-bucket path is ROADMAP A9"
        )
    dev = _bucket_dev(frs, pads)
    device = dev["fock"].device
    heff_b = torch.as_tensor(np.stack([
        _pad_frag_op(fr.heff, po, pv) for fr, (po, pv) in zip(frs, pads)
    ]), device=device)
    occ_mask = np.zeros((len(frs), nemb))
    occ_mask[:, :nsocc] = 1.0
    center_w = np.zeros((len(frs), nemb))
    for i, fr in enumerate(frs):
        w, idx = fr.weight_and_relAO_per_center
        center_w[i, list(idx)] = w
    f32_only = _f32_only()
    (e1, e2, ec, rdm1_emb_b, rdm1_b, rdm2_b, moe_b, C_b, t1_b, t2_b,
     delta) = _fused_objective_bucket(
        dev["fock"], heff_b, dev["eri"], dev["dm0"], dev["h1"],
        dev["veff0"], torch.as_tensor(occ_mask, device=device),
        torch.as_tensor(center_w, device=device),
        nsocc=nsocc, f32_only=f32_only, eeval=bool(eeval),
    )
    delta_h = delta.cpu().numpy()
    rdm1_emb_host = rdm1_emb_b.cpu().numpy()
    C_host = C_b.cpu().numpy()
    moe_host = moe_b.cpu().numpy()
    if not f32_only and float(np.max(delta_h)) > 10 * _default_conv_tol():
        warnings.warn(
            f"CCSD bucket not fully converged: "
            f"max|dt| = {float(np.max(delta_h)):.2e}"
        )
    for k, fr in enumerate(frs):
        n = fr.nao
        po = pads[k][0]
        sl = slice(po, po + n)
        nv_k = n - fr.nsocc
        fr.mo_coeffs = C_host[k][:n, po : po + n]
        fr.mo_energy = moe_host[k][po : po + n]
        fr._rdm1 = rdm1_emb_host[k][:n, :n]
        fr.rdm1__ = rdm1_b[k][sl, sl]  # device
        fr.t1 = t1_b[k][po:, :nv_k]  # device
        fr.t2 = t2_b[k][po:, po:, :nv_k, :nv_k]
        if eeval:
            fr.rdm2__ = rdm2_b[k][sl, sl, sl, sl]  # device
    if not eeval:
        return None
    e1h, e2h, ech = (x.cpu().numpy() for x in (e1, e2, ec))
    for fr, a, b, c in zip(frs, e1h, e2h, ech):
        fr.ebe = float(a + b + c)
    return [float(e1h.sum()), float(e2h.sum()), float(ech.sum())]


def form_merge_classes(
    fragments: list[Fragment],
) -> list[list[tuple[Fragment, tuple[int, int]]]]:
    """Group fragments into merged padded buckets (the production plan).

    Merges near-same-shaped buckets by zero-padding occupied/virtual
    embedding dimensions to a shared (nsocc, nvir) target (exact -- see
    ``_PAD_SHIFT``): octane BE2's (41,21)x4 + (40,22)x2 buckets become ONE
    (22,20) bucket.  Each class is a list of ``(fragment, (pad_occ,
    pad_vir))`` pairs.  The JAX function's unmerged plan (for its other
    solvers and ``QUEMB_TPU_MERGE_BUCKETS=0``) is not ported: the fused
    CCSD path, the only one here, always merges.
    """
    buckets: dict[tuple[int, int], list[Fragment]] = {}
    for fr in fragments:
        buckets.setdefault((fr.nao, fr.nsocc), []).append(fr)

    # greedy: largest-nao key seeds a class; a key joins if the class
    # target it induces keeps every member's padding <= 25% and the
    # padded shape stays on the batched path (nemb <= 48)
    classes: list[list[tuple[int, int]]] = []
    for key in sorted(buckets, reverse=True):
        for cls in classes:
            cand = cls + [key]
            so_t = max(k[1] for k in cand)
            nv_t = max(k[0] - k[1] for k in cand)
            nemb_t = so_t + nv_t
            if nemb_t <= _NEMB_BATCHED_MAX and all(
                (nemb_t - k[0]) / nemb_t <= 0.25 for k in cand
            ):
                cls.append(key)
                break
        else:
            classes.append([key])

    merge_classes: list[list[tuple[Fragment, tuple[int, int]]]] = []
    for cls in classes:
        so_t = max(k[1] for k in cls)
        nv_t = max(k[0] - k[1] for k in cls)
        pairs = []
        for nao, nsocc in cls:
            po, pv = so_t - nsocc, nv_t - (nao - nsocc)
            pairs.extend((fr, (po, pv)) for fr in buckets[(nao, nsocc)])
        merge_classes.append(pairs)
    return merge_classes


def be_func(
    pot,
    fragments: list[Fragment],
    Nocc: int,
    solver: str,
    only_chem: bool = False,
    eeval: bool = False,
    return_vec: bool = False,
    use_cumulant: bool = True,
    relax_density: bool = False,
):
    """Solve all fragments; return error norm / vector / energies.

    Same return contract as reference ``molbe/solver.py:be_func``.
    """
    for fr in fragments:
        if pot is not None:
            fr.update_heff(pot, only_chem=only_chem)

    merge_classes = form_merge_classes(fragments)

    total_e = [0.0, 0.0, 0.0]
    for pairs in merge_classes:
        frs = [fr for fr, _ in pairs]
        pads = tuple(p for _, p in pairs)
        e_b = _solve_bucket_batched(
            frs, solver, eeval, use_cumulant, relax_density, pads=pads
        )
        if eeval:
            total_e = [a + b for a, b in zip(total_e, e_b)]

    Ecorr = sum(total_e)
    if eeval and not return_vec:
        return (Ecorr, total_e)
    ernorm, ervec = solve_error(fragments, Nocc, only_chem=only_chem)
    if eeval:
        return (ernorm, ervec, [Ecorr, total_e])
    if return_vec:
        return (ernorm, ervec, None)
    return ernorm


def solve_error(fragments: list[Fragment], Nocc, only_chem: bool = False):
    """Edge-center 1-RDM matching error vector (reference solver.py:683)."""
    err_chempot = 0.0
    if only_chem:
        for fr in fragments:
            for i in fr.weight_and_relAO_per_center[1]:
                err_chempot += fr._rdm1[i, i]
        err_chempot /= fragments[0].unitcell_nkpt
        err = err_chempot - Nocc
        return abs(err), np.asarray([err])

    err_edge = []
    for fr in fragments:
        for edge in fr.relAO_per_edge:
            for j in range(len(edge)):
                for k in range(j, len(edge)):
                    err_edge.append(fr._rdm1[edge[j], edge[k]])
        for i in fr.weight_and_relAO_per_center[1]:
            err_chempot += fr._rdm1[i, i]
    err_chempot /= fragments[0].unitcell_nkpt
    err_edge.append(err_chempot)

    err_cen = []
    for fr in fragments:
        for cidx, cens in enumerate(fr.relAO_in_ref_per_edge):
            ref = fragments[fr.ref_frag_idx_per_edge[cidx]]
            for j in range(len(cens)):
                for k in range(j, len(cens)):
                    err_cen.append(ref._rdm1[cens[j], cens[k]])
    err_cen.append(Nocc)

    err_vec = np.asarray(err_edge) - np.asarray(err_cen)
    norm_ = float(np.mean(err_vec * err_vec) ** 0.5)
    return norm_, err_vec
