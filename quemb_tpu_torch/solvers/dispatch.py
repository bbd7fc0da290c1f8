"""Per-objective-evaluation fragment solve pass + error vector.

JAX counterpart: ``quemb_tpu/solvers/dispatch.py``.  Fragments are grouped
into buckets by :func:`form_merge_classes` (merged and zero-padded for CCSD
and MP2, one bucket per true shape for the CI solvers; on a card a CCSD or
MP2 fragment wider than ``_NEMB_BATCHED_MAX`` is a bucket of its own, where
the JAX package sends it down a fragment-at-a-time path), and
:func:`_solve_bucket_batched` runs every bucket with the fragment axis as a
leading batch dimension: batched fragment SCF -> MO-ERI transform -> the
solver (closed-shell CCSD, or the spin-orbital kernel under
``QUEMB_TPU_CCSD_SPINORB=1``, or MP2 on the device; relaxed CCSD densities
fragment by fragment on the device; FCI, SCI or DMRG on the host) -> RDMs
-> embedding-basis 1-RDM -> cumulant or non-cumulant energy rows.  The JAX
module keeps a fused and a staged form of this pass because one is a
single XLA program; eager torch has one form.

Under a fragment mesh (:mod:`quemb_tpu_torch.parallel.mesh`),
:func:`_solve_bucket` splits a bucket of several fragments into
contiguous chunks, one per shard, and runs :func:`_solve_bucket_batched`
on each chunk on its shard's device, one thread per shard; the chunks'
energy sums are added in shard order.  A bucket of one fragment is not
sharded: it runs where its ERI lies.  The per-fragment tensors
(``rdm1__``, ``rdm2__``, ``t1``, ``t2``) stay on their shard's device; the
host arrays (``_rdm1``, ``mo_coeffs``, ``ebe``) are what the error vector
reads.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from quemb_tpu_torch.embed.fragment import Fragment
from quemb_tpu_torch.embed.fragment_scf import rhf_orthonormal
from quemb_tpu_torch.ops.eri_transform import \
    batched_mo_eri as _batched_mo_eri
from quemb_tpu_torch.parallel.mesh import get_mesh, run_on_shards, \
    shard_ranges
from quemb_tpu_torch.solvers.ccsd import _ccsd_so_batched, \
    _default_conv_tol, _f32_only
from quemb_tpu_torch.solvers.ccsd_relaxed import ccsd_relaxed_rdms
from quemb_tpu_torch.solvers.dmrg import solve_dmrg
from quemb_tpu_torch.solvers.fci import remove_mf_part, solve_fci
from quemb_tpu_torch.solvers.mp2 import _occ_projector, \
    add_mean_field_rdm2, make_rdm1_mp2, make_rdm2_mp2, mp2_amplitudes
from quemb_tpu_torch.solvers.rccsd import _rccsd_from_mo_batched
from quemb_tpu_torch.solvers.sci import solve_sci
from quemb_tpu_torch.utils.profiling import count, span

#: largest padded embedding dimension of a bucket of several CCSD or MP2
#: fragments on a card; the plan makes each wider one a bucket of its own
#: (the JAX package's value)
_NEMB_BATCHED_MAX = 48

#: the fragment solvers that run on the host, one fragment at a time, on
#: Hamiltonians transformed on the device
_HOST_CI = {"FCI": solve_fci, "SCI": solve_sci, "DMRG": solve_dmrg}


def _mo_transform(C_b, h_b, eri_b):
    """One-body and two-body Hamiltonians of a bucket in its fragment-SCF
    orbitals, computed on the device and brought to the host (for the CI
    solver): (h_mo [nf, n, n], eri_mo [nf, n, n, n, n]) as numpy."""
    h_mo = C_b.transpose(1, 2) @ h_b @ C_b
    count("syncs", 2)
    return h_mo.cpu().numpy(), _batched_mo_eri(eri_b, C_b).cpu().numpy()


def run_fragment_scf(fr: Fragment, heff=None):
    """Fragment RHF on (fock + heff, eri) from the initial density guess,
    on the device of ``fr.eri``; returns tensors (mo_energy [n], mo_coeff
    [n, n]) there.  One fragment at its true shape: no pad orbitals."""
    eri = fr.eri
    h, dm0 = (
        torch.as_tensor(a, dtype=eri.dtype, device=eri.device)[None]
        for a in (fr.fock + (fr.heff if heff is None else heff), fr.dm0)
    )
    e, C, _, _ = rhf_orthonormal(h, eri[None], fr.nsocc, dm0)
    return e[0], C[0]


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
    return _center_rows(e1, ec, moT, eri_b, rdm2_b, center_w_b)


def _center_rows(e1, ec, moT, eri_b, rdm2_b, center_w_b):
    """The two-body rows (the 2-RDM back in the embedding basis against
    the ERI), and all three kinds of row summed over the center rows."""
    rdm2_emb = _batched_mo_eri(0.5 * rdm2_b, moT)
    e2 = (rdm2_emb * eri_b).sum((-3, -2, -1))
    return (
        (center_w_b * e1).sum(-1),
        (center_w_b * e2).sum(-1),
        (center_w_b * ec).sum(-1),
    )


def _batched_energy_rows_nc(mo_b, h1_b, veff_b, eri_b, rdm1_b, rdm2_b,
                            center_w_b):
    """Non-cumulant fragment energies for a bucket (ref helper.py:295):
    full 1-RDM against h1/veff(env), full 2-RDM against the ERI."""
    moT = mo_b.transpose(1, 2)
    rdm1_emb = mo_b @ (0.5 * rdm1_b) @ moT
    e1 = 2.0 * (h1_b * rdm1_emb).sum(-1)
    ec = (veff_b * rdm1_emb).sum(-1)
    return _center_rows(e1, ec, moT, eri_b, rdm2_b, center_w_b)


def _batched_rdm1_emb(C_b, rdm1_b):
    return (C_b @ rdm1_b @ C_b.transpose(1, 2)) * 0.5


def _rdm12_urlx_batched(t1_b, t2_b, with_dm1: bool = False):
    """Batched unrelaxed CCSD 1- and 2-RDMs (broadcast form of the
    reference's ccsd_rdm.py:make_rdm2_urlx): the cumulant 2-RDM, or with
    ``with_dm1`` the full one, mean-field part included."""
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
    if with_dm1:
        dm2 = add_mean_field_rdm2(dm2, dm1, nocc)  # dm1: correlation part
    dm1[:, idx, idx] += 2.0
    return dm1, dm2


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


def _bucket_dev(frs: list[Fragment], pads: tuple[tuple[int, int], ...],
                device: torch.device):
    """Stacked, padded operands of a merged bucket (or of a shard's chunk
    of one) on ``device``.

    fock/eri/dm0/h1/veff0/veff are fixed after BE construction; only heff
    changes between objective evaluations, so the stacks are built once
    and kept on the bucket's first fragment, keyed by the fragments'
    tokens, the pads and the device: a chunk's ERIs are copied to its
    shard's device once, not at every evaluation.  Replacing ``fr.eri``
    invalidates the entry.
    """
    key = tuple(fr._cache_token for fr in frs) + pads + (str(device),)
    hit = getattr(frs[0], "_bucket_cache", None)
    if hit is not None and hit["key"] == key and hit["eri"] is frs[0].eri:
        return hit["dev"]

    def stack(name, **diag):
        return torch.as_tensor(np.stack([
            _pad_frag_op(getattr(fr, name), po, pv, **diag)
            for fr, (po, pv) in zip(frs, pads)
        ]), device=device)

    count("syncs", 5)  # the five host stacks below
    if len(frs) == 1 and not any(pads[0]):
        # a lone fragment's ERI as it lies: no second copy on the card
        eri = frs[0].eri.to(device)[None]
    else:
        eri = torch.stack([
            _pad_frag_op(fr.eri.to(device), po, pv)
            for fr, (po, pv) in zip(frs, pads)
        ])
    out = dict(
        eri=eri,
        fock=stack("fock", diag_occ=-_PAD_SHIFT, diag_vir=_PAD_SHIFT),
        dm0=stack("dm0", diag_occ=2.0),
        h1=stack("h1"),
        veff0=stack("veff0"),
        veff=stack("veff"),
    )
    frs[0]._bucket_cache = dict(key=key, eri=frs[0].eri, dev=out)
    return out


def _spinorb() -> bool:
    """The spin-orbital CCSD kernel instead of the closed-shell one (env
    QUEMB_TPU_CCSD_SPINORB=1)."""
    return os.environ.get("QUEMB_TPU_CCSD_SPINORB", "") in (
        "1", "true", "yes",
    )


def _remove_mf_part(dm1, dm2, nsocc: int):
    """:func:`quemb_tpu_torch.solvers.fci.remove_mf_part` on tensors, one
    fragment: the mean-field and semi-cumulant part out of a 2-RDM."""
    hf_dm = 2.0 * _occ_projector(nsocc, dm1.shape[-1], dm1)
    d = dm1 - hf_dm
    es = torch.einsum
    nc = es("ij,kl->ijkl", hf_dm, hf_dm + d) + es("ij,kl->ijkl", d, hf_dm)
    nc = nc - 0.5 * (es("ij,kl->iklj", hf_dm, hf_dm + d)
                     + es("ij,kl->iklj", d, hf_dm))
    return dm2 - nc


def _check_solver(solver: str) -> None:
    """Raise for what the bucket solve does not run, with the JAX
    package's words where it has them."""
    if solver in ("SHCI", "HCI"):
        # Reference enum parity (molbe/solver.py:42 Solvers literal).
        raise NotImplementedError(
            f"Solver {solver!r} requires the external cornell_shci"
            " package; the reference gates these behind optional"
            " dependencies too (use solver='SCI' for the built-in"
            " heat-bath selected CI)."
        )
    if solver not in ("CCSD", "MP2", *_HOST_CI):
        raise NotImplementedError(f"Solver {solver} not implemented")


def _solved_alone(nemb: int, device: torch.device, solver: str,
                  relax_density: bool = False) -> bool:
    """Whether the plan makes each fragment of a class of padded width
    ``nemb`` a bucket of its own: on a card, for CCSD (unrelaxed) or MP2
    wider than ``_NEMB_BATCHED_MAX`` (the JAX package's routing to its
    fragment-at-a-time path).  The CPU batches every class."""
    return (
        nemb > _NEMB_BATCHED_MAX
        and device.type != "cpu"
        and not relax_density
        and solver in ("CCSD", "MP2")
    )


def _solve_bucket(frs, solver, eeval, use_cumulant, relax_density,
                  pads=None):
    """One bucket of :func:`be_func` through :func:`_solve_bucket_batched`;
    returns what it returns.  Under a fragment mesh a bucket of several
    fragments is split into one chunk per shard, each solved on its
    shard's device on a thread of its own, and the chunks' ``[e1, e2,
    ec]`` are added in shard order."""
    _check_solver(solver)
    if pads is None:
        pads = ((0, 0),) * len(frs)
    mesh = get_mesh()
    if mesh is None or len(frs) == 1:
        return _solve_bucket_batched(frs, solver, eeval, use_cumulant,
                                     relax_density, pads=pads)
    shards = shard_ranges(len(frs), mesh)
    rets = run_on_shards(
        lambda r, device: _solve_bucket_batched(
            frs[r.start:r.stop], solver, eeval, use_cumulant, relax_density,
            pads=pads[r.start:r.stop], device=device,
        ),
        [r for r, _ in shards], [d for _, d in shards],
    )
    return [sum(e) for e in zip(*rets)] if eeval else None


def _solve_bucket_batched(frs, solver, eeval, use_cumulant, relax_density,
                          pads=None, device=None):
    """Solve a bucket of same-shaped fragments as batched device work.

    ``pads`` (from the be_func bucket merge) zero-pads each fragment's
    occupied/virtual embedding dimensions up to a shared (nsocc, nemb)
    target so near-same-shaped buckets run as ONE batch -- exactly (see
    _PAD_SHIFT); per-fragment results are sliced back to true shapes
    before they are stored.  Solvers: ``"CCSD"`` (closed-shell, or
    spin-orbital under ``QUEMB_TPU_CCSD_SPINORB``; with ``relax_density``
    the relaxed densities one fragment at a time) and ``"MP2"`` on the
    device; ``"FCI"``, ``"SCI"`` and ``"DMRG"`` with the SCF and the MO
    transform on the device and the CI on the host; cumulant or
    non-cumulant energies.  Any width runs here; a bucket of one fragment
    without pads works on that fragment's ERI as it lies.  The bucket runs
    on ``device`` (default: the device of its ERIs).  Returns the bucket's
    summed ``[e1, e2, ec]`` with ``eeval``, else None; per-fragment
    results are written back onto the fragments.
    """
    _check_solver(solver)
    if pads is None:
        pads = ((0, 0),) * len(frs)
    padded = any(po or pv for po, pv in pads)
    if padded and (relax_density or solver not in ("CCSD", "MP2")
                   or (solver == "CCSD" and _spinorb())):
        raise ValueError(
            "bucket-merge padding supports batched CCSD/MP2 only, unrelaxed"
            " and with the closed-shell CCSD kernel"
        )
    nsocc = frs[0].nsocc + pads[0][0]
    nemb = frs[0].nao + pads[0][0] + pads[0][1]
    with span("inputs"):
        dev = _bucket_dev(frs, pads,
                          frs[0].eri.device if device is None else device)
        device = dev["fock"].device
        heff_b = torch.as_tensor(np.stack([
            _pad_frag_op(fr.heff, po, pv) for fr, (po, pv) in zip(frs, pads)
        ]), device=device)
        count("syncs")
        h_b = dev["fock"] + heff_b
        eri_b = dev["eri"]
    with span("scf"):
        moe_b, C_b, _, _ = rhf_orthonormal(h_b, eri_b, nsocc, dev["dm0"])

    t1_b = t2_b = None
    if solver == "CCSD" and relax_density:
        # lambda/response densities via adjoint implicit differentiation
        # (reference solver.py:920-940 relax=True), one fragment at a time
        h_mo_b = C_b.transpose(1, 2) @ h_b @ C_b
        rdm1_l, rdm2_l = [], []
        for h_mo, eri_mo in zip(h_mo_b, _batched_mo_eri(eri_b, C_b)):
            rdm1, rdm2, _ = ccsd_relaxed_rdms(h_mo, eri_mo, nsocc)
            if use_cumulant:
                rdm2 = _remove_mf_part(rdm1, rdm2, nsocc)
            rdm1_l.append(rdm1)
            rdm2_l.append(rdm2)
        rdm1_b, rdm2_b = torch.stack(rdm1_l), torch.stack(rdm2_l)
    elif solver == "CCSD":
        f32_only = _f32_only()
        with span("mo_transform"):
            eri_mo_b = _batched_mo_eri(eri_b, C_b)
        if _spinorb():
            amplitudes = _ccsd_so_batched
        else:
            def amplitudes(eri_mo_b, moe_b, nsocc):
                return _rccsd_from_mo_batched(eri_mo_b, moe_b, nsocc,
                                              f32_only=f32_only)
        with span("ccsd"):
            t1_b, t2_b, it, delta = amplitudes(eri_mo_b, moe_b, nsocc)
            del eri_mo_b
            # one read: the lanes' last steps and their iteration counts
            host = torch.cat([delta, it.to(delta.dtype)]).cpu().numpy()
            count("syncs")
            delta_max = float(host[:len(frs)].max())
            count("lanes", len(frs))
            count("lane_iters", int(host[len(frs):].sum()))
            if nemb > _NEMB_BATCHED_MAX:
                # too wide to batch: on a card the plan solved it alone
                count("large", len(frs))
            else:
                # the lanes' true widths, and the pads that fill each
                orbs = sum(fr.nao for fr in frs)
                count("orbs", orbs)
                count("pad_orbs", nemb * len(frs) - orbs)
        if not f32_only and delta_max > 10 * _default_conv_tol():
            warnings.warn(
                f"CCSD bucket not fully converged: "
                f"max|dt| = {delta_max:.2e}"
            )
        with span("rdm"):
            rdm1_b, rdm2_b = _rdm12_urlx_batched(
                t1_b, t2_b, with_dm1=not use_cumulant
            )
    elif solver == "MP2":
        t2_mp, _ = mp2_amplitudes(_batched_mo_eri(eri_b, C_b), moe_b, nsocc)
        rdm1_b = make_rdm1_mp2(t2_mp, nemb)
        rdm2_b = make_rdm2_mp2(t2_mp, nemb) if eeval else None
    else:
        # FCI, SCI, DMRG: the Hamiltonians go down to the host, the RDMs
        # come back
        solve_ci = _HOST_CI[solver]
        rdm1_l, rdm2_l = [], []
        for h_mo, eri_mo in zip(*_mo_transform(C_b, h_b, eri_b)):
            _, rdm1, rdm2 = solve_ci(h_mo, eri_mo, nsocc)
            if eeval and use_cumulant:
                rdm2 = remove_mf_part(rdm1, rdm2, nsocc)
            rdm1_l.append(rdm1)
            rdm2_l.append(rdm2)
        rdm1_b = torch.as_tensor(np.stack(rdm1_l), device=device)
        rdm2_b = torch.as_tensor(np.stack(rdm2_l), device=device)
        count("syncs", 2)

    # correlated 1-RDM in the embedding basis (for the error vector); all
    # big operands stay on the device, only per-fragment scalars and
    # [nemb, nemb] matrices come back to the host
    with span("rdm"):
        rdm1_emb_host = _batched_rdm1_emb(C_b, rdm1_b).cpu().numpy()
        C_host = C_b.cpu().numpy()
        moe_host = moe_b.cpu().numpy()
        count("syncs", 3)
    for k, fr in enumerate(frs):
        # pad orbitals are exactly decoupled: occupied pads (-_PAD_SHIFT)
        # sort first, virtual pads (+_PAD_SHIFT) last, so the real MOs are
        # columns [po, po + n) and the real embedding rows are [0, n)
        n = fr.nao
        po = pads[k][0]
        sl = slice(po, po + n)
        fr.mo_coeffs = C_host[k][:n, sl]
        fr.mo_energy = moe_host[k][sl]
        fr._rdm1 = rdm1_emb_host[k][:n, :n]
        fr.rdm1__ = rdm1_b[k][sl, sl]  # device
        if t1_b is not None:
            nv_k = n - fr.nsocc
            fr.t1 = t1_b[k][po:, :nv_k]  # device
            fr.t2 = t2_b[k][po:, po:, :nv_k, :nv_k]
        if eeval:
            fr.rdm2__ = rdm2_b[k][sl, sl, sl, sl]  # device
    if not eeval:
        return None

    with span("energy"):
        center_w = np.zeros((len(frs), nemb))
        for i, fr in enumerate(frs):
            w, idx = fr.weight_and_relAO_per_center
            center_w[i, list(idx)] = w
        center_w_b = torch.as_tensor(center_w, device=device)
        if use_cumulant:
            occ_mask = np.zeros((len(frs), nemb))
            occ_mask[:, :nsocc] = 1.0
            e1, e2, ec = _batched_energy_rows(
                C_b, dev["h1"], dev["veff0"], eri_b, rdm1_b, rdm2_b,
                torch.as_tensor(occ_mask, device=device), center_w_b,
            )
            count("syncs")
        else:
            e1, e2, ec = _batched_energy_rows_nc(
                C_b, dev["h1"], dev["veff"], eri_b, rdm1_b, rdm2_b,
                center_w_b,
            )
        e1h, e2h, ech = (x.cpu().numpy() for x in (e1, e2, ec))
        count("syncs", 4)  # the weights' copy up, three reads
    for fr, a, b, c in zip(frs, e1h, e2h, ech):
        fr.ebe = float(a + b + c)
    return [float(e1h.sum()), float(e2h.sum()), float(ech.sum())]


def solve_one_fragment(
    fr: Fragment,
    solver: str,
    eeval: bool,
    use_cumulant: bool = True,
    relax_density: bool = False,
):
    """Single-fragment solve (kept for probing/tests); updates fr in place."""
    return _solve_bucket([fr], solver, eeval, use_cumulant, relax_density)


def form_merge_classes(
    fragments: list[Fragment],
    solver: str = "CCSD",
    relax_density: bool = False,
) -> list[list[tuple[Fragment, tuple[int, int]]]]:
    """Group fragments into the buckets of an objective evaluation (the
    production plan); :func:`_solved_alone` is decided here and nowhere
    else.

    Merges near-same-shaped buckets by zero-padding occupied/virtual
    embedding dimensions to a shared (nsocc, nvir) target (exact -- see
    ``_PAD_SHIFT``): octane BE2's (41,21)x4 + (40,22)x2 buckets become ONE
    (22,20) bucket.  Each class is a list of ``(fragment, (pad_occ,
    pad_vir))`` pairs.  Solvers other than CCSD and MP2, relaxed densities
    and the spin-orbital kernel (``QUEMB_TPU_CCSD_SPINORB``, which takes no
    pads) get the unmerged plan, one class per true (nao, nsocc) shape
    with no pads.  No merge is wider than ``_NEMB_BATCHED_MAX``, so a wider
    class holds one true shape and no pads; where :func:`_solved_alone`
    says so (on a card), each of its fragments is a class of its own.  The
    JAX function's switch that turns merging off is not carried.
    """
    buckets: dict[tuple[int, int], list[Fragment]] = {}
    for fr in fragments:
        buckets.setdefault((fr.nao, fr.nsocc), []).append(fr)
    classes: list[list[tuple[int, int]]] = []
    if (solver not in ("CCSD", "MP2") or relax_density
            or (solver == "CCSD" and _spinorb())):
        classes = [[key] for key in buckets]
    else:
        # greedy: largest-nao key seeds a class; a key joins if the class
        # target it induces keeps every member's padding <= 25% and the
        # padded width stays within _NEMB_BATCHED_MAX
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

    plan: list[list[tuple[Fragment, tuple[int, int]]]] = []
    for cls in classes:
        so_t = max(k[1] for k in cls)
        nv_t = max(k[0] - k[1] for k in cls)
        pairs = [(fr, (so_t - nsocc, nv_t - (nao - nsocc)))
                 for nao, nsocc in cls for fr in buckets[(nao, nsocc)]]
        if _solved_alone(so_t + nv_t, pairs[0][0].eri.device, solver,
                         relax_density):
            plan.extend([pair] for pair in pairs)
        else:
            plan.append(pairs)
    return plan


@span("eval")
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

    Same return contract as reference ``molbe/solver.py:be_func``.  One
    call is the tracer's ``eval`` span.
    """
    with span("inputs"):
        for fr in fragments:
            if pot is not None:
                fr.update_heff(pot, only_chem=only_chem)
        merge_classes = form_merge_classes(fragments, solver, relax_density)

    total_e = [0.0, 0.0, 0.0]
    for pairs in merge_classes:
        frs = [fr for fr, _ in pairs]
        pads = tuple(p for _, p in pairs)
        e_b = _solve_bucket(
            frs, solver, eeval, use_cumulant, relax_density, pads=pads
        )
        if eeval:
            total_e = [a + b for a, b in zip(total_e, e_b)]

    Ecorr = sum(total_e)
    if eeval and not return_vec:
        return (Ecorr, total_e)
    with span("error"):
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
