"""Batched fragment SCF: dense RHF in an orthonormal embedding basis.

JAX counterpart: ``quemb_tpu/embed/fragment_scf.py``.  Replaces the
reference's fake-``Mole`` PySCF RHF per fragment
(``molbe/helper.py:get_scfObj``).  The Schmidt basis is orthonormal, so
the Roothaan step is a plain ``eigh``.  Where the JAX module vmaps a
``lax.while_loop`` over a bucket, this one keeps the bucket as a leading
batch dimension and iterates in a Python loop until every lane has
converged; a converged lane is frozen (its state no longer changes), as
under ``vmap``, so each lane stops exactly where it would alone.
"""

from __future__ import annotations

import torch

from quemb_tpu_torch.ops.linalg import eigh as _eigh
from quemb_tpu_torch.utils.profiling import count

DIIS_SPACE = 8
TOL = 1e-12  # max |change| of the density between iterations
MAX_CYCLE = 100

#: detection threshold for bucket-merge pad sentinels on the Fock diagonal
#: (solvers.dispatch._PAD_SHIFT = 1e6; physical Fock diagonals are O(10) Ha)
_PAD_DETECT = 5.0e5


def _eigh_finite(A: torch.Tensor):
    """Batched ``eigh`` in which a matrix with a non-finite entry gets NaN
    eigenvalues and eigenvectors and leaves the others alone.

    This is what the JAX package's ``eigh`` gives such a matrix.  cuSOLVER
    instead reports it as a convergence failure and ``torch.linalg.eigh``
    raises for the whole batch, so such a lane is handed to it as the
    identity and its outputs are NaN: its state, and so its energy, shows
    what happened to it, and the other lanes go on.
    """
    ok = torch.isfinite(A).all(-1).all(-1)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    w, V = _eigh(torch.where(ok[..., None, None], A, eye))
    return (torch.where(ok[..., None], w, float("nan")),
            torch.where(ok[..., None, None], V, float("nan")))


def _eigh_deflated(F: torch.Tensor):
    """eigh of [..., n, n] Fock matrices that may carry bucket-merge pads.

    Merged-bucket padding (solvers.dispatch._PAD_SHIFT) puts exactly
    decoupled rows with diagonal +-1e6 on the Fock.  Replacing those
    diagonals by values just outside the physical spectrum's Gershgorin
    bounds gives the same eigenvectors and the same order (occupied pads
    below every physical orbital, virtual pads above) with ``||F||`` at the
    physical scale.  Without pads this is exactly ``eigh(F)``.
    """
    d = torch.diagonal(F, dim1=-2, dim2=-1)
    occpad = d <= -_PAD_DETECT
    virpad = d >= _PAD_DETECT
    pad = occpad | virpad
    off = F.abs().sum(-1) - d.abs()
    inf = torch.full_like(d, float("inf"))
    lo = torch.where(pad, inf, d - off).amin(-1, keepdim=True)
    hi = torch.where(pad, -inf, d + off).amax(-1, keepdim=True)
    deff = torch.where(occpad, lo - 1.0, torch.where(virpad, hi + 1.0, d))
    return _eigh_finite(F + torch.diag_embed(deff - d))


def _fock(h, eri, dm):
    vj = torch.einsum("fpqrs,frs->fpq", eri, dm)
    vk = torch.einsum("fprqs,frs->fpq", eri, dm)
    return h + vj - 0.5 * vk


def _diis_solve(err_flat, fock_flat, nvalid):
    """DIIS extrapolation per lane: err_flat, fock_flat [nf, m, n*n],
    nvalid [nf].

    The JAX module's bordered system: the error Gram block of the valid
    slots plus 1e-14 on its diagonal, invalid slots masked to identity
    rows, solved by an eigh pseudo-inverse (cutoff 1e-14).  Here the valid
    block is first divided by its largest diagonal entry.  The bordered
    solution's coefficients do not change when that block is scaled by a
    positive number (only the multiplier does), so on well-conditioned
    histories they are the JAX module's; a history of error vectors near
    1e-7 or below, whose Gram entries sit at or under the 1e-14 terms,
    keeps its eigenvalues at order one instead of at the cutoff.  A lane
    with a non-finite history gets NaN coefficients (:func:`_eigh_finite`)
    and the other lanes are unchanged.
    """
    nf, m, _ = err_flat.shape
    dt, dev = err_flat.dtype, err_flat.device
    valid = torch.arange(m, device=dev)[None, :] < nvalid[:, None]
    eye = torch.eye(m, dtype=dt, device=dev)
    B = err_flat @ err_flat.transpose(1, 2) + 1e-14 * eye
    B = torch.where(valid[:, :, None] & valid[:, None, :], B, 0.0)
    B = B / torch.diagonal(B, dim1=1, dim2=2).amax(1)[:, None, None]
    B = B + torch.diag_embed((~valid).to(dt))
    border = torch.where(valid, -1.0, 0.0).to(dt)
    Bfull = torch.zeros((nf, m + 1, m + 1), dtype=dt, device=dev)
    Bfull[:, :m, :m] = B
    Bfull[:, m, :m] = border
    Bfull[:, :m, m] = border
    rhs = torch.zeros((nf, m + 1), dtype=dt, device=dev)
    rhs[:, m] = -1.0
    w, V = _eigh_finite(Bfull)
    w_safe = torch.where(w.abs() < 1e-14, float("inf"), w)
    y = (V.transpose(1, 2) @ rhs[..., None])[..., 0] / w_safe
    c = (V @ y[..., None])[:, :m, 0]
    return torch.einsum("fi,fix->fx", c, fock_flat)


def rhf_orthonormal(h, eri, nocc: int, dm0):
    """Batched RHF with S = identity over a bucket of fragments.

    h, dm0: [nf, n, n]; eri: [nf, n, n, n, n].  Returns
    (mo_energy [nf, n], mo_coeff [nf, n, n], e_el [nf], n_iter [nf]).
    Counts each loop trip (``iters``) and each flag read (``syncs``) on
    the innermost open span of the tracer.
    """
    nf, n = h.shape[0], h.shape[-1]
    dt, dev = h.dtype, h.device
    lanes = torch.arange(nf, device=dev)
    dm = dm0
    err_buf = torch.zeros((nf, DIIS_SPACE, n * n), dtype=dt, device=dev)
    fock_buf = torch.zeros_like(err_buf)
    it = torch.zeros(nf, dtype=torch.long, device=dev)
    delta = torch.full((nf,), float("inf"), dtype=dt, device=dev)
    while True:
        active = (delta > TOL) & (it < MAX_CYCLE)
        count("syncs")
        if not bool(active.any()):
            break
        count("iters")
        F = _fock(h, eri, dm)
        err = (F @ dm - dm @ F).reshape(nf, -1)
        slot = it % DIIS_SPACE
        err_new = err_buf.clone()
        fock_new = fock_buf.clone()
        err_new[lanes, slot] = err
        fock_new[lanes, slot] = F.reshape(nf, -1)
        nvalid = torch.clamp(it + 1, max=DIIS_SPACE)
        F_x = torch.where(
            (it > 0)[:, None, None],
            _diis_solve(err_new, fock_new, nvalid).reshape(nf, n, n),
            F,
        )
        _, C = _eigh_deflated(F_x)
        dm_new = 2.0 * C[..., :nocc] @ C[..., :nocc].transpose(-1, -2)
        step = (dm_new - dm).abs().amax((-2, -1))
        # converged lanes stay frozen, as under vmap(while_loop)
        a3 = active[:, None, None]
        dm = torch.where(a3, dm_new, dm)
        err_buf = torch.where(a3, err_new, err_buf)
        fock_buf = torch.where(a3, fock_new, fock_buf)
        delta = torch.where(active, step, delta)
        it = it + active.long()
    F = _fock(h, eri, dm)
    e, C = _eigh_deflated(F)
    e_el = 0.5 * ((h + F) * dm).sum((-2, -1))
    return e, C, e_el, it


def rhf_orthonormal_batched(h_b, eri_b, nocc: int, dm0_b):
    """The JAX package's name for the bucket SCF, which it vmaps over
    :func:`rhf_orthonormal`; here :func:`rhf_orthonormal` is batched
    already.  Returns (mo_energy [nf, n], mo_coeff [nf, n, n], e_el [nf],
    n_iter [nf])."""
    return rhf_orthonormal(h_b, eri_b, nocc, dm0_b)
