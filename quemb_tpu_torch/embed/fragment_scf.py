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

import threading
from collections import OrderedDict

import torch

from quemb_tpu_torch.ops import jacobi_eigh
from quemb_tpu_torch.ops.linalg import eigh as _eigh
from quemb_tpu_torch.utils.profiling import count, total

DIIS_SPACE = 8
TOL = 1e-12  # max |change| of the density between iterations
MAX_CYCLE = 100
#: on a card, replay the trips after the first as a CUDA graph
GRAPHS = True

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


def _active(it, delta):
    """The lanes that take another trip."""
    return (delta > TOL) & (it < MAX_CYCLE)


def _trip(h, eri, nocc: int, state):
    """One SCF trip of a bucket: the Fock build, DIIS, the Roothaan step.
    ``state`` is (dm, err_buf, fock_buf, it, delta); lanes that no longer
    take trips come back unchanged, as under vmap(while_loop)."""
    dm, err_buf, fock_buf, it, delta = state
    nf, n = h.shape[0], h.shape[-1]
    active = _active(it, delta)
    F = _fock(h, eri, dm)
    err = (F @ dm - dm @ F).reshape(nf, -1)
    slot = it % DIIS_SPACE
    at_slot = (torch.arange(DIIS_SPACE, device=h.device)[None, :]
               == slot[:, None])[:, :, None]
    err_new = torch.where(at_slot, err[:, None, :], err_buf)
    fock_new = torch.where(at_slot, F.reshape(nf, 1, -1), fock_buf)
    nvalid = torch.clamp(it + 1, max=DIIS_SPACE)
    F_x = torch.where(
        (it > 0)[:, None, None],
        _diis_solve(err_new, fock_new, nvalid).reshape(nf, n, n),
        F,
    )
    _, C = _eigh_deflated(F_x)
    dm_new = 2.0 * C[..., :nocc] @ C[..., :nocc].transpose(-1, -2)
    step = (dm_new - dm).abs().amax((-2, -1))
    a3 = active[:, None, None]
    return (torch.where(a3, dm_new, dm),
            torch.where(a3, err_new, err_buf),
            torch.where(a3, fock_new, fock_buf),
            it + active.long(),
            torch.where(active, step, delta))


def _graphs(h) -> bool:
    """Whether the trips of this bucket replay as one CUDA graph: on a
    card, when every ``eigh`` of a trip takes the Jacobi kernel, which
    launches without reading anything back."""
    return (GRAPHS and h.is_cuda and h.dtype == torch.float64
            and h.shape[-1] <= jacobi_eigh.MAX_N)


#: counters that a trip adds where it runs; a replayed trip adds them
#: by hand, since a replay runs no Python
_TRIP_COUNTERS = ("eigh.kernel", "jacobi_eigh.launches")

#: device bytes that the captured trips kept (by device, thread and
#: bucket shape) may hold, by :attr:`_Captured.nbytes`; the least
#: recently used go past it.  A matching job keeps a capture for each
#: bucket of the construction, of the evaluations and of the Jacobian's
#: one-fragment SCFs, nine for the thiophene dimer.
GRAPH_CACHE_BYTES = 8 << 30
_CAPTURED: OrderedDict[tuple, _Captured] = OrderedDict()
_SIDE_STREAMS: dict[tuple, torch.cuda.Stream] = {}


class _Captured:
    """One trip of a bucket shape captured as a CUDA graph over fixed
    buffers: the inputs ``h`` and ``eri``, the state, and ``flag``, which
    a replay sets to whether any lane takes another trip."""

    def __init__(self, h, eri, nocc: int, state):
        dev = h.device
        self.h, self.eri = h.clone(), eri.clone()
        self.state = tuple(t.clone() for t in state)
        self.flag = torch.ones((), dtype=torch.bool, device=dev)
        key = (dev.index, threading.get_ident())
        side = _SIDE_STREAMS.get(key)
        if side is None:
            side = _SIDE_STREAMS[key] = torch.cuda.Stream(dev)
        cur = torch.cuda.current_stream(dev)
        side.wait_stream(cur)
        before = [total(k) for k in _TRIP_COUNTERS]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                new = _trip(self.h, self.eri, nocc, self.state)
                for s, t in zip(self.state, new):
                    s.copy_(t)
                self.flag.copy_(_active(self.state[3], self.state[4]).any())
            finally:
                self.graph.capture_end()
        cur.wait_stream(side)
        self.counts = [total(k) - b for k, b in zip(_TRIP_COUNTERS, before)]
        # the fixed buffers, and about as much again for the graph's own
        # temporaries (the exchange term's permuted copy of the ERI)
        self.nbytes = 2 * sum(t.numel() * t.element_size() for t in (
            self.h, self.eri, *self.state))

    def load(self, h, eri, state) -> None:
        self.h.copy_(h)
        self.eri.copy_(eri)
        for s, t in zip(self.state, state):
            s.copy_(t)


def _replayed_trips(h, eri, nocc: int, state):
    """The trips after the first, on a card: if any lane takes one, a
    trip captured as a CUDA graph (:class:`_Captured`, kept for the next
    call with the same shape) replays until no lane takes another.  A
    replay runs the kernels of :func:`_trip` in its order; it takes away
    the host's launches, which bound a trip of these small batches.
    Returns the state as :func:`_trip` would leave it."""
    count("syncs")
    if not bool(_active(state[3], state[4]).any()):
        return state
    key = (h.device.index, threading.get_ident(), tuple(h.shape), nocc)
    cap = _CAPTURED.pop(key, None)
    # a capture counts its trip's launches as the first replay's
    counted = cap is None
    if cap is None:
        cap = _Captured(h, eri, nocc, state)
    else:
        cap.load(h, eri, state)
    _CAPTURED[key] = cap
    while (len(_CAPTURED) > 1 and sum(c.nbytes for c in _CAPTURED.values())
           > GRAPH_CACHE_BYTES):
        _CAPTURED.popitem(last=False)
    more = True
    while more:
        count("iters")
        if not counted:
            for k, n in zip(_TRIP_COUNTERS, cap.counts):
                count(k, n)
        counted = False
        cap.graph.replay()
        count("syncs")
        more = bool(cap.flag)
    return tuple(t.clone() for t in cap.state)


def rhf_orthonormal(h, eri, nocc: int, dm0):
    """Batched RHF with S = identity over a bucket of fragments.

    h, dm0: [nf, n, n]; eri: [nf, n, n, n, n].  Returns
    (mo_energy [nf, n], mo_coeff [nf, n, n], e_el [nf], n_iter [nf]).
    Counts each loop trip (``iters``) and each flag read (``syncs``) on
    the innermost open span of the tracer.  On a card, trips after the
    first replay as a CUDA graph (:func:`_replayed_trips`).
    """
    nf, n = h.shape[0], h.shape[-1]
    dt, dev = h.dtype, h.device
    err_buf = torch.zeros((nf, DIIS_SPACE, n * n), dtype=dt, device=dev)
    state = (dm0, err_buf, torch.zeros_like(err_buf),
             torch.zeros(nf, dtype=torch.long, device=dev),
             torch.full((nf,), float("inf"), dtype=dt, device=dev))
    graphs = _graphs(h)
    while True:
        count("syncs")
        if not bool(_active(state[3], state[4]).any()):
            break
        count("iters")
        state = _trip(h, eri, nocc, state)
        if graphs:
            state = _replayed_trips(h, eri, nocc, state)
            break
    dm, it = state[0], state[3]
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
