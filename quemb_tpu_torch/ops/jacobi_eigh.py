"""Batched float64 symmetric eigensolver for matrices of order n <= 64, as
a CUDA kernel: cyclic Jacobi in shared memory, one launch a batch (a
matrix's blocks each hold all of A and rotate a share of V's rows).

It replaces no TPU kernel.  It stands in for ``torch.linalg.eigh`` on the
card, where cuSOLVER's ``syevd`` solves a batch one matrix at a time in
about a hundred small launches a matrix and the host then reads its error
flags back; the fragment SCF calls it twice a loop trip
(:mod:`quemb_tpu_torch.embed.fragment_scf`).
:func:`quemb_tpu_torch.ops.linalg.eigh` routes a CUDA float64 tensor with
n <= :data:`MAX_N` here, everything else to ``torch.linalg.eigh``.

The method, in the kernel (``csrc/jacobi_eigh.cu``) and in
:func:`jacobi_eigh_plain` alike: the lower triangle is read and mirrored
(as ``torch.linalg.eigh`` reads it); an odd order is padded by one row
and column that are zero off the diagonal, which every rotation leaves
alone; then sweeps of the parallel round-robin ordering
(:func:`round_robin`), n/2 disjoint rotations a step and m - 1 steps a
sweep (m the padded order), each rotation the symmetric Schur
decomposition of its 2x2 block (Golub and Van Loan, Algorithm 8.4.1,
written with d = a_qq - a_pp and e = 2 a_pq as t = sign(d) e / (|d| +
hypot(d, e))), applied to A from both sides and to V's columns.  The
kernel moves rows and columns between slots so that a step's pairs sit
side by side; the plain version keeps them in place and rotates the same
pairs in the same order.  A matrix stops after the first sweep that
leaves its off-diagonal norm at most :data:`TOL` times its Frobenius norm,
or after :data:`MAX_SWEEPS`.  Eigenvalues come
out ascending (ties by index) with their eigenvectors in the columns.  A
matrix with a non-finite entry gets NaN eigenvalues and eigenvectors.
Eigenvectors' signs are arbitrary, as with any eigensolver.

On a CUDA tensor :func:`jacobi_eigh` launches the kernel on the current
stream of the tensor's device, reads nothing back, and raises if the
launch is refused; on a CPU tensor it runs :func:`jacobi_eigh_plain`, the
same arithmetic in plain torch.  Nothing falls back from one to the
other.  Each launch adds one to the tracer's ``jacobi_eigh.launches``
counter (:func:`quemb_tpu_torch.utils.profiling.count`).
"""

from __future__ import annotations

import ctypes

import torch

from quemb_tpu_torch.ops import cuda_build
from quemb_tpu_torch.utils.profiling import count

#: the largest order the kernel takes: A and V, 64 x 65 doubles each, fill
#: 66,560 bytes of shared memory
MAX_N = 64
#: a matrix stops once off(A) <= TOL * ||A||_F at the end of a sweep
TOL = 1e-15
#: sweeps a matrix may take at most.  Octane's fragment Fock matrices
#: take 7-8 and their DIIS matrices 1-8 (quadratic convergence); a tight
#: cluster of eigenvalues converges linearly, and an exactly threefold
#: degenerate spectrum at n = 64 takes 30-40.
MAX_SWEEPS = 50

_SRC = cuda_build.CSRC / "jacobi_eigh.cu"
_LIB = None


def build_library() -> dict:
    """Compile the kernel unless the hashed library is already built
    (:func:`quemb_tpu_torch.ops.cuda_build.build`)."""
    return cuda_build.build(_SRC)


def _library():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build_library()["path"])
        fn = lib.jacobi_eigh_f64
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        attrs = lib.jacobi_eigh_attributes
        attrs.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
        attrs.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def kernel_attributes(device=None) -> dict:
    """The loaded kernel's registers a thread, local-memory (spill) bytes
    a thread and static shared bytes a block, on ``device`` (CUDA's
    ``cudaFuncGetAttributes``): what a build that was already cached no
    longer prints."""
    vals = [ctypes.c_int() for _ in range(3)]
    with torch.cuda.device(device):
        rc = _library().jacobi_eigh_attributes(*map(ctypes.byref, vals))
    if rc != 0:
        raise RuntimeError(f"jacobi_eigh attributes: CUDA error {rc}")
    return dict(zip(("registers", "local_bytes", "static_smem_bytes"),
                    (v.value for v in vals)))


def _next_slot(s: int, k: int) -> int:
    """The slot that the index in slot ``s`` moves to after a step, for
    ``k`` pairs (the kernel's ``next_slot``)."""
    if s == 0 or k == 1:
        return s
    if s % 2 == 0:
        return s + 2 if s + 2 < 2 * k else 2 * k - 1
    return s - 2 if s > 1 else 2


def round_robin(m: int) -> list[tuple[list[int], list[int]]]:
    """The m - 1 steps of a sweep over an even order m: each step's pairs
    (p[i], q[i]), disjoint and covering 0..m-1, every pair once a sweep.

    Pair i of a step holds the indices in slots 2i and 2i + 1; between
    steps slot 0 keeps its index and the others move one place round a
    cycle (:func:`_next_slot`), so after m - 1 steps every index is back
    in its own slot.
    """
    k = m // 2
    slot = list(range(m))  # slot -> index
    steps = []
    for _ in range(m - 1):
        steps.append((slot[0::2], slot[1::2]))
        moved = [0] * m
        for s in range(m):
            moved[_next_slot(s, k)] = slot[s]
        slot = moved
    assert slot == list(range(m))
    return steps


def jacobi_eigh_plain(A: torch.Tensor):
    """The kernel's arithmetic in plain torch (the reference it is held to).

    ``A`` float64 [..., n, n].  Returns (w [..., n] ascending,
    V [..., n, n] with eigenvectors in the columns, sweeps [...] int32).
    Lanes that stop early are frozen, as the kernel's blocks stop alone.
    """
    *batch, n, _ = A.shape
    dt, dev = A.dtype, A.device
    A = A.reshape(-1, n, n)
    nb, m = A.shape[0], n + n % 2
    a = torch.zeros((nb, m, m), dtype=dt, device=dev)
    a[:, :n, :n] = torch.tril(A) + torch.tril(A, -1).transpose(1, 2)
    v = torch.eye(m, dtype=dt, device=dev).repeat(nb, 1, 1)
    offmask = ~torch.eye(m, dtype=torch.bool, device=dev)
    norm2 = (a * a).sum((1, 2))
    sweeps = torch.zeros(nb, dtype=torch.int32, device=dev)

    def converged():
        off2 = torch.where(offmask, a * a, 0.0).sum((1, 2))
        return off2 <= TOL * TOL * norm2

    finite = torch.isfinite(norm2)
    active = finite & ~converged()
    steps = [(torch.tensor(p, device=dev), torch.tensor(q, device=dev))
             for p, q in round_robin(m)]
    while bool(active.any()):
        for p, q in steps:
            app, aqq, apq = a[:, p, p], a[:, q, q], a[:, p, q]
            d, e = aqq - app, 2.0 * apq
            on = active[:, None] & (e != 0)
            t = torch.where(d >= 0, e, -e) / (d.abs() + torch.hypot(d, e))
            t = torch.where(on, t, 0.0)
            c = torch.rsqrt(1.0 + t * t)
            s = t * c
            # A <- J^T A J: rows, then columns, then the 2x2 diagonal blocks
            ap, aq = a[:, p, :], a[:, q, :]
            a[:, p, :] = c[..., None] * ap - s[..., None] * aq
            a[:, q, :] = s[..., None] * ap + c[..., None] * aq
            ap, aq = a[:, :, p], a[:, :, q]
            a[:, :, p] = ap * c[:, None] - aq * s[:, None]
            a[:, :, q] = ap * s[:, None] + aq * c[:, None]
            a[:, p, p] = app - t * apq
            a[:, q, q] = aqq + t * apq
            a[:, p, q] = 0.0
            a[:, q, p] = 0.0
            # V <- V J
            vp, vq = v[:, :, p], v[:, :, q]
            v[:, :, p] = vp * c[:, None] - vq * s[:, None]
            v[:, :, q] = vp * s[:, None] + vq * c[:, None]
        sweeps += active.to(torch.int32)
        active = active & ~converged() & (sweeps < MAX_SWEEPS)
    d = torch.diagonal(a, dim1=1, dim2=2)[:, :n]
    w, order = torch.sort(d, dim=1, stable=True)
    V = torch.gather(v[:, :n, :n], 2, order[:, None, :].expand(nb, n, n))
    nan = ~finite
    w = torch.where(nan[:, None], float("nan"), w)
    V = torch.where(nan[:, None, None], float("nan"), V)
    return (w.reshape(*batch, n), V.reshape(*batch, n, n),
            sweeps.reshape(batch))


def _check(A: torch.Tensor) -> None:
    if A.dtype != torch.float64:
        raise TypeError(f"jacobi_eigh takes float64, got {A.dtype}")
    if A.dim() < 2 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"A must be [..., n, n], got {tuple(A.shape)}")
    if A.shape[-1] > MAX_N:
        raise ValueError(f"n={A.shape[-1]} exceeds the kernel's {MAX_N}")


def jacobi_eigh(A: torch.Tensor):
    """Eigenvalues ascending and eigenvectors in the columns of symmetric
    float64 [..., n, n] matrices, n <= :data:`MAX_N`, read from the lower
    triangle.  Returns (w [..., n], V [..., n, n], sweeps [...] int32).

    A CPU tensor takes the plain version; a CUDA tensor is solved by one
    kernel launch on the current stream of its device, without
    synchronising, or raises.  A launch counts ``jacobi_eigh.launches``.
    """
    _check(A)
    if A.device.type == "cpu":
        return jacobi_eigh_plain(A)
    if A.device.type != "cuda":
        raise ValueError(f"no Jacobi eigh kernel for device {A.device}")
    *batch, n, _ = A.shape
    A3 = A.reshape(-1, n, n).contiguous()
    nb = A3.shape[0]
    w = torch.empty((nb, n), dtype=A.dtype, device=A.device)
    V = torch.empty((nb, n, n), dtype=A.dtype, device=A.device)
    sweeps = torch.empty(nb, dtype=torch.int32, device=A.device)
    if nb and n:
        with torch.cuda.device(A.device):
            stream = torch.cuda.current_stream(A.device).cuda_stream
            rc = _library().jacobi_eigh_f64(
                A3.data_ptr(), w.data_ptr(), V.data_ptr(), sweeps.data_ptr(),
                nb, n, MAX_SWEEPS, TOL, stream,
            )
        if rc != 0:
            raise RuntimeError(f"jacobi_eigh kernel: CUDA error {rc}")
        count("jacobi_eigh.launches")
    return (w.reshape(*batch, n), V.reshape(*batch, n, n),
            sweeps.reshape(batch))
