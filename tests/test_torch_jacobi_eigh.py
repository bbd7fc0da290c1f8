"""The batched Jacobi eigensolver (``quemb_tpu_torch/ops/jacobi_eigh.py``
and its CUDA kernel ``csrc/jacobi_eigh.cu``) and the routing of
``ops.linalg.eigh``.

On the CPU the plain version is held to ``torch.linalg.eigh`` at n in
{1, 2, 9, 40, 41, 57, 64}, on degenerate spectra, on a pad-deflated Fock
of the fragment SCF and on its bordered, indefinite DIIS matrix with an
eigenvalue near 1e-14.  Bars, relative to ``||A||_F``: eigenvalues 1e-12,
``||AV - V diag(w)||`` 1e-12; ``||V^T V - I||`` 1e-13 (largest entry).

The ``gpu`` tests hold the kernel to the plain version and the library on
the card, check that lanes are independent and that a NaN lane stays NaN,
check the routing by the tracer's counters, and run the H8 fragment-SCF
bucket on the kernel's route against the CPU.  Nothing here imports JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_jacobi_eigh.py
"""

import numpy as np
import pytest
import torch

import quemb_tpu_torch as qt
from quemb_tpu_torch.chem.mole import Mole
from quemb_tpu_torch.chem.scf import RHF
from quemb_tpu_torch.embed import fragment_scf as fs
from quemb_tpu_torch.ops import jacobi_eigh as je
from quemb_tpu_torch.ops import linalg
from quemb_tpu_torch.solvers.dispatch import _PAD_SHIFT, _pad_frag_op
from quemb_tpu_torch.utils import profiling

ORDERS = [1, 2, 9, 40, 41, 57, 64]
VAL_TOL = 1e-12   # eigenvalues and residual, relative to ||A||_F
ORTH_TOL = 1e-13  # largest entry of V^T V - I


def _sym(rng, nb, n):
    X = rng.standard_normal((nb, n, n))
    return torch.as_tensor(X + np.swapaxes(X, 1, 2))


def _degenerate(rng, nb, n):
    """Q diag(d) Q^T with d in three values (multiplicity about n / 3)."""
    out = []
    for _ in range(nb):
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        d = np.array([-1.5, 0.25, 2.0])[np.arange(n) % 3]
        out.append((Q * d) @ Q.T)
    return torch.as_tensor(np.stack(out))


def _check_decomposition(A, w, V, w_ref):
    """Eigenvalues against ``w_ref``, the residual, orthogonality and the
    order, each against its bar."""
    n = A.shape[-1]
    scale = torch.linalg.matrix_norm(A).clamp(min=1.0)[:, None]
    assert ((w - w_ref).abs() / scale).max() <= VAL_TOL
    res = torch.linalg.matrix_norm(A @ V - V * w[:, None, :])
    assert (res / scale[:, 0]).max() <= VAL_TOL
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    assert (V.transpose(1, 2) @ V - eye).abs().max() <= ORTH_TOL
    assert bool((w[:, 1:] >= w[:, :-1]).all())


def _projector(V, w, lo, hi):
    """Spectral projector onto the eigenvalues in (lo, hi)."""
    sel = ((w > lo) & (w < hi)).to(V.dtype)
    return (V * sel[:, None, :]) @ V.transpose(1, 2)


# ---- the plain version on the CPU


@pytest.mark.parametrize("m", [2, 4, 10, 42, 58, 64])
def test_round_robin_meets_each_pair_once(m):
    seen = []
    for p, q in je.round_robin(m):
        assert sorted(p + q) == list(range(m))
        seen += [tuple(sorted(pq)) for pq in zip(p, q)]
    assert len(seen) == len(set(seen)) == m * (m - 1) // 2


@pytest.mark.parametrize("n", ORDERS)
def test_plain_matches_library(n):
    A = _sym(np.random.default_rng(n), 3, n)
    w, V, sweeps = je.jacobi_eigh_plain(A)
    _check_decomposition(A, w, V, torch.linalg.eigh(A)[0])
    assert bool((sweeps <= 10).all())  # quadratic convergence
    assert bool((sweeps > 0).all()) == (n > 1)


@pytest.mark.parametrize("n", [9, 41, 64])
def test_plain_degenerate_spectrum(n):
    """Three eigenvalues of multiplicity about n / 3: clusters converge
    linearly, so this may take up to the cap, with the same bars."""
    A = _degenerate(np.random.default_rng(100 + n), 2, n)
    w, V, sweeps = je.jacobi_eigh_plain(A)
    wl, Vl = torch.linalg.eigh(A)
    _check_decomposition(A, w, V, wl)
    # the eigenspaces, not the vectors in them, are fixed
    for lo, hi in ((-2.0, 0.0), (0.0, 1.0), (1.0, 3.0)):
        P, Pl = _projector(V, w, lo, hi), _projector(Vl, wl, lo, hi)
        assert (P - Pl).abs().max() < 1e-12


def _recorded(monkeypatch, fn, *args):
    """The matrices that ``fn`` hands to the fragment SCF's eigh."""
    seen = []

    def record(A):
        seen.append(A.clone())
        return torch.linalg.eigh(A)

    monkeypatch.setattr(fs, "_eigh", record)
    out = fn(*args)
    return seen, out


def test_plain_on_pad_deflated_fock(monkeypatch):
    """A Fock with an occupied and two virtual bucket-merge pads, as
    ``_eigh_deflated`` hands it to eigh: the same eigenvalues and the same
    occupied density as the library."""
    rng = np.random.default_rng(7)
    n, nocc, po, pv = 40, 11, 1, 2
    F = rng.standard_normal((n, n)) * 0.1
    F = F + F.T + np.diag(np.linspace(-20.0, 3.0, n))
    Fp = _pad_frag_op(F, po, pv, diag_occ=-_PAD_SHIFT, diag_vir=_PAD_SHIFT)
    seen, (wl, Cl) = _recorded(monkeypatch, fs._eigh_deflated,
                               torch.as_tensor(Fp)[None])
    (A,) = seen
    assert A.abs().max() < 100.0  # the pads sit at the physical scale
    w, V, _ = je.jacobi_eigh_plain(A)
    _check_decomposition(A, w, V, wl)
    k = nocc + po
    D = V[..., :k] @ V[..., :k].transpose(1, 2)
    Dl = Cl[..., :k] @ Cl[..., :k].transpose(1, 2)
    assert (D - Dl).abs().max() < 1e-12


def test_plain_on_bordered_diis_matrix(monkeypatch):
    """The bordered, indefinite DIIS matrix of ``_diis_solve`` over a
    history of error vectors that are nearly dependent, with an
    eigenvalue near 1e-14."""
    rng = np.random.default_rng(11)
    m, nn = fs.DIIS_SPACE, 41 * 41
    base = rng.standard_normal((3, nn))
    err = (rng.standard_normal((m, 3)) @ base
           + 1e-7 * rng.standard_normal((m, nn)))
    err = torch.as_tensor(err)[None]
    fock = torch.as_tensor(rng.standard_normal((1, m, nn)))
    seen, _ = _recorded(monkeypatch, fs._diis_solve, err, fock,
                        torch.tensor([m]))
    (A,) = seen
    wl = torch.linalg.eigh(A)[0]
    assert bool((wl < 0).any()) and bool((wl > 0).any())
    assert wl.abs().min() < 1e-12
    w, V, sweeps = je.jacobi_eigh_plain(A)
    _check_decomposition(A, w, V, wl)
    assert int(sweeps.max()) < je.MAX_SWEEPS


def test_plain_nan_lane_leaves_others_alone():
    A = _sym(np.random.default_rng(3), 3, 9)
    A[1, 5, 2] = float("nan")  # the lower triangle is what is read
    w, V, sweeps = je.jacobi_eigh_plain(A)
    assert bool(torch.isnan(w[1]).all()) and bool(torch.isnan(V[1]).all())
    assert int(sweeps[1]) == 0
    for k in (0, 2):
        wk, Vk, _ = je.jacobi_eigh_plain(A[k:k + 1])
        assert torch.equal(w[k], wk[0]) and torch.equal(V[k], Vk[0])


def _counts(fn):
    names = ("eigh.kernel", "eigh.library", "syncs", "jacobi_eigh.launches")
    before = [profiling.total(k) for k in names]
    out = fn()
    return out, {k: profiling.total(k) - b for k, b in zip(names, before)}


def test_cpu_route_is_the_library():
    A = _sym(np.random.default_rng(5), 4, 41)
    (w, V), counts = _counts(lambda: linalg.eigh(A))
    wl, Vl = torch.linalg.eigh(A)
    assert torch.equal(w, wl) and torch.equal(V, Vl)
    assert counts == {"eigh.kernel": 0, "eigh.library": 4, "syncs": 1,
                      "jacobi_eigh.launches": 0}


def test_cpu_tensor_takes_plain_version_without_counting_a_launch():
    A = _sym(np.random.default_rng(7), 2, 9)
    (w, V, sweeps), counts = _counts(lambda: je.jacobi_eigh(A))
    wp, Vp, sweeps_p = je.jacobi_eigh_plain(A)
    assert torch.equal(w, wp) and torch.equal(V, Vp)
    assert torch.equal(sweeps, sweeps_p)
    assert counts["jacobi_eigh.launches"] == 0


# ---- the kernel on the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["random", "degenerate"])
@pytest.mark.parametrize("n", ORDERS)
def test_kernel_matches_plain_and_library(n, kind):
    cuda = _card()
    rng = np.random.default_rng(1000 + n)
    make = _sym if kind == "random" else _degenerate
    A = make(rng, 6, n).to(cuda)
    w, V, sweeps = je.jacobi_eigh(A)
    torch.cuda.synchronize()
    wp, _, sweeps_p = je.jacobi_eigh_plain(A)
    wl = torch.linalg.eigh(A)[0]
    _check_decomposition(A, w, V, wl)
    _check_decomposition(A, w, V, wp)
    if kind == "random":
        assert bool((sweeps <= 10).all())
        assert (sweeps - sweeps_p).abs().max() <= 1


@pytest.mark.gpu
def test_kernel_lanes_are_independent():
    cuda = _card()
    A = _sym(np.random.default_rng(21), 6, 41).to(cuda)
    w, V, _ = je.jacobi_eigh(A)
    for k in range(6):
        wk, Vk, _ = je.jacobi_eigh(A[k:k + 1])
        assert torch.equal(w[k], wk[0]) and torch.equal(V[k], Vk[0])


@pytest.mark.gpu
def test_nan_lane_stays_nan_on_the_card():
    """Straight into the kernel, and through ``_eigh_finite`` (which hands
    such a lane to it as the identity): the lane is NaN, the others are
    what they are alone."""
    cuda = _card()
    A = _sym(np.random.default_rng(23), 4, 41).to(cuda)
    A[2, 7, 3] = float("nan")
    for solve in (lambda X: je.jacobi_eigh(X)[:2], fs._eigh_finite):
        w, V = solve(A)
        assert bool(torch.isnan(w[2]).all()) and bool(torch.isnan(V[2]).all())
        for k in (0, 1, 3):
            wk, Vk = solve(A[k:k + 1])
            assert torch.equal(w[k], wk[0]) and torch.equal(V[k], Vk[0])


@pytest.mark.gpu
def test_kernel_on_a_side_stream():
    """The launch goes to the current stream, not the default one."""
    cuda = _card()
    A = _sym(np.random.default_rng(29), 6, 57).to(cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        w, V, _ = je.jacobi_eigh(A)
    side.synchronize()
    _check_decomposition(A, w, V, torch.linalg.eigh(A)[0])


@pytest.mark.gpu
@pytest.mark.parametrize("n, dtype, device, route", [
    (64, torch.float64, "cuda", "eigh.kernel"),
    (9, torch.float64, "cuda", "eigh.kernel"),
    (65, torch.float64, "cuda", "eigh.library"),
    (64, torch.float32, "cuda", "eigh.library"),
    (64, torch.float64, "cpu", "eigh.library"),
])
def test_routing_by_the_counters(n, dtype, device, route):
    _card()
    A = _sym(np.random.default_rng(n), 3, n).to(device=device, dtype=dtype)
    (w, V), counts = _counts(lambda: linalg.eigh(A))
    assert w.device.type == device and w.dtype == dtype
    other = ({"eigh.kernel", "eigh.library"} - {route}).pop()
    assert counts[route] == 3 and counts[other] == 0
    assert counts["syncs"] == (route == "eigh.library")
    assert counts["jacobi_eigh.launches"] == (route == "eigh.kernel")


@pytest.mark.gpu
def test_loaded_kernel_spills_nothing():
    """The loaded function's attributes, which a cached build no longer
    prints: registers within the launch bound's share, no local memory."""
    cuda = _card()
    attrs = je.kernel_attributes(cuda)
    assert 0 < attrs["registers"] <= 64
    assert attrs["local_bytes"] == 0


@pytest.fixture(scope="module")
def h8_bucket():
    """The H8 BE2 bucket of ``tests/test_torch_fragment_scf.py``, with the
    port's own mean field: six fragments' perturbed Fock matrices."""
    _card()
    atom = "\n".join(f"H 0 0 {i}." for i in range(8))
    mol = Mole(atom=atom, basis="sto-3g")
    mf = RHF(mol, conv_tol=1e-12, device="cpu")
    mf.kernel()
    fobj = qt.fragmentate(
        mol, n_BE=2, print_frags=False,
        additional_args=qt.ChemGenArgs(
            h_treatment="treat_H_like_heavy_atom"
        ),
    )
    frs = qt.BE(mf, fobj, device="cpu").fragments
    rng = np.random.default_rng(0)
    h = []
    for fr in frs:
        X = rng.standard_normal(fr.fock.shape) * 2e-2
        h.append(fr.fock + X + X.T)
    return (torch.as_tensor(np.stack(h)),
            torch.stack([fr.eri for fr in frs]).cpu(),
            torch.as_tensor(np.stack([fr.dm0 for fr in frs])),
            frs[0].nsocc)


@pytest.mark.gpu
def test_h8_fragment_scf_on_both_routes(h8_bucket):
    """The batched fragment SCF with the kernel (the card) and with the
    library (the CPU): orbital energies, densities and energies 1e-10."""
    cuda = _card()
    h, eri, dm0, nocc = h8_bucket
    out = {}
    for dev in ("cpu", cuda):
        args = (h.to(dev), eri.to(dev), nocc, dm0.to(dev))
        (e, C, e_el, it), counts = _counts(lambda: fs.rhf_orthonormal(*args))
        dm = 2.0 * C[..., :nocc] @ C[..., :nocc].transpose(1, 2)
        out[str(dev)] = [x.cpu() for x in (e, dm, e_el, it)], counts
    (e, dm, e_el, it), counts = out["cuda"]
    (e0, dm0_, e_el0, it0), counts0 = out["cpu"]
    assert counts["eigh.library"] == 0 and counts["eigh.kernel"] > 0
    assert counts0["eigh.kernel"] == 0
    assert bool((it0 > 3).all())
    assert (it - it0).abs().max() <= 2
    assert (e - e0).abs().max() < 1e-10
    assert (dm - dm0_).abs().max() < 1e-10
    assert (e_el - e_el0).abs().max() < 1e-10
