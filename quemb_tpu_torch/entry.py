"""Entry points: one batched solve step, and octane BE2 on a fragment mesh.

JAX counterpart: ``__graft_entry__.py``.  ``entry()`` returns the solve
step that every objective evaluation runs on a bucket: the batched
fragment SCF, the MO-ERI transform and closed-shell CCSD
(:func:`~quemb_tpu_torch.solvers.rccsd.rccsd_batched`, which shards over
the active mesh), with example inputs.  ``dryrun_multichip(n)`` runs one
full objective evaluation of octane BE2 on an ``n``-shard fragment mesh
over the visible cards.  Both run on a card unless the caller names the
CPU.

    python3 -m quemb_tpu_torch.entry [n_shards]
"""

from __future__ import annotations

import os

import numpy as np
import torch

from quemb_tpu_torch.utils.device import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OCTANE_FIXTURE = os.path.join(ROOT, "fixtures", "octane_sto3g_hf.npz")
OCTANE_XYZ = os.path.join(ROOT, "tests", "data", "xyz", "octane.xyz")


def _example_bucket(nf: int, nemb: int, nsocc: int, seed: int = 0):
    """Synthetic but physical fragment bucket (h, eri PSD, dm0
    idempotent), as numpy arrays."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((nf, nemb, nemb)) * 0.1
    h = 0.5 * (h + h.transpose(0, 2, 1))
    h += np.arange(nemb)[None] * np.eye(nemb)[None]
    A = rng.standard_normal((nf, nemb * nemb, nemb * nemb)) * 0.05
    eri = np.einsum("fij,fkj->fik", A, A).reshape(
        nf, nemb, nemb, nemb, nemb
    )
    eri = 0.5 * (eri + eri.transpose(0, 2, 1, 3, 4))
    eri = 0.5 * (eri + eri.transpose(0, 1, 2, 4, 3))
    eri = 0.5 * (eri + eri.transpose(0, 3, 4, 1, 2))
    dm0 = np.zeros((nf, nemb, nemb))
    dm0[:, np.arange(nsocc), np.arange(nsocc)] = 2.0
    return h, eri, dm0


def _solve_step(nsocc: int):
    from quemb_tpu_torch.embed.fragment_scf import rhf_orthonormal_batched
    from quemb_tpu_torch.ops.eri_transform import batched_mo_eri
    from quemb_tpu_torch.solvers.rccsd import rccsd_batched

    def step(h_b, eri_b, dm0_b):
        moe, C, e_el, _ = rhf_orthonormal_batched(h_b, eri_b, nsocc, dm0_b)
        t1, t2, _, delta = rccsd_batched(batched_mo_eri(eri_b, C), moe,
                                         nsocc)
        C_occ = C[:, :, :nsocc]
        return t1, t2, e_el, C_occ @ C_occ.transpose(1, 2), delta

    return step


def entry(device=None):
    """(step, example_args): ``step(h_b, eri_b, dm0_b)`` returns (t1, t2,
    e_el, rdm1_emb, delta) for a bucket of 4 fragments of width 8 with 2
    occupied orbitals, on ``device`` (default: the card)."""
    device = resolve_device(device, "entry")
    nf, nemb, nsocc = 4, 8, 2
    args = tuple(torch.as_tensor(a, device=device)
                 for a in _example_bucket(nf, nemb, nsocc))
    return _solve_step(nsocc), args


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Octane BE2 (STO-3G, chemgen) from the committed RHF fixture on an
    ``n_devices``-shard fragment mesh: over the visible cards in turn
    (round robin when ``n_devices`` exceeds them), or over ``n_devices``
    CPU shards with ``device="cpu"``.  Builds the BE, runs one full
    objective evaluation (``be_func`` with ``eeval=True``), prints a line
    and returns its facts: the devices the fragments were solved on, the
    error norm, E_corr and the fragment energies.  The mesh in place
    before the call is restored."""
    from quemb_tpu_torch import BE, fragmentate
    from quemb_tpu_torch.chem.scf import load_fixture
    from quemb_tpu_torch.parallel.mesh import get_mesh, make_fragment_mesh, \
        set_mesh
    from quemb_tpu_torch.solvers.dispatch import be_func

    device = resolve_device(device, "dryrun_multichip")
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        devices = [torch.device("cuda", k % cards) for k in range(n_devices)]
    else:
        devices = [device] * n_devices
    mf = load_fixture(OCTANE_FIXTURE, OCTANE_XYZ)
    fobj = fragmentate(mf.mol, n_BE=2, frag_type="chemgen",
                       print_frags=False)
    be = BE(mf, fobj, device=device)
    before = get_mesh()
    set_mesh(make_fragment_mesh(devices))
    try:
        ernorm, _, (ecorr, _) = be_func(be.pot, be.fragments, be.Nocc,
                                        "CCSD", eeval=True, return_vec=True)
    finally:
        set_mesh(before)
    e_el = np.asarray([fr.ebe for fr in be.fragments])
    if not np.all(np.isfinite(e_el)):
        raise RuntimeError(f"dryrun_multichip({n_devices}): e_el {e_el}")
    used = sorted({str(fr.rdm1__.device) for fr in be.fragments})
    print(f"dryrun_multichip({n_devices}): OK - octane BE2 on {len(used)}"
          f" device(s) {used}, e_el={e_el[:2]}, Ecorr={ecorr:.8f},"
          f" |err|={ernorm:.2e}")
    return dict(devices=used, error_norm=float(ernorm), ecorr=float(ecorr),
                e_el=e_el.tolist())


if __name__ == "__main__":
    import sys

    fn, args = entry()
    print("entry(): e_el =", fn(*args)[2].cpu().numpy())
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1
                     else torch.cuda.device_count())
