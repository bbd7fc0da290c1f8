"""MP2 fragment solver with unrelaxed RDMs (reference solve_mp2 path).

JAX counterpart: ``quemb_tpu/solvers/mp2.py``.  The reference uses pyscf's
``mp.MP2`` and its ``make_rdm1``/``make_rdm2`` (molbe/solver.py:312-316,
781).  Note that in the reference the MP2 2-RDM is used as returned by
pyscf (mean-field part included) even in the cumulant energy path - we
mirror that behavior for parity.

Everything here is torch on the device of its operands, and every function
takes any number of leading batch axes (a bucket of fragments), where the
JAX module works on one fragment in host numpy.
"""

from __future__ import annotations

import torch

from quemb_tpu_torch.ops.eri_transform import batched_mo_eri


def mp2_amplitudes(eri_mo, moe, nsocc: int):
    """t2[..., i,j,a,b] = (ia|jb) / (e_i + e_j - e_a - e_b), and the MP2
    correlation energy [...]."""
    no = nsocc
    ovov = eri_mo[..., :no, no:, :no, no:]  # (ia|jb)
    eo = moe[..., :no]
    ev = moe[..., no:]
    D = (
        eo[..., :, None, None, None]
        + eo[..., None, :, None, None]
        - ev[..., None, None, :, None]
        - ev[..., None, None, None, :]
    )
    K = ovov.transpose(-3, -2)  # [i,j,a,b]
    t2 = K / D
    e_mp2 = (t2 * (2.0 * K - K.transpose(-4, -3))).sum((-4, -3, -2, -1))
    return t2, e_mp2


def _occ_projector(no: int, nmo: int, like: torch.Tensor) -> torch.Tensor:
    occ = like.new_zeros(nmo)
    occ[:no] = 1.0
    return torch.diag(occ)


def add_mean_field_rdm2(dm2, dm1c, no: int):
    """Add to a correlation 2-RDM [..., nmo^4] its mean-field part and the
    coupling of the occupied space to the correlation 1-RDM ``dm1c``
    [..., nmo, nmo] (pyscf's ``_make_rdm2`` with ``with_dm1=True``, in
    broadcast form)."""
    Iocc = _occ_projector(no, dm1c.shape[-1], dm1c)
    dm2 = dm2 + 2.0 * torch.einsum("pq,...rs->...pqrs", Iocc, dm1c)
    dm2 = dm2 + 2.0 * torch.einsum("pq,...rs->...rspq", Iocc, dm1c)
    dm2 = dm2 - torch.einsum("qr,...ps->...pqrs", Iocc, dm1c)
    dm2 = dm2 - torch.einsum("ps,...rq->...pqrs", Iocc, dm1c)
    dm2 = dm2 + 4.0 * torch.einsum("pq,rs->pqrs", Iocc, Iocc)
    dm2 = dm2 - 2.0 * torch.einsum("ps,qr->pqrs", Iocc, Iocc)
    return dm2


def _rdm1_corr_mp2(t2, nmo: int):
    no = t2.shape[-4]
    L2 = 2.0 * t2 - t2.transpose(-2, -1)
    dm1c = t2.new_zeros(t2.shape[:-4] + (nmo, nmo))
    dm1c[..., :no, :no] = -2.0 * torch.einsum(
        "...ikab,...jkab->...ij", t2, L2
    )
    dm1c[..., no:, no:] = 2.0 * torch.einsum(
        "...ijac,...ijbc->...ab", t2, L2
    )
    return dm1c


def make_rdm1_mp2(t2, nmo: int):
    """Unrelaxed MP2 1-RDM (pyscf mp2.make_rdm1 semantics)."""
    no = t2.shape[-4]
    return _rdm1_corr_mp2(t2, nmo) + 2.0 * _occ_projector(no, nmo, t2)


def make_rdm2_mp2(t2, nmo: int):
    """Unrelaxed MP2 2-RDM incl. mean-field part (pyscf make_rdm2)."""
    no = t2.shape[-4]
    dm2 = t2.new_zeros(t2.shape[:-4] + (nmo,) * 4)
    # correlation ovov blocks: dm2[i,a,j,b] = 2 t2[ijab] - t2[jiab]
    gamma = (2.0 * t2 - t2.transpose(-4, -3)).transpose(-3, -2)  # [i,a,j,b]
    dm2[..., :no, no:, :no, no:] = gamma
    dm2[..., no:, :no, no:, :no] = gamma.transpose(-4, -3).transpose(-2, -1)
    return add_mean_field_rdm2(dm2, _rdm1_corr_mp2(t2, nmo), no)


def solve_mp2(fr, C, moe, with_dm2=True, use_cumulant=True):
    """MP2 RDMs of one fragment from its orbitals ``C`` and their energies
    ``moe`` (arrays or tensors); returned on the device of ``fr.eri``."""
    eri = fr.eri
    C = torch.as_tensor(C, dtype=eri.dtype, device=eri.device)
    moe = torch.as_tensor(moe, dtype=eri.dtype, device=eri.device)
    eri_mo = batched_mo_eri(eri[None], C[None])[0]
    t2, _ = mp2_amplitudes(eri_mo, moe, fr.nsocc)
    nmo = C.shape[1]
    rdm1 = make_rdm1_mp2(t2, nmo)
    rdm2 = make_rdm2_mp2(t2, nmo) if with_dm2 else None
    return rdm1, rdm2
