"""Fragment energy assembly (cumulant expression).

Dense-tensor reformulation of the reference ``molbe/helper.py:get_frag_energy``
and ``molbe/pfrag.py:update_ebe_hf``: the packed lower-triangular ERI loops of
the reference reduce, for a dense chemist-notation ERI, to plain contractions
over the embedding rows.

JAX counterpart: ``quemb_tpu/embed/energy.py``.  Each function works on one
fragment, on the device of its ``fr.eri``; the molecular driver batches the
same rows over fragments (``solvers/dispatch.py:_batched_energy_rows``,
``api.py:_init_bucket_device``), the periodic driver (``kbe/pbe.py``) calls
these.
"""

from __future__ import annotations

import numpy as np
import torch


def _on(eri: torch.Tensor, *arrays):
    return (torch.as_tensor(a, dtype=eri.dtype, device=eri.device)
            for a in arrays)


def _hf_energy_rows(h1, veff, eri, rdm_hf):
    """Per-row HF energy contributions (e1, ec, e2) over all rows."""
    e1 = 2.0 * (h1 * rdm_hf).sum(-1)
    ec = (veff * rdm_hf).sum(-1)
    J = torch.einsum("ijkl,kl->ij", eri, rdm_hf)
    K = torch.einsum("ijkl,jl->ik", eri, rdm_hf)
    e2 = 2.0 * (J * rdm_hf).sum(-1) - (K * rdm_hf).sum(-1)
    return e1, ec, e2


def fragment_hf_energy(fr) -> float:
    """HF-in-HF energy contribution of one fragment (update_ebe_hf)."""
    h1, veff, C = _on(fr.eri, fr.h1, fr.veff, fr._mo_coeffs)
    C = C[:, : fr.nsocc]
    e1, ec, e2 = _hf_energy_rows(h1, veff, fr.eri, C @ C.T)
    w, idx = fr.weight_and_relAO_per_center
    return float(w * (e1 + ec + e2)[list(idx)].sum())


def _emb_rdm2(mo, rdm2_mo):
    """0.5 * rdm2_mo with all four indices taken to the embedding basis."""
    out = 0.5 * rdm2_mo
    for _ in range(4):
        # contract the leading MO index, append the embedding index last
        out = torch.tensordot(out, mo, dims=([0], [1]))
    return out


def _frag_energy_rows(mo, h1, veff0, eri, rdm1_mo, rdm2_mo, nsocc_mask):
    """Cumulant per-row energies (e1, ec, e2) over all embedding rows.

    rdm1_mo: correlated 1-RDM in the fragment-MO basis (trace = 2*nsocc).
    rdm2_mo: cumulant-only 2-RDM in the fragment-MO basis (pyscf convention,
        E2 = 0.5 * sum((ij|kl) * Gamma[ijkl])).
    nsocc_mask: [nmo] 1.0 for occupied fragment MOs.
    """
    rdm1_emb = mo @ (0.5 * rdm1_mo) @ mo.T
    hf_1rdm = (mo * nsocc_mask[None, :]) @ mo.T
    delta = 2.0 * (rdm1_emb - hf_1rdm)
    e1 = (h1 * delta).sum(-1)
    ec = (veff0 * delta).sum(-1)
    e2 = (_emb_rdm2(mo, rdm2_mo) * eri).sum((1, 2, 3))
    return e1, ec, e2


def _frag_energy_rows_noncumulant(mo, h1, veff, eri, rdm1_mo, rdm2_mo):
    """Non-cumulant per-row energies (reference helper.py:295-299):
    full 1-RDM against h1 and the environment veff, full 2-RDM against
    the fragment ERI."""
    rdm1_emb = mo @ (0.5 * rdm1_mo) @ mo.T
    e1 = 2.0 * (h1 * rdm1_emb).sum(-1)
    ec = (veff * rdm1_emb).sum(-1)
    e2 = (_emb_rdm2(mo, rdm2_mo) * eri).sum((1, 2, 3))
    return e1, ec, e2


def fragment_energy(fr, rdm1_mo, rdm2_mo, use_cumulant: bool = True):
    """Correlated fragment energy triple [e1, e2, ec] (get_frag_energy)."""
    eri = fr.eri
    if use_cumulant:
        nmo = np.shape(fr.mo_coeffs)[1]
        mask = np.zeros(nmo)
        mask[: fr.nsocc] = 1.0
        e1, ec, e2 = _frag_energy_rows(
            *_on(eri, fr.mo_coeffs, fr.h1, fr.veff0), eri,
            *_on(eri, rdm1_mo, rdm2_mo, mask),
        )
    else:
        e1, ec, e2 = _frag_energy_rows_noncumulant(
            *_on(eri, fr.mo_coeffs, fr.h1, fr.veff), eri,
            *_on(eri, rdm1_mo, rdm2_mo),
        )
    w, idx = fr.weight_and_relAO_per_center
    idx = list(idx)
    return [float(w * x[idx].sum()) for x in (e1, e2, ec)]
