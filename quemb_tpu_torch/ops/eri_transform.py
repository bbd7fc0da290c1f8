"""AO -> embedding-basis integral transforms (reference mbe.py:1004 L4 layer).

JAX counterpart: ``quemb_tpu/ops/eri_transform.py``.  Four successive
quarter transforms per fragment against the dense AO ERI, batched over a
stack of fragments with equal embedding dimension.  This is the in-core
route wherever the AO ERI and the intermediates fit the device; the BE
driver takes the Cholesky-factor route of :mod:`quemb_tpu_torch.ops.df`
only where they do not (``api.BE._incore_via_cd``).
"""

from __future__ import annotations

import torch


def incore_transform(eri_ao: torch.Tensor, TA: torch.Tensor) -> torch.Tensor:
    """(mu nu|la si) -> (ij|kl) in the embedding basis defined by TA.

    eri_ao: [nao]*4 chemist notation; TA: [nao, nemb].
    """
    return incore_transform_batched(eri_ao, TA[None])[0]


def incore_transform_batched(
    eri_ao: torch.Tensor, TA_b: torch.Tensor
) -> torch.Tensor:
    """Batched transform for a stack of TAs [nf, nao, nemb]."""
    t = torch.einsum("pqrs,fpi->fiqrs", eri_ao, TA_b)
    t = torch.einsum("fiqrs,fqj->fijrs", t, TA_b)
    t = torch.einsum("fijrs,frk->fijks", t, TA_b)
    return torch.einsum("fijks,fsl->fijkl", t, TA_b)


def batched_mo_eri(eri_b: torch.Tensor, C_b: torch.Tensor) -> torch.Tensor:
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
