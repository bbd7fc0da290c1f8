"""Screened sparse-DF fragment ERIs, f32 tier, through the Hopper kernel.

JAX counterpart: ``quemb_tpu/ops/sparse_df.py:SparseDF``.  This port takes
the ``tier="f32-pallas"`` path only, the one that runs the repository's
screened first-transform kernel.  The f64 banded and union-gather tiers
and ``OnFlySparseDF`` are ROADMAP A13 (``BE`` raises for them).

Per fragment: the per-MO reachability screen (AO nu feeds MO i only if
(S_abs |TA|)[nu, i] >= ``mo_eps``, reference ``_get_AO_per_MO``) zeroes the
unreachable entries of TA; the first quarter transform runs in the CUDA
kernel of :mod:`quemb_tpu_torch.ops.screened_df` over the 16-AO blocks of
the union reach, skipping (never reading) the other blocks of the factor;
the second transform over the exact TA, the (ij) symmetrisation that keeps
the one-sided screen's permutational symmetry, and the Gram product are
f32 ``torch.matmul`` in full f32 (no TF32).
"""

from __future__ import annotations

import numpy as np
import torch

from quemb_tpu_torch.ops.screened_df import ScreenedDFFactor
from quemb_tpu_torch.ops.screening import ao_reach_per_fragment, approx_S_abs


class SparseDF:
    """Screened DF transformer over a precomputed factor (the f32 tier,
    ``tier="f32-pallas"`` of the JAX package).

    ``mo_eps`` is the per-MO reachability threshold (reference
    ``MO_coeff_epsilon``).
    """

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "SparseDF from an auxiliary basis needs the integral engine"
            " (ROADMAP A11/A13); use SparseDF.from_factor"
        )

    @classmethod
    def from_factor(
        cls,
        mol,
        B: np.ndarray,
        *,
        mo_eps: float = 1.0e-5,
        device: torch.device,
    ) -> "SparseDF":
        """Screened transforms over the whitened factor B [naux, nao, nao]
        (eri ~ B^T B), held once on ``device`` in f32."""
        self = cls.__new__(cls)
        self.mol = mol
        self.mo_eps = mo_eps
        self.device = device
        self.S_abs = approx_S_abs(mol)
        self.last_reach_fraction: float | None = None
        self.factor = ScreenedDFFactor(B, device)
        return self

    def reach(self, TA: np.ndarray) -> np.ndarray:
        return ao_reach_per_fragment(self.S_abs, TA, eps=self.mo_eps)

    def screen(self, TA: np.ndarray):
        """Per-MO screen of ``TA``: (TA_eff, union reach).

        TA_eff zeroes TA[nu, i] where (S_abs |TA|)[nu, i] < mo_eps; the
        union reach marks the AOs that feed any orbital.
        """
        M = self.S_abs @ np.abs(TA) >= self.mo_eps
        return np.where(M, TA, 0.0), M.any(axis=1)

    def fragment_eri_f32(self, TA: np.ndarray) -> torch.Tensor:
        """Screened f32 fragment ERI [nemb]^4 (returned as f64 on the
        device).  The first transform is the kernel; the rest is f32
        matmul."""
        if (
            self.device.type == "cuda"
            and torch.get_float32_matmul_precision() != "highest"
        ):
            raise RuntimeError(
                "the f32 tier needs full-f32 matmuls: "
                "torch.get_float32_matmul_precision() must be 'highest'"
            )
        TA_eff, union = self.screen(TA)
        self.last_reach_fraction = float(union.sum()) / self.mol.nao
        Bi = self.factor.first_transform(TA_eff, union)  # [naux, nao, nemb]
        TA32 = torch.as_tensor(
            np.asarray(TA, np.float32), device=self.device
        )
        Bij = Bi.transpose(1, 2) @ TA32  # [naux, nemb, nemb]
        Bij = 0.5 * (Bij + Bij.transpose(1, 2))
        naux, nemb, _ = Bij.shape
        Bf = Bij.reshape(naux, nemb * nemb)
        eri = Bf.T @ Bf
        return eri.to(torch.float64).reshape(nemb, nemb, nemb, nemb)

    def transform_all(self, TAs: list[np.ndarray]) -> list[torch.Tensor]:
        """Screened transforms for every fragment, one kernel launch each."""
        out, fracs = [], []
        for TA in TAs:
            out.append(self.fragment_eri_f32(TA))
            fracs.append(self.last_reach_fraction)
        self.last_reach_fraction = float(np.mean(fracs)) if fracs else None
        return out
