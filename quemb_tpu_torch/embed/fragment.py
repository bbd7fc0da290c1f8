"""Per-fragment embedding state and operations.

Mirrors the bookkeeping of the reference ``molbe/pfrag.py:Frags`` but holds
dense in-memory arrays (no HDF5 scratch on the hot path) and delegates all
heavy math to batched torch ops.

JAX counterpart: ``quemb_tpu/embed/fragment.py``, of which this is a copy (it
holds no jax).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field

import numpy as np

from quemb_tpu_torch.embed.schmidt import schmidt_decomposition
from quemb_tpu_torch.utils.typing import (
    FragmentIdx,
    GlobalAOIdx,
    RelAOIdx,
    RelAOIdxInRef,
)

# Monotonic id for device-cache keys: unlike ``id()``, never reused after
# garbage collection (see solvers/dispatch._bucket_dev).
_FRAGMENT_TOKENS = itertools.count()


@dataclass
class Fragment:
    """State of one BE fragment (embedding basis, Hamiltonian, potentials)."""

    ifrag: FragmentIdx
    AO_in_frag: list[GlobalAOIdx]
    AO_per_edge: list[list[GlobalAOIdx]]
    ref_frag_idx_per_edge: list[FragmentIdx]
    relAO_per_edge: list[list[RelAOIdx]]
    relAO_in_ref_per_edge: list[list[RelAOIdxInRef]]
    weight_and_relAO_per_center: tuple[float, list[RelAOIdx]]
    relAO_per_origin: list[RelAOIdx]

    n_frag: int = field(init=False)

    # set during initialization
    TA: np.ndarray | None = None          # [nao_full, nemb]
    TA_lo_eo: np.ndarray | None = None
    n_f: int = 0
    n_b: int = 0
    nao: int = 0                          # embedding dimension nemb
    h1: np.ndarray | None = None          # [nemb, nemb]
    eri: np.ndarray | None = None         # [nemb]*4 (chemist)
    fock: np.ndarray | None = None
    veff: np.ndarray | None = None
    veff0: np.ndarray | None = None
    heff: np.ndarray | None = None
    nsocc: int = 0
    _mo_coeffs: np.ndarray | None = None  # fragment-HF orbitals (initial)
    mo_coeffs: np.ndarray | None = None   # current (with matching potential)
    mo_energy: np.ndarray | None = None
    dm0: np.ndarray | None = None
    _rdm1: np.ndarray | None = None       # correlated 1-RDM in emb basis (x0.5)
    rdm1__: np.ndarray | None = None
    rdm2__: np.ndarray | None = None
    ebe_hf: float = 0.0
    ebe: float = 0.0
    udim: int | None = None
    unitcell_nkpt: float = 1.0

    def __post_init__(self):
        self.n_frag = len(self.AO_in_frag)
        self._cache_token = next(_FRAGMENT_TOKENS)

    @classmethod
    def from_frag_part(cls, fobj, I: int) -> "Fragment":
        return cls(
            ifrag=I,
            AO_in_frag=fobj.AO_per_frag[I],
            AO_per_edge=fobj.AO_per_edge_per_frag[I],
            ref_frag_idx_per_edge=fobj.ref_frag_idx_per_edge_per_frag[I],
            relAO_per_edge=fobj.relAO_per_edge_per_frag[I],
            relAO_in_ref_per_edge=fobj.relAO_in_ref_per_edge_per_frag[I],
            weight_and_relAO_per_center=fobj.weight_and_relAO_per_center_per_frag[I],
            relAO_per_origin=fobj.relAO_per_origin_per_frag[I],
        )

    # ------------------------------------------------------------- Schmidt
    def sd(self, lao, lmo, nocc: int, thr_bath: float, norb=None) -> None:
        self.TA_lo_eo, self.n_f, self.n_b = schmidt_decomposition(
            np.asarray(lmo)[:, :nocc],
            self.AO_in_frag,
            thr_bath=thr_bath,
            norb=norb,
        )
        self.TA = np.asarray(lao) @ self.TA_lo_eo
        self.nao = self.TA.shape[1]

    # ------------------------------------------- matching-potential update
    def update_heff(self, u, cout=None, only_chem: bool = False) -> None:
        """Build heff from the potential vector (reference pfrag.py:290)."""
        heff_ = np.zeros_like(self.h1)
        if cout is None:
            cout = self.udim

        edge_set = {i for sub in self.relAO_per_edge for i in sub}
        for i in range(self.n_frag):
            if i not in edge_set:
                heff_[i, i] -= u[-1]

        if not only_chem:
            for edge in self.relAO_per_edge:
                for j in range(len(edge)):
                    for k in range(j, len(edge)):
                        heff_[edge[j], edge[k]] = u[cout]
                        heff_[edge[k], edge[j]] = u[cout]
                        cout += 1
        self.heff = heff_

    def set_udim(self, cout: int) -> int:
        for edge in self.relAO_per_edge:
            n = len(edge)
            cout += n * (n + 1) // 2
        return cout

    @property
    def n_pot(self) -> int:
        """Number of matching-potential parameters owned by this fragment."""
        return sum(
            len(e) * (len(e) + 1) // 2 for e in self.relAO_per_edge
        )
