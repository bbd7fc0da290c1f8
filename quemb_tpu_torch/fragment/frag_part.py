"""The FragPart data contract: per-fragment AO index bookkeeping.

Field names and semantics mirror the reference contract
(``molbe/autofrag.py:38-206 FragPart``) so that downstream embedding code and
tests can speak the same language.  Implementation is a plain dataclass over
Python lists; the padded/stacked array form used on TPU is derived from this
in :mod:`quemb_tpu_torch.embed.fragments`.

JAX counterpart: ``quemb_tpu/fragment/frag_part.py``, of which this is a copy (it
holds no jax).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING

from quemb_tpu_torch.utils.typing import (  # noqa: F401 (documented contract)
    FragmentIdx,
    GlobalAOIdx,
    MotifIdx,
    OriginIdx,
    RelAOIdx,
    RelAOIdxInRef,
)

if TYPE_CHECKING:
    from quemb_tpu_torch.chem.mole import Mole


@dataclass
class FragPart:
    """Result of a BE fragmentation.

    All ``*_per_frag`` fields are lists over fragments.  "rel" AO indices are
    relative to the own fragment's AO list unless the name says ``in_ref``
    (relative to the fragment in which the edge is a center).
    """

    mol: "Mole"
    frag_type: str
    n_BE: int

    #: Global AO indices of all atoms in each fragment, ordered by the atoms
    #: in the fragment (origin, centers, edges; H's following their motif).
    AO_per_frag: list[list[GlobalAOIdx]]
    #: Global AO indices per edge per fragment.
    AO_per_edge_per_frag: list[list[list[GlobalAOIdx]]]
    #: For each edge: index of the fragment where this edge is a center.
    ref_frag_idx_per_edge_per_frag: list[list[FragmentIdx]]
    #: AO indices per edge, relative to the own fragment.
    relAO_per_edge_per_frag: list[list[list[RelAOIdx]]]
    #: AO indices per edge, relative to the fragment where the edge is center.
    relAO_in_ref_per_edge_per_frag: list[list[list[RelAOIdxInRef]]]
    #: AO indices of the origin site, relative to the own fragment.
    relAO_per_origin_per_frag: list[list[RelAOIdx]]
    #: (weight, relative AO indices of all center sites) per fragment.
    weight_and_relAO_per_center_per_frag: list[tuple[float, list[RelAOIdx]]]
    #: Motif (heavy-atom) indices per fragment, ordered origin, centers, edges.
    motifs_per_frag: list[list[MotifIdx]]
    #: The origin motif of each fragment.
    origin_per_frag: list[OriginIdx]
    #: For each atom: list of attached hydrogens (empty for non-motifs).
    H_per_motif: list[list[MotifIdx]]
    #: Per fragment: centers that are not the origin.
    add_center_atom: list[list[int]]

    frozen_core: bool = False
    iao_valence_basis: str | None = None
    iao_valence_only: bool = False

    n_frag: int = field(init=False)
    ncore: int | None = field(init=False, default=None)
    no_core_idx: list[int] | None = field(init=False, default=None)
    core_list: list[int] | None = field(init=False, default=None)

    def __post_init__(self):
        self.n_frag = len(self.AO_per_frag)
        if self.frozen_core:
            self.ncore, self.no_core_idx, self.core_list = self.mol.core_info()

    def __len__(self) -> int:
        return self.n_frag

    def all_centers_are_origins(self) -> bool:
        if self.iao_valence_basis:
            raise ValueError("Test is only defined if IAO is not used.")
        return all(
            list(relAO_center) == list(relAO_origin)
            for (_, relAO_center), relAO_origin in zip(
                self.weight_and_relAO_per_center_per_frag,
                self.relAO_per_origin_per_frag,
            )
        )

    def reorder_frags(self, idx) -> "FragPart":
        g = lambda seq: [seq[i] for i in idx]
        return FragPart(
            mol=self.mol,
            frag_type=self.frag_type,
            n_BE=self.n_BE,
            AO_per_frag=g(self.AO_per_frag),
            AO_per_edge_per_frag=g(self.AO_per_edge_per_frag),
            ref_frag_idx_per_edge_per_frag=g(self.ref_frag_idx_per_edge_per_frag),
            relAO_per_edge_per_frag=g(self.relAO_per_edge_per_frag),
            relAO_in_ref_per_edge_per_frag=g(self.relAO_in_ref_per_edge_per_frag),
            relAO_per_origin_per_frag=g(self.relAO_per_origin_per_frag),
            weight_and_relAO_per_center_per_frag=g(
                self.weight_and_relAO_per_center_per_frag
            ),
            motifs_per_frag=g(self.motifs_per_frag),
            origin_per_frag=g(self.origin_per_frag),
            H_per_motif=self.H_per_motif,
            add_center_atom=g(self.add_center_atom),
            frozen_core=self.frozen_core,
            iao_valence_basis=self.iao_valence_basis,
            iao_valence_only=self.iao_valence_only,
        )
