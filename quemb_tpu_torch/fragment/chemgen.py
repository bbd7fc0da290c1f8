"""Connectivity-based BE fragmentation ("chemgen").

Clean-room reimplementation of the reference's modern fragmenter semantics
(``molbe/chemfrag.py``): bond graph from covalent radii, BFS n-BE fragments,
subset cleanup (with optional swallow-replace), autocratic matching of shared
centers, and AO index bookkeeping.  No chemcoord/networkx — bond detection and
shortest paths are implemented directly.

JAX counterpart: ``quemb_tpu/fragment/chemgen.py``, of which this is a copy (it
holds no jax).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Mapping

import numpy as np

from quemb_tpu_torch.chem.elements import BOHR2ANG, COVALENT_RADIUS, ncore_of
from quemb_tpu_torch.chem.mole import Mole
from quemb_tpu_torch.fragment.frag_part import FragPart
from quemb_tpu_torch.utils.ordered_set import OSet, union_of_seqs


@dataclass(frozen=True)
class ChemGenArgs:
    """Extra options of the chemgen fragmenter (reference chemfrag.py:1777)."""

    h_treatment: str = "treat_H_diff"
    bonds_atoms: Mapping[int, set] | None = None
    vdW_radius: float | Callable | Mapping[str, float] | None = None
    swallow_replace: bool = False


# ------------------------------------------------------------- connectivity
class BondConnectivity:
    """Bond graph + motif (heavy atom) bookkeeping of a molecule."""

    def __init__(self, bonds_atoms, motifs, h_treatment):
        self.bonds_atoms: dict[int, OSet] = bonds_atoms
        self.motifs: OSet = motifs
        self.h_treatment = h_treatment
        self.bonds_motifs = {m: motifs & bonds_atoms[m] for m in motifs}
        all_atoms = OSet(bonds_atoms.keys())
        self.H_atoms = all_atoms.difference(motifs)
        self.H_per_motif = {
            m: bonds_atoms[m] & self.H_atoms for m in motifs
        }
        self.atoms_per_motif = {
            m: union_of_seqs([m], H) for m, H in self.H_per_motif.items()
        }

    # -- construction -------------------------------------------------------
    @classmethod
    def from_mole(
        cls,
        mol: Mole,
        *,
        bonds_atoms=None,
        vdW_radius=None,
        h_treatment: str = "treat_H_diff",
    ) -> "BondConnectivity":
        coords = mol.atom_coords() * BOHR2ANG  # Angstrom
        elements = mol.elements
        natm = mol.natm
        if bonds_atoms is not None and vdW_radius is not None:
            raise ValueError("Cannot specify both bonds_atoms and vdW_radius.")
        if bonds_atoms is not None:
            bonds = {
                i: OSet(sorted(bonds_atoms.get(i, ()))) for i in range(natm)
            }
        else:
            radii = _resolve_radii(elements, vdW_radius)
            dist = np.linalg.norm(
                coords[:, None, :] - coords[None, :, :], axis=-1
            )
            thresh = radii[:, None] + radii[None, :]
            adj = (dist < thresh) & ~np.eye(natm, dtype=bool)
            bonds = {i: OSet(np.nonzero(adj[i])[0].tolist()) for i in range(natm)}

        if h_treatment == "treat_H_like_heavy_atom" or all(
            e == "H" for e in elements
        ):
            # pure-H systems have no heavy-atom motifs; every H is a motif
            motifs = OSet(range(natm))
            return cls(bonds, motifs, "treat_H_like_heavy_atom")

        motifs = OSet(i for i in range(natm) if elements[i] != "H")
        H_atoms = [i for i in range(natm) if elements[i] == "H"]

        def motif_neighbors(h):
            return [m for m in bonds[h] if m in motifs]

        if h_treatment == "at_most_one_H":
            # assign each H to its single closest bonded heavy atom
            for h in H_atoms:
                ms = motif_neighbors(h)
                if len(ms) > 1:
                    d = {m: np.linalg.norm(coords[h] - coords[m]) for m in ms}
                    keep = min(d, key=lambda m: (d[m], m))
                    for m in ms:
                        if m != keep:
                            bonds[h] = bonds[h].difference([m])
                            bonds[m] = bonds[m].difference([h])
            h_treatment = "treat_H_diff"

        if h_treatment == "treat_H_diff":
            for h in H_atoms:
                ms = motif_neighbors(h)
                if len(ms) == 0:
                    raise ValueError(
                        f"H atom {h} belongs to no motif. Modify the bond "
                        "dictionary or change h_treatment."
                    )
                if len(ms) > 1:
                    raise ValueError(
                        f"H atom {h} is shared between motifs {ms}. Use "
                        'h_treatment="at_most_one_H" or modify bonds.'
                    )
            return cls(bonds, motifs, h_treatment)
        raise NotImplementedError(f"h_treatment={h_treatment}")

    # -- BE fragments -------------------------------------------------------
    def get_BE_fragment(self, i_center: int, n_BE: int) -> OSet:
        """Motifs within (n_BE - 1) bonds of ``i_center``."""
        if n_BE < 1:
            raise ValueError("n_BE must be >= 1")
        result = OSet([i_center])
        frontier = result.copy()
        for _ in range(n_BE - 1):
            frontier = union_of_seqs(
                *(self.bonds_motifs[i] for i in frontier)
            ).difference(result)
            if not len(frontier):
                break
            result = result.union(frontier)
        return result

    def motif_distance(self, a: int, b: int) -> int:
        """BFS shortest-path length in the motif graph."""
        if a == b:
            return 0
        seen = {a}
        frontier = [a]
        d = 0
        while frontier:
            d += 1
            nxt = []
            for x in frontier:
                for y in self.bonds_motifs[x]:
                    if y == b:
                        return d
                    if y not in seen:
                        seen.add(y)
                        nxt.append(y)
            frontier = nxt
        return 10**9


def _resolve_radii(elements, vdW_radius) -> np.ndarray:
    def base(sym):
        return COVALENT_RADIUS.get(sym, 1.5)

    if vdW_radius is None:
        return np.array([max(0.55, 1.2 * base(s)) for s in elements])
    if callable(vdW_radius):
        return np.array([vdW_radius(base(s)) for s in elements])
    if isinstance(vdW_radius, Mapping):
        return np.array(
            [
                vdW_radius.get(s, max(0.55, 1.2 * base(s)))
                for s in elements
            ]
        )
    return np.full(len(elements), float(vdW_radius))


# --------------------------------------------------------- structural stage
@dataclass
class StructureFragments:
    """Fragments at the motif level: origins, centers, edges per fragment."""

    conn: BondConnectivity
    n_BE: int
    motifs_per_frag: list[OSet] = field(default_factory=list)
    centers_per_frag: list[OSet] = field(default_factory=list)
    edges_per_frag: list[OSet] = field(default_factory=list)
    origin_per_frag: list[int] = field(default_factory=list)
    atoms_per_frag: list[OSet] = field(default_factory=list)
    #: per fragment: {edge_motif: fragment index where it is a center}
    ref_frag_idx_per_edge: list[dict[int, int]] = field(default_factory=list)

    @classmethod
    def build(
        cls,
        conn: BondConnectivity,
        n_BE: int,
        swallow_replace: bool = False,
        autocratic_matching: bool = True,
    ) -> "StructureFragments":
        raw = {c: conn.get_BE_fragment(c, n_BE) for c in conn.motifs}
        frags, swallowed = _cleanup_if_subset(raw, swallow_replace)

        self = cls(conn, n_BE)
        origins = list(frags.keys())
        centers_per_frag = [
            union_of_seqs([o], sorted(swallowed.get(o, OSet()).to_list()))
            for o in origins
        ]
        edges_per_frag = [
            OSet(sorted(frags[o].difference(centers_per_frag[i]).to_list()))
            for i, o in enumerate(origins)
        ]
        self.origin_per_frag = origins
        self.centers_per_frag = centers_per_frag
        self.edges_per_frag = edges_per_frag
        self.motifs_per_frag = [
            union_of_seqs([o], c, e)
            for o, c, e in zip(origins, centers_per_frag, edges_per_frag)
        ]
        self._rebuild_derived()
        if autocratic_matching:
            self._autocratic_matching()
        return self

    def _rebuild_derived(self):
        conn = self.conn
        self.atoms_per_frag = [
            union_of_seqs(*(conn.atoms_per_motif[m] for m in motifs))
            for motifs in self.motifs_per_frag
        ]

        def frag_of_center(edge):
            for i, cen in enumerate(self.centers_per_frag):
                if edge in cen:
                    return i
            raise ValueError(f"Edge {edge} is not a center in any fragment.")

        self.ref_frag_idx_per_edge = [
            {e: frag_of_center(e) for e in edges}
            for edges in self.edges_per_frag
        ]

    def _autocratic_matching(self):
        """Each motif remains a center in exactly one fragment (the one with
        the closest origin); elsewhere it is re-declared as an edge."""
        conn = self.conn
        appearance: dict[int, list[int]] = {}
        for i, cens in enumerate(self.centers_per_frag):
            for c in cens:
                appearance.setdefault(c, []).append(i)
        shared = {c: fr for c, fr in appearance.items() if len(fr) > 1}
        if not shared:
            return
        best = {
            c: min(
                frs,
                key=lambda i: (
                    conn.motif_distance(c, self.origin_per_frag[i]),
                    i,
                ),
            )
            for c, frs in shared.items()
        }
        becomes_edge: dict[int, set[int]] = {}
        for c, frs in shared.items():
            for i in frs:
                if i != best[c]:
                    becomes_edge.setdefault(i, set()).add(c)
        for i, cs in becomes_edge.items():
            self.centers_per_frag[i] = self.centers_per_frag[i].difference(cs)
            self.edges_per_frag[i] = OSet(
                sorted(self.edges_per_frag[i].union(cs).to_list())
            )
        self._rebuild_derived()
        # ref dicts sorted by edge index (reference chemfrag.py:_sort_by_keys)
        self.ref_frag_idx_per_edge = [
            {k: d[k] for k in sorted(d)} for d in self.ref_frag_idx_per_edge
        ]

    def shared_centers_exist(self) -> bool:
        return len(self.conn.motifs) != sum(
            len(c) for c in self.centers_per_frag
        )

    def get_string(self) -> str:
        lines = ["Atom indices of motifs (1-indexed)"]
        for i, (o, cen, edg) in enumerate(
            zip(self.origin_per_frag, self.centers_per_frag, self.edges_per_frag)
        ):
            lines.append(
                f" frag {i + 1}: origin {o + 1} | centers "
                f"{[c + 1 for c in cen]} | edges {[e + 1 for e in edg]}"
            )
        return "\n".join(lines) + "\n"


def _cleanup_if_subset(
    fragment_indices: dict[int, OSet], swallow_replace: bool
):
    """Remove fragments that are subsets of other fragments.

    Mirrors reference ``chemfrag.py:_cleanup_if_subset`` including chained
    swallowing and the swallow-replace variant.
    """
    contain_others: dict[int, OSet] = {}
    subset_of_others: set[int] = set()

    for i_center, i_fragment in fragment_indices.items():
        if i_center in subset_of_others:
            continue
        for j_center in i_fragment:
            if i_center == j_center:
                continue
            if fragment_indices[j_center].issubset(i_fragment):
                subset_of_others.add(j_center)
                contain_others.setdefault(i_center, OSet()).add(j_center)
                if j_center in contain_others:
                    for x in contain_others[j_center]:
                        contain_others[i_center].add(x)
                    del contain_others[j_center]

    cleaned = {
        c: union_of_seqs([c], sorted(motifs[1:]))
        for c, motifs in fragment_indices.items()
        if c not in subset_of_others
    }
    if swallow_replace:
        for origin, centers in contain_others.items():
            for center in centers:
                cleaned[center] = cleaned[origin]
        contain_others = {}
    return cleaned, contain_others


# ------------------------------------------------------------ AO bookkeeping
def _AO_per_atom(mol: Mole, frozen_core: bool) -> list[list[int]]:
    """Global AO index ranges per atom (with core offsets removed if frozen).

    Mirrors reference ``chemfrag.py:_get_AOidx_per_atom``.
    """
    if not frozen_core:
        return [list(range(p0, p1)) for p0, p1 in mol.aoslice_by_atom()]
    out = []
    core_offset = 0
    for ia, (p0, p1) in enumerate(mol.aoslice_by_atom()):
        n_core = ncore_of(mol.atom_charge(ia))
        out.append(
            list(range(p0 - core_offset, p1 - (core_offset + n_core)))
        )
        core_offset += n_core
    return out


def chemgen(
    mol: Mole,
    n_BE: int,
    args: ChemGenArgs | None = None,
    frozen_core: bool = False,
    iao_valence_basis: str | None = None,
    print_frags: bool = False,
) -> FragPart:
    """Fragment a molecule by chemical connectivity; return a FragPart."""
    args = args or ChemGenArgs()
    conn = BondConnectivity.from_mole(
        mol,
        bonds_atoms=args.bonds_atoms,
        vdW_radius=args.vdW_radius,
        h_treatment=args.h_treatment,
    )
    fs = StructureFragments.build(
        conn, n_BE, swallow_replace=args.swallow_replace
    )
    if fs.shared_centers_exist():
        raise ValueError(
            "Shared centers not supported. Use autocratic matching instead."
        )
    if print_frags:
        print(fs.get_string())

    AO_per_atom = _AO_per_atom(mol, frozen_core)
    AO_per_motif = {
        m: {a: AO_per_atom[a] for a in conn.atoms_per_motif[m]}
        for m in conn.motifs
    }

    AO_per_frag = [
        [ao for a in atoms for ao in AO_per_atom[a]]
        for atoms in fs.atoms_per_frag
    ]

    # relative AO indices per motif, per fragment (running offset over the
    # fragment's motifs in order; atoms within a motif: heavy atom then H's)
    relAO_per_motif_per_frag: list[dict[int, dict[int, list[int]]]] = []
    for motifs in fs.motifs_per_frag:
        rel: dict[int, dict[int, list[int]]] = {}
        off = 0
        for m in motifs:
            rel[m] = {}
            for a in conn.atoms_per_motif[m]:
                n = len(AO_per_motif[m][a])
                rel[m][a] = list(range(off, off + n))
                off += n
        relAO_per_motif_per_frag.append(rel)

    # With IAO the edge/origin bookkeeping refers to the valence (minimal)
    # basis: each atom's LO block lists its IAOs first, so the valence
    # indices are the first n_val entries of each atom's index block
    # (reference chemfrag.py:_get_FragPart_with_iao, wrong_iao_indexing=False)
    if iao_valence_basis is not None:
        val_mol = Mole(
            atom=[(s, xyz) for s, xyz in mol._atoms],
            basis=iao_valence_basis,
            unit="bohr",
        )
        nval_per_atom = [
            p1 - p0 for p0, p1 in val_mol.aoslice_by_atom()
        ]
        if frozen_core:
            nval_per_atom = [
                n - ncore_of(mol.atom_charge(ia))
                for ia, n in enumerate(nval_per_atom)
            ]

        def flat(d: dict[int, list[int]]) -> list[int]:
            return [x for a, v in d.items() for x in v[: nval_per_atom[a]]]
    else:

        def flat(d: dict[int, list[int]]) -> list[int]:
            return [x for v in d.values() for x in v]

    AO_per_edge_per_frag = [
        [flat(AO_per_motif[e]) for e in edges]
        for edges in fs.edges_per_frag
    ]
    relAO_per_edge_per_frag = [
        [flat(rel[e]) for e in edges]
        for rel, edges in zip(relAO_per_motif_per_frag, fs.edges_per_frag)
    ]
    relAO_in_ref_per_edge_per_frag = [
        [flat(relAO_per_motif_per_frag[refs[e]][e]) for e in edges]
        for refs, edges in zip(fs.ref_frag_idx_per_edge, fs.edges_per_frag)
    ]
    relAO_per_origin_per_frag = [
        flat(rel[o])
        for rel, o in zip(relAO_per_motif_per_frag, fs.origin_per_frag)
    ]

    def flat(d: dict[int, list[int]]) -> list[int]:  # noqa: F811
        return [x for v in d.values() for x in v]
    weight_and_relAO_per_center_per_frag = [
        (1.0, [x for c in cens for x in flat(rel[c])])
        for rel, cens in zip(relAO_per_motif_per_frag, fs.centers_per_frag)
    ]
    ref_frag_idx_per_edge_per_frag = [
        [refs[e] for e in edges]
        for refs, edges in zip(fs.ref_frag_idx_per_edge, fs.edges_per_frag)
    ]

    H_per_motif = [
        conn.H_per_motif[a].to_list() if a in conn.H_per_motif else []
        for a in range(mol.natm)
    ]
    add_center_atom = [
        cens.difference([o]).to_list()
        for cens, o in zip(fs.centers_per_frag, fs.origin_per_frag)
    ]

    return FragPart(
        mol=mol,
        frag_type="chemgen",
        n_BE=n_BE,
        AO_per_frag=AO_per_frag,
        AO_per_edge_per_frag=AO_per_edge_per_frag,
        ref_frag_idx_per_edge_per_frag=ref_frag_idx_per_edge_per_frag,
        relAO_per_edge_per_frag=relAO_per_edge_per_frag,
        relAO_in_ref_per_edge_per_frag=relAO_in_ref_per_edge_per_frag,
        relAO_per_origin_per_frag=relAO_per_origin_per_frag,
        weight_and_relAO_per_center_per_frag=weight_and_relAO_per_center_per_frag,
        motifs_per_frag=[m.to_list() for m in fs.motifs_per_frag],
        origin_per_frag=list(fs.origin_per_frag),
        H_per_motif=H_per_motif,
        add_center_atom=add_center_atom,
        frozen_core=frozen_core,
        iao_valence_basis=iao_valence_basis,
    )
