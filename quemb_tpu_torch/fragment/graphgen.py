"""Shortest-path fragmentation ("graphgen").

Own implementation of the reference's Dijkstra-based fragmentation
(``molbe/graphfrag.py:349``): every atom seeds a candidate fragment that
contains each neighbor whose minimum-weight path from the seed (edge
weight = squared euclidean distance in Bohr, edges only between atoms
within ``cutoff`` Bohr) visits fewer than ``n_BE`` nodes; candidate
fragments that are subsets of another get absorbed (their center sites
migrate to the superset, ``graphfrag.py:70``); fragment edges are the
overlaps of the fragment's atoms with the other fragments' center AO
sets.  The default cutoff is dynamic in ``n_BE`` (``graphfrag.py:420``).

Unlike BFS on the bond graph (chemgen/autogen), the shortest-path-visits
criterion is geometric: an atom within the cutoff joins a BE2 fragment
only if its *direct* edge is the minimum-weight path — on rings or
through-space contacts this differs from bond-count order.

Set-valued intermediates (merged centers, per-atom edge overlaps) are
materialized through Python ``set`` exactly as the reference does, so
the emitted index orderings are bit-identical to the reference oracle
(tests/data/graphgen_expected.py).

JAX counterpart: ``quemb_tpu/fragment/graphgen.py``, of which this is a copy (it
holds no jax).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np

from quemb_tpu_torch.chem.mole import Mole
from quemb_tpu_torch.fragment.chemgen import _AO_per_atom
from quemb_tpu_torch.fragment.frag_part import FragPart


@dataclass
class GraphGenArgs:
    """Graphgen-specific arguments (reference graphfrag.py:24).

    ``cutoff`` (Bohr) bounds the edge length of the adjacency graph;
    0.0 selects the dynamic default 4.5 (n_BE <= 3) / 4.5 * n_BE.
    """

    connectivity: str = "euclidean"
    cutoff: float = 0.0
    remove_nonnunique_frags: bool = True


def _min_weight_hops(
    nbrs: list[dict[int, float]], src: int
) -> dict[int, int]:
    """Node count of the minimum-weight path from ``src`` to every node.

    Dijkstra over the weighted adjacency; among equal-weight paths the
    one with fewer hops wins (lexicographic (weight, hops) order), which
    is deterministic where networkx's tie-break is incidental.
    """
    best: dict[int, tuple[float, int]] = {src: (0.0, 0)}
    pq: list[tuple[float, int, int]] = [(0.0, 0, src)]
    while pq:
        d, h, u = heapq.heappop(pq)
        if (d, h) > best.get(u, (np.inf, 0)):
            continue
        for v, w in nbrs[u].items():
            cand = (d + w, h + 1)
            if cand < best.get(v, (np.inf, 0)):
                best[v] = cand
                heapq.heappush(pq, (cand[0], cand[1], v))
    return {v: h for v, (_, h) in best.items()}


def _absorb_subset_frags(frags: list[dict], natm: int) -> list[dict]:
    """Absorb fragments whose AO set is a subset of another's.

    The absorbed fragment's center sites and origins migrate to the
    superset (reference ``_remove_nonnunique_frags``, graphfrag.py:70);
    sweeps repeat up to ``natm`` times so chains of absorption settle.
    Never deletes the last remaining fragment.
    """
    for _ in range(natm):
        absorbed: set[int] = set()
        for fa in frags:
            a_aos = set(fa["AO"])
            for b, fb in enumerate(frags):
                if fb is fa or b in absorbed:
                    continue
                if set(fb["AO"]) <= a_aos:
                    absorbed.add(b)
                    fa["center"] = tuple(
                        set(list(fa["center"]) + list(fb["center"]))
                    )
                    fa["origin"] = tuple(
                        set(list(fa["origin"]) + list(fb["origin"]))
                    )
                    fa["added_centers"] = tuple(
                        set(list(fa["added_centers"]) + list(fb["origin"]))
                    )
        for b in sorted(absorbed, reverse=True):
            if len(frags) == 1:
                break
            del frags[b]
    return frags


def graphgen(
    mol: Mole,
    n_BE: int = 2,
    frozen_core: bool = True,
    remove_nonnunique_frags: bool = True,
    frag_prefix: str = "f",
    connectivity: str = "euclidean",
    iao_valence_basis: str | None = None,
    cutoff: float = 0.0,
    print_frags: bool = False,
) -> FragPart:
    """BE fragments from shortest-path node counts (graphfrag.py:349)."""
    if iao_valence_basis is not None:
        raise NotImplementedError("IAOs not implemented for graphgen.")
    if connectivity.lower() != "euclidean":
        raise NotImplementedError(f"connectivity={connectivity!r}")
    if cutoff == 0.0:
        cutoff = 4.5 if n_BE <= 3 else 4.5 * n_BE

    natm = mol.natm
    coords = np.asarray(mol.atom_coords())  # Bohr
    symbols = list(mol.elements)
    sites = _AO_per_atom(mol, frozen_core)

    dist = np.linalg.norm(coords[:, None] - coords[None, :], axis=-1)
    nbrs: list[dict[int, float]] = [
        {
            b: float(dist[a, b]) ** 2
            for b in range(natm)
            if b != a and dist[a, b] <= cutoff
        }
        for a in range(natm)
    ]
    # hydrogens attached to each heavier atom (bookkeeping only; the
    # reference records b > a pairs only, graphfrag.py:509)
    H_per_motif = [
        [
            b
            for b in range(a + 1, natm)
            if dist[a, b] <= 2.5
            and symbols[b] == "H"
            and symbols[a] != "H"
        ]
        for a in range(natm)
    ]

    # one candidate fragment per seed atom: members are the direct
    # neighbors whose minimum-weight path visits < n_BE nodes
    frags: list[dict] = []
    for a in range(natm):
        hops = _min_weight_hops(nbrs, a)
        members = [a] + [
            b for b in sorted(nbrs[a]) if 0 < hops.get(b, natm) < n_BE
        ]
        frags.append(
            {
                "AO": tuple(i for m in members for i in sites[m]),
                "AO_by_atom": [tuple(sites[m]) for m in members],
                "motifs": tuple(members),
                "center": tuple(sites[a]),
                "origin": (a,),
                "added_centers": (),
            }
        )

    if remove_nonnunique_frags:
        frags = _absorb_subset_frags(frags, natm)

    # edges: overlap of each fragment's atoms with every other
    # fragment's center AO set (set-ordered, as the reference emits)
    AO_per_edge_per_frag: list[tuple] = []
    for a, fa in enumerate(frags):
        found: set[tuple[int, ...]] = set()
        for b, fb in enumerate(frags):
            if b == a:
                continue
            cb = set(fb["center"])
            for atom_aos in fa["AO_by_atom"]:
                ov = set(atom_aos) & cb
                if ov:
                    found.add(tuple(ov))
        AO_per_edge_per_frag.append(tuple(found))

    relAO_per_origin_per_frag = [
        tuple(fa["AO"].index(c) for c in fa["center"]) for fa in frags
    ]
    ref_frag_idx_per_edge_per_frag = []
    for a, edges in enumerate(AO_per_edge_per_frag):
        flat = {i for e in edges for i in e}
        ref_frag_idx_per_edge_per_frag.append(
            [b for b, fb in enumerate(frags) if set(fb["center"]) & flat]
        )
    relAO_in_ref_per_edge_per_frag = [
        [list(relAO_per_origin_per_frag[b]) for b in refs]
        for refs in ref_frag_idx_per_edge_per_frag
    ]
    relAO_per_edge_per_frag = [
        [[fa["AO"].index(i) for i in e] for e in edges]
        for fa, edges in zip(frags, AO_per_edge_per_frag)
    ]

    if print_frags:
        for a, fa in enumerate(frags):
            marked = [
                f"[{symbols[m]}{m}]" if m in fa["origin"]
                else f"{symbols[m]}{m}"
                for m in fa["motifs"]
            ]
            print(f"Frag `{frag_prefix}{a}`: " + " - ".join(marked))

    return FragPart(
        mol=mol,
        frag_type="graphgen",
        n_BE=n_BE,
        AO_per_frag=[fa["AO"] for fa in frags],
        AO_per_edge_per_frag=AO_per_edge_per_frag,
        ref_frag_idx_per_edge_per_frag=ref_frag_idx_per_edge_per_frag,
        relAO_per_edge_per_frag=relAO_per_edge_per_frag,
        relAO_in_ref_per_edge_per_frag=relAO_in_ref_per_edge_per_frag,
        relAO_per_origin_per_frag=relAO_per_origin_per_frag,
        weight_and_relAO_per_center_per_frag=[
            (1.0, tuple(r)) for r in relAO_per_origin_per_frag
        ],
        motifs_per_frag=[fa["motifs"] for fa in frags],
        origin_per_frag=[fa["origin"] for fa in frags],
        H_per_motif=H_per_motif,
        add_center_atom=[list(fa["added_centers"]) for fa in frags],
        frozen_core=frozen_core,
        iao_valence_basis=iao_valence_basis,
        iao_valence_only=False,
    )
