"""Connectivity fragments for BE-n ("chemgen" semantics), written anew.

A molecule's heavy atoms are its motifs; each hydrogen belongs to the one
heavy atom it is bonded to.  Two atoms are bonded when their distance is
below the sum of their radii, a radius being max(0.55, 1.2 x covalent
radius) in Angstrom.  The BE-n fragment of a motif holds every motif
within n - 1 bonds of it.  A fragment contained in another is dropped and
its origin becomes a center of the fragment that contains it (chained).
A motif that is a center of several fragments stays a center only in the
one whose origin is nearest (ties: the lower fragment index) and is an
edge elsewhere.  Every other motif of a fragment is an edge, matched to
the fragment where it is a center.  Sites are localized orbitals, one per
AO, numbered as the AOs are.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

#: covalent radii in Angstrom
COVALENT_RADIUS = {"H": 0.31, "C": 0.76, "N": 0.71, "O": 0.66, "F": 0.57,
                   "S": 1.05, "Cl": 1.02, "B": 0.84, "P": 1.07}


@dataclass
class RefFragment:
    sites: list[int]          # global site indices, origin's motif first
    centers: list[int]        # global site indices counted in the energy
    edges: list[list[int]]    # global site indices of each edge motif
    edge_ref: list[int]       # fragment in which each edge is a center


def _bonds(symbols, coords_ang):
    r = np.array([max(0.55, 1.2 * COVALENT_RADIUS[s]) for s in symbols])
    d = np.linalg.norm(coords_ang[:, None] - coords_ang[None], axis=-1)
    adj = (d < r[:, None] + r[None]) & ~np.eye(len(symbols), dtype=bool)
    return [set(np.nonzero(row)[0].tolist()) for row in adj]


def _distance(adj, a, b):
    seen, frontier, d = {a}, [a], 0
    while frontier:
        if b in frontier:
            return d
        d += 1
        frontier = [y for x in frontier for y in adj[x] if y not in seen]
        seen.update(frontier)
    raise ValueError(f"motifs {a} and {b} are not connected")


def be_fragments(symbols, coords_ang, ao_ranges, n_BE: int):
    """Fragments of a molecule: ``symbols`` [natm], ``coords_ang``
    [natm, 3] in Angstrom, ``ao_ranges`` [(start, stop)] per atom."""
    bonds = _bonds(symbols, np.asarray(coords_ang, float))
    motifs = [i for i, s in enumerate(symbols) if s != "H"]
    hyd = {m: [] for m in motifs}
    for i, s in enumerate(symbols):
        if s == "H":
            owners = [m for m in bonds[i] if m in hyd]
            if len(owners) != 1:
                raise ValueError(f"H atom {i} is bonded to {owners}")
            hyd[owners[0]].append(i)
    adj = {m: bonds[m] & set(motifs) for m in motifs}

    reach = {}
    for c in motifs:
        got, frontier = {c}, {c}
        for _ in range(n_BE - 1):
            frontier = {y for x in frontier for y in adj[x]} - got
            got |= frontier
        reach[c] = got

    # drop fragments contained in others, chaining what they swallowed
    contains: dict[int, list[int]] = {}
    dropped: set[int] = set()
    for c in motifs:
        if c in dropped:
            continue
        for j in sorted(reach[c] - {c}):
            if reach[j] <= reach[c]:
                dropped.add(j)
                contains.setdefault(c, []).append(j)
                contains[c].extend(contains.pop(j, []))
    origins = [c for c in motifs if c not in dropped]
    centers = [[o] + sorted(contains.get(o, [])) for o in origins]

    # a center shared by several fragments stays with the nearest origin
    owner: dict[int, list[int]] = {}
    for f, cs in enumerate(centers):
        for m in cs:
            owner.setdefault(m, []).append(f)
    for m, fs in owner.items():
        best = min(fs, key=lambda f: (_distance(adj, m, origins[f]), f))
        for f in fs:
            if f != best:
                centers[f].remove(m)
        owner[m] = [best]

    def sites_of(m):
        return [ao for a in [m] + sorted(hyd[m])
                for ao in range(*ao_ranges[a])]

    out = []
    for f, o in enumerate(origins):
        edges = sorted(reach[o] - set(centers[f]))
        out.append(RefFragment(
            sites=[s for m in centers[f] + edges for s in sites_of(m)],
            centers=[s for m in centers[f] for s in sites_of(m)],
            edges=[sites_of(e) for e in edges],
            edge_ref=[owner[e][0] for e in edges],
        ))
    return out
