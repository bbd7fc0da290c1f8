"""Legacy geometric fragmentation ("autogen").

Faithful reimplementation of the reference's distance-matrix autogen
(reference molbe/autofrag.py:224-724) including its documented quirks:
the |norm_i - norm_j| < 3.5 A candidate prescreen (NOT a distance -- the
known-bug oracle tests/test_known_bug_autogen.py documents geometries
where it drops real bonds), hard-coded bond cutoffs 1.8 A (1.2 A for H),
the open-fragment swallow bookkeeping, and the sequential frozen-core AO
index shifts.  Produces the same FragPart contract as chemgen.

JAX counterpart: ``quemb_tpu/fragment/autogen.py``, of which this is a copy (it
holds no jax).
"""

from __future__ import annotations

import numpy as np

from quemb_tpu_torch.chem.elements import ANG2BOHR
from quemb_tpu_torch.fragment.frag_part import FragPart

NORMDIST = 3.5 * ANG2BOHR
BOND = 1.8 * ANG2BOHR
HBOND = 1.2 * ANG2BOHR


def autogen(
    mol,
    n_BE: int = 2,
    frozen_core: bool = False,
    iao_valence_basis: str | None = None,
    print_frags: bool = True,
) -> FragPart:
    if not 1 <= n_BE <= 4:
        raise ValueError("autogen supports n_BE in 1..4; use chemgen beyond")
    if iao_valence_basis is not None:
        raise NotImplementedError(
            "autogen + IAO indexing is broken upstream; use chemgen"
        )

    coord = mol.atom_coords()
    natm = mol.natm
    sym = mol.elements
    normlist = np.linalg.norm(coord, axis=1)
    hchain = all(s == "H" for s in sym)

    def is_motif(a: int) -> bool:
        return hchain or sym[a] != "H"

    def prescreen(a: int):
        """Candidate motif partners of ``a`` by the |norm| difference."""
        return [
            b
            for b in range(natm)
            if b != a and is_motif(b)
            and abs(normlist[b] - normlist[a]) < NORMDIST
        ]

    # ---- motif fragments with the open-fragment swallow bookkeeping
    motifs_per_frag: list[list[int]] = []
    pedge: list[list[int]] = []
    origin_per_frag: list[int] = []
    open_frag: list[int] = []      # fragment index per extra center
    open_frag_cen: list[int] = []  # the extra center atom

    for idx in range(natm):
        if not is_motif(idx):
            continue
        clist = prescreen(idx)
        flist = [idx]
        pedg: list[int] = []
        if n_BE != 1:
            for jdx in clist:
                if np.linalg.norm(coord[idx] - coord[jdx]) <= BOND:
                    flist.append(jdx)
                    pedg.append(jdx)
                    if n_BE >= 3:
                        for kdx in clist:
                            if kdx == jdx:
                                continue
                            if (
                                np.linalg.norm(coord[jdx] - coord[kdx])
                                <= BOND
                                and kdx not in pedg
                            ):
                                flist.append(kdx)
                                pedg.append(kdx)
                                if n_BE == 4:
                                    for ldx in range(natm):
                                        if (
                                            ldx in (kdx, jdx)
                                            or not is_motif(ldx)
                                            or ldx in pedg
                                            or np.linalg.norm(
                                                coord[kdx] - coord[ldx]
                                            )
                                            > BOND
                                        ):
                                            continue
                                        flist.append(ldx)
                                        pedg.append(ldx)

            # swallow handling (reference autofrag.py:359-376, incl. the
            # for-else flow: a subset match drops flist entirely)
            subset_of_existing = False
            for pidx, frag_ in enumerate(motifs_per_frag):
                if set(flist).issubset(frag_):
                    open_frag.append(pidx)
                    open_frag_cen.append(idx)
                    subset_of_existing = True
                    break
                elif set(frag_).issubset(flist):
                    open_frag = [
                        o - 1 if o > pidx else o for o in open_frag
                    ]
                    open_frag.append(len(motifs_per_frag) - 1)
                    open_frag_cen.append(origin_per_frag[pidx])
                    del origin_per_frag[pidx]
                    del motifs_per_frag[pidx]
                    del pedge[pidx]
            if not subset_of_existing:
                motifs_per_frag.append(flist)
                pedge.append(pedg)
                origin_per_frag.append(idx)
        else:
            motifs_per_frag.append(flist)
            origin_per_frag.append(idx)

    # ---- hydrogens attach to the nearest bonded heavy atom (<= 1.2 A)
    H_per_motif: list[list[int]] = [[] for _ in range(natm)]
    if not hchain:
        for idx in range(natm):
            if sym[idx] != "H":
                continue
            for jdx in range(natm):
                if (
                    jdx != idx
                    and sym[jdx] != "H"
                    and abs(normlist[jdx] - normlist[idx]) < NORMDIST
                    and np.linalg.norm(coord[idx] - coord[jdx]) <= HBOND
                ):
                    H_per_motif[jdx].append(idx)

    # ---- AO index table with sequential frozen-core shifts
    from quemb_tpu_torch.chem.elements import ncore_of

    baslist = mol.aoslice_by_atom()
    sites__: list[list[int]] = [[] for _ in range(natm)]
    hshift = [0] * natm
    coreshift = 0
    for adx in range(natm):
        start_, stop_ = baslist[adx]
        if hchain:
            sites__[adx] = list(range(start_, stop_))
            continue
        if sym[adx] != "H":
            if frozen_core:
                nc = ncore_of(mol.atom_charge(adx))
                start_ -= coreshift
                stop_ -= coreshift + nc
                coreshift += nc
            sites__[adx] = list(range(start_, stop_))
        else:
            hshift[adx] = coreshift
    hsites: list[list[int]] = [[] for _ in range(natm)]
    for hdx in range(natm):
        for hidx in H_per_motif[hdx]:
            startH, stopH = baslist[hidx]
            if frozen_core:
                startH -= hshift[hidx]
                stopH -= hshift[hidx]
            hsites[hdx].extend(range(startH, stopH))

    def atom_aos(a: int) -> list[int]:
        return sites__[a] + hsites[a]

    # ---- assemble the FragPart index fields
    AO_per_frag: list[list[int]] = []
    AO_per_edge: list[list[list[int]]] = []
    relAO_per_edge: list[list[list[int]]] = []
    relAO_per_origin: list[list[int]] = []
    edge_atoms: list[list[int]] = []

    for fi, motifs in enumerate(motifs_per_frag):
        ftmp: list[int] = []
        ftmpe: list[list[int]] = []
        edind: list[list[int]] = []
        edg: list[int] = []
        indix = 0

        frglist = list(atom_aos(origin_per_frag[fi]))
        ls = len(frglist)
        if fi in open_frag:
            for oi, of in enumerate(open_frag):
                if of == fi:
                    extra = atom_aos(open_frag_cen[oi])
                    frglist.extend(extra)
                    ls += len(extra)
        ftmp.extend(frglist)
        ls_origin = len(atom_aos(origin_per_frag[fi]))
        relAO_per_origin.append(list(range(indix, indix + ls_origin)))
        indix += ls

        if n_BE != 1:
            own_centers = [
                open_frag_cen[oi]
                for oi, of in enumerate(open_frag)
                if of == fi
            ]
            for jdx in pedge[fi]:
                if fi in open_frag and (
                    jdx in own_centers or jdx in open_frag_cen
                ):
                    continue
                edg.append(jdx)
                edglist = atom_aos(jdx)
                ftmp.extend(edglist)
                ftmpe.append(list(edglist))
                edind.append(list(range(indix, indix + len(edglist))))
                indix += len(edglist)
            edge_atoms.append(edg)
            AO_per_edge.append(ftmpe)
            relAO_per_edge.append(edind)
        AO_per_frag.append(ftmp)

    ref_frag_idx_per_edge: list[list[int]] = []
    for edg in edge_atoms:
        cen_ = []
        for jx in edg:
            if jx in origin_per_frag:
                cen_.append(origin_per_frag.index(jx))
            elif jx in open_frag_cen:
                cen_.append(open_frag[open_frag_cen.index(jx)])
            else:
                raise ValueError(f"edge atom {jx} is a center of no fragment")
        ref_frag_idx_per_edge.append(cen_)

    n_frag = len(AO_per_frag)
    add_center_atom: list[list[int]] = [[] for _ in range(n_frag)]
    weight_and_relAO_per_center = []
    for fi, aos in enumerate(AO_per_frag):
        rel = [aos.index(pq) for pq in atom_aos(origin_per_frag[fi])]
        if fi in open_frag:
            for oi, of in enumerate(open_frag):
                if of == fi:
                    add_center_atom[fi].append(open_frag_cen[oi])
                    rel.extend(
                        aos.index(pq) for pq in atom_aos(open_frag_cen[oi])
                    )
        weight_and_relAO_per_center.append((1.0, rel))

    relAO_in_ref_per_edge: list[list[list[int]]] = []
    if n_BE != 1:
        for fi in range(n_frag):
            idxs = []
            for jdx, rj in enumerate(ref_frag_idx_per_edge[fi]):
                if rj in open_frag:
                    oi = open_frag.index(rj)
                    if edge_atoms[fi][jdx] == open_frag_cen[oi]:
                        cnt = atom_aos(open_frag_cen[oi])
                        idxs.append(
                            [AO_per_frag[rj].index(k) for k in cnt]
                        )
                        continue
                cnt = atom_aos(origin_per_frag[rj])
                idxs.append([AO_per_frag[rj].index(k) for k in cnt])
            relAO_in_ref_per_edge.append(idxs)

    if not AO_per_edge:
        AO_per_edge = [[] for _ in range(n_frag)]
        ref_frag_idx_per_edge = [[] for _ in range(n_frag)]
        relAO_per_edge = [[] for _ in range(n_frag)]
        relAO_in_ref_per_edge = [[] for _ in range(n_frag)]

    if print_frags:
        print(f"autogen: {n_frag} fragments "
              f"(origins {origin_per_frag})")

    return FragPart(
        mol=mol,
        frag_type="autogen",
        n_BE=n_BE,
        AO_per_frag=AO_per_frag,
        AO_per_edge_per_frag=AO_per_edge,
        ref_frag_idx_per_edge_per_frag=ref_frag_idx_per_edge,
        relAO_per_edge_per_frag=relAO_per_edge,
        relAO_in_ref_per_edge_per_frag=relAO_in_ref_per_edge,
        relAO_per_origin_per_frag=relAO_per_origin,
        weight_and_relAO_per_center_per_frag=weight_and_relAO_per_center,
        motifs_per_frag=motifs_per_frag,
        origin_per_frag=origin_per_frag,
        H_per_motif=H_per_motif,
        add_center_atom=add_center_atom,
        frozen_core=frozen_core,
        iao_valence_basis=iao_valence_basis,
    )


def _distance_bonds(mol) -> dict[int, list[int]]:
    """Bond dictionary with autogen's hard-coded cutoffs (1.8 A heavy,
    1.2 A to hydrogen); consumed by graphgen's adjacency build."""
    coord = mol.atom_coords()
    sym = mol.elements
    natm = mol.natm
    hchain = all(s == "H" for s in sym)
    bonds: dict[int, list[int]] = {i: [] for i in range(natm)}
    for i in range(natm):
        for j in range(i + 1, natm):
            d = float(np.linalg.norm(coord[i] - coord[j]))
            cut = (
                HBOND
                if (sym[i] == "H" or sym[j] == "H") and not hchain
                else BOND
            )
            if d <= cut:
                bonds[i].append(j)
                bonds[j].append(i)
    return bonds
