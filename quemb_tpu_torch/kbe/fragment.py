"""Periodic fragmentation: FragPart for cells + fragmentate dispatch.

Replacement for the reference ``kbe/fragment.py`` (FragPart with
unitcell/kpt fields, reference kbe/fragment.py:24,139).  The "chemgen"
path mirrors the reference's chemgen-on-cell behavior (reference
chemfrag.py:433 ``BondConnectivity.from_cell``): bonds are detected with
minimum-image distances, so fragments that cross the cell boundary wrap
back into cell 0 of the supercell LO space.

JAX counterpart: ``quemb_tpu/kbe/fragment.py``, of which this is a copy (it
holds no jax).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from quemb_tpu_torch.fragment.chemgen import ChemGenArgs, chemgen
from quemb_tpu_torch.fragment.frag_part import FragPart
from quemb_tpu_torch.kbe.cell import Cell


@dataclass
class KFragPart(FragPart):
    """FragPart over a Cell: adds the k-mesh and unitcell bookkeeping."""

    kpt: tuple[int, int, int] = (1, 1, 1)
    unitcell: int = 1

    @property
    def unitcell_nkpt(self) -> int:
        n = 1
        for i in self.kpt:
            if i > 1:
                n *= self.unitcell
        return n


def _min_image_bonds(
    cell: Cell,
    vdW_radius=None,
    *,
    long_bond: bool = False,
    interlayer: bool = False,
    perpend_dist: float = 4.0,
    perpend_dist_tol: float = 1e-3,
) -> dict[int, list[int]]:
    """Bond dictionary from minimum-image interatomic distances.

    ``long_bond`` widens the covalent cutoff by 2.6/1.8 (the reference's
    long-bond threshold vs its default, kbe/autofrag.py:25,365).

    ``interlayer`` adds pseudo-bonds for stacked-monolayer systems
    (reference kbe/autofrag.py:490-515,1305-1311): for each atom, its
    nearest min-image neighbors in a DIFFERENT layer (distinct
    z-coordinate) at the minimal interlayer distance (within
    ``perpend_dist_tol`` Bohr) are attached, provided that distance is
    below ``perpend_dist`` (Angstrom).  Fragments then extend across the
    van-der-Waals gap even though no covalent bond connects the layers.
    """
    from quemb_tpu_torch.fragment.chemgen import _resolve_radii
    from quemb_tpu_torch.chem.elements import ANG2BOHR

    coords = cell.atom_coords()  # Bohr
    natm = cell.natm
    radii = _resolve_radii(cell.elements, vdW_radius) * ANG2BOHR
    # images: nearest shells suffice for bond detection
    ijk = np.array(
        [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
         for k in (-1, 0, 1)]
    )
    Ls = ijk @ cell.a
    d = coords[:, None, None, :] - coords[None, :, None, :] - Ls[None, None]
    dist = np.linalg.norm(d, axis=-1).min(axis=-1)  # [natm, natm] min-image
    thresh = radii[:, None] + radii[None, :]
    if long_bond:
        thresh = thresh * (2.6 / 1.8)
    adj = (dist < thresh) & ~np.eye(natm, dtype=bool)
    if interlayer:
        z = coords[:, 2]
        other_layer = np.abs(z[:, None] - z[None, :]) > 1e-6
        cross = other_layer & ~adj & ~np.eye(natm, dtype=bool)
        dcross = np.where(cross, dist, np.inf)
        dmin = dcross.min(axis=1)  # nearest cross-layer distance per atom
        attach = (
            cross
            & (dcross <= dmin[:, None] + perpend_dist_tol)
            & (dcross < perpend_dist * ANG2BOHR)
        )
        adj = adj | attach | attach.T  # keep the bond dict symmetric
    return {i: sorted(np.nonzero(adj[i])[0].tolist()) for i in range(natm)}


def fragmentate(
    mol: Cell,
    kpt,
    *,
    n_BE: int = 2,
    frag_type: str = "chemgen",
    frozen_core: bool = False,
    unitcell: int = 1,
    iao_valence_basis: str | None = None,
    print_frags: bool = False,
    additional_args: ChemGenArgs | None = None,
    long_bond: bool = False,
    interlayer: bool = False,
    perpend_dist: float = 4.0,
    perpend_dist_tol: float = 1e-3,
) -> KFragPart:
    """Periodic fragmentation (reference kbe/fragment.py:139).

    ``chemgen``: minimum-image connectivity; fragment AO indices live in
    the cell-0 block of the supercell LO space (matches the reference's
    chemgen-on-cell semantics and its kBE baselines).

    ``long_bond``/``interlayer``/``perpend_dist``/``perpend_dist_tol``
    mirror the reference's periodic AutogenArgs (kbe/autofrag.py:14-39):
    stretched-bond cutoffs and stacked-monolayer attachment, implemented
    as connectivity transforms (see :func:`_min_image_bonds`) so they
    compose with every frag_type rather than being special-cased per
    walker.  The reference's gamma_1d/gamma_2d switches are subsumed:
    minimum-image connectivity is dimension-agnostic, so 1D/2D/3D
    k-meshes (including gamma-only directions) need no flags here.
    """
    args = additional_args or ChemGenArgs()
    bond_kw = dict(
        long_bond=long_bond,
        interlayer=interlayer,
        perpend_dist=perpend_dist,
        perpend_dist_tol=perpend_dist_tol,
    )
    if frag_type == "chemgen":
        # minimum-image connectivity; fragments wrap into the cell-0 block
        # of the supercell LO space (the reference's chemgen-on-cell
        # semantics, chemfrag.py:433)
        if args.bonds_atoms is None:
            args = ChemGenArgs(
                h_treatment=args.h_treatment,
                swallow_replace=args.swallow_replace,
                bonds_atoms=_min_image_bonds(
                    mol, args.vdW_radius, **bond_kw
                ),
            )
        fp = chemgen(
            mol,
            n_BE=n_BE,
            args=args,
            frozen_core=frozen_core,
            iao_valence_basis=iao_valence_basis,
            print_frags=print_frags,
        )
    elif frag_type == "autogen":
        fp = _supercell_extended_fragments(
            mol, kpt, n_BE, frozen_core, args, iao_valence_basis,
            print_frags, bond_kw,
        )
    else:
        raise NotImplementedError(f"frag_type={frag_type}")
    return KFragPart(
        **{
            f: getattr(fp, f)
            for f in fp.__dataclass_fields__
            if fp.__dataclass_fields__[f].init
        },
        kpt=tuple(kpt),
        unitcell=unitcell,
    )


def _supercell_extended_fragments(
    mol: Cell, kpt, n_BE, frozen_core, args, iao_valence_basis,
    print_frags, bond_kw=None,
):
    """Fragments that extend into neighboring cells (the reference's
    periodic autogen semantics, kbe/autofrag.py:261): chemgen runs on the
    kmesh supercell ring, fragments with origins outside cell 0 are
    dropped, and their edge cross-references are folded back onto the
    translation-equivalent cell-0 fragments.
    """
    from dataclasses import replace

    sup = mol.supercell(kpt)
    natm_c = mol.natm
    sup_args = ChemGenArgs(
        h_treatment=args.h_treatment,
        swallow_replace=args.swallow_replace,
        bonds_atoms=_min_image_bonds(
            sup, args.vdW_radius, **(bond_kw or {})
        ),
    )
    fp = chemgen(
        sup,
        n_BE=n_BE,
        args=sup_args,
        frozen_core=frozen_core,
        iao_valence_basis=iao_valence_basis,
        print_frags=print_frags,
    )
    frag_of_origin = {o: i for i, o in enumerate(fp.origin_per_frag)}
    if len(frag_of_origin) != fp.n_frag or any(
        fp.add_center_atom[i] for i in range(fp.n_frag)
    ):
        raise NotImplementedError(
            "supercell-extended fragments require origin-unique"
            " fragments (no swallowed centers); use frag_type='chemgen'"
        )
    kept = [
        i for i in range(fp.n_frag) if fp.origin_per_frag[i] < natm_c
    ]
    new_idx = {old: new for new, old in enumerate(kept)}

    def fold(atom: int) -> int:
        return atom % natm_c

    ref_idx, rel_in_ref = [], []
    for i in kept:
        refs_i, rel_i = [], []
        for e_pos, ref_old in enumerate(
            fp.ref_frag_idx_per_edge_per_frag[i]
        ):
            edge_atom = fp.origin_per_frag[ref_old]
            ref0 = frag_of_origin[fold(edge_atom)]
            refs_i.append(new_idx[ref0])
            # the edge sits on the ref fragment's ORIGIN; its AO
            # positions inside the cell-0 equivalent are the origin's
            rel_i.append(list(fp.relAO_per_origin_per_frag[ref0]))
        ref_idx.append(refs_i)
        rel_in_ref.append(rel_i)

    def pick(lst):
        return [lst[i] for i in kept]

    return replace(
        fp,
        # core bookkeeping must count the UNIT cell (post-init recomputes
        # ncore/no_core_idx from mol), while AO indices stay supercell
        mol=mol,
        AO_per_frag=pick(fp.AO_per_frag),
        AO_per_edge_per_frag=pick(fp.AO_per_edge_per_frag),
        ref_frag_idx_per_edge_per_frag=ref_idx,
        relAO_per_edge_per_frag=pick(fp.relAO_per_edge_per_frag),
        relAO_in_ref_per_edge_per_frag=rel_in_ref,
        relAO_per_origin_per_frag=pick(fp.relAO_per_origin_per_frag),
        weight_and_relAO_per_center_per_frag=pick(
            fp.weight_and_relAO_per_center_per_frag
        ),
        motifs_per_frag=pick(fp.motifs_per_frag),
        origin_per_frag=pick(fp.origin_per_frag),
    )
