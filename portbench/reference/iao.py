"""IAO+PAO localized orbitals with a frozen core, worked out again.

The intrinsic atomic orbitals of G. Knizia, J. Chem. Theory Comput. 9,
4834 (2013), eq. 1, with symmetric (Lowdin) orthogonalization, and the
projected atomic orbitals of the rest of the basis, orthogonalized the
same way.  The minimal basis is, as in QuEmb's ``get_iao`` with
``iao_loc_method="lowdin"``, the working basis's own functions whose
labels (principal quantum number counted per angular momentum, as PySCF
labels them) appear in the valence basis: for 6-31G under STO-3G, the
first contraction of each shell STO-3G has.  So the valence basis's own
integrals are never needed, only its shells.  The PAOs are the working
functions outside that subset, projected off the IAO space.

Each orbital belongs to the atom where its population in the
symmetrically orthogonalized AOs is largest, which must exceed 0.5
(QuEmb keeps, per atom, the orbitals above 0.5; one orbital on two atoms
or on none raises here).  The frozen core's MOs are projected out of the
IAOs, the IAOs left with population above 0.5 are kept and
orthogonalized again.  Sites are numbered per atom, in the order of the
atoms: its valence IAOs, then its PAOs, each in the order of the
functions they come from.  That is the program's numbering.

Departures from QuEmb: none in the orbitals; the core count of each
element comes from the configuration's file, not from a table of Z.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from portbench.reference.fragments import RefFragment, be_fragments

#: angular momentum of a shell letter
_L = {"s": 0, "p": 1}


def ao_labels(shells: str) -> list[tuple[int, int, int]]:
    """(n, l, m) of each function of an atom with ``shells``, in the
    integral engine's order (shells sorted by angular momentum, each
    shell's components in turn); n counts the shells of each l from
    l + 1."""
    out, seen = [], {}
    for letter in sorted(shells, key=lambda c: _L[c]):
        l = _L[letter]
        n = seen.get(l, l) + 1
        seen[l] = n
        out += [(n, l, m) for m in range(2 * l + 1)]
    return out


@dataclass
class SiteLayout:
    """Where each atom's functions and sites lie."""

    ao_ranges: list[tuple[int, int]]   # per atom, working-basis functions
    valence_aos: list[list[int]]       # per atom, its minimal-basis subset
    core: list[int]                    # per atom, frozen core orbitals
    lo_ranges: list[tuple[int, int]]   # per atom, its sites
    nval: list[int]                    # per atom, its valence IAO sites

    @classmethod
    def of(cls, symbols, shells: dict, valence_shells: dict,
           core: dict) -> "SiteLayout":
        ao_ranges, valence_aos, cores, lo_ranges, nval = [], [], [], [], []
        off = lo = 0
        for s in symbols:
            labels = ao_labels(shells[s])
            val = set(ao_labels(valence_shells[s]))
            valence_aos.append([off + i for i, lab in enumerate(labels)
                                if lab in val])
            if len(valence_aos[-1]) != len(val):
                raise ValueError(f"{s}: the valence shells are no subset")
            ao_ranges.append((off, off + len(labels)))
            cores.append(int(core.get(s, 0)))
            nval.append(len(val) - cores[-1])
            n_sites = len(labels) - cores[-1]
            lo_ranges.append((lo, lo + n_sites))
            off += len(labels)
            lo += n_sites
        return cls(ao_ranges, valence_aos, cores, lo_ranges, nval)

    def valence_sites(self) -> set[int]:
        return {lo0 + k for (lo0, _), n in zip(self.lo_ranges, self.nval)
                for k in range(n)}


def _symm_orth(C, S):
    """C (C^T S C)^(-1/2)."""
    w, V = torch.linalg.eigh(C.T @ S @ C)
    if float(w.min()) < 1e-9:
        raise ValueError(f"ill-conditioned orbitals: {float(w.min()):.2e}")
    return C @ (V * w.rsqrt()) @ V.T


def _by_atom(C, S, ao_ranges):
    """Per atom, the columns of C whose population there, in the
    symmetrically orthogonalized AOs, is largest and above 0.5."""
    w, V = torch.linalg.eigh(S)
    pop = ((V * w.sqrt()) @ V.T @ C).square()
    per_atom = torch.stack([pop[a:b].sum(0) for a, b in ao_ranges])
    best, where = per_atom.max(0)
    if float(best.min()) <= 0.5:
        raise ValueError("an orbital has no atom with population > 0.5")
    return [torch.nonzero(where == k)[:, 0].tolist()
            for k in range(len(ao_ranges))]


def iao_pao(S, C_occ, C_core, layout: SiteLayout):
    """The site orbitals W [nao, nsites] (W^T S W = 1) in the program's
    numbering, from the overlap S, the occupied MOs (core included) and
    the core MOs, float64 tensors."""
    n = S.shape[0]
    one = torch.eye(n, dtype=S.dtype, device=S.device)
    val = [i for a in layout.valence_aos for i in a]
    rest = sorted(set(range(n)) - set(val))
    S12 = S[:, val]
    P12 = torch.linalg.solve(S, S12)
    P21 = torch.linalg.solve(S[val][:, val], S12.T)
    # Knizia eq. 1: the depolarized occupied orbitals Ct, and the
    # projectors O, Ot onto the occupied and depolarized spaces
    Ct = P12 @ P21 @ C_occ
    O = C_occ @ C_occ.T
    Ot = Ct @ torch.linalg.solve(Ct.T @ S @ Ct, Ct.T)
    A = O @ S @ Ot @ S @ P12 + (one - O @ S) @ (one - Ot @ S) @ P12
    iao = _symm_orth(A, S)
    pao = _symm_orth((one - iao @ iao.T @ S)[:, rest], S)
    iao_atoms = _by_atom(iao, S, layout.ao_ranges)
    pao_atoms = _by_atom(pao, S, layout.ao_ranges)
    # project the core out of the IAOs, keep those still mostly there
    X = (one - C_core @ C_core.T @ S) @ iao
    kept = torch.nonzero(((X.T @ S) * X.T).sum(1) > 0.5)[:, 0].tolist()
    if len(kept) != iao.shape[1] - C_core.shape[1]:
        raise ValueError("the core is not the IAOs' to remove")
    valence = dict(zip(kept, _symm_orth(X[:, kept], S).T))
    cols = []
    for k, (ia, pa) in enumerate(zip(iao_atoms, pao_atoms)):
        mine = [valence[i] for i in ia if i in valence]
        if len(mine) != layout.nval[k] or len(pa) != (
                layout.lo_ranges[k][1] - layout.lo_ranges[k][0]
                - layout.nval[k]):
            raise ValueError(f"atom {k} holds another number of sites")
        cols += mine + list(pao[:, pa].T)
    return torch.stack(cols, 1)


def iao_fragments(symbols, coords_ang, layout: SiteLayout,
                  n_BE: int) -> list[RefFragment]:
    """Chemgen fragments over the sites: every site of an atom belongs to
    its fragments and centers, and an edge holds only its atoms' valence
    IAO sites (QuEmb matches edges in the minimal basis)."""
    frags = be_fragments(symbols, coords_ang, layout.lo_ranges, n_BE)
    val = layout.valence_sites()
    for fr in frags:
        fr.edges = [[s for s in e if s in val] for e in fr.edges]
    return frags


def in_site_basis(mf: dict, W, ncore: int, device) -> dict:
    """The mean field ``mf`` (host arrays ``hcore``, ``S``, ``eri``,
    ``C``, ``nocc``, ``enuc``) in the orthonormal sites W with its first
    ``ncore`` MOs frozen, in the form :func:`portbench.reference.be.embed`
    takes, as host arrays: S = 1, so its Lowdin orbitals are the sites;
    h holds the core's Coulomb and exchange; C the valence MOs; ``enuc``
    the core's energy.  The sites span all but the core (PAOs are
    orthogonal to the occupied space, the valence IAOs to the core), so
    the valence density is whole in them."""

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                               device=device)

    S, hcore, C, eri = t(mf["S"]), t(mf["hcore"]), t(mf["C"]), t(mf["eri"])
    W = W.to(device)
    nocc = int(mf["nocc"]) - ncore
    P_core = 2.0 * C[:, :ncore] @ C[:, :ncore].T
    v_core = (torch.einsum("pqrs,rs->pq", eri, P_core)
              - 0.5 * torch.einsum("prqs,rs->pq", eri, P_core))
    E_core = float(((hcore + 0.5 * v_core) * P_core).sum())
    for _ in range(4):
        eri = torch.tensordot(eri, W, dims=([0], [0]))
    out = dict(S=torch.eye(W.shape[1], dtype=torch.float64),
               hcore=W.T @ (hcore + v_core) @ W, eri=eri,
               C=W.T @ S @ C[:, ncore:])
    # embed takes host arrays
    out = {k: v.cpu().numpy() for k, v in out.items()}
    return dict(out, nocc=nocc, enuc=float(mf["enuc"]) + E_core)
