"""Bootstrap embedding at given matching potentials, worked out again.

From a closed-shell mean field (hcore, S, the AO ERI, the MO coefficients
and the nuclear repulsion) and the fragments of
:mod:`portbench.reference.fragments`: Lowdin orbitals, the Schmidt bath
of the Hartree-Fock density, fragment Hamiltonians with the environment's
mean-field potential, the HF-in-HF energy, then at a matching potential
each fragment's RHF, CCSD, its 1- and 2-RDMs with the amplitudes standing
in for the lambda amplitudes (QuEmb's unrelaxed CCSD densities), the
center-row energies and the density-matching error.  One fragment at a
time, float64, on any torch device, TF32 off.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from portbench.reference.ccsd import rccsd
from portbench.reference.fragments import RefFragment

es = torch.einsum


def transform4(eri, C):
    """(pq|rs) -> sum C_pi C_qj C_rk C_sl (pq|rs), one index at a time."""
    for _ in range(4):
        eri = torch.tensordot(eri, C, dims=([0], [0]))
    return eri


def _jk(eri, dm):
    return es("pqrs,rs->pq", eri, dm), es("prqs,rs->pq", eri, dm)


def scf(h, eri, nocc: int, dm, tol: float = 1e-12, max_cycle: int = 300):
    """Closed-shell RHF in an orthonormal basis with Pulay DIIS, from the
    density ``dm``.  Returns (mo_energy, mo_coeff, dm, cycles)."""
    errs, focks = [], []
    for cycle in range(1, max_cycle + 1):
        J, K = _jk(eri, dm)
        F = h + J - 0.5 * K
        errs.append((F @ dm - dm @ F).reshape(-1))
        focks.append(F)
        errs, focks = errs[-8:], focks[-8:]
        m = len(errs)
        if m > 1:
            E = torch.stack(errs)
            B = torch.zeros((m + 1, m + 1), dtype=h.dtype)
            B[:m, :m] = (E @ E.T).cpu()
            B[:m, m] = B[m, :m] = -1.0
            rhs = torch.zeros(m + 1, dtype=h.dtype)
            rhs[m] = -1.0
            c = torch.linalg.lstsq(B, rhs[:, None]).solution[:m, 0]
            F = (c.to(h.device)[:, None, None] * torch.stack(focks)).sum(0)
        _, C = torch.linalg.eigh(F)
        new = 2.0 * C[:, :nocc] @ C[:, :nocc].T
        step = float((new - dm).abs().max())
        dm = new
        if step < tol:
            break
    J, K = _jk(eri, dm)
    e, C = torch.linalg.eigh(h + J - 0.5 * K)
    return e, C, dm, cycle


@dataclass
class FragmentProblem:
    """A fragment's embedding Hamiltonian at zero potential."""

    frag: RefFragment
    nf: int          # fragment sites
    nsocc: int
    h1: torch.Tensor
    veff0: torch.Tensor
    fock: torch.Tensor  # h1 + the environment's potential
    eri: torch.Tensor
    dm0: torch.Tensor   # fragment HF density at zero potential
    e_hf: float         # the fragment's HF-in-HF center-row energy


def embed(mf: dict, frags: list[RefFragment], device,
          thr_bath: float = 1e-10) -> tuple[list[FragmentProblem], float]:
    """Fragment problems and the HF-in-HF total energy.  ``mf``: host
    arrays ``hcore``, ``S``, ``eri`` [nao]^4, ``C``, and ``nocc``,
    ``enuc``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                               device=device)

    S, hcore, C, eri = t(mf["S"]), t(mf["hcore"]), t(mf["C"]), t(mf["eri"])
    nocc = int(mf["nocc"])
    w, V = torch.linalg.eigh(S)
    W = (V * w.rsqrt()) @ V.T                       # Lowdin orbitals
    Cocc = C[:, :nocc]
    lmo_occ = W.T @ S @ Cocc
    D = lmo_occ @ lmo_occ.T
    dm_hf = 2.0 * Cocc @ Cocc.T
    J, K = _jk(eri, dm_hf)
    veff_hf = J - 0.5 * K
    nlo = W.shape[1]
    out, e_hf = [], float(mf["enuc"])
    for fr in frags:
        sites = torch.as_tensor(fr.sites, device=device)
        env_mask = torch.ones(nlo, dtype=torch.bool, device=device)
        env_mask[sites] = False
        env = torch.nonzero(env_mask)[:, 0]
        lam, U = torch.linalg.eigh(D[env][:, env])
        keep = (lam.abs() > thr_bath) & (lam.abs() < 1.0 - thr_bath)
        bath = U[:, keep]
        nf = len(fr.sites)
        TA_lo = torch.zeros((nlo, nf + bath.shape[1]), dtype=S.dtype,
                            device=device)
        TA_lo[sites, torch.arange(nf, device=device)] = 1.0
        TA_lo[env[:, None], nf + torch.arange(bath.shape[1],
                                              device=device)[None]] = bath
        TA = W @ TA_lo
        ST = S @ TA
        nsocc = int(round(float((ST.T @ Cocc).square().sum())))
        h1 = TA.T @ hcore @ TA
        veff0 = TA.T @ veff_hf @ TA
        eri_f = transform4(eri, TA)
        P = ST.T @ dm_hf @ ST
        Jf, Kf = _jk(eri_f, P)
        fock = h1 + veff0 - (Jf - 0.5 * Kf)
        _, Cf, dm0, _ = scf(fock, eri_f, nsocc, P)
        g = 0.5 * dm0                               # half density
        Jg, Kg = _jk(eri_f, g)
        rows = (2.0 * (h1 * g).sum(1) + ((fock - h1) * g).sum(1)
                + 2.0 * (Jg * g).sum(1) - (Kg * g).sum(1))
        cen = [fr.sites.index(s) for s in fr.centers]
        e_f = float(rows[cen].sum())
        e_hf += e_f
        out.append(FragmentProblem(fr, nf, nsocc, h1, veff0, fock, eri_f,
                                   dm0, e_f))
    return out, e_hf


def _rdms(t1, t2, nocc: int):
    """Unrelaxed CCSD 1-RDM and cumulant 2-RDM (chemist order) in the MO
    basis with lambda = t (QuEmb's ``make_rdm1_ccsd_t1`` and
    ``make_rdm2_urlx``)."""
    no, nv = t1.shape
    n = no + nv
    o, v = slice(0, no), slice(no, n)
    g = 0.5 * (es("ia,jb->ijab", t1, t1) + t2)       # [i, j, a, b]
    # d[i, a, j, b] = 2 g[i, j, a, b] - g[j, i, a, b]
    d = 2.0 * g.permute(0, 2, 1, 3) - g.permute(1, 2, 0, 3)
    blk = d + d.permute(2, 3, 0, 1)
    dm2 = t1.new_zeros((n, n, n, n))
    dm2[o, v, o, v] = blk
    dm2[v, o, v, o] = blk.permute(1, 0, 3, 2)
    dm1 = t1.new_zeros((n, n))
    dm1[o, v] = t1
    dm1[v, o] = t1.T
    dm1[range(no), range(no)] += 2.0
    return dm1, dm2


@dataclass
class Solved:
    rdm1: torch.Tensor   # half 1-RDM in the embedding basis
    e_rows: float        # correlation energy of the center rows
    ccsd_iter: int
    ccsd_delta: float


def solve(p: FragmentProblem, heff: torch.Tensor) -> Solved:
    """One fragment at potential ``heff`` [nemb, nemb]: RHF, CCSD, RDMs and
    its center-row correlation energy."""
    e, C, _, _ = scf(p.fock + heff, p.eri, p.nsocc, p.dm0)
    eri_mo = transform4(p.eri, C)
    t1, t2, _, it, delta = rccsd(eri_mo, e, p.nsocc)
    dm1, dm2 = _rdms(t1, t2, p.nsocc)
    rdm1 = C @ (0.5 * dm1) @ C.T
    hf = C[:, : p.nsocc] @ C[:, : p.nsocc].T
    delta1 = 2.0 * (rdm1 - hf)
    e1 = (p.h1 * delta1).sum(1) + (p.veff0 * delta1).sum(1)
    e2 = (transform4(0.5 * dm2, C.T) * p.eri).sum((1, 2, 3))
    cen = [p.frag.sites.index(s) for s in p.frag.centers]
    return Solved(rdm1, float((e1 + e2)[cen].sum()), it, delta)


def matching_error(problems: list[FragmentProblem], solved: list[Solved],
                   nocc: int, only_chem: bool) -> float:
    """Root mean square of the density-matching conditions: each edge's
    1-RDM block against the same sites in the fragment where they are
    centers (upper triangles), and the electron count of the centers;
    with ``only_chem``, the electron count alone."""
    count = sum(float(s.rdm1[[p.frag.sites.index(c) for c in p.frag.centers],
                             [p.frag.sites.index(c) for c in p.frag.centers]]
                      .sum()) for p, s in zip(problems, solved))
    if only_chem:
        return abs(count - nocc)
    errs = [count - nocc]
    for p, s in zip(problems, solved):
        for edge, ref in zip(p.frag.edges, p.frag.edge_ref):
            q, r = problems[ref], solved[ref]
            a = [p.frag.sites.index(x) for x in edge]
            b = [q.frag.sites.index(x) for x in edge]
            for j in range(len(edge)):
                for k in range(j, len(edge)):
                    errs.append(float(s.rdm1[a[j], a[k]]
                                      - r.rdm1[b[j], b[k]]))
    return float(np.sqrt(np.mean(np.square(errs))))
