"""Density-fitted integral machinery on PyTorch.

JAX counterpart: ``quemb_tpu/ops/df.py``.  The three-index factor
``B[P, mu, nu]`` is generated on the host (the integral engine, scipy
whitening against the metric with the eigh fallback for near-dependent
even-tempered sets) exactly as there; each fragment's (ij|kl) is two
quarter transforms ``(P|ij) = TA^T (P|mu nu) TA`` and one Gram product, as
batched ``torch.matmul`` on the device of the tensors it is given.

The auxiliary basis can be an aux :class:`Mole`, generated even-tempered
("etb[:beta]", "autoaux") from the orbital basis, or the pivoted-Cholesky
factor of the dense ERI ("cholesky[:tol]").

The JAX module chunks the aux axis by a fixed byte budget that exists for
emulated f64 on the TPU; here the aux axis is chunked only when the
half transform would not fit the device's free memory
(:func:`df_transform_batched`).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import scipy.linalg
import torch

from quemb_tpu_torch.chem import integrals
from quemb_tpu_torch.chem.mole import (
    Mole,
    Shell,
    _normalize_contraction,
    ncart,
)
from quemb_tpu_torch.utils.device import resolve_device


def make_even_tempered_auxbasis(mol: Mole, beta: float = 1.8) -> Mole:
    """Even-tempered auxiliary basis generated from the orbital basis
    (the pyscf ``aug_etb`` recipe).

    Per atom: collect min/max orbital exponents PER angular momentum,
    then for each auxiliary l up to 2*l_max span the geometric-mean
    range over (l1, l2) pairs with l1+l2 == l (max doubled: alpha+alpha
    products on one center) with ratio ``beta``.  Per-l ranges keep the
    set compact for polarized bases (a flat [2min, 2max] range for every
    l explodes for cc-pVDZ-class sets) while covering the actual density
    products.
    """
    aux = Mole.__new__(Mole)
    aux.basis = "autoaux"
    aux.charge = mol.charge
    aux.spin = mol.spin
    aux._atoms = list(mol._atoms)
    shells = []
    offset = 0
    aux._aoslice = []
    for ia in range(mol.natm):
        start = offset
        at_shells = [sh for sh in mol.shells if sh.atom_idx == ia]
        lmax = max(sh.l for sh in at_shells)
        emin_l = np.full(lmax + 1, np.inf)
        emax_l = np.zeros(lmax + 1)
        for sh in at_shells:
            emin_l[sh.l] = min(emin_l[sh.l], float(np.min(sh.exps)))
            emax_l[sh.l] = max(emax_l[sh.l], float(np.max(sh.exps)))
        # floor of l_aux = 2 so even s-only atoms (H) get p/d fitting
        # functions (pure 2*l_max starves hydrogen-rich systems)
        for laux in range(max(2 * lmax, 2) + 1):
            pairs = [
                (l1, l2)
                for l1 in range(lmax + 1)
                for l2 in range(lmax + 1)
                if l1 + l2 == laux
            ] or [
                (l1, l2)
                for l1 in range(lmax + 1)
                for l2 in range(lmax + 1)
            ]
            emin = min(
                np.sqrt(emin_l[l1] * emin_l[l2]) for l1, l2 in pairs
            )
            emax = max(
                np.sqrt(emax_l[l1] * emax_l[l2]) for l1, l2 in pairs
            ) * 2.0
            n = max(1, int(np.ceil(np.log(emax / emin) / np.log(beta))))
            for a in emin * beta ** np.arange(n):
                coefs = _normalize_contraction(laux, [a], [1.0])
                shells.append(
                    Shell(
                        laux, np.array([a]), coefs,
                        np.asarray(mol._atoms[ia][1]), ia, offset,
                    )
                )
                offset += ncart(laux)
        aux._aoslice.append((start, offset))
    aux.shells = shells
    aux.nao = offset
    return aux


def cholesky_df_factor(
    mol: Mole, tol: float = 1.0e-10, eri: np.ndarray | None = None
) -> np.ndarray:
    """Pivoted-Cholesky (Beebe-Linderberg) three-index factor.

    Decomposes the ERI supermatrix M[(mu nu),(la si)] = (mu nu|la si) as
    M ~ L L^T by diagonal-pivoted Cholesky, stopping when the largest
    residual diagonal falls below ``tol`` -- so the factorization error
    of EVERY ERI element is bounded by ``tol`` (the residual is PSD, so
    |R_ij| <= sqrt(R_ii R_jj) <= tol).  Returns B [rank, nao, nao],
    drop-in compatible with the aux-basis whitened factor of
    :class:`DFTensor`.

    This is the high-accuracy alternative to tabulated Coulomb-fitting
    sets (reference: ``auxbasis="weigend"``, asserted at atol 1e-10 in
    tests/test_eri_sparse_DF.py:28-44): no published JFIT tables ship in
    this environment, and a threshold-controlled CD meets or exceeds
    their fitting accuracy by construction.  Needs the in-core ERI (or
    one computed here), so it is a *compression*, not a memory-bounded
    generation path; use the even-tempered aux sets when the 4-index ERI
    cannot be held.
    """
    if eri is None:
        eri = integrals.eri_full(mol)
    n = eri.shape[0]
    M = np.ascontiguousarray(np.asarray(eri, np.float64).reshape(
        n * n, n * n
    ))
    d = np.diagonal(M).copy()
    max_rank = n * n
    L = np.zeros((max_rank, n * n))
    piv_mask = np.ones(n * n, bool)
    rank = 0
    while rank < max_rank:
        dm = np.where(piv_mask, d, -np.inf)
        p = int(np.argmax(dm))
        dp = dm[p]
        if dp < tol:
            break
        col = M[:, p] - L[:rank].T @ L[:rank, p]
        ell = col / np.sqrt(dp)
        L[rank] = ell
        d = d - ell * ell
        piv_mask[p] = False
        rank += 1
    return L[:rank].reshape(rank, n, n)


def resolve_auxbasis(mol: Mole, spec):
    """Resolve an ``auxbasis`` argument to a concrete factorization recipe.

    Returns ("mol", auxmol) for metric-whitened aux-basis DF or
    ("cholesky", tol) for the pivoted-CD factor.  Accepted specs:

    - None / Mole        : even-tempered autoaux / explicit aux molecule
    - "autoaux"/"etb"    : even-tempered recipe (optionally "etb:<beta>")
    - "cholesky"         : pivoted CD at 1e-10 (or "cholesky:<tol>")
    - "weigend", "def2-universal-jfit": the reference's Coulomb-fitting
      tables are not shipped in this environment; resolves to the CD
      factor at 1e-10 -- which bounds every ERI element error at 1e-10,
      meeting the accuracy the reference asserts for these sets
      (tests/test_eri_sparse_DF.py:28-44) -- with a loud notice.
    """
    if spec is None:
        return "mol", make_even_tempered_auxbasis(mol)
    if isinstance(spec, Mole):
        return "mol", spec
    s = str(spec).lower()
    if s.startswith(("etb", "autoaux")):
        beta = float(s.split(":", 1)[1]) if ":" in s else 1.8
        return "mol", make_even_tempered_auxbasis(mol, beta=beta)
    if s.startswith("cholesky"):
        tol = float(s.split(":", 1)[1]) if ":" in s else 1.0e-10
        return "cholesky", tol
    if s in ("weigend", "weigend+etb", "def2-universal-jfit", "jfit"):
        import logging

        logging.getLogger(__name__).warning(
            "auxbasis=%r: tabulated Coulomb-fitting sets are not available"
            " in this environment; using the pivoted-Cholesky factor at"
            " tol=1e-10, which bounds every fitted ERI element error by"
            " 1e-10 (at least the tabulated sets' accuracy).", spec,
        )
        return "cholesky", 1.0e-10
    raise ValueError(f"unknown auxbasis spec: {spec!r}")


class DFTensor:
    """Cholesky-whitened 3-center factor: eri ~ sum_P B[P,mu,nu] B[P,la,si].

    ``auxmol`` accepts anything :func:`resolve_auxbasis` does: an aux
    Mole, None (even-tempered autoaux), "etb:<beta>", "cholesky[:tol]",
    or "weigend" (CD-backed, see resolve_auxbasis).
    """

    def __init__(self, mol: Mole, auxmol: Mole | str | None = None):
        self.mol = mol
        kind, arg = resolve_auxbasis(mol, auxmol)
        if kind == "cholesky":
            self.auxmol = None
            self.B = cholesky_df_factor(mol, tol=arg)
            self.naux = self.B.shape[0]
            return
        self.auxmol = arg
        J = integrals.int2c2e(self.auxmol)  # (P|Q)
        P3 = integrals.int3c2e(mol, self.auxmol)  # [nao, nao, naux]
        naux = self.auxmol.nao
        rhs = P3.reshape(-1, naux).T  # [naux, nao*nao]
        # Whiten against the metric; ETB sets can be near-linearly-dependent,
        # so use the eigh pseudo-inverse square root (the reference's
        # cholesky-or-eig fallback, kbe/eri_onthefly.py:18).
        try:
            L = scipy.linalg.cholesky(J, lower=True)
            B = scipy.linalg.solve_triangular(L, rhs, lower=True)
        except np.linalg.LinAlgError:
            w, V = np.linalg.eigh(J)
            keep = w > 1e-10 * w.max()
            B = (V[:, keep] / np.sqrt(w[keep])).T @ rhs
            naux = int(keep.sum())
        self.B = B.reshape(naux, mol.nao, mol.nao)
        self.naux = naux

    def eri_full(self) -> np.ndarray:
        """Dense 4-center ERI reconstructed from the DF factors."""
        B = self.B.reshape(self.naux, -1)
        eri = B.T @ B
        n = self.mol.nao
        return eri.reshape(n, n, n, n)


def df_fragment_eri(B: torch.Tensor, TA: torch.Tensor) -> torch.Tensor:
    """(ij|kl) for one fragment: B [naux, nao, nao], TA [nao, nemb]."""
    return df_transform_batched(B, TA[None])[0]


def _free_bytes(device: torch.device) -> float:
    """Free memory of a CUDA device, with what PyTorch's allocator holds
    in its cache and can hand out again; unbounded elsewhere."""
    if device.type == "cuda":
        return float(torch.cuda.mem_get_info(device)[0]
                     + torch.cuda.memory_reserved(device)
                     - torch.cuda.memory_allocated(device))
    return float("inf")


def df_transform_batched(B: torch.Tensor, TA_b: torch.Tensor) -> torch.Tensor:
    """Fragment ERIs [nf, nemb]^4 for a stack of bases TA_b [nf, nao, nemb].

    The first quarter transform's output is nf * naux * nemb * nao doubles
    (3.1 GB at nf 38, naux 3460, nemb 42, nao 282).  When that and the
    [nf, naux, nemb^2] second half exceed what half the device's free
    memory leaves beside the [nf, nemb^4] result and one partial sum, the
    aux axis is cut into equal chunks that fit and the Gram products
    accumulate; otherwise the whole batch is one pass.  The caller sizes
    nf so that the result fits (``api._cd_fragment_eris``).
    """
    naux, nao, _ = B.shape
    nf, _, nemb = TA_b.shape
    need = 8.0 * nf * naux * nemb * (nao + 2 * nemb)
    room = max(0.5 * _free_bytes(B.device) - 2 * 8.0 * nf * nemb ** 4,
               need / naux)
    nchunk = int(min(naux, max(1, -(-need // room))))
    step = -(-naux // nchunk)
    eri = None
    for p0 in range(0, naux, step):
        Bc = B[p0 : p0 + step]
        Bi = torch.einsum("pmn,fmi->fpin", Bc, TA_b)
        Bij = torch.matmul(Bi, TA_b[:, None])  # [nf, chunk, nemb, nemb]
        Bf = Bij.reshape(nf, Bc.shape[0], nemb * nemb)
        part = Bf.transpose(1, 2) @ Bf
        eri = part if eri is None else eri.add_(part)
    return eri.reshape(nf, nemb, nemb, nemb, nemb)


def block_step_size(nao: int, naux: int, max_memory_gb: float) -> int:
    """AO-row block size for streamed DF generation under a memory budget
    (reference eri_onthefly.py:18 block_step_size): the held block is
    B_blk [naux, blk*nao] f64 plus an equally-sized integral workspace.
    """
    bytes_per_row = 2 * naux * nao * 8
    blk = int(max_memory_gb * 1e9 / max(bytes_per_row, 1))
    return max(1, min(nao, blk))


def _int3c2e_rows(mol: Mole, auxmol, row_shells: list[int]) -> np.ndarray:
    """(mu nu | P) for bra shells restricted to ``row_shells`` (all nu).

    Returns [nao_rows, nao, naux] with nao_rows = AOs of the row shells.
    """
    from quemb_tpu_torch.chem.integrals import (
        _eri_quartets,
        _PairClass,
        _single_shell_pairs,
    )

    shells = mol.shells
    row_set = list(row_shells)
    row_offsets = {}
    off = 0
    for i in row_set:
        row_offsets[i] = off
        off += shells[i].nfunc
    nao_rows = off
    nao = getattr(mol, "nao_cart", mol.nao)
    naux = getattr(auxmol, "nao_cart", auxmol.nao)

    groups = defaultdict(list)
    for i in row_set:
        for j in range(len(shells)):
            si, sj = shells[i], shells[j]
            groups[(si.l, len(si.exps), sj.l, len(sj.exps))].append((i, j))
    aux_classes = _single_shell_pairs(auxmol.shells)
    for pc2 in aux_classes:
        pc2._H = pc2.hermite_coefs()

    out = np.zeros((nao_rows, nao, naux))
    for pairs in groups.values():
        flat, prs = [], []
        for (i, j) in pairs:
            flat += [shells[i], shells[j]]
            prs.append((len(flat) - 2, len(flat) - 1))
        pc1 = _PairClass(flat, prs)
        pc1._H = pc1.hermite_coefs()
        row_off = np.array([row_offsets[i] for (i, j) in pairs])
        col_off = np.array([shells[j].ao_offset for (i, j) in pairs])
        for pc2 in aux_classes:
            bi, ki = np.meshgrid(
                np.arange(pc1.n), np.arange(pc2.n), indexing="ij"
            )
            bi, ki = bi.ravel(), ki.ravel()
            for s in range(0, bi.size, 4096):
                sl = slice(s, min(s + 4096, bi.size))
                val = _eri_quartets(pc1, pc2, bi[sl], ki[sl])
                na, nb = len(pc1.comps_a), len(pc1.comps_b)
                nc = len(pc2.comps_a)
                val = val.reshape(-1, na, nb, nc)
                ra = row_off[bi[sl]]
                cb = col_off[bi[sl]]
                kc = pc2.ao_a[ki[sl]]
                for a in range(na):
                    for b_ in range(nb):
                        for c in range(nc):
                            out[ra + a, cb + b_, kc + c] = val[:, a, b_, c]
    T = getattr(mol, "c2s", None)
    if T is not None:
        from quemb_tpu_torch.chem.sph import c2s_matrix
        from scipy.linalg import block_diag

        Tr = block_diag(*[c2s_matrix(shells[i].l) for i in row_set])
        out = np.einsum(
            "mnp,am,bn->abp", out, Tr, T, optimize=True
        )
    Ta = getattr(auxmol, "c2s", None)
    if Ta is not None:
        out = out @ Ta.T
    return out


class StreamedDF:
    """Blocked/streamed DF factors under a memory budget.

    The whitened factor B is never materialized in full: AO-row blocks
    stream through :meth:`iter_blocks`, bounded by
    ``settings.INTEGRAL_TRANSFORM_MAX_MEMORY`` (reference
    eri_onthefly.py:18-45 blocked generation with prefetch).
    """

    def __init__(self, mol: Mole, auxmol=None, max_memory_gb=None,
                 device: torch.device | str | None = None):
        from quemb_tpu_torch.config import settings

        self.mol = mol
        self.device = resolve_device(device, "StreamedDF")
        kind, arg = resolve_auxbasis(mol, auxmol)
        if kind == "cholesky":
            raise ValueError(
                "StreamedDF generates blocks from an auxiliary basis; the"
                " pivoted-Cholesky factor needs the in-core ERI and is"
                " not memory-bounded -- use DFTensor or an etb auxbasis."
            )
        self.auxmol = arg
        self.max_memory_gb = (
            max_memory_gb
            if max_memory_gb is not None
            else settings.INTEGRAL_TRANSFORM_MAX_MEMORY
        )
        J = integrals.int2c2e(self.auxmol)
        w, V = np.linalg.eigh(J)
        keep = w > 1e-10 * w.max()
        self._M = (V[:, keep] / np.sqrt(w[keep])).T  # whitener [nfit, naux]
        self.naux = int(keep.sum())

    def iter_blocks(self):
        """Yield (ao_row_indices, B_blk [naux, n_rows, nao])."""
        shells = self.mol.shells
        nao = self.mol.nao
        sph = getattr(self.mol, "c2s", None) is not None
        # per-shell AO count and offset in the PUBLIC basis (sph or cart)
        nfunc = [
            (2 * sh.l + 1) if sph else sh.nfunc for sh in shells
        ]
        offs = np.concatenate([[0], np.cumsum(nfunc)])[:-1]
        blk_rows = block_step_size(nao, self.naux, self.max_memory_gb)
        i = 0
        while i < len(shells):
            row_shells = []
            n_rows = 0
            while i < len(shells) and n_rows + nfunc[i] <= max(
                blk_rows, nfunc[i]
            ):
                row_shells.append(i)
                n_rows += nfunc[i]
                i += 1
            p3 = _int3c2e_rows(self.mol, self.auxmol, row_shells)
            B_blk = (self._M @ p3.reshape(-1, p3.shape[-1]).T).reshape(
                self.naux, n_rows, nao
            )
            rows = np.concatenate(
                [
                    np.arange(offs[s], offs[s] + nfunc[s])
                    for s in row_shells
                ]
            )
            yield rows, B_blk

    def fragment_eri(self, TA: np.ndarray) -> torch.Tensor:
        """(ij|kl) accumulated over streamed row blocks (two quarter
        transforms per block + one Gram matmul at the end); the blocks are
        generated on the host and contracted on ``self.device``, where the
        result stays."""
        dev = self.device
        TA_d = torch.as_tensor(np.asarray(TA, np.float64), device=dev)
        nemb = TA.shape[1]
        Bij = torch.zeros((self.naux, nemb, nemb), dtype=torch.float64,
                          device=dev)
        for rows, B_blk in self.iter_blocks():
            Bi = torch.as_tensor(B_blk, device=dev) @ TA_d  # [P, m, j]
            Bij += TA_d[torch.as_tensor(rows, device=dev)].T @ Bi
        Bf = Bij.reshape(self.naux, nemb * nemb)
        return (Bf.T @ Bf).reshape(nemb, nemb, nemb, nemb)
