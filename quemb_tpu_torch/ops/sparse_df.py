"""Screened sparse-DF fragment ERIs on PyTorch: the f64 tiers and the f32
tier that runs the Hopper kernel.

JAX counterpart: ``quemb_tpu/ops/sparse_df.py`` (``SparseDF``,
``OnFlySparseDF``), selectable as ``BE(int_transform="sparse-DF")`` and
``"on-fly-sparse-DF"``.

The S_abs reachability screen (:mod:`quemb_tpu_torch.ops.screening`)
selects what each fragment needs of the whitened DF factor, and the
transform runs as dense matmuls over the reduced index.

- ``tier="f64"`` (default), banded: on an extended system the geometric
  AO-pair screen S_abs[mu, nu] >= ``ao_eps`` is a band after a
  reverse-Cuthill-McKee ordering.  The factor is gathered once to
  [nblk, b*naux, W] (:func:`_band_gather_device`), the first quarter
  transform is one batched GEMM over row blocks with the fragments folded
  into its N axis (:func:`_banded_first`), the second transform and the
  Gram product run per fragment (:func:`_banded_second`).
- ``tier="f64"``, union gather: where the band is as wide as the molecule,
  the per-MO screen ``mo_eps`` picks each fragment's reachable AOs and the
  factor is gathered to that subset (:meth:`SparseDF.fragment_eri`).
- ``tier="f32-pallas"`` (the name is the JAX package's, so that callers
  and ``QUEMB_TPU_CCSD_F32_ONLY`` mean the same in both): the per-MO screen
  zeroes the unreachable entries of TA; the first quarter transform runs in
  the CUDA kernel of :mod:`quemb_tpu_torch.ops.screened_df` over the 16-AO
  blocks of the union reach, skipping (never reading) the other blocks of
  the factor; the second transform over the exact TA, the (ij)
  symmetrisation that keeps the one-sided screen's permutational symmetry,
  and the Gram product are f32 ``torch.matmul`` in full f32 (no TF32).

Everything but the kernel is ``torch.matmul``/``bmm``/``index_select`` in
f64 on ``SparseDF.device`` (CUDA unless the caller names the CPU); the
screens and the band plan are host numpy/scipy.  Fragment ERIs are
returned as tensors on that device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from quemb_tpu_torch.chem.mole import Mole
from quemb_tpu_torch.ops.df import DFTensor, _free_bytes
from quemb_tpu_torch.ops.screened_df import ScreenedDFFactor
from quemb_tpu_torch.ops.screening import ao_reach_per_fragment, approx_S_abs
from quemb_tpu_torch.utils.device import resolve_device

#: host budget for the folded half transform where the device reports no
#: free-memory figure (the CPU)
_CPU_HALF_TRANSFORM_BYTES = 4.0e9


def _S_abs_of(mol: Mole) -> np.ndarray:
    """:func:`approx_S_abs` of a built molecule, kept on it: the host loop
    over shell pairs takes seconds on a long chain, and every transformer
    of one molecule screens with the same matrix."""
    if getattr(mol, "_S_abs", None) is None:
        mol._S_abs = approx_S_abs(mol)
    return mol._S_abs


def _screened_eri_device_2ta(Bg, TA_first, TA_second):
    """(ij|kl) from the gathered factor Bg [naux, nr, nr]: two quarter
    transforms + one Gram matmul (eri_sparse_DF.cpp:484,560,611).
    The first transform uses the per-MO-screened TA, the second the
    exact TA rows.  The result is symmetrized in (ij) so the one-sided
    screening error keeps the ERI's permutational symmetry."""
    Bi = Bg @ TA_first  # [p, m, i]
    Bij = Bi.transpose(1, 2) @ TA_second  # [p, i, j]
    Bij = 0.5 * (Bij + Bij.transpose(1, 2))
    naux, nemb, _ = Bij.shape
    Bf = Bij.reshape(naux, nemb * nemb)
    eri = Bf.T @ Bf
    return eri.reshape(nemb, nemb, nemb, nemb)


def _gather_B(B, idx):
    """B[:, idx, :][:, :, idx] as two device ``index_select``."""
    return B.index_select(1, idx).index_select(2, idx)


def _band_gather_device(B, perm, col_idx, b):
    """Permute, block, and band-gather the factor on its device.

    [naux, nao, nao] (any float dtype) -> [nblk, b*naux, W] f64, the
    layout :func:`_banded_eri_bucket` consumes.  ``perm`` and ``col_idx``
    are the host arrays of :meth:`SparseDF._band_plan`.  Each row of
    ``col_idx`` is a contiguous window, so block k is the slab
    B[:, perm[k*b:(k+1)*b], :][:, :, perm[window k]]: two ``index_select``
    on a [naux, b, nao] slab per block.  No permuted dense copy of the
    factor and no output-sized index tensor is ever made; the rows past
    nao in the last block are zero.
    """
    naux, nao, _ = B.shape
    nblk, W = col_idx.shape
    dev = B.device
    perm_d = torch.as_tensor(np.asarray(perm, np.int64), device=dev)
    out = torch.zeros((nblk, b, naux, W), dtype=torch.float64, device=dev)
    for k in range(nblk):
        rows = perm_d[k * b : (k + 1) * b]
        cols = perm_d[int(col_idx[k, 0]) : int(col_idx[k, 0]) + W]
        slab = B.index_select(1, rows).index_select(2, cols)  # [p, <=b, W]
        out[k, : rows.numel()] = slab.transpose(0, 1)
    return out.reshape(nblk, b * naux, W)


def _banded_first(Bk, TAb_all):
    """Banded first quarter transform, fragments folded into N.

    [k, (b p), W] x [k, W, (f i)] -> [k, (b p), (f i)].  FLOPs
    naux*nao*W*nemb*F instead of naux*nao^2*nemb*F, and the folded
    N = F*nemb makes one wide GEMM per row block out of F narrow ones.
    """
    return torch.bmm(Bk, TAb_all)


def _banded_second(T, TAp_f, f, nemb):
    """Second quarter transform + symmetrize + Gram for ONE fragment.

    The columns of fragment ``f`` in T [k, (b p), (f i)] are a strided
    slice; flattening it to [(k b), (p i)] is the one copy made here
    (nao_pad*naux*nemb doubles).  The contraction index (k b) then meets
    the TAp_f rows as a transposed GEMM: ``Tf.T`` is a view, so no second
    copy is materialised.
    """
    nblk, xdim, _ = T.shape
    b = TAp_f.shape[0] // nblk
    naux = xdim // b
    Tf = T[:, :, f * nemb : (f + 1) * nemb].reshape(nblk * b, naux * nemb)
    Bij = (Tf.T @ TAp_f).reshape(naux, nemb, nemb)  # [p, i, j]
    Bij = 0.5 * (Bij + Bij.transpose(1, 2))
    Bf = Bij.reshape(naux, nemb * nemb)
    return (Bf.T @ Bf).reshape(nemb, nemb, nemb, nemb)


def _banded_eri_bucket(Bk, TAb_all, TAps_pad):
    """Pair-screened fragment ERIs via the banded first quarter transform.

    ``Bk`` is the RCM-permuted whitened DF factor pre-gathered down to
    each b-row block's reachable column band and laid out
    [nblk, b*naux, W] with the block-row index OUTSIDE the aux index
    (built once per molecule in :meth:`SparseDF._ensure_banded_factor`).
    ``TAb_all[k, w, f*nemb+i]`` holds the band rows of every fragment's
    RCM-permuted basis, gathered on the host (it moves only the small TA
    matrices); ``TAps_pad`` is the zero-padded permuted basis stack
    [F, nblk*b, nemb].

    The live footprint is Bk plus one [nblk*b, naux*F*nemb] half
    transform plus one fragment's slice of it.

    ``TAp`` rows beyond the band only ever ADD pairs vs the
    S_abs >= eps screen (band clipping), so accuracy is bounded by the
    same screen.  Symmetrization + Gram as in
    :func:`_screened_eri_device_2ta`.

    Returns a list of device tensors (one [nemb]^4 ERI per fragment).
    """
    F, _, nemb = TAps_pad.shape
    T = _banded_first(Bk, TAb_all)
    return [_banded_second(T, TAps_pad[f], f, nemb) for f in range(F)]


class _Factor:
    """A factor given by the caller: ``B`` and ``naux``."""


class SparseDF:
    """Screened DF transformer: S_abs screen + reachable-subset gather.

    Two independent screens, with the reference's production defaults
    (``molbe/mbe.py:191-192``):

    - ``mo_eps`` (reference ``MO_coeff_epsilon = 1e-5``): the per-MO
      reachability threshold of :func:`ao_reach_per_fragment` (the C++
      ``get_AO_per_MO`` epsilon, eri_sparse_DF.cpp:443).  AO nu feeds
      MO i only if (S_abs |TA|)[nu, i] >= mo_eps.
    - ``ao_eps`` (reference ``AO_coeff_epsilon = 1e-10``): the geometric
      AO-pair screen S_abs[mu, nu] >= ao_eps (``_get_AO_per_AO``,
      eri_sparse_DF.py:227) that the banded first transform's RCM band
      is built from.

    ``screen_eps`` (legacy single knob) overrides both when given,
    kept for the tight-screen exactness tests.  Smaller eps keeps more
    AOs (tighter energies, more FLOPs).  ``device`` defaults to CUDA.
    """

    def __init__(
        self,
        mol: Mole,
        auxmol: Mole | str | None = None,
        screen_eps: float | None = None,
        tier: str = "f64",
        *,
        mo_eps: float = 1.0e-5,
        ao_eps: float = 1.0e-10,
        device: torch.device | str | None = None,
    ):
        if tier not in ("f64", "f32-pallas"):
            raise ValueError(f"tier={tier}")
        if screen_eps is not None:
            mo_eps = ao_eps = screen_eps
        self.device = resolve_device(device, "SparseDF")
        self.mol = mol
        self.tier = tier
        self.mo_eps = mo_eps
        self.ao_eps = ao_eps
        # legacy alias; the MO screen is the one that bounds the
        # union-gather accuracy
        self.screen_eps = mo_eps
        self.dft = DFTensor(mol, auxmol)
        self._init_common()

    @classmethod
    def from_factor(
        cls,
        mol: Mole,
        B,
        *,
        tier: str = "f64",
        mo_eps: float = 1.0e-5,
        ao_eps: float = 1.0e-10,
        device_upload: str | None = None,
        device: torch.device | str | None = None,
    ) -> "SparseDF":
        """Screened transforms over a precomputed whitened factor.

        ``B`` is a [naux, nao, nao] factor with eri ~ B^T B, a host array
        (e.g. ``DFTensor.B``) or a tensor that already lies on the device
        (e.g. ``RHF.get_df_B()``), so callers that hold the factor skip
        integral generation and metric whitening.  The screen plans are
        rebuilt from the molecule as usual.

        ``device_upload="f32-widen"`` rounds the factor to f32, keeps that
        compact copy on the device and widens it to f64 there; the host
        view ``dft.B`` is widened identically, so both see bit-equal
        factors.  The rounding perturbs the fit by ~1e-7 relative, and the
        screened-vs-dense agreement is exact either way (both sides consume
        the same factor).
        """
        if tier not in ("f64", "f32-pallas"):
            raise ValueError(f"tier={tier}")
        self = cls.__new__(cls)
        self.device = resolve_device(device, "SparseDF")
        self.mol = mol
        self.tier = tier
        self.mo_eps = mo_eps
        self.ao_eps = ao_eps
        self.screen_eps = mo_eps
        self.dft = _Factor()
        if device_upload == "f32-widen":
            if isinstance(B, torch.Tensor):
                B32 = B.to(torch.float32)
                self.dft.B = B32.to(torch.float64)
            else:
                B32 = np.ascontiguousarray(np.asarray(B, np.float32))
                self.dft.B = B32.astype(np.float64)
            self._B32_dev = torch.as_tensor(B32, device=self.device)
        elif device_upload not in (None, "f64"):
            raise ValueError(f"device_upload={device_upload}")
        else:
            self.dft.B = B if isinstance(B, torch.Tensor) else (
                np.ascontiguousarray(B)
            )
        self.dft.naux = B.shape[0]
        self._init_common()
        return self

    def _init_common(self):
        self.naux = self.dft.naux
        self.S_abs = _S_abs_of(self.mol)
        # diagnostics for logging
        self.last_reach_fraction: float | None = None
        self.band_fraction: float | None = None

    @property
    def _B_dev(self) -> torch.Tensor:
        """Dense whitened factor on the device, created lazily and cached
        ONLY for the union-gather path.  In the banded regime the class
        keeps the factor on the device in its banded layout alone
        (band_fraction of the dense size)."""
        if not hasattr(self, "_B_dev_cache"):
            if hasattr(self, "_B32_dev"):
                # widen the resident compact factor on the device:
                # bit-equal to the widened host view
                self._B_dev_cache = self._B32_dev.to(torch.float64)
            else:
                self._B_dev_cache = torch.as_tensor(
                    self.dft.B, device=self.device
                )
        return self._B_dev_cache

    @property
    def factor(self) -> ScreenedDFFactor:
        """The f32 copy of the factor that the kernel reads, made once."""
        if not hasattr(self, "_screened_factor"):
            self._screened_factor = ScreenedDFFactor(
                getattr(self, "_B32_dev", self.dft.B), self.device
            )
        return self._screened_factor

    def reach(self, TA: np.ndarray) -> np.ndarray:
        return ao_reach_per_fragment(self.S_abs, TA, eps=self.mo_eps)

    def screen(self, TA: np.ndarray):
        """Per-MO screen of ``TA``: (TA_eff, union reach).

        TA_eff zeroes TA[nu, i] where (S_abs |TA|)[nu, i] < mo_eps; the
        union reach marks the AOs that feed any orbital.
        """
        M = self.S_abs @ np.abs(TA) >= self.mo_eps
        return np.where(M, TA, 0.0), M.any(axis=1)

    def _band_plan(self):
        """Banded pair-screen plan (computed once per molecule).

        The reference's effective sparse-DF screen is the *geometric*
        AO-pair screen S_abs[mu, nu] >= eps (``_get_AO_per_AO``,
        eri_sparse_DF.py:227 -- no MO coefficients involved), which on
        extended systems keeps O(N) pairs.  Here that pair set is made a
        *band*: reverse-Cuthill-McKee orders the AOs so every significant
        pair sits within a fixed bandwidth W (set by the screen's physical
        range, independent of system size), and the first quarter
        transform becomes a static-shape batched GEMM over row blocks x
        their column bands.

        Returns (perm, col_idx[nblk, W], b, W) or None when banding
        cannot beat the dense path (W ~ nao on compact molecules).
        """
        if hasattr(self, "_band_cache"):
            return self._band_cache
        import scipy.sparse as _sp
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        nao = self.mol.nao
        b = 8
        A = self.S_abs >= self.ao_eps
        perm = np.asarray(
            reverse_cuthill_mckee(_sp.csr_matrix(A), symmetric_mode=True)
        )
        Ap = A[np.ix_(perm, perm)]
        nblk = -(-nao // b)
        lo = np.zeros(nblk, dtype=np.int64)
        hi = np.zeros(nblk, dtype=np.int64)
        for k in range(nblk):
            rows = Ap[k * b : (k + 1) * b]
            nz = np.nonzero(rows.any(axis=0))[0]
            lo[k], hi[k] = (nz[0], nz[-1] + 1) if nz.size else (0, 1)
        W = int((hi - lo).max())
        W = min(nao, -(-W // 32) * 32)  # pad: share shapes across blocks
        self.band_fraction = W / nao
        if W >= nao:
            self._band_cache = None
            return None
        start = np.clip(lo, 0, nao - W)
        col_idx = start[:, None] + np.arange(W)[None, :]
        self._band_cache = (perm, col_idx, b, W)
        return self._band_cache

    def _ensure_banded_factor(self):
        """Permute, block, and band-gather the whitened factor (once).

        The stored factor is reduced to the band -- band_fraction of the
        dense size -- and laid out [nblk, b*naux, W] with the block-row
        index outermost and the intra-block row index OUTSIDE the aux
        index (see :func:`_banded_eri_bucket` for why), so the
        per-fragment work is pure GEMMs with no gathers or large
        transposes.  The gather reads the compact f32 copy if there is
        one, the cached dense copy if the union path made one, and
        otherwise a dense f64 upload that is a temporary of this method:
        the class does not keep a dense copy beside the banded one.
        """
        if hasattr(self, "_Bk_dev"):
            return
        perm, col_idx, b, W = self._band_plan()
        if hasattr(self, "_B32_dev"):
            B_src = self._B32_dev
        elif hasattr(self, "_B_dev_cache"):
            B_src = self._B_dev_cache
        else:
            B_src = torch.as_tensor(self.dft.B, device=self.device)
        self._Bk_dev = _band_gather_device(B_src, perm, col_idx, b)

    def _banded_host_prep(self, TAs: list[np.ndarray]):
        """Band gather + padding for a same-nemb fragment list.

        Returns (TAb_all [nblk, W, F*nemb], TAps_pad [F, nblk*b, nemb])
        on the device, ready for :func:`_banded_eri_bucket`.  The host only
        permutes and pads the small TA matrices; the band rows
        ``TAp[col_idx]`` are gathered on the device from the uploaded
        stack.  (The JAX package gathers them on the host because a device
        ``take`` there bloated the compile; in numpy the same gather costs
        0.13-0.17 s for 35 fragments at C40H82, three times the device
        work of the whole bucket.)
        """
        perm, col_idx, b, W = self._band_plan()
        nblk = col_idx.shape[0]
        pad = nblk * b - self.mol.nao
        TAps_pad = torch.as_tensor(np.stack([
            np.concatenate([TA[perm], np.zeros((pad, TA.shape[1]))])
            for TA in TAs
        ]), device=self.device)  # [F, nblk*b, nemb]
        F, _, nemb = TAps_pad.shape
        if not hasattr(self, "_col_idx_dev"):
            self._col_idx_dev = torch.as_tensor(col_idx, device=self.device)
        TAb_all = TAps_pad[:, self._col_idx_dev]  # [F, nblk, W, nemb]
        TAb_all = TAb_all.permute(1, 2, 0, 3).reshape(nblk, W, F * nemb)
        return TAb_all, TAps_pad

    def fragment_eri_banded(self, TA: np.ndarray) -> torch.Tensor:
        """f64 pair-screened fragment ERI via the banded first transform.

        Falls back to :meth:`fragment_eri` when the band plan reports no
        win (band_fraction ~ 1 on compact molecules).
        """
        plan = self._band_plan()
        if plan is None:
            return self.fragment_eri(TA)
        self.last_reach_fraction = self.band_fraction
        self._ensure_banded_factor()
        TAb_all, TAps_pad = self._banded_host_prep([TA])
        return _banded_eri_bucket(self._Bk_dev, TAb_all, TAps_pad)[0]

    def _screen_pad(self, TA: np.ndarray):
        """Per-MO screen + union gather set.

        Reference semantics (``_get_AO_per_MO``, eri_sparse_DF.py:211):
        AO nu contributes to MO i only if (S_abs |TA|)[nu, i] >= eps.
        Entries of TA outside each orbital's reachable set are zeroed
        for the first quarter transform, which is exactly the reference's
        skipped sparse-pair contributions.  The JAX package pads the reach
        set to a multiple of ``QUEMB_TPU_SDF_PAD`` (default 32 there) so
        that compiled programs are shared; eager torch has nothing to
        share, so the default here is 1 (no pad).  The variable keeps its
        meaning: padding rows gather AO 0 of the factor but carry zero TA
        rows, so they change no number.

        Returns (idx, TA_eff, TA_ex, reach_fraction).
        """
        X = self.S_abs @ np.abs(TA)
        M = X >= self.mo_eps
        union = M.any(axis=1)
        idx = np.nonzero(union)[0]
        frac = idx.size / self.mol.nao
        TA_eff = np.where(M, TA, 0.0)[idx]
        TA_ex = TA[idx]
        pad = int(os.environ.get("QUEMB_TPU_SDF_PAD", "1"))
        n_pad = -idx.size % pad
        if n_pad:
            idx = np.concatenate([idx, np.zeros(n_pad, idx.dtype)])
            z = np.zeros((n_pad, TA.shape[1]))
            TA_eff = np.vstack([TA_eff, z])
            TA_ex = np.vstack([TA_ex, z])
        return idx, TA_eff, TA_ex, frac

    def fragment_eri(self, TA: np.ndarray) -> torch.Tensor:
        """f64 screened fragment ERI for one fragment basis TA.

        The factor is gathered down to the union of reachable AOs
        (:meth:`_screen_pad`) so FLOPs and traffic scale with the union
        size; the second transform uses the exact (unscreened) TA rows.
        """
        idx, TA_eff, TA_ex, frac = self._screen_pad(TA)
        self.last_reach_fraction = frac
        dev = self.device
        Bg = _gather_B(self._B_dev, torch.as_tensor(idx, device=dev))
        return _screened_eri_device_2ta(
            Bg, torch.as_tensor(TA_eff, device=dev),
            torch.as_tensor(TA_ex, device=dev),
        )

    def fragment_eri_f32(self, TA: np.ndarray) -> torch.Tensor:
        """Screened f32 fragment ERI [nemb]^4 (returned as f64 on the
        device).  The first transform is the kernel; the rest is f32
        matmul.  Per-MO screening semantics match :meth:`fragment_eri`."""
        if (
            self.device.type == "cuda"
            and torch.get_float32_matmul_precision() != "highest"
        ):
            raise RuntimeError(
                "the f32 tier needs full-f32 matmuls: "
                "torch.get_float32_matmul_precision() must be 'highest'"
            )
        TA_eff, union = self.screen(TA)
        self.last_reach_fraction = float(union.sum()) / self.mol.nao
        Bi = self.factor.first_transform(TA_eff, union)  # [naux, nao, nemb]
        TA32 = torch.as_tensor(
            np.asarray(TA, np.float32), device=self.device
        )
        Bij = Bi.transpose(1, 2) @ TA32  # [naux, nemb, nemb]
        Bij = 0.5 * (Bij + Bij.transpose(1, 2))
        naux, nemb, _ = Bij.shape
        Bf = Bij.reshape(naux, nemb * nemb)
        eri = Bf.T @ Bf
        return eri.to(torch.float64).reshape(nemb, nemb, nemb, nemb)

    def _banded_chunk(self, nemb: int) -> int:
        """Fragments folded into one banded first GEMM.

        ``QUEMB_TPU_SDF_CHUNK`` sets it.  Otherwise it is what fits: the
        folded half transform is nblk*b * naux * nemb * 8 bytes per
        fragment (288 * 3460 * 42 * 8 = 335 MB at C40H82/etb:6.0), and the
        count is a quarter of the device's free memory over that, which
        leaves room for one fragment's slice, the Gram products and the
        ERIs already made.  The CPU has no free-memory figure and takes a
        4 GB budget.  A bigger count is a wider N in the first GEMM.
        """
        env = os.environ.get("QUEMB_TPU_SDF_CHUNK")
        if env:
            return max(1, int(env))
        nblk, b = self._band_plan()[1].shape[0], self._band_plan()[2]
        per_fragment = 8.0 * nblk * b * self.naux * nemb
        budget = min(0.25 * _free_bytes(self.device),
                     _CPU_HALF_TRANSFORM_BYTES
                     if self.device.type == "cpu" else float("inf"))
        return max(1, int(budget // per_fragment))

    def transform_all(self, TAs: list[np.ndarray], fetch: bool = False):
        """Screened transforms for every fragment.

        The per-fragment ERIs are tensors on ``self.device`` (the solver
        consumes them there); ``fetch=True`` copies them to host numpy.
        Three branches: banded (f64 tier on an extended system, equal-nemb
        fragments folded :meth:`_banded_chunk` at a time into the first
        GEMM), the f32 tier (one kernel launch per fragment), and the
        union gather (one fragment at a time, so that one gathered factor
        is live).
        """
        if self.tier != "f32-pallas" and self._band_plan() is not None:
            self._ensure_banded_factor()
            out = [None] * len(TAs)
            buckets: dict[int, list[int]] = {}
            for i, TA in enumerate(TAs):
                buckets.setdefault(TA.shape[1], []).append(i)
            for nemb, idxs in buckets.items():
                chunk = self._banded_chunk(nemb)
                for c0 in range(0, len(idxs), chunk):
                    part = idxs[c0 : c0 + chunk]
                    TAb_all, TAps_pad = self._banded_host_prep(
                        [TAs[i] for i in part]
                    )
                    eb = _banded_eri_bucket(self._Bk_dev, TAb_all, TAps_pad)
                    for j, i in enumerate(part):
                        out[i] = eb[j]
            self.last_reach_fraction = self.band_fraction
        else:
            one = (self.fragment_eri_f32 if self.tier == "f32-pallas"
                   else self.fragment_eri)
            out, fracs = [], []
            for TA in TAs:
                out.append(one(TA))
                fracs.append(self.last_reach_fraction)
            self.last_reach_fraction = (
                float(np.mean(fracs)) if fracs else None
            )
        if fetch:
            return [e.cpu().numpy() for e in out]
        return out


class OnFlySparseDF:
    """Memory-bounded sparse-DF: (P|mu nu) recomputed per fragment.

    The reference's ``on-fly-sparse-DF`` transform (molbe/mbe.py:63-71;
    eri_sparse_DF.py ``precompute_P_mu_nu=False``) never holds the full
    3-center tensor: for each fragment only the reachable-AO rows of
    (P|mu nu) are generated on the host, in shell blocks bounded by
    ``max_memory_gb`` (default
    ``settings.INTEGRAL_TRANSFORM_MAX_MEMORY``), quarter-transformed on
    ``device`` and discarded.  Peak host memory is ~2 * naux * blk * nao
    doubles regardless of system size; FLOPs match :class:`SparseDF` (the
    same S_abs screen selects the rows).

    Requires an auxiliary-basis fit (the pivoted-Cholesky factor needs
    the in-core ERI and defeats the purpose here).
    """

    def __init__(
        self,
        mol: Mole,
        auxmol=None,
        screen_eps: float | None = None,
        max_memory_gb: float | None = None,
        *,
        mo_eps: float = 1.0e-5,
        device: torch.device | str | None = None,
    ):
        from quemb_tpu_torch.chem import integrals
        from quemb_tpu_torch.config import settings
        from quemb_tpu_torch.ops.df import resolve_auxbasis

        kind, arg = resolve_auxbasis(mol, auxmol)
        if kind == "cholesky":
            raise ValueError(
                "on-fly-sparse-DF generates (P|mu nu) blocks from an"
                " auxiliary basis; the pivoted-Cholesky factor needs the"
                " in-core ERI -- use int_transform='sparse-DF' for it."
            )
        if screen_eps is not None:
            mo_eps = screen_eps
        self.device = resolve_device(device, "OnFlySparseDF")
        self.mol = mol
        self.auxmol = arg
        self.mo_eps = mo_eps
        self.screen_eps = mo_eps  # legacy alias
        self.max_memory_gb = (
            max_memory_gb
            if max_memory_gb is not None
            else settings.INTEGRAL_TRANSFORM_MAX_MEMORY
        )
        J = integrals.int2c2e(self.auxmol)
        w, V = np.linalg.eigh(J)
        keep = w > 1e-10 * w.max()
        self._M = (V[:, keep] / np.sqrt(w[keep])).T  # [nfit, naux]
        self.naux = int(keep.sum())
        self.S_abs = _S_abs_of(mol)
        self.last_reach_fraction: float | None = None

    def fragment_eri(self, TA: np.ndarray) -> torch.Tensor:
        from quemb_tpu_torch.ops.df import _int3c2e_rows, block_step_size

        mol = self.mol
        nao = mol.nao
        nemb = TA.shape[1]
        dev = self.device
        X = self.S_abs @ np.abs(TA)
        Mmask = X >= self.mo_eps
        union = Mmask.any(axis=1)
        self.last_reach_fraction = float(union.sum()) / nao
        TA_eff = np.where(Mmask, TA, 0.0)

        # shell bookkeeping in the public (sph or cart) basis
        shells = mol.shells
        sph = getattr(mol, "c2s", None) is not None
        nfunc = [(2 * sh.l + 1) if sph else sh.nfunc for sh in shells]
        offs = np.concatenate([[0], np.cumsum(nfunc)])[:-1].astype(int)
        reach_shells = [
            s for s in range(len(shells))
            if union[offs[s] : offs[s] + nfunc[s]].any()
        ]

        blk_rows = block_step_size(nao, self.naux, self.max_memory_gb)
        TA_d = torch.as_tensor(np.asarray(TA, np.float64), device=dev)
        Bij = torch.zeros((self.naux, nemb, nemb), dtype=torch.float64,
                          device=dev)
        i = 0
        while i < len(reach_shells):
            row_shells = []
            n_rows = 0
            while i < len(reach_shells) and n_rows + nfunc[
                reach_shells[i]
            ] <= max(blk_rows, nfunc[reach_shells[i]]):
                row_shells.append(reach_shells[i])
                n_rows += nfunc[reach_shells[i]]
                i += 1
            p3 = _int3c2e_rows(mol, self.auxmol, row_shells)
            B_blk = (self._M @ p3.reshape(-1, p3.shape[-1]).T).reshape(
                self.naux, n_rows, nao
            )
            rows = np.concatenate(
                [np.arange(offs[s], offs[s] + nfunc[s])
                 for s in row_shells]
            )
            Bi = torch.as_tensor(B_blk, device=dev) @ TA_d  # [p, m, j]
            Bij += torch.as_tensor(TA_eff[rows], device=dev).T @ Bi
        # symmetrize: the row side is screened, the column side exact
        Bij = 0.5 * (Bij + Bij.transpose(1, 2))
        Bf = Bij.reshape(self.naux, nemb * nemb)
        return (Bf.T @ Bf).reshape(nemb, nemb, nemb, nemb)

    def transform_all(self, TAs: list[np.ndarray], fetch: bool = False):
        out = []
        fracs = []
        for TA in TAs:
            out.append(self.fragment_eri(TA))
            fracs.append(self.last_reach_fraction)
        self.last_reach_fraction = float(np.mean(fracs)) if fracs else None
        if fetch:
            return [e.cpu().numpy() for e in out]
        return out
