"""8-fold-symmetry ERI packing (s8), vectorized.

Used to ship compact integral fixtures (e.g. the octane benchmark HF cache)
and for scratch-light ERI storage: a chemist-notation ERI (pq|rs) with
p<->q, r<->s, pq<->rs symmetry stores only npair*(npair+1)/2 unique values
(npair = nao*(nao+1)/2), an 8x reduction over the dense tensor.

Analog of the reference's use of ``pyscf.ao2mo.restore`` 1<->8 fold
(reference molbe/helper.py:154 get_eri reads s8 HDF5 and restores).

JAX counterpart: ``quemb_tpu/utils/eri_pack.py``, of which this is a copy (it
holds no jax).
"""

from __future__ import annotations

import numpy as np


def pack_eri_s8(eri: np.ndarray) -> np.ndarray:
    """Pack a dense 8-fold-symmetric ERI [nao]^4 into its unique values."""
    nao = eri.shape[0]
    iu = np.triu_indices(nao)
    pairs = eri[iu[0], iu[1]][:, iu[0], iu[1]]  # [npair, npair]
    ju = np.triu_indices(pairs.shape[0])
    return np.ascontiguousarray(pairs[ju])


def unpack_eri_s8(packed: np.ndarray, nao: int) -> np.ndarray:
    """Restore the dense [nao]^4 ERI from :func:`pack_eri_s8` output."""
    npair = nao * (nao + 1) // 2
    pairs = np.zeros((npair, npair), dtype=packed.dtype)
    ju = np.triu_indices(npair)
    pairs[ju] = packed
    pairs.T[ju] = packed
    iu = np.triu_indices(nao)
    tmp = np.zeros((npair, nao, nao), dtype=packed.dtype)
    tmp[:, iu[0], iu[1]] = pairs
    tmp[:, iu[1], iu[0]] = pairs
    full = np.zeros((nao, nao, nao, nao), dtype=packed.dtype)
    full[iu[0], iu[1]] = tmp
    full[iu[1], iu[0]] = tmp
    return full
