"""Screened first quarter transform of the DF factor, as a Hopper kernel.

JAX counterpart: ``quemb_tpu/ops/pallas_df.py`` (the Pallas ``_kernel``,
``PallasDFFactor`` and ``screened_first_transform``).

Computes Bi[P, mu, i] = sum_nu B[P, mu, nu] TA[nu, i] over the 16-AO nu
blocks that hold at least one reachable AO (the reach mask of
:func:`quemb_tpu_torch.ops.screening.ao_reach_per_fragment`, reduced to
any-per-block).  On a CUDA tensor it launches the CUDA C++ kernel in
``csrc/screened_first_transform.cu``, which loops over the compacted list
of kept blocks and never reads the columns of a skipped one: a real skip.
:func:`plan_launches` splits a kept list whose rows of TA do not fit the
kernel's shared memory over launches that accumulate.
On a CPU tensor it runs :func:`screened_first_transform_plain`, the same
arithmetic in plain torch.  Nothing falls back from one to the other.

The kernel is compiled with ``nvcc`` for ``sm_90a`` into ``build/`` at the
repository root on first use (:mod:`quemb_tpu_torch.ops.cuda_build`) and
bound with ``ctypes``.  Each launch adds one to the
tracer's ``screened_df.launches`` counter
(:func:`quemb_tpu_torch.utils.profiling.count`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from quemb_tpu_torch.ops import cuda_build
from quemb_tpu_torch.utils.profiling import count

NU_BLOCK = 16
#: kept-block capacity of the kernel's parameter list (nao <= 8192)
MAX_BLOCKS = 512
#: bytes of the kept rows of TA that one launch stages in shared memory,
#: per TF32 part (18 blocks of a 64-column tile); a longer kept list is
#: split over launches that accumulate.  The kernel owns the rest of its
#: layout and rejects a launch that does not fit.
TA_SMEM_MAX = 18 * NU_BLOCK * 64 * 4

_SRC = cuda_build.CSRC / "screened_first_transform.cu"
_LIB = None


def build_library() -> dict:
    """Compile the kernel unless the hashed library is already built
    (:func:`quemb_tpu_torch.ops.cuda_build.build`)."""
    return cuda_build.build(_SRC)


def _library():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build_library()["path"])
        fn = lib.screened_first_transform_f32
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def kept_blocks(reach: np.ndarray) -> np.ndarray:
    """Indices (int32) of the 16-AO blocks holding a reachable AO."""
    reach = np.asarray(reach, bool)
    nblk = -(-reach.size // NU_BLOCK)
    padded = np.zeros(nblk * NU_BLOCK, bool)
    padded[: reach.size] = reach
    return np.nonzero(padded.reshape(nblk, NU_BLOCK).any(axis=1))[0].astype(
        np.int32
    )


def tile_width(nemb: int) -> int:
    """Columns of the kernel's output tile: nemb rounded up to 8, at most
    64 (a wider nemb loops over 64-column chunks)."""
    return min(64, -(-nemb // 8) * 8)


def plan_launches(nemb: int, blocks: np.ndarray) -> list[np.ndarray]:
    """The kept blocks of each kernel launch of one transform.

    The kept list is split into groups whose TA rows fit ``TA_SMEM_MAX``
    (one group, one launch, up to 18 blocks at nemb <= 64); the launches
    after the first add to the output.  No kept block: one launch that
    writes zeros.
    """
    blocks = np.asarray(blocks, np.int32)
    group = TA_SMEM_MAX // (NU_BLOCK * tile_width(nemb) * 4)
    return [blocks[i:i + group]
            for i in range(0, blocks.size, group)] or [blocks]


def block_rowmask(reach: np.ndarray, dtype, device) -> torch.Tensor:
    """Per-AO 0/1 weights: 1 where the AO's 16-block is kept.

    This is the per-block mask expanded to AO rows, not the per-AO reach.
    """
    nao = np.asarray(reach).size
    rows = np.zeros(nao, bool)
    for k in kept_blocks(reach):
        rows[k * NU_BLOCK : (k + 1) * NU_BLOCK] = True
    return torch.as_tensor(rows, device=device).to(dtype)


def screened_first_transform_plain(
    B: torch.Tensor, TA: torch.Tensor, rowmask: torch.Tensor
) -> torch.Tensor:
    """The kernel's arithmetic in plain torch (the reference it is held to).

    ``rowmask`` comes from :func:`block_rowmask`.
    """
    return torch.einsum("pmn,ni->pmi", B, TA * rowmask[:, None])


def _check(B: torch.Tensor, TA: torch.Tensor, reach: np.ndarray) -> None:
    if B.dtype != torch.float32 or TA.dtype != torch.float32:
        raise TypeError(
            f"screened_first_transform takes float32, got {B.dtype}, "
            f"{TA.dtype}"
        )
    if B.dim() != 3 or B.shape[1] != B.shape[2]:
        raise ValueError(f"B must be [naux, nao, nao], got {tuple(B.shape)}")
    nao = B.shape[1]
    if TA.dim() != 2 or TA.shape[0] != nao or TA.shape[1] == 0:
        raise ValueError(
            f"TA must be [nao={nao}, nemb > 0], got {tuple(TA.shape)}"
        )
    if np.shape(reach) != (nao,):
        raise ValueError(f"reach must be [nao={nao}], got {np.shape(reach)}")
    if B.device != TA.device:
        raise ValueError(f"B on {B.device}, TA on {TA.device}")
    if not (B.is_contiguous() and TA.is_contiguous()):
        raise ValueError("B and TA must be contiguous")


def screened_first_transform(
    B: torch.Tensor, TA: torch.Tensor, reach: np.ndarray
) -> torch.Tensor:
    """Bi[P, mu, i] = sum over kept nu blocks of B[P, mu, nu] TA[nu, i].

    ``B`` f32 [naux, nao, nao] and ``TA`` f32 [nao, nemb], contiguous, on
    one device; ``reach`` a host bool [nao].  Returns a new f32
    [naux, nao, nemb] on that device.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel on the current stream
    without synchronising, or raises.
    """
    _check(B, TA, reach)
    if B.device.type == "cpu":
        return screened_first_transform_plain(
            B, TA, block_rowmask(reach, B.dtype, B.device)
        )
    if B.device.type != "cuda":
        raise ValueError(f"no screened-DF kernel for device {B.device}")
    nao = B.shape[1]
    if nao > MAX_BLOCKS * NU_BLOCK:
        raise ValueError(f"nao={nao} exceeds the kernel's {MAX_BLOCKS} blocks")
    if B.data_ptr() % 16:
        raise ValueError("B must start on a 16-byte boundary")
    return run_plan(B, TA, plan_launches(TA.shape[1], kept_blocks(reach)))


def run_plan(B: torch.Tensor, TA: torch.Tensor, plan: list[np.ndarray]):
    """Launch the kernel once per kept list of ``plan`` (see
    :func:`plan_launches`) into a new output, on the current stream."""
    naux, nao, _ = B.shape
    nemb = TA.shape[1]
    out = torch.empty((naux, nao, nemb), dtype=torch.float32, device=B.device)
    stream = torch.cuda.current_stream(B.device).cuda_stream
    for k, blocks in enumerate(plan):
        blocks = np.ascontiguousarray(blocks, np.int32)
        rc = _library().screened_first_transform_f32(
            B.data_ptr(), TA.data_ptr(), blocks.ctypes.data,
            int(blocks.size), out.data_ptr(), naux * nao, nao, nemb,
            int(k > 0), stream,
        )
        if rc != 0:
            raise RuntimeError(
                f"screened_first_transform kernel: CUDA error {rc}"
            )
        count("screened_df.launches")
    return out


class ScreenedDFFactor:
    """The DF factor held once on the device in f32 for the screened
    transform (counterpart of ``PallasDFFactor``).

    Built from the factor [naux, nao, nao], a host array (rounded to f32
    before the upload) or a tensor (rounded on ``device``); kept in its
    natural layout, with no transpose and no padding.
    """

    def __init__(self, B, device: torch.device):
        if isinstance(B, torch.Tensor):
            self.B32 = B.to(device=device, dtype=torch.float32).contiguous()
        else:
            self.B32 = torch.as_tensor(
                np.ascontiguousarray(np.asarray(B, np.float32)),
                device=device,
            )

    def first_transform(self, TA: np.ndarray, reach: np.ndarray):
        """Device f32 [naux, nao, nemb] half transform of ``TA``."""
        TA32 = torch.as_tensor(
            np.ascontiguousarray(np.asarray(TA, np.float32)),
            device=self.B32.device,
        )
        return screened_first_transform(self.B32, TA32, reach)
