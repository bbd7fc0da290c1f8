"""Screened first quarter transform: the port's kernel module against the
JAX package's Pallas kernel.

On the CPU the port's wrapper runs its plain torch version; it is held to
``quemb_tpu.ops.pallas_df.screened_first_transform`` in interpret mode at
1e-5 relative (both sum the same f32 products, in different
orders).  The ``gpu`` tests hold the CUDA kernel (3xTF32 on the tensor
cores, FP32 to about 1e-6 relative) to the plain version on the card at
the same tolerance; the JAX package is imported inside the tests that
use it, so that the ``gpu`` tests also run where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_screened_df.py
"""

import numpy as np
import pytest
import torch

from quemb_tpu_torch.ops import screened_df as sd
from quemb_tpu_torch.utils.profiling import total

torch.set_num_threads(1)

REL_TOL = 1e-5


def _skip_case():
    """nao 70 (five 16-blocks, the last ragged): blocks 1 and 3 are
    unreachable, block 4 is reachable through one AO only."""
    reach = np.ones(70, bool)
    reach[16:32] = False
    reach[48:70] = False
    reach[66] = True
    return 64, 70, 37, reach


def _full_case():
    return 24, 21, 5, np.ones(21, bool)


def _wide_case():
    """nemb 130: more than one 64-column chunk; nao 37 is odd (rows only
    4-byte aligned) and block 1 of 3 is unreachable."""
    reach = np.ones(37, bool)
    reach[16:32] = False
    return 6, 37, 130, reach


def _empty_case():
    """No reachable AO: no block is kept and the output is all zeros."""
    return 8, 40, 12, np.zeros(40, bool)


def _chain_case():
    """C40 widths (nao 282, nemb 42) at naux 4: a window of blocks 5-12
    and the ragged tail block 17 (AOs 272-281) kept."""
    reach = np.zeros(282, bool)
    reach[80:208] = True
    reach[275] = True
    return 4, 282, 42, reach


CASES = {"full": _full_case, "skip": _skip_case, "wide": _wide_case,
         "empty": _empty_case, "chain": _chain_case}


def _inputs(case, seed=0):
    naux, nao, nemb, reach = CASES[case]()
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((naux, nao, nao))
    B = (L + L.transpose(0, 2, 1)).astype(np.float32)
    TA = rng.standard_normal((nao, nemb)).astype(np.float32)
    return B, TA, reach


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_kernel(case):
    from quemb_tpu.ops.pallas_df import screened_first_transform as jax_sft

    B, TA, reach = _inputs(case)
    ref = np.asarray(jax_sft(B, TA, reach, interpret=True))
    out = sd.screened_first_transform(
        torch.as_tensor(B), torch.as_tensor(TA), reach
    ).numpy()
    assert out.shape == ref.shape == (B.shape[0], B.shape[1], TA.shape[1])
    assert np.abs(out - ref).max() <= REL_TOL * np.abs(ref).max()


def test_skip_case_drops_whole_blocks_only():
    B, TA, reach = _inputs("skip")
    assert sd.kept_blocks(reach).tolist() == [0, 2, 4]
    rows = sd.block_rowmask(reach, torch.float64, "cpu").numpy()
    kept = np.r_[0:16, 32:48, 64:70]
    assert rows[kept].all() and rows.sum() == kept.size
    # the skip is by block: unreachable AOs inside a kept block still count
    out = sd.screened_first_transform(
        torch.as_tensor(B), torch.as_tensor(TA), reach
    ).numpy().astype(np.float64)
    ref = np.einsum("pmn,ni->pmi", B.astype(np.float64),
                    TA.astype(np.float64) * rows[:, None])
    assert np.abs(out - ref).max() <= REL_TOL * np.abs(ref).max()


def test_kept_cases_keep_the_blocks_they_say():
    assert sd.kept_blocks(_inputs("empty")[2]).size == 0
    assert sd.kept_blocks(_inputs("wide")[2]).tolist() == [0, 2]
    assert sd.kept_blocks(_inputs("chain")[2]).tolist() == [*range(5, 13), 17]
    out = sd.screened_first_transform(
        *(torch.as_tensor(x) for x in _inputs("empty")[:2]),
        _inputs("empty")[2],
    )
    assert out.shape == (8, 40, 12) and not out.abs().max()


@pytest.mark.parametrize("nao,nemb,kept", [
    (58, 41, range(4)),  # octane: every block
    (282, 42, range(5, 13)),  # C40 window
    (282, 42, [*range(5, 13), 17]),  # with the ragged tail block
    (282, 64, range(18)),  # every block at the widest tile
    (37, 130, [0, 2]),  # odd nao, nemb over 64
    (40, 12, []),  # nothing kept
    (8192, 64, range(512)),  # kept list over several launches
])
def test_plan_launches_covers_the_kept_blocks(nao, nemb, kept):
    reach = np.zeros(nao, bool)
    for k in kept:
        reach[k * sd.NU_BLOCK] = True
    blocks = sd.kept_blocks(reach)
    assert blocks.tolist() == list(kept)
    plan = sd.plan_launches(nemb, blocks)
    # every kept block in exactly one launch, in order
    assert np.concatenate(plan).tolist() == list(kept)
    assert all(p.dtype == np.int32 for p in plan)
    width = sd.tile_width(nemb)
    assert width == min(64, -(-nemb // 8) * 8) and width >= min(nemb, 64)
    for p in plan:
        assert sd.NU_BLOCK * p.size * width * 4 <= sd.TA_SMEM_MAX
    # one launch unless the TA rows of the kept list overflow
    assert len(plan) == max(1, -(-len(kept) // (sd.TA_SMEM_MAX // (
        sd.NU_BLOCK * width * 4))))
    assert (len(plan) == 1) == (nao < 8192)


def test_cpu_tensor_takes_plain_version_without_counting():
    B, TA, reach = _inputs("full")
    before = total("screened_df.launches")
    sd.screened_first_transform(torch.as_tensor(B), torch.as_tensor(TA),
                                reach)
    assert total("screened_df.launches") == before


@pytest.mark.parametrize("bad", ["f64", "shape", "reach", "strided"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    B, TA, reach = _inputs("full")
    B, TA = torch.as_tensor(B), torch.as_tensor(TA)
    if bad == "f64":
        B = B.double()
    elif bad == "shape":
        TA = TA[:-1].contiguous()
    elif bad == "reach":
        reach = reach[:-1]
    else:
        TA = torch.as_tensor(np.asfortranarray(TA.numpy()))
    with pytest.raises((TypeError, ValueError)):
        sd.screened_first_transform(B, TA, reach)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_kernel_matches_plain_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    B, TA, reach = _inputs(case)
    B = torch.as_tensor(B, device="cuda")
    TA = torch.as_tensor(TA, device="cuda")
    before = total("screened_df.launches")
    out = sd.screened_first_transform(B, TA, reach)
    ref = sd.screened_first_transform_plain(
        B, TA, sd.block_rowmask(reach, B.dtype, B.device)
    )
    torch.cuda.synchronize()
    assert total("screened_df.launches") == before + 1
    err = float((out - ref).abs().max())
    assert err <= REL_TOL * float(ref.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    c for c in sorted(CASES) if sd.kept_blocks(CASES[c]()[3]).size > 1
])
def test_cuda_split_launches_match_plain_on_card(case):
    """A kept list split over launches that accumulate, against the
    plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    B, TA, reach = _inputs(case)
    B = torch.as_tensor(B, device="cuda")
    TA = torch.as_tensor(TA, device="cuda")
    blocks = sd.kept_blocks(reach)
    ref = sd.screened_first_transform_plain(
        B, TA, sd.block_rowmask(reach, B.dtype, B.device)
    )
    half = blocks.size // 2
    out = sd.run_plan(B, TA, [blocks[:half], blocks[half:]])
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    assert err <= REL_TOL * float(ref.abs().max()), err
