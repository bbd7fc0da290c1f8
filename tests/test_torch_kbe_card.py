"""Periodic BE on the card against the CPU (no JAX here, so this runs on
the machine with the card):

    python -m pytest --noconftest -m gpu tests/test_torch_kbe_card.py
"""

import numpy as np
import pytest
import torch

from quemb_tpu_torch import kbe

LAT = np.diag([6.0, 6.0, 4.0])
H4 = "H 0 0 0; H 0 0 1.0; H 0 0 2.0; H 0 0 3.0"
KMESH = [1, 1, 3]


@pytest.mark.gpu
def test_h4_oneshot_on_card_matches_cpu():
    """The H4 BE2 one-shot CCSD with the KRHF, the KGDF's J/K and
    embedding ERIs and the fragment solves on the card, against the same
    on the CPU: e_tot, ebe_hf and ebe_tot 1e-9."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = []
    for dev in ("cpu", "cuda"):
        cell = kbe.Cell(atom=H4, a=LAT, basis="sto-3g")
        kpts = cell.make_kpts(KMESH)
        mf = kbe.KRHF(cell, kpts, omega=0.6, conv_tol=1e-11, device=dev)
        mf.kernel()
        be = kbe.BE(mf, kbe.fragmentate(mol=cell, kpt=KMESH, n_BE=2),
                    kpts=kpts)
        assert be.fragments[0].eri.device.type == dev
        be.oneshot(solver="CCSD")
        out.append((mf.e_tot, be.ebe_hf, be.ebe_tot))
    assert np.abs(np.subtract(*out)).max() < 1e-9
