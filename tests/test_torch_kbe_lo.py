"""k-point localization: the port's IAO+PAO and Wannier localizers in
``kbe.BE`` against the JAX package's, on the CPU.

The H4 cell of ``tests/test_kbe.py:99-118`` in 6-31G, each package from
its own KRHF (the two agree to a few 1e-9 Ha here: the near-dependent
default aux leaves that much rounding noise in both, see
``tests/test_torch_kbe_integrals.py``):

- the host copies ``iao_pao_k``, ``lowdin_k`` and ``wannier_k`` fed the
  JAX side's overlap and orbitals give the JAX functions' results (the
  same code on the same input; the Wannier spread at 1e-12);
- ``kbe.BE(..., lo_method="iao")`` with STO-3G valence IAOs: HF-in-HF
  (< 1e-7), ``ebe_hf`` and the one-shot CCSD ``ebe_tot`` within 1e-8 Ha of
  the JAX package's;
- ``kbe.BE(..., lo_method="wannier")``: the localized orbitals' spread
  within 1e-8 of the JAX package's, ``ebe_hf`` and the one-shot MP2
  ``ebe_tot`` within 1e-8 Ha.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from quemb_tpu import kbe as jkbe
from quemb_tpu.kbe import lo as jlo
from quemb_tpu.kbe import wannier as jwannier
from quemb_tpu_torch import kbe
from quemb_tpu_torch.kbe import lo, wannier

torch.set_num_threads(1)
try:
    # the localizers and solves of both packages run numpy BLAS; one
    # thread per test worker keeps the workers from oversubscribing
    from threadpoolctl import threadpool_limits
except ImportError:
    pass
else:
    threadpool_limits(limits=1, user_api="blas")

LAT = np.diag([6.0, 6.0, 4.0])
H4 = "H 0 0 0; H 0 0 1.0; H 0 0 2.0; H 0 0 3.0"
KMESH = [1, 1, 3]
TOL = 1e-8


@pytest.fixture(scope="module")
def h4_631g():
    cell = kbe.Cell(atom=H4, a=LAT, basis="6-31g")
    jcell = jkbe.Cell(atom=H4, a=LAT, basis="6-31g")
    kpts = cell.make_kpts(KMESH)
    mf = kbe.KRHF(cell, kpts, omega=0.6, conv_tol=1e-11, device="cpu")
    mf.kernel()
    jmf = jkbe.KRHF(jcell, kpts, omega=0.6, conv_tol=1e-11)
    jmf.kernel()
    return SimpleNamespace(cell=cell, jcell=jcell, kpts=kpts, mf=mf, jmf=jmf)


def test_host_localizers_match_jax(h4_631g):
    S, C = h4_631g.jmf.get_ovlp(), h4_631g.jmf.mo_coeff
    for got, ref in zip(lo.lowdin_k(S, C), jlo.lowdin_k(S, C)):
        assert np.array_equal(got, ref)
    val_idx = [0, 2, 4, 6]  # the 1s of each H in 6-31G
    nocc = h4_631g.cell.nelectron // 2
    for got, ref in zip(lo.iao_pao_k(S, C, nocc, val_idx),
                        jlo.iao_pao_k(S, C, nocc, val_idx)):
        assert np.abs(got - ref).max() < 1e-12
    W, lmo, info = wannier.wannier_k(S, C, h4_631g.cell, h4_631g.kpts,
                                     KMESH)
    jW, jlmo, jinfo = jwannier.wannier_k(S, C, h4_631g.jcell,
                                         h4_631g.kpts, KMESH)
    assert info["spread_final"] < info["spread_init"] - 1e-6
    assert abs(info["spread_final"] - jinfo["spread_final"]) < 1e-12
    assert np.abs(W - jW).max() < 1e-10


@pytest.mark.parametrize("lo_method, solver", [("iao", "CCSD"),
                                               ("wannier", "MP2")])
def test_kbe_localization_against_jax(h4_631g, lo_method, solver):
    out = []
    for pkg, mf, cell, kw in ((kbe, h4_631g.mf, h4_631g.cell,
                               dict(device="cpu")),
                              (jkbe, h4_631g.jmf, h4_631g.jcell, {})):
        fobj = pkg.fragmentate(mol=cell, kpt=KMESH, n_BE=2,
                               frag_type="chemgen",
                               iao_valence_basis="sto-3g")
        be = pkg.BE(mf, fobj, kpts=h4_631g.kpts, lo_method=lo_method, **kw)
        assert abs(mf.e_tot - (be.ebe_hf + be.ek)) < 1e-7
        be.oneshot(solver=solver)
        spread = wannier.lo_spread(cell, h4_631g.kpts, KMESH, be.W)
        out.append((be.ebe_hf, be.ebe_tot, spread))
    (ehf, etot, spread), (jehf, jetot, jspread) = out
    assert abs(ehf - jehf) < TOL and abs(etot - jetot) < TOL
    assert abs(spread - jspread) < TOL
