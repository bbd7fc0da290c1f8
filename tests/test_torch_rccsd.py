"""Closed-shell CCSD: the port's batched update and iteration against the
JAX package's.

One ``rccsd_update_mat`` step on random amplitudes agrees at 1e-11 (f64).
The converged correlation energy of H4 and H6 chains agrees at 1e-8 in
f64 and at 1e-5 under the f32-only tier.  The DIIS coefficient solve
(``torch.linalg.solve_ex`` in the port, an unrolled elimination in the JAX
package) agrees at 1e-10 on random masked Gram matrices.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quemb_tpu.chem.mole import Mole as JMole
from quemb_tpu.chem.scf import RHF as JRHF
from quemb_tpu.solvers import ccsd as jccsd
from quemb_tpu.solvers import rccsd as jrccsd
from quemb_tpu.solvers import rccsd_mat as jmat
from quemb_tpu_torch.solvers import ccsd as tccsd
from quemb_tpu_torch.solvers import rccsd as trccsd
from quemb_tpu_torch.solvers import rccsd_mat as tmat

torch.set_num_threads(1)


def _random_system(seed, nmo, no, naux=13):
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((nmo, nmo, naux))
    L = L + L.transpose(1, 0, 2)
    eri = np.einsum("pqx,rsx->pqrs", L, L)
    moe = np.sort(rng.standard_normal(nmo)) * 2.0
    moe[no:] += 4.0
    nv = nmo - no
    t1 = 0.1 * rng.standard_normal((no, nv))
    t2 = 0.1 * rng.standard_normal((no, no, nv, nv))
    return eri, moe, t1, t2 + t2.transpose(1, 0, 3, 2)


@pytest.mark.parametrize("seed,nmo,no", [(11, 9, 4), (3, 7, 2), (5, 10, 5)])
def test_update_step_matches_jax(seed, nmo, no):
    nv = nmo - no
    eri, moe, t1, t2 = _random_system(seed, nmo, no)
    fb = jmat.rccsd_fused_blocks(jnp.asarray(eri), no)
    ref = jmat.rccsd_update_mat(
        jnp.asarray(t1), jnp.asarray(t2).reshape(no * no, nv * nv),
        jnp.asarray(moe[:no]), jnp.asarray(moe[no:]), fb,
    )
    tfb = tmat.rccsd_fused_blocks(torch.as_tensor(eri)[None], no)
    assert set(tfb) == set(tmat.RBLOCK_KEYS) == set(jmat.RBLOCK_KEYS)
    for key in tmat.RBLOCK_KEYS:
        assert np.abs(tfb[key][0].numpy() - np.asarray(fb[key])).max() \
            < 1e-12, key
    out = tmat.rccsd_update_mat(
        torch.as_tensor(t1)[None],
        torch.as_tensor(t2).reshape(1, no * no, nv * nv),
        torch.as_tensor(moe[:no])[None], torch.as_tensor(moe[no:])[None],
        tfb,
    )
    for a, b in zip(out, ref):
        assert np.abs(a[0].numpy() - np.asarray(b)).max() < 1e-11


def _chain_mo(natm):
    mol = JMole(
        atom="; ".join(f"H 0 0 {i * 1.0}" for i in range(natm)),
        basis="sto-3g",
    )
    mf = JRHF(mol, conv_tol=1e-12)
    mf.kernel()
    C = mf.mo_coeff
    eri = np.einsum("pqrs,pi,qj,rk,sl->ijkl", mf.get_eri(), C, C, C, C)
    return eri, np.asarray(mf.mo_energy), natm // 2


def _energy(t1, t2, eri, no):
    ovov = eri[:no, no:, :no, no:]
    tau = t2 + np.einsum("ia,jb->ijab", t1, t1)
    return float(
        np.einsum("ijab,iajb->", tau, 2.0 * ovov)
        - np.einsum("ijab,ibja->", tau, ovov)
    )


@pytest.fixture(scope="module")
def chains():
    return {n: _chain_mo(n) for n in (4, 6)}


@pytest.mark.parametrize("f32_only,tol", [(False, 1e-8), (True, 1e-5)])
@pytest.mark.parametrize("natm", [4, 6])
def test_converged_energy_matches_jax(chains, natm, f32_only, tol):
    eri, moe, no = chains[natm]
    jt1, jt2, _, jdelta = jrccsd._rccsd_from_mo_batched(
        jnp.asarray(eri)[None], jnp.asarray(moe)[None], no,
        f32_only=f32_only,
    )
    # a bucket of two copies: the batch axis is exercised as well
    eri_b = torch.as_tensor(np.stack([eri, eri]))
    moe_b = torch.as_tensor(np.stack([moe, moe]))
    t1, t2, it, delta = trccsd._rccsd_from_mo_batched(
        eri_b, moe_b, no, f32_only=f32_only
    )
    assert t1.dtype == t2.dtype == torch.float64
    conv = 1e-5 if f32_only else 1e-9
    assert float(delta.max()) <= conv and float(jdelta[0]) <= conv
    e_ref = _energy(np.asarray(jt1[0]), np.asarray(jt2[0]), eri, no)
    for k in range(2):
        e = _energy(t1[k].numpy(), t2[k].numpy(), eri, no)
        assert abs(e - e_ref) < tol
    assert e_ref < -1e-3


@pytest.mark.parametrize("nvalid", [1, 2, 3, 4, 5, 6])
def test_diis_coeffs_match_jax(nvalid):
    m = tccsd.DIIS_SPACE
    assert m == jccsd.DIIS_SPACE
    rng = np.random.default_rng(nvalid)
    E = rng.standard_normal((m, 20)) * 1e-3
    B = E @ E.T
    ref = np.asarray(jccsd._diis_coeffs(jnp.asarray(B), nvalid,
                                        newest_last=True))
    c = tccsd._diis_coeffs(
        torch.as_tensor(B)[None], torch.tensor([nvalid])
    )[0].numpy()
    assert abs(c.sum() - 1.0) < 1e-12
    assert np.abs(c - ref).max() < 1e-10
