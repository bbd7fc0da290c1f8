"""Selected CI (variational heat-bath) for embedded fragments.

Own replacement for the reference's cornell_shci adapter
(molbe/solver.py:1029 solve_block2-style external-solver shellouts; the
reference's SCI baselines are gated known-to-fail upstream,
tests/sci_be_test.py:17).  Implements the variational stage of heat-bath
CI: starting from the HF determinant, iteratively add determinants a
with |H_ai c_i| > eps_var for any selected i, diagonalizing in the
selected space each round.  eps_var -> 0 recovers FCI exactly (tested).

Fragment spaces are small (the embedding caps nmo), so the determinant
machinery of :mod:`solvers.fci` is reused; the selected-space Hamiltonian
columns come from sigma applications on unit vectors.

JAX counterpart: ``quemb_tpu/solvers/sci.py``, of which this is a copy (it
holds no jax): host numpy, as there.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg

from quemb_tpu_torch.solvers.fci import fci_space


def solve_sci(h1_mo, eri_mo, nocc: int, eps_var: float = 1e-4,
              max_rounds: int = 30):
    """Variational heat-bath selected CI.

    Returns (e_elec, rdm1, rdm2) with PySCF RDM conventions, like
    :func:`solvers.fci.solve_fci`.
    """
    h1 = np.asarray(h1_mo)
    eri = np.asarray(eri_mo)
    nmo = h1.shape[0]
    space = fci_space(nmo, nocc)
    dim = space.dim
    # sigma consumes the Knowles-Handy effective one-body part
    h_eff = h1 - 0.5 * np.einsum("pqqs->ps", eri)

    # HF determinant: both alpha and beta strings = lowest string.  The
    # string list from itertools.combinations starts with (0..nocc-1).
    hf_idx = 0  # flattened (Ia=0, Ib=0)
    selected = [hf_idx]
    sel_set = {hf_idx}

    h_cols: dict[int, np.ndarray] = {}

    def H_col(i: int) -> np.ndarray:
        if i not in h_cols:
            e_i = np.zeros(dim)
            e_i[i] = 1.0
            h_cols[i] = np.asarray(space.sigma(e_i, h_eff, eri))
        return h_cols[i]

    c_sel = np.array([1.0])
    e_val = float(H_col(hf_idx)[hf_idx])
    for _ in range(max_rounds):
        # connection scan: |H_ai c_i| > eps for any selected i
        new: set[int] = set()
        for ci, i in zip(c_sel, selected):
            col = H_col(i)
            hits = np.nonzero(np.abs(col * ci) > eps_var)[0]
            new.update(int(a) for a in hits if a not in sel_set)
        if not new:
            break
        selected = selected + sorted(new)
        sel_set.update(new)
        # diagonalize in the selected space
        ns = len(selected)
        Hs = np.empty((ns, ns))
        for a, i in enumerate(selected):
            Hs[:, a] = H_col(i)[selected]
        Hs = 0.5 * (Hs + Hs.T)
        w, V = scipy.linalg.eigh(Hs)
        e_val = float(w[0])
        c_sel = V[:, 0]

    ci = np.zeros(dim)
    ci[selected] = c_sel
    rdm1, rdm2 = space.make_rdm12(ci)
    return e_val, rdm1, rdm2
