"""Central-difference numerical Jacobian of the BE matching conditions.

Mirrors the reference ``molbe/numerical_jac.py:compute_numerical_jacobian``:
each matching potential lives on exactly one fragment, so a perturbed
column only requires re-solving the owning fragment (the error vector is
then re-assembled from the stored fragment RDMs).  Only the final
chemical-potential column touches every fragment.

JAX counterpart: ``quemb_tpu/matching/numerical_jac.py``, over the port's
``be_func``, ``solve_one_fragment`` and ``solve_error``.
"""

from __future__ import annotations

import numpy as np

from quemb_tpu_torch.solvers.dispatch import be_func, solve_error, \
    solve_one_fragment


def compute_numerical_jacobian(
    be, solver: str, only_chem: bool, step_size: float = 1e-6
):
    pot0 = [0.0] if only_chem else list(be.pot)
    n = len(pot0)
    fragments = be.fragments

    def full_errvec(pot):
        _, vec, _ = be_func(
            list(pot),
            fragments,
            be.Nocc,
            solver,
            only_chem=only_chem,
            eeval=False,
            return_vec=True,
        )
        return np.asarray(vec)

    # owner fragment of each potential entry (the chem-pot column n-1 has
    # no single owner)
    owner = np.full(n, -1, dtype=int)
    if not only_chem:
        for fi, fr in enumerate(fragments):
            owner[fr.udim : fr.udim + fr.n_pot] = fi

    # base solve populates every fragment's _rdm1 at pot0
    full_errvec(pot0)
    base_rdm1 = [fr._rdm1.copy() for fr in fragments]

    def column_errvec(pot, k):
        fi = owner[k]
        if fi < 0:  # chemical potential: all fragments feel it
            return full_errvec(pot)
        fr = fragments[fi]
        fr.update_heff(list(pot), only_chem=only_chem)
        solve_one_fragment(fr, solver, eeval=False)
        vec = solve_error(fragments, be.Nocc, only_chem=only_chem)[1]
        # restore the owner's base state for the next column
        fr._rdm1 = base_rdm1[fi].copy()
        fr.update_heff(list(pot0), only_chem=only_chem)
        return np.asarray(vec)

    J = np.zeros((n, n))
    for k in range(n):
        dp = np.array(pot0)
        dp[k] += step_size
        fp = column_errvec(dp, k)
        dp[k] -= 2 * step_size
        fm = column_errvec(dp, k)
        J[:, k] = (fp - fm) / (2 * step_size)
    return J
