"""Derivative-free quasi-Newton root finder for the BE matching conditions.

Solves ``errvec(pot) = 0`` with "good" Broyden secant updates applied to an
explicitly stored inverse Jacobian (the condition count is tens at most, so
dense O(n^2) state is free and avoids any history bookkeeping), globalized
either by the derivative-free line search of Li & Fukushima
(Optim. Methods Softw. 13, 181 (2000)) or by a dogleg trust region.

Functional replacement for the reference's FrankQN optimizer
(shared/external/optqn.py:25-247, which carries a third-party NOTICE);
this is an independent formulation of the same published algorithms: the
reference keeps the Broyden inverse in product form over the iteration
history, here it is a dense matrix updated in place.

JAX counterpart: ``quemb_tpu/matching/optqn.py``, of which this is a copy
(it holds no jax): host numpy, as there.
"""

from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger(__name__)


def lf_line_search(func, x, fx, step, k, max_backtracks: int = 20):
    """Li-Fukushima derivative-free backtracking.

    Accepts the full step when ||f|| already decreases sufficiently;
    otherwise shrinks by ``beta`` until the (non-monotone) criterion
    ``||f(x + a s)|| <= (1 + eta_k) ||f(x)|| - s1 a^2 ||s||^2`` holds.
    Returns (alpha, x_new, f_new, n_evals).
    """
    beta = 0.1
    rho = 0.9
    s1 = s2 = 1e-3
    eta_k = 1.0 / (k + 1) ** 2  # summable sequence -> global convergence

    step_sq = float(step @ step)
    f_norm = np.linalg.norm(fx)

    alpha = 1.0
    x_try = x + step
    f_try = func(x_try)
    n_evals = 1
    if np.linalg.norm(f_try) <= rho * f_norm - s2 * step_sq:
        return alpha, x_try, f_try, n_evals

    while (
        np.linalg.norm(f_try)
        > (1.0 + eta_k) * f_norm - s1 * alpha**2 * step_sq
    ):
        if n_evals >= max_backtracks:
            break
        alpha *= beta
        x_try = x + alpha * step
        f_try = func(x_try)
        n_evals += 1
    logger.info(f"QN line search: {n_evals} evaluation(s), alpha={alpha:g}")
    return alpha, x_try, f_try, n_evals


def dogleg_step(J, Jinv, fx, radius):
    """Dogleg model step of length <= radius for 0.5||f + J dx||^2.

    Combines the Gauss-Newton point with the Cauchy (steepest-descent)
    point along the standard dogleg path.
    """
    g = J.T @ fx  # model gradient
    dx_gn = -Jinv @ (Jinv.T @ g)  # Gauss-Newton: -(J^T J)^-1 g
    if np.linalg.norm(dx_gn) <= radius:
        return dx_gn
    Jg = J @ g
    t_cauchy = float(g @ g) / float(Jg @ Jg)
    dx_c = -t_cauchy * g
    nc = np.linalg.norm(dx_c)
    if nc >= radius:
        return dx_c * (radius / nc)
    # walk from the Cauchy point toward the GN point until the boundary
    d = dx_gn - dx_c
    a = float(d @ d)
    b = 2.0 * float(dx_c @ d)
    c = float(dx_c @ dx_c) - radius**2
    tau = (-b + np.sqrt(b * b - 4 * a * c)) / (2 * a)
    return dx_c + tau * d


class QNSolver:
    """Broyden root finder with explicit inverse-Jacobian state.

    func: R^n -> R^n residual; x0 initial point; f0 optional residual at
    x0; J0 initial Jacobian estimate.
    """

    def __init__(self, func, x0, f0=None, J0=None, trust=0.5,
                 max_space: int = 500):
        self.func = func
        self.x = np.array(x0, dtype=float)
        self.f = np.asarray(f0 if f0 is not None else func(self.x), float)
        n = self.x.size
        J0 = np.eye(n) if J0 is None else np.asarray(J0, float)
        self.J = J0
        self.Jinv = np.linalg.pinv(J0)
        self.trust = trust
        self.max_space = max_space
        self._k = 0

    def _broyden_update(self, dx, df):
        """Good-Broyden secant update of the stored inverse (Sherman-
        Morrison form); skipped when the curvature denominator degenerates.
        """
        Bdf = self.Jinv @ df
        denom = float(dx @ Bdf)
        if abs(denom) < 1e-14:
            return
        self.Jinv += np.outer((dx - Bdf) / denom, dx @ self.Jinv)

    def step(self, use_trust_region: bool = False):
        """One quasi-Newton iteration; updates (x, f) in place."""
        x_old, f_old = self.x, self.f
        if use_trust_region:
            J = np.linalg.pinv(self.Jinv)
            # shrink the radius until the actual reduction is acceptable
            radius0 = max(1.0, np.linalg.norm(x_old))
            x_new, f_new = x_old, f_old
            for micro in range(60):
                radius = radius0 * self.trust**micro
                dx = dogleg_step(J, self.Jinv, f_old, radius)
                f_new = self.func(x_old + dx)
                actual = float(f_old @ f_old) - float(f_new @ f_new)
                model = f_old + J @ dx
                predicted = float(f_old @ f_old) - float(model @ model)
                if actual > 0 and (
                    predicted <= 0 or actual / predicted > 0.001
                ):
                    x_new = x_old + dx
                    break
            else:
                x_new = x_old + dx
        else:
            dx_qn = -(self.Jinv @ f_old)
            _, x_new, f_new, _ = lf_line_search(
                self.func, x_old, f_old, dx_qn, self._k
            )
        self._broyden_update(x_new - x_old, f_new - f_old)
        self.x, self.f = x_new, f_new
        self._k += 1


class FrankQN(QNSolver):
    """Backwards-compatible shim exposing the reference-style optimizer API."""

    def __init__(self, func, x0, f0, J0, trust=0.5, max_space=500):
        super().__init__(func, x0, f0=f0, J0=J0, trust=trust,
                         max_space=max_space)

    def next_step(self, it: int, trust_region_opt: bool = False):
        self.step(use_trust_region=trust_region_opt)
