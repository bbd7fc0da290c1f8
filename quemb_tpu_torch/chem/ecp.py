"""Effective core potentials (semi-local ECPs) by radial-angular quadrature.

The reference threads ``ecp`` through be2puffin into PySCF's libecp
integrals (reference molbe/misc.py:266,331; example
molbe_oneshot_rbe_hcore.py:83).  This module is the from-scratch
equivalent: the one-electron ECP matrix

  V_ECP = sum_A [ U_L(r_A)
                  + sum_{l<L} sum_m |lm><lm| (U_l(r_A) - U_L(r_A)) ]

with U_l(r) = sum_k c_k r^(n_k - 2) exp(-a_k r^2), evaluated numerically
on an atom-centered product grid: mapped Gauss-Legendre radial points x
(Gauss-Legendre in cos(theta)) x (uniform phi).  The angular projector
sum_m |lm><lm| is evaluated with the spherical-harmonic addition theorem

  sum_m Y_lm(w) Y_lm(w') = (2l+1)/(4pi) P_l(w . w')

so no spherical-harmonic tables enter -- only Legendre recurrences.

Parameters are user-supplied (no tabulated ECP libraries ship in this
environment); the accepted format is a per-element dict, e.g.::

    ecp = {"Na": {
        "ncore": 10,
        "local": [(2, 1.32, 10.0), (1, 0.88, 3.0)],   # (n, alpha, c)
        "semilocal": {0: [(2, 1.45, 22.0)], 1: [(2, 1.20, 9.0)]},
    }}

JAX counterpart: ``quemb_tpu/chem/ecp.py``, of which this is a copy (it
holds no jax).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class ECPData:
    """One element's semi-local ECP."""

    ncore: int
    local: list[tuple[int, float, float]] = field(default_factory=list)
    semilocal: dict[int, list[tuple[int, float, float]]] = field(
        default_factory=dict
    )

    @classmethod
    def from_spec(cls, spec) -> "ECPData":
        if isinstance(spec, ECPData):
            return spec
        return cls(
            ncore=int(spec["ncore"]),
            local=[tuple(t) for t in spec.get("local", [])],
            semilocal={
                int(l): [tuple(t) for t in terms]
                for l, terms in spec.get("semilocal", {}).items()
            },
        )


def normalize_ecp(ecp) -> dict[str, ECPData]:
    """Normalize a user ecp argument to {element_symbol: ECPData}."""
    if not ecp:
        return {}
    return {sym: ECPData.from_spec(spec) for sym, spec in ecp.items()}


def _radial_grid(n: int = 120, R: float = 1.0):
    """Mapped Gauss-Legendre grid on (0, inf): r = R x / (1 - x)."""
    x, w = np.polynomial.legendre.leggauss(n)
    x = 0.5 * (x + 1.0)
    w = 0.5 * w
    r = R * x / (1.0 - x)
    dr = R / (1.0 - x) ** 2
    return r, w * dr


def _angular_grid(n_theta: int = 14, n_phi: int = 28):
    """Gauss-Legendre x uniform product grid on the sphere.

    Returns (omega [n,3], w [n]) with sum(w) = 4 pi; exact for spherical
    polynomials of degree <= min(2 n_theta - 1, n_phi - 1).
    """
    ct, wt = np.polynomial.legendre.leggauss(n_theta)
    st = np.sqrt(1.0 - ct**2)
    phi = 2.0 * np.pi * np.arange(n_phi) / n_phi
    om = np.empty((n_theta * n_phi, 3))
    w = np.empty(n_theta * n_phi)
    k = 0
    for i in range(n_theta):
        for j in range(n_phi):
            om[k] = (st[i] * np.cos(phi[j]), st[i] * np.sin(phi[j]), ct[i])
            w[k] = wt[i] * (2.0 * np.pi / n_phi)
            k += 1
    return om, w


def _U_of_r(terms, r):
    """U(r) = sum_k c_k r^(n_k-2) exp(-a_k r^2) on radial points r."""
    U = np.zeros_like(r)
    for n, a, c in terms:
        U += c * r ** (int(n) - 2) * np.exp(-a * r * r)
    return U


def _legendre_P(lmax: int, x):
    """P_0..P_lmax at x (any shape) by upward recurrence."""
    P = [np.ones_like(x), x]
    for l in range(1, lmax):
        P.append(((2 * l + 1) * x * P[l] - l * P[l - 1]) / (l + 1))
    return P[: lmax + 1]


def ecp_matrix(
    mol,
    ecp: dict[str, ECPData] | None = None,
    n_rad: int = 120,
    n_theta: int = 26,
    n_phi: int = 52,
    r_max: float | None = None,
) -> np.ndarray:
    """<mu| V_ECP |nu> in the molecule's public (sph or cart) AO basis.

    Angular resolution note: off-center AO products carry the factor
    exp(4 a r d cos(theta)) about the ECP center (a: AO exponent, d:
    center distance), which Gauss-Legendre in cos(theta) resolves only
    for orders well above the exponent scale -- hence the generous
    defaults (validated to <=1e-8 against closed forms in
    tests/test_ecp.py).  ``r_max`` defaults to each potential's own
    decay radius sqrt(37/alpha_min), which also bounds that exponent.
    """
    from quemb_tpu_torch.utils.io import eval_ao

    ecp = normalize_ecp(ecp if ecp is not None else getattr(
        mol, "ecp", None
    ))
    nao = mol.nao
    V = np.zeros((nao, nao))
    if not ecp:
        return V
    r_all, wr_all = _radial_grid(n_rad)
    om, wa = _angular_grid(n_theta, n_phi)
    n_ang = om.shape[0]
    cosg = np.clip(om @ om.T, -1.0, 1.0)

    for ia, (sym, C) in enumerate(mol._atoms):
        data = ecp.get(sym)
        if data is None:
            continue
        alphas = [t[1] for t in data.local] + [
            t[1] for terms in data.semilocal.values() for t in terms
        ]
        r_cut = r_max if r_max is not None else float(
            np.sqrt(37.0 / min(alphas)) if alphas else 12.0
        )
        keep = r_all < r_cut
        r, wr = r_all[keep], wr_all[keep]
        # AO values on the full product grid around this center:
        # [n_rad, n_ang, nao]
        pts = (C[None, None, :] + r[:, None, None] * om[None, :, :])
        A = eval_ao(mol, pts.reshape(-1, 3)).reshape(len(r), n_ang, nao)

        # ---- local channel U_L
        if data.local:
            UL = _U_of_r(data.local, r)
            dens = np.einsum(
                "j,a,jam,jan->mn", wr * r * r * UL, wa, A, A,
                optimize=True,
            )
            V += dens

        # ---- semi-local projectors
        if data.semilocal:
            lmax = max(data.semilocal)
            Pl = _legendre_P(lmax, cosg)
            for l, terms in sorted(data.semilocal.items()):
                Ul = _U_of_r(terms, r)
                K = ((2 * l + 1) / (4.0 * np.pi)) * (
                    wa[:, None] * wa[None, :] * Pl[l]
                )
                # B[j,a,m] = sum_b K[a,b] A[j,b,m]
                B = np.einsum("ab,jbm->jam", K, A, optimize=True)
                V += np.einsum(
                    "j,jam,jan->mn", wr * r * r * Ul, A, B,
                    optimize=True,
                )
    return 0.5 * (V + V.T)
