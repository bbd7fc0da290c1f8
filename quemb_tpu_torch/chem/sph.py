"""Cartesian -> real-spherical-harmonic AO transforms.

The integral engine works in cartesian Gaussians (general L); spherical
AO bases (the PySCF default for d and higher) are obtained by a
block-diagonal transform T with S_sph = T S_cart T^T etc.  The per-shell
coefficients are DERIVED numerically: the standard integer-coefficient
solid-harmonic combinations are S-orthonormalized against the exact
single-shell cartesian overlap, which is exact for any normalization
convention of the cartesian components.

Parity: the reference works on PySCF Mole objects whose default AO
basis is spherical (``mol.cart = False``); every reference baseline
(e.g. tests/chem_dft_test.py geometries) is a spherical-basis run.
``Mole(cart=False)`` provides the same convention here.

JAX counterpart: ``quemb_tpu/chem/sph.py``, of which this is a copy (it
holds no jax).
"""

from __future__ import annotations

import numpy as np

from quemb_tpu_torch.chem.mole import cart_components

# integer-coefficient real solid harmonics over cartesian monomials,
# pyscf m ordering (-l..l); each entry: {(lx,ly,lz): coef}
_SOLID = {
    0: [{(0, 0, 0): 1.0}],
    1: [{(1, 0, 0): 1.0}, {(0, 1, 0): 1.0}, {(0, 0, 1): 1.0}],
    2: [
        {(1, 1, 0): 1.0},                                     # xy
        {(0, 1, 1): 1.0},                                     # yz
        {(0, 0, 2): 2.0, (2, 0, 0): -1.0, (0, 2, 0): -1.0},   # 3z^2-r^2
        {(1, 0, 1): 1.0},                                     # xz
        {(2, 0, 0): 1.0, (0, 2, 0): -1.0},                    # x^2-y^2
    ],
    3: [
        {(2, 1, 0): 3.0, (0, 3, 0): -1.0},                    # y(3x^2-y^2)
        {(1, 1, 1): 1.0},                                     # xyz
        {(0, 1, 2): 4.0, (2, 1, 0): -1.0, (0, 3, 0): -1.0},   # yz^2
        {(0, 0, 3): 2.0, (2, 0, 1): -3.0, (0, 2, 1): -3.0},   # z^3
        {(1, 0, 2): 4.0, (3, 0, 0): -1.0, (1, 2, 0): -1.0},   # xz^2
        {(2, 0, 1): 1.0, (0, 2, 1): -1.0},                    # z(x^2-y^2)
        {(3, 0, 0): 1.0, (1, 2, 0): -3.0},                    # x(x^2-3y^2)
    ],
    4: [
        {(3, 1, 0): 1.0, (1, 3, 0): -1.0},
        {(2, 1, 1): 3.0, (0, 3, 1): -1.0},
        {(1, 1, 2): 6.0, (3, 1, 0): -1.0, (1, 3, 0): -1.0},
        {(0, 1, 3): 4.0, (2, 1, 1): -3.0, (0, 3, 1): -3.0},
        {(0, 0, 4): 8.0, (2, 0, 2): -24.0, (0, 2, 2): -24.0,
         (4, 0, 0): 3.0, (0, 4, 0): 3.0, (2, 2, 0): 6.0},
        {(1, 0, 3): 4.0, (3, 0, 1): -3.0, (1, 2, 1): -3.0},
        {(2, 0, 2): 6.0, (0, 2, 2): -6.0, (4, 0, 0): -1.0,
         (0, 4, 0): 1.0},
        {(3, 0, 1): 1.0, (1, 2, 1): -3.0},
        {(4, 0, 0): 1.0, (2, 2, 0): -6.0, (0, 4, 0): 1.0},
    ],
}


def _cart_shell_overlap(l: int) -> np.ndarray:
    """Exact single-shell cartesian overlap with the (l,0,0)-component
    normalization used by the engine (exponent scale drops out)."""

    def dfact(n):
        r = 1.0
        while n > 1:
            r *= n
            n -= 2
        return r

    comps = cart_components(l)
    n = len(comps)
    S = np.zeros((n, n))
    norm_l00 = dfact(2 * l - 1)
    for i, a in enumerate(comps):
        for j, b in enumerate(comps):
            if any((a[d] + b[d]) % 2 for d in range(3)):
                continue
            v = 1.0
            for d in range(3):
                v *= dfact(a[d] + b[d] - 1)
            S[i, j] = v / norm_l00
    return S


def c2s_matrix(l: int) -> np.ndarray:
    """[2l+1, ncart(l)] transform; rows are S-orthonormal combinations."""
    if l > max(_SOLID):
        raise NotImplementedError(f"spherical transform for l={l}")
    comps = cart_components(l)
    pos = {c: i for i, c in enumerate(comps)}
    rows = np.zeros((2 * l + 1, len(comps)))
    for m, combo in enumerate(_SOLID[l]):
        for mono, coef in combo.items():
            rows[m, pos[mono]] = coef
    S = _cart_shell_overlap(l)
    for m in range(2 * l + 1):
        nrm = rows[m] @ S @ rows[m]
        rows[m] /= np.sqrt(nrm)
    # orthogonality holds by symmetry; verify defensively
    G = rows @ S @ rows.T
    assert np.abs(G - np.eye(2 * l + 1)).max() < 1e-12, G
    return rows


def mol_c2s(mol) -> np.ndarray:
    """Block-diagonal [nao_sph, nao_cart] transform for a whole Mole."""
    blocks = [c2s_matrix(sh.l) for sh in mol.shells]
    nsph = sum(b.shape[0] for b in blocks)
    ncart = sum(b.shape[1] for b in blocks)
    T = np.zeros((nsph, ncart))
    i = j = 0
    for b in blocks:
        T[i : i + b.shape[0], j : j + b.shape[1]] = b
        i += b.shape[0]
        j += b.shape[1]
    return T
