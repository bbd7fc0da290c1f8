"""Model geometries used by benchmarks and tests.

JAX counterpart: ``quemb_tpu/utils/geometry.py``, of which this is a copy (it
holds no jax).
"""

from __future__ import annotations

import numpy as np


def alkane_atoms(n: int):
    """Zigzag all-anti alkane C_nH_{2n+2} (C-C 1.526 A, C-C-C 111 deg).

    Deterministic, so fixtures storing only the mean field can rebuild
    the identical molecule at load time.
    """
    d, h = 1.258, 0.864  # bond projection / zigzag height
    atoms = []
    cs = []
    for i in range(n):
        c = np.array([i * d, (i % 2) * h, 0.0])
        cs.append(c)
        atoms.append(("C", c))
    for i, c in enumerate(cs):
        s = 1.0 if i % 2 == 0 else -1.0  # outward y
        atoms.append(("H", c + np.array([0.0, s * 0.55, 0.94])))
        atoms.append(("H", c + np.array([0.0, s * 0.55, -0.94])))
    atoms.append(("H", cs[0] + np.array([-0.89, -0.63, 0.0])))
    atoms.append(("H", cs[-1] + np.array(
        [0.89, 0.63 * (1.0 if (n - 1) % 2 == 0 else -1.0), 0.0]
    )))
    return [(sym, tuple(x)) for sym, x in atoms]
