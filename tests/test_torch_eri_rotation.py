"""The native integral engine's ERI turns with the molecule.

Two sulfur and two carbon atoms of the thiophene dimer, 6-31G (44 AOs),
at their place and turned by a fixed rotation: the ERI built at the
turned geometry equals the first one turned on its four axes.  The
Schwarz screen of shell quartets needs each pair's diagonal (ab|ab) in
full; when the primitive screen also pruned those diagonals, a distant
pair whose primitive quartets are each below it read 0 and lost every
quartet, some of 5e-9, in some orientations and not in others.
"""

import numpy as np
import pytest

from quemb_tpu_torch.chem import integrals
from quemb_tpu_torch.chem.mole import Mole

#: C, C, S, S of the thiophene dimer, Angstrom
ATOMS = [("C", (3.74360, 5.55710, 7.14890)),
         ("C", (3.74360, 5.55710, 4.61180)),
         ("S", (3.39270, 4.78350, 9.80840)),
         ("S", (4.27710, 6.66240, 5.88040))]


def _rotation(seed: int) -> np.ndarray:
    w, x, y, z = np.random.default_rng(seed).standard_normal(4)
    n = np.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


@pytest.mark.parametrize("seed", [1, 2300000011])
def test_eri_turns_with_the_molecule(seed):
    mol = Mole(atom=ATOMS, basis="6-31g")
    Q = _rotation(seed)
    turned = Mole(atom=[(s, np.asarray(c) @ Q.T) for s, c in ATOMS],
                  basis="6-31g")
    # Q on each p shell (x, y, z in turn), 1 on each s function
    M = np.eye(mol.nao)
    for i, lab in enumerate(mol.ao_labels()):
        if lab.endswith("px"):
            M[i:i + 3, i:i + 3] = Q
    eri = integrals.eri_full(mol)
    for _ in range(4):
        eri = np.tensordot(eri, M.T, axes=([0], [0]))
    assert np.abs(eri - integrals.eri_full(turned)).max() < 1e-12
