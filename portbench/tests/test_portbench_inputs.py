"""The seeded rotation and the inputs made from it."""

from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.lib import inputs as inp
from portbench.lib import registry

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("seed", [0, 1, 2, 2**31 + 11, 987654321012])
def test_rotation_is_proper_and_orthogonal(seed):
    Q = inp.rotation(seed)
    assert np.allclose(Q.T @ Q, np.eye(3), atol=1e-14)
    assert np.isclose(np.linalg.det(Q), 1.0, atol=1e-14)
    if seed == 0:
        assert np.array_equal(Q, np.eye(3))
    else:
        assert not np.allclose(Q, np.eye(3))


def test_same_seed_same_rotation():
    assert np.array_equal(inp.rotation(12345), inp.rotation(12345))


def test_unpack_matches_every_symmetry():
    n = 5
    rng = np.random.default_rng(0)
    full = rng.standard_normal((n,) * 4)
    full = full + full.transpose(1, 0, 2, 3)
    full = full + full.transpose(0, 1, 3, 2)
    full = full + full.transpose(2, 3, 0, 1)
    i, j = np.triu_indices(n)
    pairs = full[i, j][:, i, j]
    packed = pairs[np.triu_indices(len(i))]
    assert np.array_equal(inp.unpack_s8(packed, n), full)


@pytest.fixture(scope="module")
def octane():
    return registry.load_cell("octane-be2.match").config


def test_rotated_integrals_are_the_turned_molecule(octane):
    """S and hcore turned by the seed's rotation equal those the
    program's integral engine computes for the turned coordinates, so
    the AO layout and the rotation's convention are right."""
    from quemb_tpu_torch.chem import integrals
    from quemb_tpu_torch.chem.mole import Mole

    d = inp.make_inputs(ROOT, octane, 7, "cpu")
    mol = Mole(atom=list(zip(d["symbols"], d["coords"])), basis="sto-3g")
    assert np.abs(integrals.overlap(mol) - d["S"]).max() < 1e-12
    assert np.abs(integrals.core_hamiltonian(mol) - d["hcore"]).max() < 1e-10
    assert abs(mol.energy_nuc() - d["enuc"]) < 1e-9


def test_seed_zero_is_the_fixture(octane):
    d = inp.make_inputs(ROOT, octane, 0, "cpu")
    with np.load(ROOT / octane["molecule"]["fixture"]) as f:
        assert np.array_equal(d["S"], f["S"])
        assert np.array_equal(d["C"], f["C"])


def test_a_changed_fixture_is_refused(octane, tmp_path):
    conf = dict(octane, molecule=dict(octane["molecule"],
                                      fixture_sha256="0" * 64))
    with pytest.raises(ValueError, match="fixture_sha256"):
        inp.make_inputs(ROOT, conf, 1, "cpu")


def test_reference_oneshot_is_the_same_for_seeds_0_1_2(octane):
    """The reference's octane BE2 one-shot E_corr does not depend on the
    orientation (every number it touches does)."""
    from portbench.reference.be import embed, solve
    from portbench.reference.fragments import be_fragments

    ecorr, ehf = [], []
    for seed in (0, 1, 2):
        d = inp.make_inputs(ROOT, octane, seed, "cpu")
        frags = be_fragments(d["symbols"], d["coords"], d["ao_ranges"], 2)
        probs, e_hf = embed(d, frags, "cpu")
        ehf.append(e_hf)
        ecorr.append(sum(solve(p, torch.zeros_like(p.h1)).e_rows
                         for p in probs))
    assert abs(ehf[0] - d["e_tot"]) < 1e-7          # HF-in-HF
    assert max(ecorr) - min(ecorr) < 1e-9
    assert max(ehf) - min(ehf) < 1e-9
    assert abs(ecorr[0] - (-0.5499458)) < 1e-6      # the port's, seed 0
