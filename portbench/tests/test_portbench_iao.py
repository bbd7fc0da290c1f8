"""The IAO configuration's inputs, program side and reference.

Its hooks (``portbench/configs/thiophene-dimer-be2-iao.py``) run whole on
the CPU on a small molecule of the same kind: methyl thiocyanate
(CH3SCN) in 6-31G, 46 AOs, with sulfur and nitrogen, IAOs on STO-3G, a
frozen core and chemgen BE2, two fragments with an edge each (a
three-heavy-atom chain such as ethanethiol is one BE2 fragment with
nothing to match).  A sound job is judged correct; an unchanged
quasi-Newton step and an energy row off by 1e-6 Ha are not.  The
thiophene dimer's own inputs are made at full size: the ERI built by the
program's engine must give back the frozen mean field.
"""

import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.lib import harness, registry
from portbench.lib import inputs as inp
from portbench.lib.faults import planted
from portbench.lib.judge import Judge
from portbench.reference.iao import SiteLayout, ao_labels, iao_fragments, \
    iao_pao

ROOT = Path(__file__).resolve().parents[2]
CELL = "thiophene-dimer-be2-iao.match"
SEED = 2**31 + 77

#: methyl thiocyanate, Angstrom: C-S 1.82, S-C 1.70, C-N 1.16, C-S-C 100
CH3SCN = [
    ("C", (-1.82000, 0.00000, 0.00000)),
    ("S", (0.00000, 0.00000, 0.00000)),
    ("C", (0.29520, 1.67417, 0.00000)),
    ("N", (0.49663, 2.81655, 0.00000)),
    ("H", (-2.18406, 1.02787, 0.00000)),
    ("H", (-2.18406, -0.51393, 0.89016)),
    ("H", (-2.18406, -0.51394, -0.89016)),
]
SMALL = {"shells": {"N": "ssspp"}, "valence_shells": {"N": "ssp"},
         "core": {"N": 1}, "charges": {"N": 7}}


@pytest.fixture(scope="module")
def thiophene():
    return registry.load_cell(CELL)


@pytest.fixture(scope="module", autouse=True)
def shared_reference():
    """The reference's evaluation at a potential, once for the module."""
    memo = {}
    orig = Judge.evaluate

    def evaluate(self, heffs):
        key = b"".join(h.tobytes() for h in heffs)
        if key not in memo:
            memo[key] = orig(self, heffs)
        return memo[key]

    Judge.evaluate = evaluate
    yield
    Judge.evaluate = orig


def _mean_field(atoms, basis):
    """The program's RHF on the CPU, restarted from its own density until
    max|FDS - SDF| < 1e-9."""
    from quemb_tpu_torch.chem.mole import Mole
    from quemb_tpu_torch.chem.scf import RHF

    mol = Mole(atom=atoms, basis=basis)
    mf = RHF(mol, conv_tol=1e-12, device="cpu")
    mf.kernel()
    S = mf.get_ovlp()
    for _ in range(20):
        dm = mf.make_rdm1()
        F = mf.get_hcore() + mf.get_veff(dm)
        if np.abs(F @ dm @ S - S @ dm @ F).max() < 1e-9:
            break
        mf.kernel(dm0=dm)
    return mol, mf


@pytest.fixture(scope="module")
def small(thiophene, tmp_path_factory):
    """The thiophene cell on CH3SCN: its own files in a checkout of its
    own, the configuration's module, traffic and limits."""
    root = tmp_path_factory.mktemp("ch3scn")
    xyz = root / "ch3scn.xyz"
    xyz.write_text(f"{len(CH3SCN)}\nmethyl thiocyanate\n" + "".join(
        f"{s} {x:.5f} {y:.5f} {z:.5f}\n" for s, (x, y, z) in CH3SCN))
    mol, mf = _mean_field(CH3SCN, "6-31g")
    np.savez(root / "ch3scn.npz", hcore=mf.get_hcore(), S=mf.get_ovlp(),
             C=mf.mo_coeff, moe=mf.mo_energy, e_tot=np.float64(mf.e_tot),
             nao=np.int64(mol.nao))
    conf = json.loads(json.dumps(thiophene.config))
    m = conf["molecule"]
    for key, extra in SMALL.items():
        m[key].update(extra)
    m.update(xyz="ch3scn.xyz", fixture="ch3scn.npz",
             xyz_sha256=inp.file_sha256(xyz),
             fixture_sha256=inp.file_sha256(root / "ch3scn.npz"))
    # a fault that never steps would run the traffic's 500 evaluations
    traffic = dict(thiophene.traffic,
                   kwargs=dict(thiophene.traffic["kwargs"], max_iter=20))
    return dataclasses.replace(thiophene, name="ch3scn.match", config=conf,
                               traffic=traffic, root=root), mol, mf


def cpu_run(cell):
    return harness.run(cell, SEED, 0.0, False, "cpu", time.perf_counter())


def test_sound_job_is_correct(small):
    cell, _, _ = small
    out = cpu_run(cell)
    assert out["correct"] is True and out["failed"] == 0
    assert out["checks"]["energy_gap"]["value"] < 1e-9


def test_step_that_leaves_its_state_unchanged(small):
    cell, _, _ = small
    with planted("step_unchanged"):
        out = cpu_run(cell)
    assert out["correct"] is False
    assert out["checks"]["match_error"]["value"] > \
        out["checks"]["match_error"]["limit"]


def test_energy_row_altered_by_a_micro_hartree(small):
    cell, _, _ = small
    with planted("altered_answer"):
        out = cpu_run(cell)
    assert out["correct"] is False
    assert out["checks"]["energy_gap"]["value"] > \
        out["checks"]["energy_gap"]["limit"]


def test_reference_sites_are_the_programs(small):
    """The reference's IAO+PAO orbitals, built from S and the MOs alone,
    are the program's, column for column."""
    import quemb_tpu_torch as qt

    cell, mol, mf = small
    m = cell.config["molecule"]
    layout = SiteLayout.of([a for a, _ in CH3SCN], m["shells"],
                           m["valence_shells"], m["core"])
    fobj = qt.fragmentate(mol, n_BE=2, iao_valence_basis="sto-3g",
                          frozen_core=True, print_frags=False)
    be = qt.BE(mf, fobj, lo_method="IAO", device="cpu")
    S, C = torch.as_tensor(mf.get_ovlp()), torch.as_tensor(mf.mo_coeff)
    W = iao_pao(S, C[:, : mol.nelectron // 2], C[:, : sum(layout.core)],
                layout)
    assert np.abs(W.numpy() - be.W).max() < 1e-10


def _program_fragments(mol):
    import quemb_tpu_torch as qt

    f = qt.fragmentate(mol, n_BE=2, iao_valence_basis="sto-3g",
                       frozen_core=True, print_frags=False)
    return {frozenset(sites): {(frozenset(e), frozenset(f.AO_per_frag[r]))
                               for e, r in zip(edges, refs)}
            for sites, edges, refs in zip(f.AO_per_frag,
                                          f.AO_per_edge_per_frag,
                                          f.ref_frag_idx_per_edge_per_frag)}


@pytest.mark.parametrize("molecule", ["ch3scn", "thiophene-dimer"])
def test_fragment_sites_are_the_programs(small, thiophene, molecule):
    """Each fragment's sites, and each edge's sites with the fragment it
    is matched to, are the program's."""
    from quemb_tpu_torch.chem.mole import Mole

    if molecule == "ch3scn":
        symbols = [a for a, _ in CH3SCN]
        coords = np.array([c for _, c in CH3SCN])
        m = small[0].config["molecule"]
    else:
        m = thiophene.config["molecule"]
        symbols, coords = inp.read_xyz(ROOT / m["xyz"])
    mol = Mole(atom=list(zip(symbols, coords)), basis=m["basis"])
    layout = SiteLayout.of(symbols, m["shells"], m["valence_shells"],
                           m["core"])
    frags = iao_fragments(symbols, coords, layout, 2)
    ref = {frozenset(fr.sites): {(frozenset(e),
                                  frozenset(frags[r].sites))
                                 for e, r in zip(fr.edges, fr.edge_ref)}
           for fr in frags}
    assert ref == _program_fragments(mol)
    if molecule == "thiophene-dimer":
        assert len(frags) == 10
        assert sorted(len(fr.sites) for fr in frags) == \
            [24, 24, 26, 26, 28, 28, 28, 28, 34, 34]
        # the matching potentials: one block per edge, and the chemical one
        assert sum(len(e) * (len(e) + 1) // 2 for fr in frags
                   for e in fr.edges) + 1 == 261


def _labels(mol):
    """Per atom, the (n, l) of each function, read from ``Mole``."""
    out = [[] for _ in range(mol.natm)]
    for lab in mol.ao_labels():
        atom, _, nl = lab.split()
        out[int(atom)].append((int(nl[0]), "spd".index(nl[1])))
    return out


@pytest.mark.parametrize("basis,key", [("6-31g", "shells"),
                                       ("sto-3g", "valence_shells")])
def test_shells_are_the_engines(small, basis, key):
    """The configuration's shells give the integral engine's AO order in
    both bases (the rotation's p shells, the reference's minimal
    subset)."""
    from quemb_tpu_torch.chem.mole import Mole

    m = small[0].config["molecule"]
    atoms = [("C", (0, 0, 0)), ("H", (0, 0, 1.1)), ("S", (0, 1.8, 0)),
             ("N", (1.5, 0, 0))]
    mol = Mole(atom=atoms, basis=basis)
    for (s, _), got in zip(atoms, _labels(mol)):
        assert [(n, l) for n, l, _ in ao_labels(m[key][s])] == got, s
    _, p_starts, nao = inp.ao_layout([s for s, _ in atoms], m[key])
    assert nao == mol.nao
    assert p_starts == [i for i, lab in enumerate(mol.ao_labels())
                        if lab.endswith("px")]


def test_thiophene_inputs_are_checked(thiophene):
    """The dimer's inputs at seed 0 and at a large seed: the rotated
    integrals are the engine's at the turned geometry, the ERI built there
    gives back the frozen mean field, and an ERI off by 1e-8 is
    refused."""
    from quemb_tpu_torch.chem import integrals
    from quemb_tpu_torch.chem.mole import Mole

    mod = thiophene.module
    for seed in (0, 2**31 + 11):
        d = mod.make_inputs(ROOT, thiophene.config, seed, "cpu")
        gap, comm = mod.check_inputs(d, "cpu")
        assert gap < mod.ENERGY_TOL and comm < mod.COMMUTATOR_TOL
        mol = Mole(atom=list(zip(d["symbols"], d["coords"])), basis="6-31g")
        assert np.abs(integrals.overlap(mol) - d["S"]).max() < 1e-12
        assert np.abs(integrals.core_hamiltonian(mol)
                      - d["hcore"]).max() < 1e-10
        assert abs(mol.energy_nuc() - d["enuc"]) < 1e-9
    d["eri"] *= 1.0 + 1e-8
    with pytest.raises(ValueError, match="does not reproduce"):
        mod.check_inputs(d, "cpu")
