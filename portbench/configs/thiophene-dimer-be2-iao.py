"""The thiophene dimer's own inputs, program side and reference.

Inputs: the frozen mean field (``hcore``, ``S``, ``C``, ``moe``,
``e_tot``) turned by the seed's rotation as in
:mod:`portbench.lib.inputs`, and the dense AO ERI built at set-up by the
program's integral engine at the turned geometry (106^4 doubles, 1 GB,
are not committed).  The inputs are refused unless the turned density's
energy with that ERI is the fixture's ``e_tot`` within 1e-11 Ha and
max|FDS - SDF| < 1e-7, so that a change to the engine cannot change the
benchmark's inputs unseen.

Program: ``fragmentate`` with the IAO valence basis and the frozen core,
``BE(..., lo_method="IAO")``.  Reference: the IAO+PAO sites and the
frozen core of :mod:`portbench.reference.iao`, then the same embedding,
solves and judgement as octane's.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from portbench.lib import harness
from portbench.lib import inputs as inp
from portbench.lib import judge
from portbench.reference.be import embed
from portbench.reference.iao import SiteLayout, iao_fragments, iao_pao, \
    in_site_basis

#: what the inputs' ERI has to give of the fixture's mean field
ENERGY_TOL = 1e-11
COMMUTATOR_TOL = 1e-7


def check_inputs(d: dict, device) -> tuple[float, float]:
    """|E(D) - e_tot| and max|FDS - SDF| of the inputs' density D with
    their ERI; raises ValueError past ENERGY_TOL or COMMUTATOR_TOL."""

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                               device=device)

    eri, h, S, C = t(d["eri"]), t(d["hcore"]), t(d["S"]), t(d["C"])
    D = 2.0 * C[:, : d["nocc"]] @ C[:, : d["nocc"]].T
    F = h + torch.einsum("pqrs,rs->pq", eri, D) \
        - 0.5 * torch.einsum("prqs,rs->pq", eri, D)
    energy = float(0.5 * ((h + F) * D).sum()) + d["enuc"]
    gap = abs(energy - d["e_tot"])
    comm = float((F @ D @ S - S @ D @ F).abs().max())
    if not (gap < ENERGY_TOL and comm < COMMUTATOR_TOL):
        raise ValueError(
            f"the ERI does not reproduce the frozen mean field: energy off "
            f"by {gap:.3e} Ha (limit {ENERGY_TOL}), max|FDS - SDF| "
            f"{comm:.3e} (limit {COMMUTATOR_TOL})")
    return gap, comm


def make_inputs(root: Path, config: dict, seed: int, device) -> dict:
    """The rotated mean field with the ERI of the rotated molecule, as
    host float64 arrays (the keys of :func:`portbench.lib.inputs.
    make_inputs`)."""
    from quemb_tpu_torch.chem.integrals import eri_full
    from quemb_tpu_torch.chem.mole import Mole

    mol = config["molecule"]
    xyz, fixture = root / mol["xyz"], root / mol["fixture"]
    for path, key in ((xyz, "xyz_sha256"), (fixture, "fixture_sha256")):
        if inp.file_sha256(path) != mol[key]:
            raise ValueError(f"{path} is not the file this configuration "
                             f"was written for ({key})")
    symbols, coords = inp.read_xyz(xyz)
    ranges, p_starts, nao = inp.ao_layout(symbols, mol["shells"])
    with np.load(fixture) as f:
        if int(f["nao"]) != nao:
            raise ValueError(f"fixture nao {int(f['nao'])} != {nao}")
        arrays = {k: f[k] for k in ("hcore", "S", "C", "moe", "e_tot")}
    Q = inp.rotation(seed)
    M = inp.ao_rotation(Q, p_starts, nao)
    turned = coords @ Q.T
    charges = mol["charges"]
    d = dict(
        symbols=symbols, coords=turned, ao_ranges=ranges,
        hcore=M @ arrays["hcore"] @ M.T, S=M @ arrays["S"] @ M.T,
        C=M @ arrays["C"], moe=arrays["moe"], e_tot=float(arrays["e_tot"]),
        nocc=sum(charges[s] for s in symbols) // 2,
        enuc=inp.nuclear_repulsion(symbols, coords, charges),
        eri=eri_full(Mole(atom=list(zip(symbols, turned)),
                          basis=mol["basis"])),
    )
    check_inputs(d, device)
    return d


class Runner(harness.Runner):
    """``fragmentate`` takes the IAO valence basis and the frozen core;
    ``BE`` the rest of the configuration's ``be``."""

    def __init__(self, cell, inputs: dict, device: str):
        super().__init__(cell, inputs, device)
        for key in ("iao_valence_basis", "frozen_core"):
            self.frag_kwargs[key] = self.be_kwargs.pop(key)


class Judge(judge.Judge):
    """Octane's judge over the IAO+PAO sites with the core frozen."""

    def __init__(self, inputs: dict, config: dict, traffic: dict, device):
        be = config["be"]
        if (be["frag_type"], be["lo_method"], be["frozen_core"],
                traffic["kwargs"].get("solver", "CCSD")) != (
                "chemgen", "IAO", True, "CCSD"):
            raise NotImplementedError(
                "this reference covers chemgen fragments, IAO orbitals with "
                "a frozen core and CCSD")
        self.form = traffic["potentials"]
        if self.form not in judge.FORMS:
            raise ValueError(f"potentials={self.form!r}")
        self.device = device
        mol = config["molecule"]
        layout = SiteLayout.of(inputs["symbols"], mol["shells"],
                               mol["valence_shells"], mol["core"])
        ncore = sum(layout.core)
        S = torch.as_tensor(inputs["S"], dtype=torch.float64, device=device)
        C = torch.as_tensor(inputs["C"], dtype=torch.float64, device=device)
        W = iao_pao(S, C[:, : int(inputs["nocc"])], C[:, :ncore], layout)
        sites = in_site_basis(inputs, W, ncore, device)
        self.nocc = sites["nocc"]
        frags = iao_fragments(inputs["symbols"], inputs["coords"], layout,
                              int(be["n_BE"]))
        self.problems, self.e_hf = embed(sites, frags, device)
        self._cache: dict[bytes, tuple[float, float]] = {}
