"""Judges a job's result with the plain reference.

A job hands back its total energy and, per fragment, its sites (global
localized-orbital indices) and the matching potential ``heff`` it was
last solved at.  That potential is the job's matched state: the judge
checks that it has the form the traffic allows (edge blocks, one chemical
potential on the other fragment sites, zero elsewhere), puts it into the
reference's own fragments, and has the reference work out the energy and
the density-matching error there.  The job is judged by three numbers:
the gap between its energy and the reference's, the reference's matching
error at its potential, and the count of potential entries of a form the
traffic does not allow.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.be import embed, matching_error, solve
from portbench.reference.fragments import be_fragments

#: what each kind of traffic lets the matching potential hold
FORMS = ("none", "chemical", "edges_and_chemical")


class Judge:
    def __init__(self, inputs: dict, config: dict, traffic: dict, device):
        be = config["be"]
        if (be.get("frag_type", "chemgen"), be.get("lo_method", "lowdin"),
                traffic["kwargs"].get("solver", "CCSD")) != (
                "chemgen", "lowdin", "CCSD"):
            raise NotImplementedError(
                "the reference covers chemgen fragments, Lowdin orbitals "
                "and CCSD")
        self.form = traffic["potentials"]
        if self.form not in FORMS:
            raise ValueError(f"potentials={self.form!r}")
        self.device = device
        self.nocc = int(inputs["nocc"])
        frags = be_fragments(inputs["symbols"], inputs["coords"],
                             inputs["ao_ranges"], int(be["n_BE"]))
        self.problems, self.e_hf = embed(inputs, frags, device)
        self._cache: dict[bytes, tuple[float, float]] = {}

    def potentials(self, state: dict) -> tuple[list[np.ndarray], int]:
        """The job's potential in the reference's fragments, and the count
        of its entries that break the allowed form."""
        bad = 0
        mus = []
        heffs = [None] * len(self.problems)
        by_sites = {frozenset(p.frag.sites): k
                    for k, p in enumerate(self.problems)}
        for sites, heff in state["frags"]:
            k = by_sites.get(frozenset(sites))
            if k is None or heffs[k] is not None:
                bad += 1
                continue
            p = self.problems[k]
            nf = p.nf
            heff = np.asarray(heff, dtype=np.float64)
            bad += int(np.count_nonzero(heff[nf:])
                       + np.count_nonzero(heff[:nf, nf:]))
            perm = [list(sites).index(s) for s in p.frag.sites]
            H = heff[:nf, :nf][np.ix_(perm, perm)]
            allowed = np.zeros((nf, nf), dtype=bool)
            edge_sites = {s for e in p.frag.edges for s in e}
            if self.form == "edges_and_chemical":
                for e in p.frag.edges:
                    idx = [p.frag.sites.index(s) for s in e]
                    allowed[np.ix_(idx, idx)] = True
            bad += int(np.count_nonzero(H != H.T))
            for i, s in enumerate(p.frag.sites):
                if s not in edge_sites:
                    mus.append(-H[i, i])
                    allowed[i, i] = True
            bad += int(np.count_nonzero(H[~allowed]))
            heffs[k] = H
        bad += sum(h is None for h in heffs)
        if mus:
            bad += int(np.count_nonzero(np.asarray(mus) != mus[0]))
            if self.form == "none":
                bad += int(np.count_nonzero(np.asarray(mus)))
        return heffs, bad

    def evaluate(self, heffs: list[np.ndarray]) -> tuple[float, float]:
        """Reference total energy and matching error at a potential given
        on the fragment sites of each reference fragment."""
        key = b"".join(h.tobytes() for h in heffs)
        if key not in self._cache:
            solved = []
            for p, H in zip(self.problems, heffs):
                n = p.h1.shape[0]
                full = torch.zeros((n, n), dtype=torch.float64,
                                   device=self.device)
                full[: p.nf, : p.nf] = torch.as_tensor(H, device=self.device)
                solved.append(solve(p, full))
            e_tot = self.e_hf + sum(s.e_rows for s in solved)
            err = matching_error(self.problems, solved, self.nocc,
                                 only_chem=self.form == "chemical")
            self._cache[key] = (e_tot, err)
        return self._cache[key]

    def judge(self, state: dict) -> dict:
        """The numbers of one job."""
        heffs, bad = self.potentials(state)
        out = {"energy_gap": float("inf"), "potential_form": float(bad)}
        if self.form != "none":
            out["match_error"] = float("inf")
        if bad:
            return out
        e_ref, err = self.evaluate(heffs)
        # a non-finite reading is the worst there is
        out["energy_gap"] = float(np.nan_to_num(abs(state["e_tot"] - e_ref),
                                                nan=np.inf))
        if self.form != "none":
            out["match_error"] = float(np.nan_to_num(err, nan=np.inf))
        return out
