"""The port's autogen and graphgen fragmenters are copies: held to the JAX
package's and to the reference's oracles.

Structures (every index list of the ``FragPart``) must be equal, not
close: on the H8 chain and on octane, BE1-BE3, against both the JAX
package's ``fragmentate`` and ``tests/data/{autogen,graphgen}_expected.py``;
with a frozen core against the JAX package.  The dispatch in
``fragmentate`` (``GraphGenArgs`` through ``additional_args``,
``order_by_size``, the message for an unknown ``frag_type``) is the JAX
function's.  H8 BE2 one-shot CCSD energies of the three fragmenters agree
with each other at 1e-6 Ha (the JAX test's bar) and with the JAX
package's at 1e-8 Ha.
"""

import os
import sys

import numpy as np
import pytest
import torch

import quemb_tpu as jq
import quemb_tpu_torch as qt
from quemb_tpu.chem.mole import Mole as JMole
from quemb_tpu.chem.scf import RHF as JRHF
from quemb_tpu_torch.chem.mole import Mole
from quemb_tpu_torch.chem.scf import RHF
from quemb_tpu_torch.fragment.graphgen import GraphGenArgs

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
sys.path.insert(0, DATA)
from autogen_expected import EXPECTED as AUTOGEN  # noqa: E402
from graphgen_expected import EXPECTED as GRAPHGEN  # noqa: E402

ORACLES = {"autogen": AUTOGEN, "graphgen": GRAPHGEN}
H8_ATOMS = [("H", (0.0, 0.0, float(i))) for i in range(8)]
OCTANE = os.path.join(DATA, "xyz", "octane.xyz")
FIELDS = (
    "frag_type", "n_BE", "AO_per_frag", "AO_per_edge_per_frag",
    "ref_frag_idx_per_edge_per_frag", "relAO_per_edge_per_frag",
    "relAO_in_ref_per_edge_per_frag", "relAO_per_origin_per_frag",
    "weight_and_relAO_per_center_per_frag", "motifs_per_frag",
    "origin_per_frag", "H_per_motif", "add_center_atom", "frozen_core",
    "iao_valence_basis", "iao_valence_only", "n_frag", "ncore",
    "no_core_idx", "core_list",
)
ORACLE_FIELDS = (
    "AO_per_frag", "AO_per_edge_per_frag", "ref_frag_idx_per_edge_per_frag",
    "relAO_per_origin_per_frag", "weight_and_relAO_per_center_per_frag",
)


def _t(x):
    """Nested sequences as tuples and numpy scalars as Python numbers."""
    if isinstance(x, (list, tuple, np.ndarray)):
        return tuple(_t(i) for i in x)
    if isinstance(x, np.generic):
        return x.item()
    return x


def _mols(system):
    if system == "h8":
        kw = dict(atom=H8_ATOMS, basis="sto-3g", unit="angstrom")
        return Mole(**kw), JMole(**kw)
    return (Mole.from_xyz_file(OCTANE, basis="sto-3g"),
            JMole.from_xyz_file(OCTANE, basis="sto-3g"))


def _assert_same(fobj, jfobj, fields=FIELDS):
    for name in fields:
        assert _t(getattr(fobj, name)) == _t(getattr(jfobj, name)), name


@pytest.mark.parametrize("n_BE", [1, 2, 3])
@pytest.mark.parametrize("system", ["h8", "octane"])
@pytest.mark.parametrize("frag_type", ["autogen", "graphgen"])
def test_structures_match_jax_and_oracle(frag_type, system, n_BE):
    mol, jmol = _mols(system)
    kw = dict(n_BE=n_BE, frag_type=frag_type, print_frags=False)
    fobj = qt.fragmentate(mol, **kw)
    _assert_same(fobj, jq.fragmentate(jmol, **kw))
    name = "h_linear" if system == "h8" else "octane"
    target = ORACLES[frag_type][f"test_{frag_type}_{name}_be{n_BE}"]
    for field in ORACLE_FIELDS:
        assert _t(getattr(fobj, field)) == _t(target[field]), field


@pytest.mark.parametrize("frag_type", ["autogen", "graphgen"])
def test_frozen_core_structures_match_jax(frag_type):
    mol, jmol = _mols("octane")
    kw = dict(n_BE=2, frag_type=frag_type, frozen_core=True,
              print_frags=False)
    fobj = qt.fragmentate(mol, **kw)
    assert fobj.ncore == 8
    _assert_same(fobj, jq.fragmentate(jmol, **kw))


def test_dispatch_matches_jax():
    mol, jmol = _mols("octane")
    args = dict(n_BE=2, frag_type="graphgen", print_frags=False,
                order_by_size=True)
    fobj = qt.fragmentate(mol, additional_args=GraphGenArgs(cutoff=3.0),
                          **args)
    from quemb_tpu.fragment.graphgen import GraphGenArgs as JGraphGenArgs

    jfobj = jq.fragmentate(jmol, additional_args=JGraphGenArgs(cutoff=3.0),
                           **args)
    _assert_same(fobj, jfobj)
    sizes = [len(a) for a in fobj.AO_per_frag]
    assert sizes == sorted(sizes, reverse=True)
    with pytest.raises(NotImplementedError) as err:
        qt.fragmentate(mol, frag_type="nonsense")
    with pytest.raises(NotImplementedError) as jerr:
        jq.fragmentate(jmol, frag_type="nonsense")
    assert str(err.value) == str(jerr.value)


@pytest.fixture(scope="module")
def h8_ecorr():
    """H8 BE2 one-shot CCSD E_corr by fragmenter, the port's on the CPU
    (from its own RHF) and the JAX package's."""
    jmol = JMole(atom=H8_ATOMS, basis="sto-3g")
    jmf = JRHF(jmol, conv_tol=1e-12)
    jmf.kernel()
    mol = Mole(atom=H8_ATOMS, basis="sto-3g")
    mf = RHF(mol, conv_tol=1e-12, device="cpu")
    mf.kernel()
    out = {}
    for ft in ("chemgen", "autogen", "graphgen"):
        be = qt.BE(mf, qt.fragmentate(mol, n_BE=2, frag_type=ft,
                                      print_frags=False), device="cpu")
        be.oneshot(solver="CCSD")
        jbe = jq.BE(jmf, jq.fragmentate(jmol, n_BE=2, frag_type=ft,
                                        print_frags=False))
        jbe.oneshot(solver="CCSD")
        out[ft] = (be.ebe_tot - be.ebe_hf, jbe.ebe_tot - jbe.ebe_hf)
    return out


@pytest.mark.parametrize("frag_type", ["chemgen", "autogen", "graphgen"])
def test_h8_oneshot_energy_by_fragmenter(h8_ecorr, frag_type):
    ecorr, jecorr = h8_ecorr[frag_type]
    assert abs(ecorr - jecorr) < 1e-8
    assert abs(ecorr - h8_ecorr["chemgen"][0]) < 1e-6
