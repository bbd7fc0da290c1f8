"""Reference energies of ``chip_smoke.py`` phases 13-17 and 19, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/jax_references.py CASE
        [--package jax|torch]

``CASE`` is one of:

- ``octane-relaxed`` (phase 13): octane (C8H18, STO-3G) BE2 from
  ``fixtures/octane_sto3g_hf.npz``, six chemgen fragments,
  ``BE.optimize(solver="CCSD", relax_density=True, only_chem=True)``
  from zero potential with the HF Jacobian and CCSD tolerance 1e-6 (the
  relaxed densities iterate their own CCSD to 1e-10).  Minutes an
  evaluation on four cores;
- ``hexene-anion-ube`` (phase 14): the hexene anion (STO-3G, charge -1,
  spin 1), ``UHF(conv_tol=1e-10)``, then with a frozen core one-shot
  ``UBE`` BE1 and BE2 with UCCSD, as ``tests/test_ube_hexene.py`` runs
  them.  A few minutes;
- ``octane-qmmm`` (phase 15): ``be2puffin`` on ``tests/data/xyz/octane.xyz``
  (STO-3G, BE2, no frozen core) with the four point charges of
  ``tests/test_aux_surface.py:328-331``, its own QM/MM RHF, CCSD tolerance
  1e-9; E_corr, and E_HF and HF-in-HF of the BE it builds.  About a
  minute;
- ``octane-autogen`` (phase 16): octane BE2 from
  ``fixtures/octane_sto3g_hf.npz``, ``frag_type="autogen"``,
  ``BE.optimize(solver="CCSD")`` at CCSD tolerance 1e-6 (as phase 6);
  then one-shot E_corr of chemgen and graphgen at the same tolerance.
  A few minutes;
- ``propane-ecp`` (phase 17): propane with the synthetic carbon ECP of
  ``tests/test_ecp.py`` (``_PSEUDO_C``), ``RHF(conv_tol=1e-12)``, one-shot
  BE1 and BE2 CCSD at tolerance 1e-9.  Seconds;
- ``polyacetylene-kbe`` (phase 19): the polyacetylene cell of
  ``tests/test_kbe.py:117-129`` (STO-3G, 1x1x3 k-points), the default
  ``KGDF`` (``make_etb_aux(l_extra=1)``) built once, ``KRHF(omega=0.6,
  conv_tol=1e-11)``, then with a frozen core ``kbe.BE`` on chemgen and on
  autogen BE2 fragments, each ``optimize(solver="CCSD")`` at the default
  CCSD tolerance.  KRHF ``e_tot``, ``E_core``, ``ebe_hf``, HF-in-HF and
  both matched ``ebe_tot``.  About 13 minutes to the first ``BE`` for
  JAX on the CPU (the host ``KGDF.build`` and the KRHF), then the two
  matchings; the port's KRHF converges in about 12 cycles where the JAX
  package's stops unconverged at its 300-cycle cap;
- ``polyacetylene-krhf-cross``: that cell's KRHF through the port on the
  CPU, then the JAX package's Fock build at the port's converged density
  (its energy and max|FDS - SDF|) and the JAX package's SCF started from
  that density (40 cycles).  Both packages build their KGDF (about 8
  minutes); ``--package`` is ignored.

Each runs through the JAX package (default; plain f64 CCSD) or through the
port (``device="cpu"``) and prints one JSON line per energy, with the
wall (``octane-relaxed`` also one line per objective evaluation, with its
error norm).
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
FIXTURE = os.path.join(ROOT, "fixtures", "octane_sto3g_hf.npz")
OCTANE_XYZ = os.path.join(ROOT, "tests", "data", "xyz", "octane.xyz")
HEXENE_XYZ = os.path.join(ROOT, "tests", "data", "xyz", "hexene.xyz")


def _octane_be(package, frag_type="chemgen"):
    if package == "torch":
        import quemb_tpu_torch as qt
        from quemb_tpu_torch.chem.scf import load_fixture

        mf = load_fixture(FIXTURE, OCTANE_XYZ, device="cpu")
        return qt.BE(mf, qt.fragmentate(mf.mol, n_BE=2, frag_type=frag_type,
                                        print_frags=False), device="cpu")
    import numpy as np

    from quemb_tpu import BE, fragmentate
    from quemb_tpu.chem.mole import Mole
    from quemb_tpu.chem.scf import RHF
    from quemb_tpu.utils.eri_pack import unpack_eri_s8

    mol = Mole.from_xyz_file(OCTANE_XYZ, basis="sto-3g")
    mf = RHF(mol, conv_tol=1e-12)
    d = np.load(FIXTURE)
    mf._hcore, mf._S = d["hcore"], d["S"]
    mf._eri = unpack_eri_s8(d["eri_s8"], int(d["nao"]))
    mf.mo_coeff, mf.mo_energy = d["C"], d["moe"]
    mf.e_tot = float(d["e_tot"])
    mf.converged = True
    return BE(mf, fragmentate(mol=mol, n_BE=2, frag_type=frag_type,
                              print_frags=False))


def octane_relaxed(package):
    os.environ["QUEMB_TPU_CCSD_CONV_TOL"] = "1e-6"
    be = _octane_be(package)
    if package == "torch":
        from quemb_tpu_torch.matching import beopt
    else:
        from quemb_tpu.matching import beopt
    be_func, errs = beopt.be_func, []

    def logged(*args, **kwargs):
        ret = be_func(*args, **kwargs)
        errs.append(float(ret[0]))
        print(json.dumps({"evaluation": len(errs), "error_norm": errs[-1],
                          "s": time.perf_counter() - t0}), flush=True)
        return ret

    beopt.be_func = logged
    t0 = time.perf_counter()
    be.optimize(solver="CCSD", relax_density=True, only_chem=True)
    yield {"ebe_tot": be.ebe_tot, "ebe_hf": be.ebe_hf,
           "evaluations": len(errs), "s": time.perf_counter() - t0}


def hexene_anion_ube(package):
    if package == "torch":
        from quemb_tpu_torch import fragmentate
        from quemb_tpu_torch.chem.mole import Mole
        from quemb_tpu_torch.chem.scf import UHF
        from quemb_tpu_torch.ube import UBE

        kw = dict(device="cpu")
    else:
        from quemb_tpu import fragmentate
        from quemb_tpu.chem.mole import Mole
        from quemb_tpu.chem.scf import UHF
        from quemb_tpu.ube import UBE

        kw = {}
    mol = Mole.from_xyz_file(HEXENE_XYZ, basis="sto-3g", charge=-1, spin=1)
    mf = UHF(mol, conv_tol=1e-10, **kw)
    mf.kernel()
    yield {"e_hf": mf.e_tot}
    for n_BE in (1, 2):
        fobj = fragmentate(mol=mol, n_BE=n_BE, frag_type="chemgen",
                           frozen_core=True, print_frags=False)
        t0 = time.perf_counter()
        ube = UBE(mf, fobj, **kw)
        ube.oneshot(solver="UCCSD")
        yield {"n_BE": n_BE, "ebe_tot_minus_ebe_hf": ube.ebe_tot - ube.ebe_hf,
               "hf_in_hf": ube.hf_etot - ube.ebe_hf,
               "s": time.perf_counter() - t0}


#: tests/test_aux_surface.py:328-331: MM charges and their coordinates (Bohr)
QMMM_CHARGES = [-0.2, -0.1, 0.15, 0.2]
QMMM_COORDS = [(-3, -8, -2), (-2, 6, 1), (2, -5, 2), (1, 8, 1.5)]
#: tests/test_ecp.py: propane and its synthetic 2-electron-core carbon ECP
PROPANE = (
    "C 0 0 0; C 1.26 0.86 0; C 2.52 0 0;"
    "H -0.55 0.94 0; H -0.55 -0.55 0.8; H -0.55 -0.55 -0.8;"
    "H 1.26 1.5 0.88; H 1.26 1.5 -0.88;"
    "H 3.07 0.94 0; H 3.07 -0.55 0.8; H 3.07 -0.55 -0.8"
)
PSEUDO_C = {"C": {"ncore": 2, "local": [(2, 4.5, 8.0), (1, 2.8, 2.0)],
                  "semilocal": {0: [(2, 6.0, 10.0)]}}}


def _captured_be(package):
    """A context in which every BE the package builds is appended to the
    list it yields."""
    import contextlib

    if package == "torch":
        import quemb_tpu_torch as pkg
    else:
        import quemb_tpu as pkg

    @contextlib.contextmanager
    def ctx():
        made, inner = [], pkg.BE

        class Captured(inner):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                made.append(self)

        pkg.BE = Captured
        try:
            yield made
        finally:
            pkg.BE = inner

    return ctx()


def octane_qmmm(package):
    import numpy as np

    os.environ["QUEMB_TPU_CCSD_CONV_TOL"] = "1e-9"
    if package == "torch":
        from quemb_tpu_torch.misc import be2puffin

        kw = dict(device="cpu")
    else:
        from quemb_tpu.misc import be2puffin

        kw = {}
    t0 = time.perf_counter()
    with _captured_be(package) as made:
        ecorr = be2puffin(
            OCTANE_XYZ, "sto-3g", n_BE=2, frozen_core=False,
            pts_and_charges=(np.array(QMMM_COORDS, float),
                             np.array(QMMM_CHARGES)), **kw)
    be = made[0]
    yield {"ecorr": ecorr, "e_hf": be.hf_etot,
           "hf_in_hf": be.hf_etot - be.ebe_hf,
           "s": time.perf_counter() - t0}


def octane_autogen(package):
    os.environ["QUEMB_TPU_CCSD_CONV_TOL"] = "1e-6"
    be = _octane_be(package, frag_type="autogen")
    t0 = time.perf_counter()
    be.optimize(solver="CCSD")
    yield {"frag_type": "autogen", "n_frag": len(be.fragments),
           "ebe_tot": be.ebe_tot, "ecorr": be.ebe_tot - be.ebe_hf,
           "hf_in_hf": be.hf_etot - be.ebe_hf,
           "s": time.perf_counter() - t0}
    for frag_type in ("chemgen", "graphgen"):
        be = _octane_be(package, frag_type=frag_type)
        t0 = time.perf_counter()
        be.oneshot(solver="CCSD")
        yield {"frag_type": frag_type, "n_frag": len(be.fragments),
               "oneshot_ecorr": be.ebe_tot - be.ebe_hf,
               "hf_in_hf": be.hf_etot - be.ebe_hf,
               "s": time.perf_counter() - t0}


def propane_ecp(package):
    os.environ["QUEMB_TPU_CCSD_CONV_TOL"] = "1e-9"
    if package == "torch":
        import quemb_tpu_torch as pkg
        from quemb_tpu_torch.chem.mole import Mole
        from quemb_tpu_torch.chem.scf import RHF

        kw = dict(device="cpu")
    else:
        import quemb_tpu as pkg
        from quemb_tpu.chem.mole import Mole
        from quemb_tpu.chem.scf import RHF

        kw = {}
    mol = Mole(atom=PROPANE, basis="sto-3g", ecp=PSEUDO_C)
    mf = RHF(mol, conv_tol=1e-12, **kw)
    mf.kernel()
    yield {"nelectron": mol.nelectron, "e_hf": mf.e_tot,
           "converged": mf.converged}
    for n_BE in (1, 2):
        fobj = pkg.fragmentate(mol, n_BE=n_BE, frag_type="chemgen",
                               print_frags=False)
        be = pkg.BE(mf, fobj, **kw)
        be.oneshot(solver="CCSD")
        yield {"n_BE": n_BE, "ecorr": be.ebe_tot - be.ebe_hf,
               "hf_in_hf": be.hf_etot - be.ebe_hf}


#: tests/test_kbe.py:117-129: the polyacetylene cell (Angstrom)
POLYACETYLENE = """
H      1.4285621630072645    0.0    -0.586173422487319
C      0.3415633681566205    0.0    -0.5879921146011252
H     -1.4285621630072645    0.0     0.586173422487319
C     -0.3415633681566205    0.0     0.5879921146011252
H      1.4285621630072645    0.0     1.868826577512681
C      0.3415633681566205    0.0     1.867007885398875
H     -1.4285621630072645    0.0     3.041173422487319
C     -0.3415633681566205    0.0     3.0429921146011254
"""
POLYACETYLENE_LATTICE = ((8.0, 0.0, 0.0), (0.0, 8.0, 0.0),
                         (0.0, 0.0, 2.455 * 2))


def polyacetylene_kbe(package):
    import numpy as np

    if package == "torch":
        from quemb_tpu_torch import kbe

        kw = dict(device="cpu")
    else:
        from quemb_tpu import kbe

        kw = {}
    cell = kbe.Cell(atom=POLYACETYLENE, a=np.array(POLYACETYLENE_LATTICE),
                    basis="sto-3g")
    kpts = cell.make_kpts([1, 1, 3])
    t0 = time.perf_counter()
    gdf = kbe.KGDF(cell, kpts, omega=0.6, **kw).build()
    yield {"naux": gdf.naux, "kgdf_build_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    mf = kbe.KRHF(cell, kpts, with_df=gdf, omega=0.6, conv_tol=1e-11, **kw)
    mf.kernel()
    yield {"krhf_e_tot": mf.e_tot, "converged": bool(mf.converged),
           "cycles": getattr(mf, "cycles", None),
           "krhf_s": time.perf_counter() - t0}
    for frag_type in ("chemgen", "autogen"):
        fobj = kbe.fragmentate(mol=cell, kpt=[1, 1, 3], n_BE=2,
                               frag_type=frag_type, frozen_core=True)
        t0 = time.perf_counter()
        be = kbe.BE(mf, fobj, kpts=kpts, **kw)
        line = {"frag_type": frag_type, "n_frag": len(be.fragments),
                "nemb": [int(f.nao) for f in be.fragments],
                "E_core": be.E_core, "ek": be.ek, "ebe_hf": be.ebe_hf,
                "hf_in_hf": mf.e_tot - (be.ebe_hf + be.ek),
                "be_s": time.perf_counter() - t0}
        t0 = time.perf_counter()
        be.optimize(solver="CCSD")
        yield {**line, "ebe_tot": be.ebe_tot,
               "optimize_s": time.perf_counter() - t0}


def polyacetylene_krhf_cross(package):
    import numpy as np

    from quemb_tpu import kbe as jkbe
    from quemb_tpu_torch import kbe

    lattice = np.array(POLYACETYLENE_LATTICE)
    cell = kbe.Cell(atom=POLYACETYLENE, a=lattice, basis="sto-3g")
    kpts = cell.make_kpts([1, 1, 3])
    mf = kbe.KRHF(cell, kpts, omega=0.6, conv_tol=1e-11, device="cpu")
    mf.kernel()
    yield {"port_e_tot": mf.e_tot, "converged": bool(mf.converged),
           "cycles": mf.cycles}
    jcell = jkbe.Cell(atom=POLYACETYLENE, a=lattice, basis="sto-3g")
    jmf = jkbe.KRHF(jcell, kpts, omega=0.6, conv_tol=1e-11)
    jmf.with_df.build()
    h, S, dm = jmf.get_hcore(), jmf.get_ovlp(), mf.hf_dm
    veff = jmf.get_veff(dm)
    F = h + veff
    e = np.mean([np.einsum("uv,vu->", h[k] + 0.5 * veff[k], dm[k])
                 for k in range(len(kpts))]).real + jcell.ewald()
    err = max(np.abs(F[k] @ dm[k] @ S[k] - S[k] @ dm[k] @ F[k]).max()
              for k in range(len(kpts)))
    yield {"jax_energy_at_port_density": e,
           "jax_commutator_at_port_density": err}
    jmf.max_cycle = 40
    yield {"jax_scf_from_port_density_40": jmf.kernel(dm0=dm),
           "converged": bool(jmf.converged)}


CASES = {"octane-relaxed": octane_relaxed,
         "hexene-anion-ube": hexene_anion_ube,
         "octane-qmmm": octane_qmmm,
         "octane-autogen": octane_autogen,
         "propane-ecp": propane_ecp,
         "polyacetylene-kbe": polyacetylene_kbe,
         "polyacetylene-krhf-cross": polyacetylene_krhf_cross}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("case", choices=tuple(CASES))
    ap.add_argument("--package", choices=("jax", "torch"), default="jax")
    args = ap.parse_args()
    if args.package == "jax":
        os.environ["QUEMB_TPU_CCSD_MIXED"] = "0"
    for line in CASES[args.case](args.package):
        print(json.dumps({"case": args.case, "package": args.package,
                          **line}), flush=True)


if __name__ == "__main__":
    main()
