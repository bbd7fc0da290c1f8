"""Writes the frozen mean field of the ``thiophene-dimer-be2-iao``
configuration: the program's RHF of the thiophene dimer in 6-31G on the
CPU at ``conv_tol`` 1e-12, from ``portbench/configs/thiophene-dimer.xyz``.

    python3 portbench/fixtures/make_thiophene_dimer.py

Writes ``portbench/fixtures/thiophene-dimer-631g-hf.npz`` (``hcore``,
``S``, ``C``, ``moe``, ``e_tot``, ``nao``) and prints its sha256, which
the configuration's file records.  The ERI is not stored (106^4 doubles
are 1 GB): the configuration builds it at set-up and checks it against
this mean field.
"""

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.lib.inputs import file_sha256, read_xyz  # noqa: E402

XYZ = ROOT / "portbench" / "configs" / "thiophene-dimer.xyz"
OUT = ROOT / "portbench" / "fixtures" / "thiophene-dimer-631g-hf.npz"


def main() -> int:
    from quemb_tpu_torch.chem.mole import Mole
    from quemb_tpu_torch.chem.scf import RHF

    symbols, coords = read_xyz(XYZ)
    mol = Mole(atom=list(zip(symbols, coords)), basis="6-31g")
    mf = RHF(mol, conv_tol=1e-12, device="cpu")
    S = mf.get_ovlp()

    def commutator():
        dm = mf.make_rdm1()
        F = mf.get_hcore() + mf.get_veff(dm)
        return float(np.abs(F @ dm @ S - S @ dm @ F).max())

    # the SCF stops on the energy and the density's step (1e-5); passes
    # from its own density bring max|FDS - SDF| under 1e-8
    passes = []
    mf.kernel()
    while True:
        if not mf.converged:
            raise SystemExit(f"RHF did not converge in {mf.cycles} cycles")
        passes.append((mf.cycles, mf.e_tot, commutator()))
        if passes[-1][2] < 1e-8 or len(passes) == 20:
            break
        mf.kernel(dm0=mf.make_rdm1())
    comm = passes[-1][2]
    C = mf.mo_coeff
    np.savez(OUT, hcore=mf.get_hcore(), S=S, C=C, moe=mf.mo_energy,
             e_tot=np.float64(mf.e_tot), nao=np.int64(mol.nao))
    for cycles, e_tot, c in passes:
        print(f"pass: {cycles} cycles, e_tot {e_tot!r}, max|FDS-SDF| {c:.3e}")
    print(f"nao {mol.nao} nelectron {mol.nelectron} e_tot {mf.e_tot!r} "
          f"max|FDS-SDF| {comm:.3e}")
    print(f"{OUT.relative_to(ROOT)} sha256 {file_sha256(OUT)}")
    print(f"{XYZ.relative_to(ROOT)} sha256 {file_sha256(XYZ)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
