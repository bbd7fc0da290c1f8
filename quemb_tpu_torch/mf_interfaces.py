"""Mean-field interchange: dump/load converged SCF solutions.

Replacement for the reference ``molbe/mf_interfaces/main.py`` (load_scf /
dump_scf at :138-155 and kbe/mf_interfaces) -- the decoupling layer that
lets BE consume a mean field computed elsewhere (another machine, another
program, a previous run) without re-running SCF.  Serialization is npz
(geometry + basis name + MO data); ``load_scf`` rebuilds the Mole/Cell and
a converged mean-field object whose integrals regenerate on demand from
the own integral engine.

An external program's AO ordering must match this framework's (PySCF
cartesian convention, chem/mole.py docstring); reordering hooks for other
conventions (the reference's ORCA f/g/h fixes, orca_interface.py:100-120)
can be layered on the coefficients before dumping.

JAX counterpart: ``quemb_tpu/mf_interfaces.py``.  The file format and the
ORCA readers are copies, so a file that either package dumps loads in the
other.  ``load_scf``, ``mf_from_orca_json`` and ``run_orca`` take the
port's ``device=`` keyword: the mean field they return is bound to it
(CUDA unless the caller names the CPU; no card raises), and so does
``load_kscf``: its KRHF is the port's (``kbe/scf.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from quemb_tpu_torch.chem.mole import Mole
from quemb_tpu_torch.chem.scf import RHF, UHF
from quemb_tpu_torch.utils.device import resolve_device

__all__ = ["dump_scf", "load_scf", "dump_kscf", "load_kscf"]


def _mol_payload(mol) -> dict:
    return dict(
        elements=np.array(mol.elements),
        coords_bohr=mol.atom_coords(),
        basis=np.array(mol.basis),
        charge=np.int64(mol.charge),
        spin=np.int64(mol.spin),
    )


def _rebuild_mol(data, cls=Mole, **extra):
    atoms = [
        (str(sym), xyz)
        for sym, xyz in zip(data["elements"], data["coords_bohr"])
    ]
    return cls(
        atom=atoms,
        basis=str(data["basis"]),
        charge=int(data["charge"]),
        spin=int(data["spin"]),
        unit="bohr",
        **extra,
    )


def dump_scf(mf, chkfile) -> None:
    """Store a converged RHF/UHF (geometry + basis + MOs) to ``chkfile``."""
    payload = _mol_payload(mf.mol)
    payload.update(
        e_tot=np.float64(mf.e_tot),
        mo_energy=np.asarray(mf.mo_energy),
        mo_coeff=np.asarray(mf.mo_coeff),
        unrestricted=np.bool_(isinstance(mf, UHF)),
    )
    np.savez(chkfile, **payload)


def load_scf(chkfile, device: torch.device | str | None = None):
    """Recreate (mol, converged mf) from a :func:`dump_scf` file; the mean
    field runs on ``device``."""
    dev = resolve_device(device, "load_scf")
    data = np.load(chkfile, allow_pickle=False)
    mol = _rebuild_mol(data)
    mf = (UHF if bool(data["unrestricted"]) else RHF)(mol, device=dev)
    mf.mo_coeff = data["mo_coeff"]
    mf.mo_energy = data["mo_energy"]
    mf.e_tot = float(data["e_tot"])
    mf.converged = True
    return mol, mf


def dump_kscf(mf, chkfile) -> None:
    """Store a converged KRHF (reference kbe/mf_interfaces/main.py)."""
    payload = _mol_payload(mf.cell)
    payload.update(
        a=mf.cell.a,
        kpts=mf.kpts,
        e_tot=np.float64(mf.e_tot),
        mo_energy=np.asarray(mf.mo_energy),
        mo_coeff=np.asarray(mf.mo_coeff),
        hf_veff=np.asarray(mf.hf_veff),
        S=np.asarray(mf.get_ovlp()),
        hcore=np.asarray(mf.get_hcore()),
    )
    np.savez(chkfile, **payload)


def load_kscf(chkfile, device: torch.device | str | None = None):
    """Recreate (cell, converged KRHF) from :func:`dump_kscf`; the KRHF
    and its (unbuilt) ``KGDF`` run on ``device``.

    The cached S/hcore/veff ship in the file, so no periodic integral
    rebuild is needed to construct a kbe.BE -- only the DF build for the
    embedding ERI transform.
    """
    from quemb_tpu_torch.kbe.cell import Cell  # noqa: PLC0415
    from quemb_tpu_torch.kbe.scf import KRHF  # noqa: PLC0415

    dev = resolve_device(device, "load_kscf")
    data = np.load(chkfile, allow_pickle=False)
    atoms = [
        (str(sym), xyz)
        for sym, xyz in zip(data["elements"], data["coords_bohr"])
    ]
    cell = Cell(
        atom=atoms,
        a=data["a"],
        basis=str(data["basis"]),
        charge=int(data["charge"]),
        unit="bohr",
    )
    mf = KRHF(cell, data["kpts"], device=dev)
    mf.mo_coeff = data["mo_coeff"]
    mf.mo_energy = data["mo_energy"]
    mf.e_tot = float(data["e_tot"])
    mf.hf_veff = data["hf_veff"]
    mf._S = data["S"]
    mf._hcore = data["hcore"]
    mf.converged = True
    return cell, mf


# ------------------------------------------------------- ORCA JSON reader
_L_ORDER = "spdfgh"
# pyscf's spherical m_l component order per l
_PYSCF_ML = {
    "s": ["s"],
    "p": ["px", "py", "pz"],
    "d": ["dxy", "dyz", "dz^2", "dxz", "dx2-y2"],
    "f": ["f-3", "f-2", "f-1", "f+0", "f+1", "f+2", "f+3"],
    "g": ["g-4", "g-3", "g-2", "g-1", "g+0", "g+1", "g+2", "g+3", "g+4"],
    "h": ["h-5", "h-4", "h-3", "h-2", "h-1", "h+0", "h+1", "h+2", "h+3",
          "h+4", "h+5"],
}


def _parse_orca_label(label: str):
    """'0O   1dx2y2' -> (idx_atom, element, n, l, m_l) with pyscf names
    (reference mf_interfaces/_pyscf_orbital_order.py:from_orca_label)."""
    import re

    m = re.match(r"(\d+)([A-Z][a-z]?)\s+(\d+)([a-zA-Z0-9+\-]+)",
                 label.strip())
    if not m:
        raise ValueError(f"Cannot parse ORCA label: {label!r}")
    idx_atom, element, n, m_l = m.groups()
    translate = {"dz2": "dz^2", "dx2y2": "dx2-y2", "f0": "f+0",
                 "g0": "g+0", "h0": "h+0"}
    m_l = translate.get(m_l, m_l)
    l = next(c for c in _L_ORDER if m_l.startswith(c))
    return int(idx_atom), element, int(n), l, m_l


def _pyscf_sort_key(orb):
    idx_atom, _, n, l, m_l = orb
    return (idx_atom, _L_ORDER.index(l), n, _PYSCF_ML[l].index(m_l))


def load_orca_json(path):
    """Parse an ORCA JSON property file into pyscf-ordered MO data.

    Own implementation of the reference's ORCA interface parsing
    (mf_interfaces/orca_interface.py:100-120): MO coefficients are
    reordered from ORCA's AO ordering to the PySCF spherical convention,
    with the sign flips of the |m_l| in {3, 4} f/g/h components.

    Returns dict(atoms, mo_coeff, mo_energy, mo_occ, e_tot, charge,
    multiplicity, labels).
    """
    import json

    data = json.load(open(path))
    mol = data["Molecule"]
    mos = mol["MolecularOrbitals"]["MOs"]
    labels = [
        _parse_orca_label(lb)
        for lb in mol["MolecularOrbitals"]["OrbitalLabels"]
    ]
    C = np.array([m["MOCoefficients"] for m in mos]).T  # [nao, nmo]
    # opposite sign convention for |m_l| in {3,4} of f/g/h vs pyscf
    flip = [
        i for i, (_, _, _, l, m_l) in enumerate(labels)
        if l in "fgh" and m_l[-2:] in ("-4", "-3", "+3", "+4")
    ]
    C[flip, :] *= -1.0
    order = sorted(range(len(labels)), key=lambda i: _pyscf_sort_key(labels[i]))
    C = C[order]
    # deterministic column signs (largest-magnitude entry positive)
    piv = np.argmax(np.abs(C), axis=0)
    signs = np.sign(C[piv, np.arange(C.shape[1])])
    signs[signs == 0] = 1.0
    C = C * signs
    if mol["MolecularOrbitals"]["EnergyUnit"] != "Eh":
        raise ValueError("unexpected MO energy unit")
    return dict(
        atoms=mol["Atoms"],
        labels=[labels[i] for i in order],
        mo_coeff=C,
        mo_energy=np.array([m["OrbitalEnergy"] for m in mos]),
        mo_occ=np.array([m["Occupancy"] for m in mos]),
        charge=mol.get("Charge"),
        multiplicity=mol.get("Multiplicity"),
        coordinate_units=mol.get("CoordinateUnits", "Bohrs"),
        e_tot=data.get("SCFEnergy", mol.get("SCFEnergy")),
    )


def mole_from_orca_json(path) -> "object":
    """Build a spherical :class:`Mole` from the basis embedded in an ORCA
    JSON property file (each atom carries its shells with exponents and
    contraction coefficients), so the parsed mean field can be consumed
    end-to-end without tabulated basis data.

    The reference reaches the same point through PySCF's basis tables
    (mf_interfaces/orca_interface.py builds a pyscf Mole); here the
    integral engine re-derives S/hcore/ERIs on the embedded basis.
    """
    import json

    from quemb_tpu_torch.chem.mole import Mole

    data = json.load(open(path))
    mol_d = data["Molecule"]
    unit = mol_d.get("CoordinateUnits", "Bohrs")
    if unit.lower().startswith("bohr"):
        in_unit = "bohr"
    elif unit.lower().startswith("ang"):
        in_unit = "angstrom"
    else:
        raise ValueError(f"unexpected ORCA coordinate unit {unit!r}")
    basis: dict = {}
    atoms = []
    for ia, at in enumerate(mol_d["Atoms"]):
        sym = at["ElementLabel"]
        atoms.append((sym, np.asarray(at["Coords"], dtype=np.float64)))
        basis[ia] = [
            (
                _L_ORDER.index(sh["Shell"].lower()),
                list(zip(sh["Exponents"], sh["Coefficients"])),
            )
            for sh in at["Basis"]
        ]
    return Mole(
        atom=atoms,
        basis=basis,
        charge=int(mol_d.get("Charge", 0)),
        spin=int(mol_d.get("Multiplicity", 1)) - 1,
        unit=in_unit,
        cart=False,
    )


def mf_from_orca_json(path, with_energy: bool = True,
                      device: torch.device | str | None = None):
    """(mol, converged RHF-like) from an ORCA JSON property file.

    The MO coefficients come from the file; S/hcore/veff are re-derived by
    the own integral engine on the embedded basis, validated by the
    C^T S C = I orthonormality identity.  This is the end-to-end analog of
    the reference's ``get_mf(backend="orca")`` (mf_interfaces/main.py:37).
    The mean field runs on ``device``.
    """
    from quemb_tpu_torch.chem.integrals import overlap

    dev = resolve_device(device, "mf_from_orca_json")
    parsed = load_orca_json(path)
    mol = mole_from_orca_json(path)
    if parsed["multiplicity"] != 1:
        raise NotImplementedError("only RHF ORCA ingestion is supported")
    C = parsed["mo_coeff"]
    S = overlap(mol)
    ortho_err = np.abs(C.T @ S @ C - np.eye(C.shape[1])).max()
    if ortho_err > 1e-6:
        raise ValueError(
            f"parsed ORCA MOs are not S-orthonormal (err {ortho_err:.2e}); "
            "basis/ordering mismatch"
        )
    mf = RHF(mol, device=dev)
    mf.mo_coeff = C
    mf.mo_energy = parsed["mo_energy"]
    mf.converged = True
    if with_energy:
        # total energy re-derived from the density with own integrals
        # (the dense ERI build dominates; skip when only parsing)
        nocc = mol.nelectron // 2
        dm = 2.0 * C[:, :nocc] @ C[:, :nocc].T
        mf.e_tot = float(mf.energy_tot(dm=dm))
    return mol, mf


def run_orca(
    mol,
    *,
    basis: str | None = None,
    simple_keywords: tuple[str, ...] = ("HF", "TightSCF"),
    n_procs: int = 1,
    workdir: str | None = None,
    orca_exe: str | None = None,
    with_energy: bool = True,
    device: torch.device | str | None = None,
):
    """Run ORCA on ``mol`` and ingest the converged mean field.

    The reference drives ORCA through the OPI package
    (``mf_interfaces/orca_interface.py:23-120``: write input, run, read
    the gbw-JSON property file); here the ``orca`` and ``orca_2json``
    binaries are invoked directly, so no OPI dependency is needed.  The
    resulting JSON goes through :func:`mf_from_orca_json` (AO reorder +
    f/g/h sign fixes + S-orthonormality validation).

    Raises RuntimeError when the ORCA executable is not on PATH (the
    reference's tests gate on backend availability the same way,
    test_mf_interface.py:406).  The mean field runs on ``device``.
    ``orca_exe`` overrides discovery --
    the mock-binary test uses this to exercise the full plumbing from a
    stored ORCA output, the reference suite's own fixture pattern.
    """
    import shutil
    import subprocess
    import tempfile
    from pathlib import Path

    from quemb_tpu_torch.chem.elements import BOHR2ANG

    dev = resolve_device(device, "run_orca")
    exe = orca_exe or shutil.which("orca")
    if exe is None:
        raise RuntimeError(
            "ORCA executable not found on PATH; install ORCA or pass"
            " orca_exe="
        )
    basis = basis or (mol.basis if isinstance(mol.basis, str) else None)
    if basis is None:
        raise ValueError("pass basis= when mol carries an embedded basis")
    wd = Path(workdir) if workdir else Path(tempfile.mkdtemp(prefix="orca_"))
    wd.mkdir(parents=True, exist_ok=True)
    coords = np.asarray(mol.atom_coords()) * BOHR2ANG
    lines = [f"! {' '.join(simple_keywords)} {basis}"]
    if n_procs > 1:
        lines.append(f"%pal nprocs {n_procs} end")
    lines.append(f"* xyz {mol.charge} {mol.spin + 1}")
    for sym, xyz in zip(mol.elements, coords):
        lines.append(
            f"  {sym} {xyz[0]:.12f} {xyz[1]:.12f} {xyz[2]:.12f}"
        )
    lines.append("*")
    inp = wd / "job.inp"
    inp.write_text("\n".join(lines) + "\n")
    with open(wd / "job.out", "w") as out:
        subprocess.run(
            [exe, str(inp)], stdout=out, stderr=subprocess.STDOUT,
            cwd=wd, check=True,
        )
    gbw = wd / "job.gbw"
    to_json = (
        shutil.which("orca_2json")
        or str(Path(exe).with_name("orca_2json"))
    )
    subprocess.run([to_json, str(gbw)], cwd=wd, check=True,
                   capture_output=True)
    json_path = wd / "job.json"
    if not json_path.exists():  # older naming
        json_path = wd / "job.property.json"
    return mf_from_orca_json(str(json_path), with_energy=with_energy,
                             device=dev)
