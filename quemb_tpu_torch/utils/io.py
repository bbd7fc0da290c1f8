"""IO utilities: AO evaluation on grids, cube-file export, FCIDUMP export.

Covers reference ``shared/io.py:write_cube`` and ``molbe/misc.py:be2fcidump``
without pyscf: AO values on a grid come from the own basis machinery, and the
FCIDUMP writer emits the standard Molpro format with 8-fold symmetry.

JAX counterpart: ``quemb_tpu/utils/io.py``.  The AO evaluation, the cube
and FCIDUMP writers and the reader are copies (no jax in them).  In
``be2fcidump`` and ``ube2fcidump`` the fragment SCF and the
``fragment_mo`` four-index transform run on the device of the fragment's
ERI; the result is read back once per fragment for writing.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from quemb_tpu_torch.chem.mole import Mole, cart_components


def eval_ao(mol: Mole, coords: np.ndarray) -> np.ndarray:
    """AO values on grid points [npts, 3] (Bohr). Returns [npts, nao]."""
    coords = np.asarray(coords)
    out = np.zeros((coords.shape[0], getattr(mol, "nao_cart", mol.nao)))
    for sh in mol.shells:
        d = coords - sh.center[None, :]
        r2 = np.einsum("pi,pi->p", d, d)
        rad = np.einsum(
            "k,pk->p",
            sh.coefs,
            np.exp(-np.outer(r2, sh.exps)),
        )
        for ic, (lx, ly, lz) in enumerate(cart_components(sh.l)):
            ang = d[:, 0] ** lx * d[:, 1] ** ly * d[:, 2] ** lz
            out[:, sh.ao_offset + ic] = ang * rad
    T = getattr(mol, "c2s", None)
    return out if T is None else out @ T.T


def write_orbital_cube(
    mol: Mole, path, coeff: np.ndarray, nx=60, ny=60, nz=60, margin=4.0
) -> None:
    """Write one orbital (AO coefficient vector) as a Gaussian cube file."""
    coords = mol.atom_coords()
    lo = coords.min(axis=0) - margin
    hi = coords.max(axis=0) + margin
    steps = (hi - lo) / np.array([nx - 1, ny - 1, nz - 1])
    xs = [lo[i] + steps[i] * np.arange([nx, ny, nz][i]) for i in range(3)]
    grid = np.array(
        [[x, y, z] for x in xs[0] for y in xs[1] for z in xs[2]]
    )
    vals = eval_ao(mol, grid) @ coeff
    with open(path, "w") as f:
        f.write("quemb_tpu cube file\norbital\n")
        f.write(
            f"{mol.natm:5d} {lo[0]:12.6f} {lo[1]:12.6f} {lo[2]:12.6f}\n"
        )
        for i, n in enumerate([nx, ny, nz]):
            v = [0.0, 0.0, 0.0]
            v[i] = steps[i]
            f.write(f"{n:5d} {v[0]:12.6f} {v[1]:12.6f} {v[2]:12.6f}\n")
        for ia in range(mol.natm):
            Z = mol.atom_charge(ia)
            x, y, z = coords[ia]
            f.write(f"{Z:5d} {float(Z):12.6f} {x:12.6f} {y:12.6f} {z:12.6f}\n")
        vals = vals.reshape(nx, ny, nz)
        for ix in range(nx):
            for iy in range(ny):
                row = vals[ix, iy]
                for i0 in range(0, nz, 6):
                    f.write(
                        " ".join(f"{v:13.5E}" for v in row[i0 : i0 + 6])
                        + "\n"
                    )


def write_cube(
    be_object,
    cube_file_path,
    *,
    fragment_idx=None,
    orbital_idx=None,
    **cube_kwargs,
) -> None:
    """Write cube files of embedding orbitals (reference shared/io.py)."""
    cube_file_path = Path(cube_file_path)
    cube_file_path.mkdir(exist_ok=True, parents=True)
    if fragment_idx is None:
        fragment_idx = range(be_object.fobj.n_frag)
    for idx in fragment_idx:
        TA = be_object.fragments[idx].TA
        orbs = orbital_idx if orbital_idx else range(TA.shape[1])
        for i in orbs:
            write_orbital_cube(
                be_object.mol,
                cube_file_path / f"frag_{idx}_orb_{i}.cube",
                TA[:, i],
                **cube_kwargs,
            )


def write_fcidump(
    path, h1e: np.ndarray, h2e: np.ndarray, norb: int, nelec: int, ms: int = 0,
    tol: float = 1e-12,
) -> None:
    """Write integrals in the standard FCIDUMP (Molpro) format."""
    with open(path, "w") as f:
        f.write(
            f"&FCI NORB={norb:d},NELEC={nelec:d},MS2={ms:d},\n"
            f"  ORBSYM={'1,' * norb}\n  ISYM=1,\n&END\n"
        )
        for i in range(norb):
            for j in range(i + 1):
                for k in range(i + 1):
                    lmax = j + 1 if k == i else k + 1
                    for l in range(lmax):  # noqa: E741
                        v = h2e[i, j, k, l]
                        if abs(v) > tol:
                            f.write(
                                f"{v:23.16E} {i + 1:4d} {j + 1:4d} "
                                f"{k + 1:4d} {l + 1:4d}\n"
                            )
        for i in range(norb):
            for j in range(i + 1):
                v = h1e[i, j]
                if abs(v) > tol:
                    f.write(f"{v:23.16E} {i + 1:4d} {j + 1:4d}    0    0\n")
        f.write(f"{0.0:23.16E}    0    0    0    0\n")


def read_fcidump(path):
    """Read an FCIDUMP file. Returns (h1e, h2e, norb, nelec, e_core)."""
    with open(path) as f:
        header = ""
        line = f.readline()
        while "&END" not in line.upper() and "/" not in line:
            header += line
            line = f.readline()
        header += line
        import re

        norb = int(re.search(r"NORB\s*=\s*(\d+)", header).group(1))
        nelec = int(re.search(r"NELEC\s*=\s*(\d+)", header).group(1))
        h1e = np.zeros((norb, norb))
        h2e = np.zeros((norb, norb, norb, norb))
        e_core = 0.0
        for line in f:
            parts = line.split()
            if len(parts) != 5:
                continue
            v = float(parts[0])
            i, j, k, l = (int(x) for x in parts[1:])  # noqa: E741
            if i == 0:
                e_core = v
            elif k == 0:
                for a, b in {(i - 1, j - 1), (j - 1, i - 1)}:
                    h1e[a, b] = v
                h1e[j - 1, i - 1] = v
            else:
                i, j, k, l = i - 1, j - 1, k - 1, l - 1  # noqa: E741
                for a, b, c, d in {
                    (i, j, k, l), (j, i, k, l), (i, j, l, k), (j, i, l, k),
                    (k, l, i, j), (l, k, i, j), (k, l, j, i), (l, k, j, i),
                }:
                    h2e[a, b, c, d] = v
    return h1e, h2e, norb, nelec, e_core


def _fragment_integrals(fr, basis: str):
    """(h1e, h2e) of one fragment in ``basis``, host arrays: the fragment's
    Fock and ERI (``"embedding"``), or both in the orbitals of the
    fragment's RHF (``"fragment_mo"``), transformed on the ERI's device."""
    from quemb_tpu_torch.ops.eri_transform import batched_mo_eri
    from quemb_tpu_torch.solvers.dispatch import run_fragment_scf

    if basis == "embedding":
        return np.asarray(fr.fock), fr.eri.cpu().numpy()
    if basis == "fragment_mo":
        _, C = run_fragment_scf(fr)
        fock = torch.as_tensor(fr.fock, dtype=C.dtype, device=C.device)
        h1e = C.T @ fock @ C
        h2e = batched_mo_eri(fr.eri[None], C[None])[0]
        return h1e.cpu().numpy(), h2e.cpu().numpy()
    raise ValueError("basis must be 'embedding' or 'fragment_mo'")


def be2fcidump(be_obj, fcidump_prefix, basis: str) -> None:
    """FCIDUMP per fragment (reference molbe/misc.py:be2fcidump).

    A bare directory prefix is materialized through the scratch manager
    (reference shared/manage_scratch.py WorkDir)."""
    from quemb_tpu_torch.utils.scratch import WorkDir

    fcidump_prefix = Path(fcidump_prefix)
    if not fcidump_prefix.parent.exists():
        WorkDir(fcidump_prefix.parent, cleanup_at_end=False)
    for fidx, fr in enumerate(be_obj.fragments):
        h1e, h2e = _fragment_integrals(fr, basis)
        path = fcidump_prefix.parent / f"{fcidump_prefix.name}f{fidx}"
        write_fcidump(path, h1e, h2e, fr.TA.shape[1], fr.nsocc * 2)


def ube2fcidump(be_obj, fcidump_prefix, basis: str) -> None:
    """Per-spin FCIDUMP per fragment (reference molbe/misc.py:163
    ube2fcidump): alpha fragments to ``{prefix}f{i}a``, beta to
    ``{prefix}f{i}b``, each with the spin's own Fock/ERI block."""
    from quemb_tpu_torch.utils.scratch import WorkDir

    fcidump_prefix = Path(fcidump_prefix)
    if not fcidump_prefix.parent.exists():
        WorkDir(fcidump_prefix.parent, cleanup_at_end=False)
    for tag, frags in (("a", be_obj.Fobjs_a), ("b", be_obj.Fobjs_b)):
        for fidx, fr in enumerate(frags):
            h1e, h2e = _fragment_integrals(fr, basis)
            path = (
                fcidump_prefix.parent
                / f"{fcidump_prefix.name}f{fidx}{tag}"
            )
            # Per-spin FCIDUMP carries that spin's own electron count
            # (ref molbe/misc.py ube2fcidump passes frag.nsocc, not 2*nsocc).
            write_fcidump(path, h1e, h2e, fr.TA.shape[1], fr.nsocc)
