"""The benchmark's inputs: a closed-shell mean field from a committed
fixture, turned by a rotation drawn from the seed.

Seed 0 is the identity.  Any other seed draws a Haar-random rotation Q of
SO(3) (a uniform unit quaternion) and turns the molecule by it: every
atom's coordinates r -> Q r, and on the AO axes of hcore, S, the ERI and
the MO coefficients the block-diagonal M that is Q on each p shell and 1
on each s shell (h -> M h M^T, C -> M C, the ERI on all four axes).  It
is the same molecule in another orientation, so every number the program
touches changes and no energy does.  Both the program and the plain
reference are handed these arrays.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np
import torch

#: angular momentum of a shell letter
_L = {"s": 0, "p": 1}


def file_sha256(path: Path) -> str:
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


def read_xyz(path: Path) -> tuple[list[str], np.ndarray]:
    """Symbols and coordinates (Angstrom) of an xyz file."""
    lines = Path(path).read_text().strip().splitlines()
    natm = int(lines[0].split()[0])
    rows = [ln.split() for ln in lines[2: 2 + natm]]
    return [r[0] for r in rows], np.array([[float(x) for x in r[1:4]]
                                           for r in rows])


def unpack_s8(packed: np.ndarray, n: int) -> np.ndarray:
    """Dense [n]^4 ERI from its 8-fold packed form: the upper triangle,
    row by row, of the matrix over AO pairs, whose pairs (i <= j) are
    numbered row by row along the upper triangle of [n, n]."""
    npair = n * (n + 1) // 2
    M = np.zeros((npair, npair))
    M[np.triu_indices(npair)] = packed
    M = M + M.T - np.diag(np.diag(M))
    i, j = np.triu_indices(n)
    pair = np.zeros((n, n), dtype=np.int64)
    pair[i, j] = pair[j, i] = np.arange(npair)
    return M[pair[:, :, None, None], pair[None, None, :, :]]


def rotation(seed: int) -> np.ndarray:
    """Q in SO(3): the identity for seed 0, else Haar-random from the
    seed."""
    if seed == 0:
        return np.eye(3)
    q = np.random.default_rng(seed).standard_normal(4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def ao_layout(symbols: list[str], shells: dict[str, str]):
    """Per atom its AO range, and the start of every p shell."""
    ranges, p_starts, off = [], [], 0
    for s in symbols:
        start = off
        for letter in shells[s]:
            if letter == "p":
                p_starts.append(off)
            off += 2 * _L[letter] + 1
        ranges.append((start, off))
    return ranges, p_starts, off


def ao_rotation(Q: np.ndarray, p_starts: list[int], nao: int) -> np.ndarray:
    M = np.eye(nao)
    for p in p_starts:
        M[p: p + 3, p: p + 3] = Q
    return M


def nuclear_repulsion(symbols, coords_ang, charges: dict[str, int]) -> float:
    bohr = np.asarray(coords_ang) / 0.52917721092
    Z = np.array([charges[s] for s in symbols], float)
    d = np.linalg.norm(bohr[:, None] - bohr[None], axis=-1)
    i, j = np.triu_indices(len(symbols), 1)
    return float((Z[i] * Z[j] / d[i, j]).sum())


def make_inputs(root: Path, config: dict, seed: int, device) -> dict:
    """The rotated mean field of ``config`` as host float64 arrays, with
    the molecule's symbols, coordinates (Angstrom), AO ranges, electron
    count and nuclear repulsion.  The rotation runs on ``device``."""
    mol = config["molecule"]
    xyz, fixture = root / mol["xyz"], root / mol["fixture"]
    for path, key in ((xyz, "xyz_sha256"), (fixture, "fixture_sha256")):
        if file_sha256(path) != mol[key]:
            raise ValueError(f"{path} is not the file this configuration "
                             f"was written for ({key})")
    symbols, coords = read_xyz(xyz)
    ranges, p_starts, nao = ao_layout(symbols, mol["shells"])
    with np.load(fixture) as d:
        if int(d["nao"]) != nao:
            raise ValueError(f"fixture nao {int(d['nao'])} != {nao}")
        arrays = {k: d[k] for k in ("hcore", "S", "C", "moe", "e_tot")}
        eri = unpack_s8(d["eri_s8"], nao)
    Q = rotation(seed)
    M = torch.as_tensor(ao_rotation(Q, p_starts, nao), device=device)

    def turn2(a):
        a = torch.as_tensor(a, device=device)
        return (M @ a @ M.T).cpu().numpy()

    e = torch.as_tensor(eri, device=device)
    for _ in range(4):
        e = torch.tensordot(e, M.T, dims=([0], [0]))
    charges = mol["charges"]
    nelec = sum(charges[s] for s in symbols)
    return dict(
        symbols=symbols, coords=coords @ Q.T, ao_ranges=ranges,
        hcore=turn2(arrays["hcore"]), S=turn2(arrays["S"]),
        C=(M @ torch.as_tensor(arrays["C"], device=device)).cpu().numpy(),
        eri=e.cpu().numpy(), moe=arrays["moe"], e_tot=float(arrays["e_tot"]),
        nocc=nelec // 2, enuc=nuclear_repulsion(symbols, coords, charges),
    )
