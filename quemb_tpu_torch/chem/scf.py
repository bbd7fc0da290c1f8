"""Restricted Hartree-Fock on PyTorch (float64), with DIIS.

JAX counterpart: ``quemb_tpu/chem/scf.py``.  Self-contained replacement
for ``pyscf.scf.RHF`` as :class:`~quemb_tpu_torch.api.BE` reads it
(``get_hcore``, ``get_ovlp``, ``get_eri``, ``get_veff``, ``make_rdm1``,
``energy_nuc``, ``e_tot``, ``mo_coeff``, ``mo_energy``).  The AO integrals come from the
host engine (:mod:`quemb_tpu_torch.chem.integrals`); the J/K builds, the
Roothaan step and the DIIS extrapolation are dense ``torch`` linear
algebra on the mean field's device, which is CUDA unless the caller names
the CPU.  ``with_df=True`` builds J/K from the whitened three-index factor
and never forms the dense AO ERI.  A mean field may also be filled from
arrays computed elsewhere (:meth:`RHF.from_arrays`) or from a committed
fixture (:func:`load_fixture`).  The accessors hand back host numpy.

The JAX module's host-backend context around the SCF loop is not carried
over (the loop runs where the mean field lives), the dense ERI and the
factor are copied to the device once, and S^(-1/2) is built once per SCF
instead of once per diagonalization (the same numbers).  :class:`UHF`
runs on the dense AO ERI, as in the JAX package.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from quemb_tpu_torch.chem import integrals
from quemb_tpu_torch.chem.mole import Mole
from quemb_tpu_torch.ops.linalg import eigh
from quemb_tpu_torch.utils.device import resolve_device
from quemb_tpu_torch.utils.eri_pack import unpack_eri_s8


def _orthogonalizer(S: torch.Tensor) -> torch.Tensor:
    """X = S^(-1/2) by symmetric orthogonalization."""
    s, U = eigh(S)
    return (U / torch.sqrt(s)) @ U.T


def _eigh_gen(F: torch.Tensor, S: torch.Tensor, X: torch.Tensor | None = None):
    """Generalized symmetric eigenproblem F C = S C e via symmetric
    orthogonalization; ``X`` is a precomputed S^(-1/2)."""
    if X is None:
        X = _orthogonalizer(S)
    e, Cp = eigh(X.T @ F @ X)
    return e, X @ Cp


def get_jk(eri: torch.Tensor, dm: torch.Tensor):
    """Coulomb and exchange matrices from a dense AO ERI (chemist
    notation)."""
    vj = torch.tensordot(eri, dm, dims=([2, 3], [0, 1]))
    vk = torch.tensordot(eri, dm, dims=([1, 3], [0, 1]))
    return vj, vk


def get_jk_df(B: torch.Tensor, dm: torch.Tensor):
    """J/K from the whitened DF factor B [naux, nao, nao]:
    J = sum_P B_P tr(B_P dm),  K = sum_P B_P dm B_P.  The exchange is one
    batched matmul and one [nao, naux nao] x [naux nao, nao] GEMM; its
    temporary ``B @ dm`` is as large as B."""
    naux, nao, _ = B.shape
    c = torch.mv(B.reshape(naux, nao * nao), dm.reshape(-1))
    vj = (c @ B.reshape(naux, nao * nao)).reshape(nao, nao)
    Bd = B @ dm  # [naux, nao(m), nao(r)]
    vk = torch.einsum("pmr,prn->mn", Bd, B)
    return vj, vk


class RHF:
    """Restricted Hartree-Fock on a :class:`Mole`.

    After :meth:`kernel`: ``mo_coeff``, ``mo_energy``, ``mo_occ``,
    ``e_tot``, ``converged``, ``cycles`` and the cached AO matrices are
    available.
    """

    def __init__(
        self,
        mol: Mole,
        conv_tol: float = 1e-12,
        max_cycle: int = 200,
        with_df: bool = False,
        auxbasis=None,
        device: torch.device | str | None = None,
    ):
        """with_df=True builds J/K from density-fitted 3-center factors
        (the own :class:`~quemb_tpu_torch.ops.df.DFTensor` of
        ``auxbasis``): O(naux nao^2) memory instead of the dense nao^4
        ERI.  ``device`` defaults to CUDA; it is resolved when the first
        J/K build or SCF step needs it, and raises then if no card is
        present."""
        self.mol = mol
        self.conv_tol = conv_tol
        self.max_cycle = max_cycle
        self.with_df = with_df
        self.auxbasis = auxbasis
        self._device = (
            None if device is None else resolve_device(device, "RHF")
        )
        self.converged = False
        self.cycles = 0
        self.mo_coeff: np.ndarray | None = None
        self.mo_energy: np.ndarray | None = None
        self.e_tot = 0.0
        self._hcore: np.ndarray | None = None
        self._S: np.ndarray | None = None
        self._eri: np.ndarray | None = None
        self._eri_dev: torch.Tensor | None = None
        self._df_B: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        if self._device is None:
            self._device = resolve_device(None, "RHF")
        return self._device

    def bind_device(self, device: torch.device) -> None:
        """Run on ``device`` unless the mean field was given one."""
        if self._device is None:
            self._device = device

    @classmethod
    def from_arrays(
        cls, mol: Mole, hcore, S, eri, mo_coeff, mo_energy, e_tot: float,
        device: torch.device | str | None = None,
    ) -> "RHF":
        """A converged mean field from its AO matrices, dense AO ERI
        [nao]^4 (chemist notation), orbitals and total energy."""
        mf = cls(mol, device=device)
        mf._hcore = np.asarray(hcore, np.float64)
        mf._S = np.asarray(S, np.float64)
        mf._eri = np.asarray(eri, np.float64)
        mf.mo_coeff = np.asarray(mo_coeff, np.float64)
        mf.mo_energy = np.asarray(mo_energy, np.float64)
        mf.e_tot = float(e_tot)
        mf.converged = True
        return mf

    # --- pyscf-compatible accessors that BE reads ---------------------------
    def get_hcore(self) -> np.ndarray:
        if self._hcore is None:
            self._hcore = integrals.core_hamiltonian(self.mol)
        return self._hcore

    def get_ovlp(self) -> np.ndarray:
        if self._S is None:
            self._S = integrals.overlap(self.mol)
        return self._S

    def get_eri(self) -> np.ndarray:
        """Dense AO ERI [nao]^4 on the host (never touched when
        ``with_df``)."""
        if self._eri is None:
            self._eri = integrals.eri_full(self.mol)
        return self._eri

    def get_eri_dev(self) -> torch.Tensor:
        """The dense AO ERI on the device, copied once per mean field."""
        if self._eri_dev is None:
            self._eri_dev = torch.as_tensor(self.get_eri(), device=self.device)
        return self._eri_dev

    def get_df_B(self) -> torch.Tensor:
        """Whitened DF 3-center factor [naux, nao, nao] on the device
        (with_df path), built once."""
        if self._df_B is None:
            from quemb_tpu_torch.ops.df import DFTensor

            self._df_B = torch.as_tensor(
                DFTensor(self.mol, self.auxbasis).B, device=self.device
            )
        return self._df_B

    def _jk(self, dm: torch.Tensor):
        if self.with_df:
            return get_jk_df(self.get_df_B(), dm)
        return get_jk(self.get_eri_dev(), dm)

    @property
    def nocc(self) -> int:
        if self.mol.nelectron % 2:
            raise ValueError("RHF needs an even electron count")
        return self.mol.nelectron // 2

    def make_rdm1(self) -> np.ndarray:
        C = self.mo_coeff[:, : self.nocc]
        return 2.0 * C @ C.T

    def get_veff(self, dm: np.ndarray | None = None) -> np.ndarray:
        if dm is None:
            dm = self.make_rdm1()
        vj, vk = self._jk(torch.as_tensor(
            np.asarray(dm, np.float64), device=self.device
        ))
        return (vj - 0.5 * vk).cpu().numpy()

    def energy_nuc(self) -> float:
        return self.mol.energy_nuc()

    def energy_tot(self, dm: np.ndarray | None = None) -> float:
        """HF total energy of a given (default: current) 1-RDM."""
        if dm is None:
            dm = self.make_rdm1()
        h = self.get_hcore()
        veff = self.get_veff(dm)
        e_el = float(
            np.einsum("ij,ji->", dm, h)
            + 0.5 * np.einsum("ij,ji->", dm, veff)
        )
        return e_el + self.energy_nuc()

    @property
    def mo_occ(self) -> np.ndarray:
        occ = np.zeros(self.mol.nao)
        occ[: self.nocc] = 2.0
        return occ

    # --- SCF ----------------------------------------------------------------
    def kernel(self, dm0: np.ndarray | None = None) -> float:
        dev = self.device
        hcore = torch.as_tensor(self.get_hcore(), device=dev)
        S = torch.as_tensor(self.get_ovlp(), device=dev)
        if dm0 is not None:
            dm0 = torch.as_tensor(np.asarray(dm0, np.float64), device=dev)
        e, C, e_el, converged, cycles = _scf_loop(
            hcore, S, self._jk, self.nocc, dm0, self.conv_tol, self.max_cycle
        )
        self.mo_energy = e.cpu().numpy()
        self.mo_coeff = C.cpu().numpy()
        self.converged = bool(converged)
        self.cycles = cycles
        self.e_tot = float(e_el) + self.energy_nuc()
        return self.e_tot


def _scf_loop(hcore, S, jk, nocc, dm0, conv_tol, max_cycle, diis_size=8):
    """Roothaan + DIIS iteration (host loop; each step is torch compute on
    the tensors' device, with one host read of the energy, the DIIS error
    and the density change per cycle).

    Robustness: the density is damped until the DIIS error is small
    (the bare hcore guess oscillates for chains like octane and undamped
    DIIS then diverges), and a divergence triggers one restart with
    heavy damping.

    Returns (mo_energy, mo_coeff, e_el, converged, cycles).
    """
    X = _orthogonalizer(S)
    # GWH (generalized Wolfsberg-Helmholz) guess: far more reliable than
    # bare hcore for extended molecules (hcore mislocates the valence
    # occupations of e.g. alkane chains).
    hd = torch.diagonal(hcore)
    F0 = 0.5 * 1.75 * (hd[:, None] + hd[None, :]) * S
    F0 = F0 - torch.diag(torch.diagonal(F0)) + torch.diag(hd)
    if dm0 is None:
        e, C = _eigh_gen(F0, S, X)
        dm = 2.0 * C[:, :nocc] @ C[:, :nocc].T
    else:
        dm = dm0
    errs: list = []
    focks: list = []
    e_last = 0.0
    e, C = None, None
    converged = False
    damp = 0.30  # fraction of the OLD density kept while far from SCF
    restarted = False
    cycle = 0
    while cycle < max_cycle:
        cycle += 1
        vj, vk = jk(dm)
        F = hcore + vj - 0.5 * vk
        e_el = float(torch.sum((hcore + 0.5 * (vj - 0.5 * vk)) * dm))
        if not np.isfinite(e_el):
            if restarted:
                break
            # diverged: restart from the GWH guess with heavy damping
            restarted = True
            damp = 0.7
            e, C = _eigh_gen(F0, S, X)
            dm = 2.0 * C[:, :nocc] @ C[:, :nocc].T
            errs.clear()
            focks.clear()
            e_last = 0.0
            continue
        # DIIS on the commutator FDS - SDF
        err = F @ dm @ S - S @ dm @ F
        err_norm = float(torch.max(torch.abs(err)))
        errs.append(err)
        focks.append(F)
        if len(errs) > diis_size:
            errs.pop(0)
            focks.pop(0)
        if len(errs) > 1 and err_norm < 2.0:
            F = _diis_extrapolate(errs, focks)
        e, C = _eigh_gen(F, S, X)
        dm_new = 2.0 * C[:, :nocc] @ C[:, :nocc].T
        if err_norm > 0.05:
            dm_new = (1.0 - damp) * dm_new + damp * dm
        dm_change = float(torch.max(torch.abs(dm_new - dm)))
        dm = dm_new
        if (
            abs(e_el - e_last) < conv_tol
            and dm_change < np.sqrt(conv_tol) * 10
            and cycle > 1
        ):
            converged = True
            break
        e_last = e_el
    # final energy with converged density
    vj, vk = jk(dm)
    e_el = float(torch.sum((hcore + 0.5 * (vj - 0.5 * vk)) * dm))
    return e, C, e_el, converged, cycle


class UHF(RHF):
    """Unrestricted Hartree-Fock; spin = Nalpha - Nbeta from the Mole.

    J/K from the dense AO ERI on the mean field's device; ``mo_coeff``
    and ``mo_energy`` are stacked [alpha, beta] host arrays, and
    ``make_rdm1`` / ``get_veff`` give [2, nao, nao] (occupancy 1 per
    spin).  The SCF starts from the core-Hamiltonian guess and
    extrapolates the concatenated alpha/beta Fock by DIIS over the last 8
    concatenated commutators, as the JAX class does.
    """

    @property
    def nelec(self) -> tuple[int, int]:
        n = self.mol.nelectron
        s = self.mol.spin
        if (n + s) % 2:
            raise ValueError("inconsistent charge/spin")
        return ((n + s) // 2, (n - s) // 2)

    def make_rdm1(self) -> np.ndarray:
        na, nb = self.nelec
        Ca = self.mo_coeff[0][:, :na]
        Cb = self.mo_coeff[1][:, :nb]
        return np.stack([Ca @ Ca.T, Cb @ Cb.T])

    @property
    def mo_occ(self) -> np.ndarray:
        na, nb = self.nelec
        occ = np.zeros((2, self.mol.nao))
        occ[0, :na] = 1.0
        occ[1, :nb] = 1.0
        return occ

    def _veff_spin(self, dma: torch.Tensor, dmb: torch.Tensor):
        """(Fa - hcore, Fb - hcore): J of the total density minus the
        exchange of each spin."""
        eri = self.get_eri_dev()
        vj = torch.tensordot(eri, dma + dmb, dims=([2, 3], [0, 1]))
        vka = torch.tensordot(eri, dma, dims=([1, 3], [0, 1]))
        vkb = torch.tensordot(eri, dmb, dims=([1, 3], [0, 1]))
        return vj - vka, vj - vkb

    def get_veff(self, dm: np.ndarray | None = None) -> np.ndarray:
        """[2, nao, nao] spin potentials: J(total) - K(sigma)."""
        if dm is None:
            dm = self.make_rdm1()
        dm = torch.as_tensor(np.asarray(dm, np.float64), device=self.device)
        return torch.stack(self._veff_spin(dm[0], dm[1])).cpu().numpy()

    def kernel(self, dm0: np.ndarray | None = None) -> float:
        dev = self.device
        hcore = torch.as_tensor(self.get_hcore(), device=dev)
        S = torch.as_tensor(self.get_ovlp(), device=dev)
        X = _orthogonalizer(S)
        na, nb = self.nelec
        if dm0 is None:
            _, C = _eigh_gen(hcore, S, X)
            dma = C[:, :na] @ C[:, :na].T
            dmb = C[:, :nb] @ C[:, :nb].T
        else:
            dma, dmb = torch.as_tensor(np.asarray(dm0, np.float64),
                                       device=dev)
        n = hcore.shape[0]
        e_last = 0.0
        errs: list = []
        focks: list = []
        self.converged = False
        for cycle in range(self.max_cycle):
            va, vb = self._veff_spin(dma, dmb)
            Fa, Fb = hcore + va, hcore + vb
            e_el = 0.5 * float(((hcore + Fa) * dma).sum()
                               + ((hcore + Fb) * dmb).sum())
            errs.append(torch.cat([(Fa @ dma @ S - S @ dma @ Fa).reshape(-1),
                                   (Fb @ dmb @ S - S @ dmb @ Fb).reshape(-1)]))
            focks.append(torch.cat([Fa.reshape(-1), Fb.reshape(-1)]))
            if len(errs) > 8:
                errs.pop(0)
                focks.pop(0)
            if len(errs) > 1:
                Fx = _diis_extrapolate(errs, focks)
                Fa, Fb = Fx[: n * n].reshape(n, n), Fx[n * n:].reshape(n, n)
            ea, Ca = _eigh_gen(Fa, S, X)
            eb, Cb = _eigh_gen(Fb, S, X)
            dma_new = Ca[:, :na] @ Ca[:, :na].T
            dmb_new = Cb[:, :nb] @ Cb[:, :nb].T
            delta = float(torch.maximum((dma_new - dma).abs().max(),
                                        (dmb_new - dmb).abs().max()))
            dma, dmb = dma_new, dmb_new
            self.cycles = cycle + 1
            if (
                abs(e_el - e_last) < self.conv_tol
                and delta < np.sqrt(self.conv_tol) * 10
                and cycle > 1
            ):
                self.converged = True
                break
            e_last = e_el
        self.mo_energy = torch.stack([ea, eb]).cpu().numpy()
        self.mo_coeff = torch.stack([Ca, Cb]).cpu().numpy()
        va, vb = self._veff_spin(dma, dmb)
        e_el = 0.5 * float(((2.0 * hcore + va) * dma).sum()
                           + ((2.0 * hcore + vb) * dmb).sum())
        self.e_tot = e_el + self.energy_nuc()
        return self.e_tot


def _diis_extrapolate(errs, focks):
    n = len(errs)
    B = np.empty((n + 1, n + 1))
    B[-1, :] = -1.0
    B[:, -1] = -1.0
    B[-1, -1] = 0.0
    E = torch.stack([e.reshape(-1) for e in errs])
    B[:n, :n] = (E @ E.T).cpu().numpy()
    # scale-normalize the Gram block for conditioning (coefficients are
    # invariant; only the Lagrange multiplier rescales)
    scale = max(abs(B[:n, :n]).max(), 1e-280)
    B[:n, :n] /= scale
    rhs = np.zeros(n + 1)
    rhs[-1] = -1.0
    try:
        c = np.linalg.lstsq(B, rhs, rcond=1e-12)[0][:n]
    except np.linalg.LinAlgError:
        return focks[-1]
    if not np.all(np.isfinite(c)) or np.abs(c).sum() > 1e4:
        return focks[-1]
    F = torch.zeros_like(focks[-1])
    for ci, Fi in zip(c, focks):
        F = F + float(ci) * Fi
    return F


def load_fixture(
    path: str | Path, xyz: str | Path, basis: str = "sto-3g",
    device: torch.device | str | None = None,
):
    """Mean field from a committed RHF fixture (``fixtures/*_hf.npz``).

    The fixture holds ``hcore``, ``S``, the s8-packed AO ERI ``eri_s8``,
    ``nao``, the orbitals ``C`` and ``moe``, and ``e_tot``; the geometry
    comes from ``xyz``.  Returns an :class:`RHF` whose ``mol`` is built.
    """
    mol = Mole.from_xyz_file(xyz, basis=basis)
    with np.load(path) as d:
        nao = int(d["nao"])
        if nao != mol.nao:
            raise ValueError(f"fixture nao {nao} != molecule nao {mol.nao}")
        return RHF.from_arrays(
            mol, d["hcore"], d["S"], unpack_eri_s8(d["eri_s8"], nao),
            d["C"], d["moe"], float(d["e_tot"]), device=device,
        )
