"""Public BE driver on PyTorch.

JAX counterpart: ``quemb_tpu/api.py``.  Mirrors the reference molbe
``BE``/``fragmentate`` entry points (reference molbe/mbe.py:173,
molbe/fragment.py:22) for the slice this port carries: chemgen
fragmentation, Lowdin localization, Schmidt embedding, the fragment ERI
transform (``"in-core"``, or ``"sparse-DF"`` under the f32 tier, which
runs the screened-DF CUDA kernel), batched fragment initialization, the
one-shot solve and density matching (``optimize``: analytic HF/MP2/CCSD or
numerical Jacobian, quasi-Newton loop) with the CCSD, MP2 and FCI bucket
solvers.

Device work runs on an explicit ``torch.device``: ``BE(..., device=...)``
defaults to CUDA and raises when no card is present; the CPU is used only
when the caller names it.  Host bookkeeping stays numpy.
"""

from __future__ import annotations

import logging
import os
import time
import warnings
from typing import Literal

import numpy as np
import torch

from quemb_tpu_torch.chem.mole import Mole
from quemb_tpu_torch.chem.scf import RHF
from quemb_tpu_torch.embed.fragment import Fragment
from quemb_tpu_torch.embed.fragment_scf import rhf_orthonormal
from quemb_tpu_torch.fragment.chemgen import ChemGenArgs, chemgen
from quemb_tpu_torch.fragment.frag_part import FragPart
from quemb_tpu_torch.lo.lowdin import lowdin_orth
from quemb_tpu_torch.matching.beopt import BEOPT
from quemb_tpu_torch.matching.cphf import get_be_error_jacobian
from quemb_tpu_torch.solvers.dispatch import be_func

logger = logging.getLogger(__name__)


def _init_bucket_device(eri_b, P_emb_b, h1_b, veff0_b, dm0_b, nsocc: int):
    """Fragment initialization for one (nemb, nsocc) bucket: environment
    potential (vj/vk from the embedding density), Fock assembly, batched
    DIIS RHF, and the per-row HF-in-HF energy contributions."""
    vj = torch.einsum("fpqrs,frs->fpq", eri_b, P_emb_b)
    vk = torch.einsum("fprqs,frs->fpq", eri_b, P_emb_b)
    veff = veff0_b - (vj - 0.5 * vk)
    fock = h1_b + veff
    moe, C, _, _ = rhf_orthonormal(fock, eri_b, nsocc, dm0_b)
    Cocc = C[..., :nsocc]
    rdm_hf = Cocc @ Cocc.transpose(-1, -2)
    e1 = 2.0 * (h1_b * rdm_hf).sum(-1)
    ec = (veff * rdm_hf).sum(-1)
    J = torch.einsum("fijkl,fkl->fij", eri_b, rdm_hf)
    K = torch.einsum("fijkl,fjl->fik", eri_b, rdm_hf)
    e2 = 2.0 * (J * rdm_hf).sum(-1) - (K * rdm_hf).sum(-1)
    return veff, moe, C, e1 + ec + e2


def fragmentate(
    mol: Mole,
    *,
    frag_type: str = "chemgen",
    n_BE: int = 2,
    frozen_core: bool = False,
    iao_valence_basis: str | None = None,
    print_frags: bool = True,
    additional_args: ChemGenArgs | None = None,
) -> FragPart:
    """Fragment a molecule for BE (reference molbe/fragment.py:fragmentate).

    chemgen only; autogen and graphgen are ROADMAP A15.
    """
    if frag_type != "chemgen":
        raise NotImplementedError(
            f"frag_type={frag_type!r}: only chemgen is ported (autogen and"
            " graphgen are ROADMAP A15)"
        )
    return chemgen(
        mol,
        n_BE=n_BE,
        args=additional_args,
        frozen_core=frozen_core,
        iao_valence_basis=iao_valence_basis,
        print_frags=print_frags,
    )


def initialize_pot(n_frag: int, relAO_per_edge_per_frag) -> list[float]:
    pot = []
    for I in range(n_frag):
        for edge in relAO_per_edge_per_frag[I]:
            n = len(edge)
            pot.extend([0.0] * (n * (n + 1) // 2))
    pot.append(0.0)
    return pot


def _resolve_device(device) -> torch.device:
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "BE(device=cuda): no CUDA device is available; pass"
            " device='cpu' to run on the CPU"
        )
    return device


class BE:
    """Restricted bootstrap embedding driver."""

    def __init__(
        self,
        mf: RHF,
        fobj: FragPart,
        *,
        lo_method: str = "lowdin",
        thr_bath: float = 1.0e-10,
        int_transform: str = "in-core",
        auxbasis=None,
        MO_coeff_epsilon: float = 1.0e-5,
        device: torch.device | str | None = None,
    ):
        """int_transform: "in-core" (dense AO ERI: the pivoted-Cholesky
        factor route on CUDA, quarter transforms on the CPU; see
        :meth:`_incore_via_cd`) or "sparse-DF" (the screened f32 tier,
        which needs ``QUEMB_TPU_CCSD_F32_ONLY=1`` and
        ``auxbasis="cholesky[:tol]"``; the f64 tier is ROADMAP A13).
        ``MO_coeff_epsilon`` is the sparse-DF per-MO screening threshold
        (reference mbe.py:191).  ``device`` defaults to CUDA."""
        if int_transform not in ("in-core", "sparse-DF"):
            raise NotImplementedError(
                f"int_transform={int_transform!r}: only 'in-core' and"
                " 'sparse-DF' are ported (the other DF routes are"
                " ROADMAP A13)"
            )
        if lo_method.lower() != "lowdin":
            raise NotImplementedError(
                f"lo_method={lo_method!r}: only Lowdin is ported (ROADMAP"
                " A12)"
            )
        if fobj.frozen_core:
            raise NotImplementedError("frozen core is ROADMAP A10")
        self.device = _resolve_device(device)
        self.int_transform = int_transform
        self.auxbasis = auxbasis
        self.MO_coeff_epsilon = MO_coeff_epsilon
        self.mf = mf
        self.fobj = fobj
        self.thr_bath = thr_bath

        mol = mf.mol
        self.mol = mol
        self.Nocc = mol.nelectron // 2
        self.enuc = mf.energy_nuc()
        self.hcore = np.asarray(mf.get_hcore())
        self.S = np.asarray(mf.get_ovlp())
        self.C = np.asarray(mf.mo_coeff)
        self.hf_dm = mf.make_rdm1()
        self.hf_veff = mf.get_veff()
        self.hf_etot = mf.e_tot
        self.ebe_hf = 0.0
        self.ebe_tot = 0.0
        self.E_core = 0.0  # no frozen core (ROADMAP A10)

        self.localize()
        self.fragments: list[Fragment] = []
        self.pot = initialize_pot(
            fobj.n_frag, fobj.relAO_per_edge_per_frag
        )
        self.initialize()

    def _incore_via_cd(self) -> bool:
        """Route the in-core ERI transform through the pivoted-CD factor?

        "auto" (default): yes on CUDA (two GEMMs and a Gram product on
        the card against a ~rank x nao^2 factor), no on the CPU (the
        quarter transform, whose exact numbers the tests pin).  Forced
        with QUEMB_TPU_INCORE_CD=1/0, as in the JAX package.
        """
        mode = os.environ.get("QUEMB_TPU_INCORE_CD", "auto")
        if mode in ("1", "true", "yes"):
            return True
        if mode in ("0", "false", "no"):
            return False
        return self.device.type != "cpu"

    # ------------------------------------------------------------ localize
    def localize(self) -> None:
        """Lowdin orthogonalization: W = S^{-1/2}, lmo_coeff = W^T S C."""
        S = torch.as_tensor(self.S, device=self.device)
        W = lowdin_orth(S).cpu().numpy()
        self.W = W
        self.lmo_coeff = W.T @ self.S @ self.C

    # ---------------------------------------------------------- initialize
    def initialize(self) -> None:
        t0 = time.perf_counter()
        fobj = self.fobj
        for I in range(fobj.n_frag):
            fr = Fragment.from_frag_part(fobj, I)
            fr.sd(self.W, self.lmo_coeff, self.Nocc, thr_bath=self.thr_bath)
            self.fragments.append(fr)
        logger.info("init: Schmidt %.2fs", time.perf_counter() - t0)
        t0 = time.perf_counter()
        dev = self.device

        if self.int_transform == "sparse-DF":
            from quemb_tpu_torch.ops.df import cholesky_df_factor, \
                resolve_auxbasis
            from quemb_tpu_torch.ops.sparse_df import SparseDF
            from quemb_tpu_torch.solvers.ccsd import _f32_only

            if not _f32_only():
                raise NotImplementedError(
                    "sparse-DF runs the f32 tier only"
                    " (QUEMB_TPU_CCSD_F32_ONLY=1); its f64 tier is"
                    " ROADMAP A13"
                )
            # the factor of the mean field's own ERI: the counterpart of
            # DFTensor(mol, "cholesky") without the integral engine
            _, tol = resolve_auxbasis(self.mol, self.auxbasis)
            B = cholesky_df_factor(self.mol, tol=tol, eri=self.mf.get_eri())
            sdf = SparseDF.from_factor(
                self.mol, B, mo_eps=self.MO_coeff_epsilon, device=dev
            )
            eris = sdf.transform_all([fr.TA for fr in self.fragments])
            for fr, eri in zip(self.fragments, eris):
                fr.eri = eri
            logger.info(
                "sparse-DF mean reachable-AO fraction: "
                f"{sdf.last_reach_fraction:.3f} (tier f32-pallas)"
            )
        elif self._incore_via_cd():
            # compress the AO ERI by diagonal-pivoted Cholesky (every
            # element exact to 1e-10) and run all fragment transforms as
            # one batched device computation; the ERIs stay on the device
            from quemb_tpu_torch.ops.df import cholesky_df_factor, \
                df_transform_batched

            B = cholesky_df_factor(self.mol, tol=1.0e-10,
                                   eri=self.mf.get_eri())
            B_dev = torch.as_tensor(B, device=dev)
            ne_max = max(fr.TA.shape[1] for fr in self.fragments)
            TA_b = torch.as_tensor(np.stack([
                np.pad(fr.TA, ((0, 0), (0, ne_max - fr.TA.shape[1])))
                for fr in self.fragments
            ]), device=dev)
            eri_b = df_transform_batched(B_dev, TA_b)
            for k, fr in enumerate(self.fragments):
                n = fr.TA.shape[1]
                fr.eri = eri_b[k, :n, :n, :n, :n].contiguous()
        else:
            from quemb_tpu_torch.ops.eri_transform import \
                incore_transform_batched

            eri_ao = torch.as_tensor(self.mf.get_eri(), device=dev)
            buckets: dict[int, list[Fragment]] = {}
            for fr in self.fragments:
                buckets.setdefault(fr.nao, []).append(fr)
            for frs in buckets.values():
                TA_b = torch.as_tensor(
                    np.stack([fr.TA for fr in frs]), device=dev
                )
                eri_b = incore_transform_batched(eri_ao, TA_b)
                for fr, eri in zip(frs, eri_b):
                    fr.eri = eri
        logger.info("init: ERI transform %.2fs", time.perf_counter() - t0)
        t0 = time.perf_counter()

        E_hf = self._init_fragments_batched()
        logger.info("init: fragment init %.2fs", time.perf_counter() - t0)

        self.ebe_hf = E_hf + self.enuc
        hf_err = self.hf_etot - self.ebe_hf
        logger.info(f"HF-in-HF error: {hf_err:.4e} Ha")
        print(f"HF-in-HF error                 :  {hf_err:>.4e} Ha")
        if abs(hf_err) > 1.0e-5:
            warnings.warn("Large HF-in-HF energy error")

        # matching-potential dimensions
        couti = 0
        for fr in self.fragments:
            fr.udim = couti
            couti = fr.set_udim(couti)

    def _init_fragments_batched(self) -> float:
        """Fragment Hamiltonians + Fock + SCF + HF energies, bucketed.

        The small projections stay in host numpy; each (nemb, nsocc)
        bucket runs one batched device computation.  Returns the summed
        HF-in-HF fragment energy.
        """
        C_occ = self.C[:, : self.Nocc]
        for fr in self.fragments:
            TA = fr.TA
            C_ = TA.T @ self.S @ C_occ
            fr.nsocc = int(round(np.trace(C_ @ C_.T)))
            fr._mo_coeffs = np.linalg.svd(C_)[0]
            fr.h1 = TA.T @ self.hcore @ TA
            ST = self.S @ TA
            fr._P_emb = ST.T @ self.hf_dm @ ST
            fr.veff0 = TA.T @ self.hf_veff @ TA
            fr.heff = np.zeros_like(fr.h1)
            fr.dm0 = 2.0 * (
                fr._mo_coeffs[:, : fr.nsocc]
                @ fr._mo_coeffs[:, : fr.nsocc].T
            )
        buckets: dict[tuple[int, int], list[Fragment]] = {}
        for fr in self.fragments:
            buckets.setdefault((fr.nao, fr.nsocc), []).append(fr)
        return sum(
            self._init_bucket(frs, nsocc)
            for (_, nsocc), frs in buckets.items()
        )

    def _init_bucket(self, frs, nsocc) -> float:
        dev = self.device

        def stack(name):
            return torch.as_tensor(
                np.stack([getattr(fr, name) for fr in frs]), device=dev
            )

        veff_b, moe_b, C_b, erows_b = (
            t.cpu().numpy()
            for t in _init_bucket_device(
                torch.stack([fr.eri for fr in frs]),
                stack("_P_emb"), stack("h1"), stack("veff0"), stack("dm0"),
                nsocc,
            )
        )
        E_hf = 0.0
        for k, fr in enumerate(frs):
            fr.veff = veff_b[k]
            fr.fock = fr.h1 + fr.veff
            fr._mo_coeffs = C_b[k]
            fr.dm0 = 2.0 * (C_b[k][:, :nsocc] @ C_b[k][:, :nsocc].T)
            w, idx = fr.weight_and_relAO_per_center
            fr.ebe_hf = float(w * erows_b[k][list(idx)].sum())
            E_hf += fr.ebe_hf
            del fr._P_emb
        return E_hf

    # -------------------------------------------------------------- oneshot
    def oneshot(
        self, solver: str = "CCSD", use_cumulant: bool = True
    ) -> None:
        """One objective evaluation at zero matching potential; sets
        ``ebe_tot``."""
        rets = be_func(
            None,
            self.fragments,
            self.Nocc,
            solver,
            eeval=True,
            use_cumulant=use_cumulant,
            return_vec=False,
        )
        logger.info(f"One-shot BE, solver={solver}: Ecorr={rets[0]:.10f}")
        if use_cumulant:
            self.ebe_tot = rets[0] + self.ebe_hf
        else:
            # Non-cumulant: rets[0] is already the full electronic energy
            # of the matched regions, so only nuclear + frozen-core terms
            # are added
            self.ebe_tot = rets[0] + self.enuc + self.E_core
        print(f"One-shot BE ({solver}): E_corr = {rets[0]:.10f} Ha, "
              f"E_tot = {self.ebe_tot:.10f} Ha")

    # ------------------------------------------------------------- optimize
    def optimize(
        self,
        solver: str = "CCSD",
        method: str = "QN",
        only_chem: bool = False,
        use_cumulant: bool = True,
        conv_tol: float = 1.0e-6,
        relax_density: bool = False,
        jac_solver: Literal["HF", "MP2", "CCSD", "Numerical"] = "HF",
        max_iter: int = 500,
        trust_region: bool = False,
    ) -> None:
        """Density matching: quasi-Newton root search for the matching
        potential (or, with ``only_chem``, the chemical potential alone)
        from the Jacobian of ``jac_solver``; sets ``ebe_tot``.  The
        fragment solves and the responses run on ``self.device``."""
        if not only_chem:
            pot = self.pot
            if self.fobj.n_BE == 1:
                raise ValueError(
                    "BE1 only works with chemical potential optimization. "
                    "Set only_chem=True"
                )
            if (
                not self.fobj.iao_valence_basis
                and self.fobj.n_BE >= 3
                and not self.fobj.all_centers_are_origins()
            ):
                raise ValueError(
                    "BE3+ with centers that are not origins is not supported "
                    "for density matching; use swallow_replace=True."
                )
        else:
            pot = [0.0]

        be_ = BEOPT(
            pot,
            self.fragments,
            self.Nocc,
            self.enuc,
            solver=solver,
            only_chem=only_chem,
            use_cumulant=use_cumulant,
            max_space=max_iter,
            conv_tol=conv_tol,
            relax_density=relax_density,
            ebe_hf=self.ebe_hf,
        )

        if jac_solver == "Numerical":
            from quemb_tpu_torch.matching.numerical_jac import (  # noqa: PLC0415
                compute_numerical_jacobian,
            )

            J0 = compute_numerical_jacobian(self, solver, only_chem)
        else:
            J0 = get_be_error_jacobian(self.fragments, jac_solver)
            if only_chem:
                J0 = J0[-1:, -1:]

        be_.optimize(method, J0=J0, trust_region=trust_region)

        if use_cumulant:
            self.ebe_tot = be_.Ebe[0] + self.ebe_hf
        else:
            self.ebe_tot = be_.Ebe[0] + self.enuc + self.E_core
        print(
            f"BE optimize ({solver}): E_corr = {be_.Ebe[0]:.10f} Ha, "
            f"E_tot = {self.ebe_tot:.10f} Ha"
        )

    def get_be_error_jacobian(self, jac_solver: str = "HF"):
        return get_be_error_jacobian(self.fragments, jac_solver)
