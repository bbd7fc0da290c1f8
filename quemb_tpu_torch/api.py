"""Public BE driver on PyTorch.

JAX counterpart: ``quemb_tpu/api.py``.  Mirrors the reference molbe
``BE``/``fragmentate`` entry points (reference molbe/mbe.py:173,
molbe/fragment.py:22) for the restricted molecular driver: chemgen,
autogen or graphgen fragmentation with or without a frozen core, Lowdin,
Boys, Pipek-Mezey, Edmiston-Ruedenberg or IAO+PAO localization, Schmidt
embedding, the fragment ERI transform (``"in-core"`` and the density-fitted
routes ``"int-direct-DF"``, ``"sparse-DF"``, ``"on-fly-sparse-DF"`` and
``"out-core-DF"``; under the f32 tier ``"sparse-DF"`` runs the screened-DF
CUDA kernel), batched fragment initialization, the one-shot solve, density
matching (``optimize``: analytic HF/MP2/CCSD or numerical Jacobian,
quasi-Newton loop) with the CCSD, MP2, FCI, SCI and DMRG solvers, the
save/restart file, and the full-basis RDMs and energy
(``rdm1_fullbasis``, ``compute_energy_full``).  ``initialize``,
``oneshot`` and ``optimize`` add their walls to
:data:`quemb_tpu_torch.utils.helper.timer`.  Each ``BE`` is one trace of
the tracer (:mod:`quemb_tpu_torch.utils.profiling`): the ``fragmentate``
that made its fragments, its construction and every solve on it.

Device work runs on an explicit ``torch.device``: ``BE(..., device=...)``
defaults to CUDA and raises when no card is present; the CPU is used only
when the caller names it.  Host bookkeeping (the Jacobi and IAO
localizers, Schmidt) stays numpy, as in the JAX package.
"""

from __future__ import annotations

import logging
import os
import warnings
from typing import Literal

import numpy as np
import torch

from quemb_tpu_torch.chem.elements import ncore_of
from quemb_tpu_torch.chem.mole import Mole
from quemb_tpu_torch.chem.scf import RHF, get_jk
from quemb_tpu_torch.embed.fragment import Fragment
from quemb_tpu_torch.embed.fragment_scf import rhf_orthonormal
from quemb_tpu_torch.fragment.chemgen import ChemGenArgs, chemgen
from quemb_tpu_torch.fragment.frag_part import FragPart
from quemb_tpu_torch.lo.iao import get_iao, get_pao, get_xovlp, \
    remove_core_mo
from quemb_tpu_torch.lo.jacobi import get_loc
from quemb_tpu_torch.lo.lowdin import lowdin_orth
from quemb_tpu_torch.matching.beopt import BEOPT
from quemb_tpu_torch.matching.cphf import get_be_error_jacobian
from quemb_tpu_torch.ops.df import _free_bytes, df_transform_batched
from quemb_tpu_torch.ops.eri_transform import batched_mo_eri
from quemb_tpu_torch.solvers.dispatch import be_func
from quemb_tpu_torch.utils.device import resolve_device
from quemb_tpu_torch.utils.helper import timer
from quemb_tpu_torch.utils.profiling import count, current, span

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


def _memory_chunks(items: list, per_item: float, device: torch.device):
    """Consecutive runs of ``items``, each as long as ``per_item`` bytes an
    item fit into half the device's free memory, read anew before every
    run; one run on the CPU."""
    i = 0
    while i < len(items):
        free = _free_bytes(device)
        n = len(items) if free == float("inf") else max(
            1, int(0.5 * free // per_item))
        yield items[i : i + n]
        i += n


def _quarter_bytes(n: int, nao: int) -> float:
    """Bytes of the four quarter-transformed intermediates of one fragment
    of width ``n`` against the [nao]^4 AO ERI."""
    return 8.0 * n * (nao ** 3 + n * nao ** 2 + n * n * nao + n ** 3)


def _cd_fragment_eris(B: torch.Tensor, TAs: list) -> list[torch.Tensor]:
    """Fragment ERIs from the pivoted-CD factor B [rank, nao, nao] on the
    device, for host bases TAs [nao, nemb_f] padded to the widest: as many
    fragments a pass as fit their output, one partial sum and the
    half-transformed factor (:func:`df_transform_batched`)."""
    naux, nao, _ = B.shape
    ne = max(TA.shape[1] for TA in TAs)
    per = 8.0 * (2 * ne ** 4 + naux * ne * (nao + 2 * ne))
    eris = []
    for part in _memory_chunks(TAs, per, B.device):
        TA_b = torch.as_tensor(np.stack([
            np.pad(TA, ((0, 0), (0, ne - TA.shape[1]))) for TA in part
        ]), device=B.device)
        eri_b = df_transform_batched(B, TA_b)
        for k, TA in enumerate(part):
            n = TA.shape[1]
            eris.append(eri_b[k, :n, :n, :n, :n].contiguous())
        del eri_b
    return eris


def _init_fragment_buckets(frs: list, device: torch.device) -> float:
    """Fragment initialization (:func:`_init_bucket_device`) per (nemb,
    nsocc) bucket on ``device``, in runs that fit three stacked ERIs a
    fragment into half the free memory (the stack and the einsum and SCF
    temporaries).  Reads ``eri``, ``_P_emb``, ``h1``, ``veff0``, ``dm0``
    and ``weight_and_relAO_per_center``; sets ``veff``, ``fock``,
    ``_mo_coeffs``, ``dm0`` and ``ebe_hf``.  Returns the summed HF-in-HF
    fragment energy."""
    buckets: dict[tuple[int, int], list] = {}
    for fr in frs:
        buckets.setdefault((fr.nao, fr.nsocc), []).append(fr)
    E_hf = 0.0
    for (nemb, nsocc), frs_all in buckets.items():
        for run in _memory_chunks(frs_all, 3 * 8.0 * nemb ** 4, device):
            E_hf += _init_bucket(run, nsocc, device)
    return E_hf


def _init_bucket(frs: list, nsocc: int, device: torch.device) -> float:
    def stack(name):
        return torch.as_tensor(
            np.stack([getattr(fr, name) for fr in frs]), device=device
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


@span("fragmentate")
def fragmentate(
    mol: Mole,
    *,
    frag_type: str = "chemgen",
    n_BE: int = 2,
    frozen_core: bool = False,
    iao_valence_basis: str | None = None,
    print_frags: bool = True,
    order_by_size: bool = False,
    additional_args: ChemGenArgs | None = None,
) -> FragPart:
    """Fragment a molecule for BE (reference molbe/fragment.py:fragmentate):
    chemgen, autogen or graphgen (``additional_args`` carries
    :class:`ChemGenArgs` or :class:`GraphGenArgs`).  The call is the root
    span of a trace, which the first ``BE`` built from the result joins
    (``trace_id``)."""
    if frag_type == "chemgen":
        result = chemgen(
            mol,
            n_BE=n_BE,
            args=additional_args,
            frozen_core=frozen_core,
            iao_valence_basis=iao_valence_basis,
            print_frags=print_frags,
        )
    elif frag_type == "autogen":
        from quemb_tpu_torch.fragment.autogen import autogen  # noqa: PLC0415

        result = autogen(
            mol,
            n_BE=n_BE,
            frozen_core=frozen_core,
            iao_valence_basis=iao_valence_basis,
            print_frags=print_frags,
        )
    elif frag_type == "graphgen":
        from quemb_tpu_torch.fragment.graphgen import (  # noqa: PLC0415
            GraphGenArgs,
            graphgen,
        )

        gargs = additional_args or GraphGenArgs()
        result = graphgen(
            mol,
            n_BE=n_BE,
            frozen_core=frozen_core,
            iao_valence_basis=iao_valence_basis,
            cutoff=gargs.cutoff,
            remove_nonnunique_frags=gargs.remove_nonnunique_frags,
            print_frags=print_frags,
        )
    else:
        raise NotImplementedError(
            f"frag_type={frag_type!r} is not implemented; "
            'use "chemgen", "autogen", or "graphgen"'
        )
    if order_by_size:
        idx = np.argsort(
            [-len(aos) for aos in result.AO_per_frag], stable=True
        )
        result = result.reorder_frags(idx)
    result.trace_id = current().trace
    return result


def _reorder_by_atom(Clo, aoind_by_atom, S, thr: float = 0.5):
    """Assign localized orbitals to atoms by population and reorder.

    Port of the reference ``shared/external/lo_helper.py:reorder_by_atom_``.
    """
    w, V = np.linalg.eigh(S)
    X = (V * np.sqrt(w)) @ V.T
    Clo_soao = X @ Clo
    loind_reorder = []
    loind_by_atom = []
    loshift = 0
    for ra in aoind_by_atom:
        pop = np.sum(Clo_soao[ra] ** 2.0, axis=0)
        loind_a = np.where(pop > thr)[0].tolist()
        loind_reorder += loind_a
        loind_by_atom.append(list(range(loshift, loshift + len(loind_a))))
        loshift += len(loind_a)
    return Clo[:, loind_reorder], loind_by_atom


def initialize_pot(n_frag: int, relAO_per_edge_per_frag) -> list[float]:
    pot = []
    for I in range(n_frag):
        for edge in relAO_per_edge_per_frag[I]:
            n = len(edge)
            pot.extend([0.0] * (n * (n + 1) // 2))
    pot.append(0.0)
    return pot


def _same_auxbasis(a, b) -> bool:
    if isinstance(a, str) and isinstance(b, str):
        return a.lower() == b.lower()
    return a is b


_INT_TRANSFORMS = (
    "in-core", "int-direct-DF", "sparse-DF", "out-core-DF",
    "on-fly-sparse-DF",
)


class BE:
    """Restricted bootstrap embedding driver."""

    def __init__(
        self,
        mf: RHF,
        fobj: FragPart,
        *,
        lo_method: str = "lowdin",
        iao_loc_method: str = "lowdin",
        thr_bath: float = 1.0e-10,
        int_transform: str = "in-core",
        auxbasis=None,
        screen_eps: float | None = None,
        MO_coeff_epsilon: float = 1.0e-5,
        AO_coeff_epsilon: float = 1.0e-10,
        device: torch.device | str | None = None,
    ):
        """int_transform: "in-core" (dense AO ERI: quarter transforms of
        the mean field's device copy wherever they fit, the host
        pivoted-Cholesky factor on a card where they do not, the route
        chosen by size in :meth:`_incore_via_cd`), "int-direct-DF"
        (density-fitted, the whole factor against every fragment),
        "sparse-DF" (S_abs-screened DF, the performance path: the banded
        or union-gather f64 tier, or under ``QUEMB_TPU_CCSD_F32_ONLY=1``
        the f32 tier that runs the screened-DF kernel), "out-core-DF"
        (streamed DF factor blocks under the memory budget) or
        "on-fly-sparse-DF" (per-fragment screened (P|mu nu) recompute
        under the memory budget).  No DF route reads the dense AO ERI,
        except to factorize it when ``auxbasis`` is ``"cholesky[:tol]"``.
        ``auxbasis`` accepts an aux Mole or a spec string ("etb:<beta>",
        "cholesky[:tol]", "weigend"; see ops/df.py:resolve_auxbasis);
        default: even-tempered from the orbital basis.

        ``lo_method``: "lowdin", "boys", "PM", "ER" (Jacobi sweeps from
        the Lowdin orbitals) or "IAO" (IAO+PAO on the fragmentation's
        ``iao_valence_basis``, localized within each space by
        ``iao_loc_method``).  A ``fobj`` built with ``frozen_core=True``
        freezes the core orbitals: their density enters the one-electron
        Hamiltonian and ``E_core``.

        ``MO_coeff_epsilon`` / ``AO_coeff_epsilon`` are the sparse-DF
        screening thresholds with the reference's names and production
        defaults (mbe.py:191-192): the per-MO reachability screen and
        the geometric AO-pair screen.  ``screen_eps`` (legacy single
        knob) overrides both when given.  ``device`` defaults to CUDA; a
        mean field that was given no device runs its J/K there too.

        Construction is the tracer's ``construct`` span, in the trace of
        ``fobj``'s ``fragmentate`` when no other ``BE`` took it first
        (``trace_id``)."""
        trace = getattr(fobj, "trace_id", None)
        fobj.trace_id = None
        with span("construct", trace) as sp:
            self.trace_id = sp.trace
            with span("mean_field"):
                self._set_options(mf, fobj, thr_bath, int_transform,
                                  auxbasis, screen_eps, MO_coeff_epsilon,
                                  AO_coeff_epsilon, device)
                self._read_mean_field(mf)
            with span("localize"):
                self.localize(lo_method, iao_loc_method=iao_loc_method)
            self.initialize()

    def _read_mean_field(self, mf: RHF) -> None:
        """What construction reads of the mean field, on the host, with
        the frozen core's density and potential folded in (the tracer's
        ``core`` span)."""
        mol = mf.mol
        self.Nocc = mol.nelectron // 2
        self.enuc = mf.energy_nuc()
        self.hcore = np.asarray(mf.get_hcore())
        self.S = np.asarray(mf.get_ovlp())
        self.C = np.asarray(mf.mo_coeff)
        self.mo_energy = np.asarray(mf.mo_energy)
        self.hf_dm = mf.make_rdm1()
        self.hf_veff = mf.get_veff()
        self.hf_etot = mf.e_tot

        if not self.frozen_core:
            return
        with span("core"):
            self.Nocc -= self.ncore
            C_val = self.C[:, self.ncore : self.ncore + self.Nocc]
            self.hf_dm = 2.0 * C_val @ C_val.T
            self.C_core = self.C[:, : self.ncore]
            self.P_core = self.C_core @ self.C_core.T
            # on the mean field's device, dense or density-fitted alike
            self.core_veff = mf.get_veff(dm=self.P_core * 2.0)
            self.E_core = float(np.einsum(
                "ji,ji->", 2.0 * self.hcore + self.core_veff, self.P_core
            ))
            self.hf_veff = self.hf_veff - self.core_veff
            self.hcore = self.hcore + self.core_veff

    def _set_options(self, mf, fobj, thr_bath, int_transform, auxbasis,
                     screen_eps, MO_coeff_epsilon, AO_coeff_epsilon,
                     device) -> None:
        """What the constructor and :meth:`from_restart_file` share: the
        options, the device, and an empty fragment state."""
        if int_transform not in _INT_TRANSFORMS:
            raise ValueError(f"int_transform={int_transform}")
        self.device = resolve_device(device, "BE")
        mf.bind_device(self.device)
        self.int_transform = int_transform
        self.auxbasis = auxbasis
        if screen_eps is not None:
            MO_coeff_epsilon = AO_coeff_epsilon = screen_eps
        self.screen_eps = screen_eps
        self.MO_coeff_epsilon = MO_coeff_epsilon
        self.AO_coeff_epsilon = AO_coeff_epsilon
        self.mf = mf
        self.fobj = fobj
        self.thr_bath = thr_bath
        self.mol = mf.mol
        self.unrestricted = False
        self.ebe_hf = 0.0
        self.ebe_tot = 0.0
        self.frozen_core = fobj.frozen_core
        self.ncore = (fobj.ncore or 0) if fobj.frozen_core else 0
        self.E_core = 0.0
        self.C_core = self.P_core = self.core_veff = None
        self.fragments: list[Fragment] = []
        self.pot = initialize_pot(
            fobj.n_frag, fobj.relAO_per_edge_per_frag
        )

    @property
    def Fobjs(self) -> list[Fragment]:
        """The fragments under the reference's attribute name."""
        return self.fragments

    def _incore_via_cd(self) -> bool:
        """Route the in-core ERI transform through the pivoted-CD factor?

        "auto" (default) chooses by size: no, the quarter transform of the
        dense AO ERI on the device, when the ERI (nothing more when the
        mean field already holds it there) and twice one widest
        fragment's intermediates fit in the device's free memory; yes, the
        host factor (rank x nao^2 on the card), only where they do not: an
        ERI too large for the card, nao above ~230 on 80 GB.  The CPU's
        memory counts as unbounded, so there it is always the quarter
        transform, whose exact numbers the tests pin.  Forced with
        QUEMB_TPU_INCORE_CD=1/0, as in the JAX package.
        """
        mode = os.environ.get("QUEMB_TPU_INCORE_CD", "auto")
        if mode in ("1", "true", "yes"):
            return True
        if mode in ("0", "false", "no"):
            return False
        nao = self.S.shape[0]
        resident = (self.mf.device == self.device
                    and self.mf._eri_dev is not None)
        need = 0.0 if resident else 8.0 * nao ** 4
        n = max(fr.nao for fr in self.fragments)
        return need + 2.0 * _quarter_bytes(n, nao) > _free_bytes(self.device)

    def _df_factor(self):
        """The whitened factor [naux, nao, nao] of ``self.auxbasis`` for the
        routes that hold it whole: a host array, or the mean field's device
        tensor when it was converged on the same auxiliary basis (the same
        function of the same molecule, so it is reused, not rebuilt).
        ``"cholesky[:tol]"`` factorizes the mean field's dense ERI; every
        other spec goes through the three-center integrals and never forms
        it."""
        from quemb_tpu_torch.ops.df import (
            DFTensor,
            cholesky_df_factor,
            resolve_auxbasis,
        )

        mf = self.mf
        if (
            getattr(mf, "with_df", False)
            and mf._df_B is not None
            and _same_auxbasis(mf.auxbasis, self.auxbasis)
        ):
            return mf.get_df_B()
        kind, arg = resolve_auxbasis(self.mol, self.auxbasis)
        if kind == "cholesky":
            return cholesky_df_factor(self.mol, tol=arg, eri=mf.get_eri())
        return DFTensor(self.mol, arg).B

    # ------------------------------------------------------------ localize
    def localize(self, lo_method: str, iao_loc_method: str = "lowdin") -> None:
        """Localized orbitals ``W`` and the MOs in them, ``lmo_coeff``.

        Lowdin orthogonalization runs on the device; with a frozen core
        the core is projected out, orbitals of population above 0.7 are
        kept and re-orthogonalized; Boys, PM and ER start from there.
        IAO+PAO (:meth:`_localize_iao`) is the tracer's ``iao`` span.
        """
        norm = {"lowdin": "lowdin", "boys": "boys", "pm": "PM", "er": "ER",
                "iao": "IAO"}
        lo_method = norm.get(lo_method.lower(), lo_method)
        if lo_method == "IAO":
            with span("iao"):
                self._localize_iao(iao_loc_method)
            return
        if lo_method not in ("lowdin", "boys", "PM", "ER"):
            raise NotImplementedError(f"lo_method={lo_method!r}")
        S = torch.as_tensor(self.S, device=self.device)
        W = lowdin_orth(S).cpu().numpy()
        if self.frozen_core:
            # project out the core, re-orthogonalize the remainder
            # (reference mbe.py:1407-1426)
            C_ = (np.eye(W.shape[0]) - self.P_core @ self.S) @ W
            Cpop = np.diag(C_.T @ self.S @ C_)
            C_ = C_[:, np.where(Cpop > 0.7)[0]]
            es_, vs_ = np.linalg.eigh(C_.T @ self.S @ C_)
            W = C_ @ ((vs_ / np.sqrt(es_)) @ vs_.T)
        if lo_method != "lowdin":
            # Jacobi localization seeded from the Lowdin orbitals
            # (reference mbe.py:1451-1481)
            W = get_loc(self.mol, W, lo_method, S=self.S)
        self.W = W
        self.lmo_coeff = W.T @ self.S @ self.C[:, self.ncore :]

    def _localize_iao(self, iao_loc_method: str = "lowdin") -> None:
        """IAO+PAO localization (reference mbe.py:1483-1609), host numpy
        as in the JAX package."""
        fobj = self.fobj
        assert fobj.iao_valence_basis is not None
        Co = self.C[:, : self.mol.nelectron // 2]
        # the lowdin variant reads the valence basis's labels alone
        S_vw = S_vv = None
        if iao_loc_method != "lowdin":
            S_vw, S_vv, _ = get_xovlp(self.mol,
                                      basis=fobj.iao_valence_basis)
        Ciao = get_iao(
            Co, S_vw, self.S, S_vv, self.mol, fobj.iao_valence_basis,
            iao_loc_method,
        )
        Cpao = get_pao(
            Ciao, self.S, S_vw, self.mol, fobj.iao_valence_basis,
            iao_loc_method,
        )
        if iao_loc_method != "lowdin":
            Ciao = get_loc(self.mol, Ciao, iao_loc_method)
            Cpao = get_loc(self.mol, Cpao, iao_loc_method)

        aoind_by_atom = [
            list(range(p0, p1)) for p0, p1 in self.mol.aoslice_by_atom()
        ]
        Ciao, iaoind_by_atom = _reorder_by_atom(Ciao, aoind_by_atom, self.S)
        Cpao, paoind_by_atom = _reorder_by_atom(Cpao, aoind_by_atom, self.S)

        if self.frozen_core:
            Ciao = remove_core_mo(Ciao, self.C[:, : self.ncore], self.S)

        # per atom: its valence IAOs (the core ones dropped), then its PAOs
        cols = []
        ncore_cum = 0
        for ix in range(self.mol.natm):
            if self.frozen_core:
                nc = ncore_of(self.mol.atom_charge(ix))
                ncore_cum += nc
                cols.append(Ciao[:, [i - ncore_cum
                                     for i in iaoind_by_atom[ix][nc:]]])
            else:
                cols.append(Ciao[:, iaoind_by_atom[ix]])
            cols.append(Cpao[:, paoind_by_atom[ix]])
        self.W = np.hstack(cols)
        assert np.allclose(
            self.W.T @ self.S @ self.W, np.eye(self.W.shape[1])
        )

        nmo = self.C.shape[1] - self.ncore
        nlo = self.W.shape[1]
        if nmo > nlo:
            # the virtuals that the localized space holds, by SVD
            Co_nocore = self.C[:, self.ncore : self.ncore + self.Nocc]
            Cv = self.C[:, self.ncore + self.Nocc :]
            _, sv, vt = np.linalg.svd(
                self.W.T @ self.S @ Cv, full_matrices=False
            )
            nvlo = nlo - self.Nocc
            assert np.allclose(np.sum(sv[:nvlo]), nvlo)
            C_ = np.hstack([Co_nocore, Cv @ vt[:nvlo].T])
            self.lmo_coeff = self.W.T @ self.S @ C_
        else:
            self.lmo_coeff = self.W.T @ self.S @ self.C[:, self.ncore :]

    # ---------------------------------------------------------- initialize
    @timer.timeit
    def initialize(self) -> None:
        """Schmidt decomposition, the fragment ERIs and the fragment
        SCFs at zero potential: the tracer's ``schmidt``, ``eri`` and
        ``fragment_init`` spans."""
        with span("schmidt") as sp:
            fobj = self.fobj
            for I in range(fobj.n_frag):
                fr = Fragment.from_frag_part(fobj, I)
                fr.sd(self.W, self.lmo_coeff, self.Nocc,
                      thr_bath=self.thr_bath)
                self.fragments.append(fr)
        logger.info("init: Schmidt %.2fs", sp.seconds)
        with span("eri") as sp:
            self._fragment_eris()
        logger.info("init: ERI transform %.2fs", sp.seconds)
        with span("fragment_init") as sp:
            E_hf = self._init_fragments_batched()
        logger.info("init: fragment init %.2fs", sp.seconds)

        self.ebe_hf = E_hf + self.enuc + self.E_core
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

    def _fragment_eris(self) -> None:
        """Each fragment's ``eri`` on the device, by ``int_transform``."""
        dev = self.device

        TAs = [fr.TA for fr in self.fragments]
        if self.int_transform == "int-direct-DF":
            from quemb_tpu_torch.ops.df import df_transform_batched

            B_dev = torch.as_tensor(self._df_factor(), device=dev)
            buckets: dict[int, list[Fragment]] = {}
            for fr in self.fragments:
                buckets.setdefault(fr.nao, []).append(fr)
            for frs in buckets.values():
                TA_b = torch.as_tensor(
                    np.stack([fr.TA for fr in frs]), device=dev
                )
                for fr, eri in zip(frs, df_transform_batched(B_dev, TA_b)):
                    fr.eri = eri
        elif self.int_transform == "sparse-DF":
            from quemb_tpu_torch.ops.sparse_df import SparseDF
            from quemb_tpu_torch.solvers.ccsd import _f32_only

            # Under the f32-only capacity tier the solver iterates in f32
            # anyway, so the screened first transform runs as the CUDA
            # block-skip kernel without changing the attainable accuracy.
            tier = "f32-pallas" if _f32_only() else "f64"
            sdf = SparseDF.from_factor(
                self.mol, self._df_factor(), tier=tier,
                mo_eps=self.MO_coeff_epsilon, ao_eps=self.AO_coeff_epsilon,
                device=dev,
            )
            for fr, eri in zip(self.fragments, sdf.transform_all(TAs)):
                fr.eri = eri
            logger.info(
                "sparse-DF mean reachable-AO fraction: "
                f"{sdf.last_reach_fraction:.3f} (tier {tier})"
            )
        elif self.int_transform == "on-fly-sparse-DF":
            from quemb_tpu_torch.ops.sparse_df import OnFlySparseDF

            sdf = OnFlySparseDF(
                self.mol, self.auxbasis, mo_eps=self.MO_coeff_epsilon,
                device=dev,
            )
            for fr, eri in zip(self.fragments, sdf.transform_all(TAs)):
                fr.eri = eri
            logger.info(
                "on-fly-sparse-DF mean reachable-AO fraction: "
                f"{sdf.last_reach_fraction:.3f}"
            )
        elif self.int_transform == "out-core-DF":
            from quemb_tpu_torch.ops.df import StreamedDF

            sdf = StreamedDF(self.mol, self.auxbasis, device=dev)
            for fr in self.fragments:
                fr.eri = sdf.fragment_eri(fr.TA)
        elif self._incore_via_cd():
            # compress the AO ERI by diagonal-pivoted Cholesky (every
            # element exact to 1e-10) and run all fragment transforms as
            # one batched device computation; the ERIs stay on the device
            from quemb_tpu_torch.ops.df import cholesky_df_factor

            with span("cd_factor"):
                B = cholesky_df_factor(self.mol, tol=1.0e-10,
                                       eri=self.mf.get_eri())
            eris = _cd_fragment_eris(torch.as_tensor(B, device=dev),
                                     [fr.TA for fr in self.fragments])
            for fr, eri in zip(self.fragments, eris):
                fr.eri = eri
            count("eri.cd", len(self.fragments))
        else:
            from quemb_tpu_torch.ops.eri_transform import \
                incore_transform_batched

            # the mean field's device copy, which its J/K already made
            eri_ao = (self.mf.get_eri_dev() if self.mf.device == dev
                      else torch.as_tensor(self.mf.get_eri(), device=dev))
            nao = eri_ao.shape[0]
            buckets: dict[int, list[Fragment]] = {}
            for fr in self.fragments:
                buckets.setdefault(fr.nao, []).append(fr)
            for n, frs_all in buckets.items():
                per = _quarter_bytes(n, nao)
                for frs in _memory_chunks(frs_all, per, dev):
                    TA_b = torch.as_tensor(
                        np.stack([fr.TA for fr in frs]), device=dev
                    )
                    eri_b = incore_transform_batched(eri_ao, TA_b)
                    for fr, eri in zip(frs, eri_b):
                        fr.eri = eri
            count("eri.direct", len(self.fragments))

    def _init_fragments_batched(self) -> float:
        """Fragment Hamiltonians + Fock + SCF + HF energies, bucketed.

        The small projections stay in host numpy; each (nemb, nsocc)
        bucket runs one batched device computation.  Returns the summed
        HF-in-HF fragment energy.
        """
        C_occ = self.C[:, self.ncore : self.ncore + self.Nocc]
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
        return _init_fragment_buckets(self.fragments, self.device)

    # -------------------------------------------------------------- oneshot
    @timer.timeit
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
    @timer.timeit
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

    # ------------------------------------------------------- save / restart
    def save(self, save_file="storebe.npz") -> None:
        """Persist the mean-field-level state for restart (reference
        ``molbe/mbe.py:458 save``; npz instead of pickle).  The keys are
        the JAX package's, so a file written by either package restarts
        the other."""
        np.savez(
            save_file,
            Nocc=self.Nocc,
            hf_veff=self.hf_veff,
            hcore=self.hcore,
            S=self.S,
            C=self.C,
            hf_dm=self.hf_dm,
            hf_etot=self.hf_etot,
            W=self.W,
            lmo_coeff=self.lmo_coeff,
            enuc=self.enuc,
            E_core=self.E_core,
            mo_energy=self.mo_energy,
        )

    @classmethod
    def from_restart_file(
        cls, mf, fobj, restart_file="storebe.npz", *,
        thr_bath: float = 1.0e-10, int_transform: str = "in-core",
        auxbasis=None, screen_eps: float | None = None,
        MO_coeff_epsilon: float = 1.0e-5, AO_coeff_epsilon: float = 1.0e-10,
        device: torch.device | str | None = None,
    ) -> "BE":
        """A BE object from a save file: the mean-field state and the
        localized orbitals are read, the fragments are rebuilt (Schmidt,
        ERI transform and fragment SCF on ``device``)."""
        be = cls.__new__(cls)
        be._set_options(mf, fobj, thr_bath, int_transform, auxbasis,
                        screen_eps, MO_coeff_epsilon, AO_coeff_epsilon,
                        device)
        with np.load(restart_file) as data:
            for key in ("hf_veff", "hcore", "S", "C", "hf_dm", "W",
                        "lmo_coeff", "mo_energy"):
                setattr(be, key, data[key])
            be.Nocc = int(data["Nocc"])
            be.enuc = float(data["enuc"])
            be.E_core = float(data["E_core"])
            be.hf_etot = float(data["hf_etot"])
        be.initialize()
        return be

    # ------------------------------------------------------ RDM reassembly
    def _rdms_ao(self, with_rdm2: bool, strip_mf: bool):
        """The democratically projected AO 1-RDM and (``with_rdm2``) 2-RDM
        summed over the fragments, on ``self.device``, before
        symmetrization.  Per bucket of equal embedding width: the center
        projection and the first index of the back-transform fuse into one
        matrix, the other three indices are transformed one at a time, and
        the first index and the fragment sum are one GEMM.  ``strip_mf``
        takes each fragment's approximate mean-field part out of its
        2-RDM first (reference mbe.py:520-534)."""
        dev = self.device
        nao = self.C.shape[0]
        rdm1 = torch.zeros((nao, nao), dtype=torch.float64, device=dev)
        # the 2-RDM accumulates as [q, r, s, p]
        rdm2 = (torch.zeros((nao,) * 4, dtype=torch.float64, device=dev)
                if with_rdm2 else None)
        buckets: dict[int, list[Fragment]] = {}
        for fr in self.fragments:
            buckets.setdefault(fr.nao, []).append(fr)
        SW = self.S @ self.W
        for n, frs in buckets.items():
            proj1, AOm = [], []
            for fr in frs:
                cind = [fr.AO_in_frag[i]
                        for i in fr.weight_and_relAO_per_center[1]]
                SWc = SW[:, cind]
                Pc = fr.TA.T @ (SWc @ SWc.T) @ fr.TA
                proj1.append(fr.TA @ Pc @ fr.mo_coeffs)
                AOm.append(fr.TA @ fr.mo_coeffs)
            proj1 = torch.as_tensor(np.stack(proj1), device=dev)
            AOm = torch.as_tensor(np.stack(AOm), device=dev)
            d1 = torch.stack([torch.as_tensor(fr.rdm1__, device=dev)
                              for fr in frs])
            rdm1 += (proj1 @ d1 @ AOm.transpose(1, 2)).sum(0)
            if not with_rdm2:
                continue
            d2 = torch.stack([torch.as_tensor(fr.rdm2__, device=dev)
                              for fr in frs])
            if strip_mf:
                occ = torch.zeros((len(frs), n), dtype=d1.dtype, device=dev)
                for k, fr in enumerate(frs):
                    occ[k, : fr.nsocc] = 2.0
                c1 = d1 - torch.diag_embed(occ)
                d2 = d2 - (torch.einsum("fij,fkl->fijkl", c1, c1)
                           - 0.5 * torch.einsum("fij,fkl->fiklj", c1, c1))
            # indices l, k, j back to AOs (axis-rolling: [f, q, r, s, i])
            X = d2
            for _ in range(3):
                X = (X.reshape(len(frs), -1, n) @ AOm.transpose(1, 2))
                X = X.reshape(len(frs), *d2.shape[1:4], nao).movedim(-1, 1)
                d2 = X
            # [f, q, r, s, i] -> [(q r s), (f i)] against [(f i), p]
            Xq = X.reshape(len(frs), nao ** 3, n).permute(1, 0, 2)
            rdm2.view(nao ** 3, nao).addmm_(
                Xq.reshape(nao ** 3, len(frs) * n),
                proj1.permute(0, 2, 1).reshape(len(frs) * n, nao),
            )
            del X, Xq, d2
        if with_rdm2:
            rdm2 = rdm2.permute(3, 0, 1, 2)
        return rdm1, rdm2

    def rdm1_fullbasis(
        self,
        return_ao: bool = True,
        only_rdm1: bool = False,
        only_rdm2: bool = False,
        return_lo: bool = False,
        return_RDM2: bool = True,
        print_energy: bool = False,
    ):
        """Reassemble full-basis 1-/2-RDMs from the solved fragments.

        Same contract as reference ``molbe/mbe.py:488 rdm1_fullbasis``
        (democratic projection via center projectors) and as the JAX
        method; computed on ``self.device`` (:meth:`_rdms_ao`), returned
        as host arrays.  ``return_RDM2`` strips each fragment's
        mean-field part and rebuilds the non-cumulant part from the
        reassembled 1-RDM.  The AO 1-RDM is accumulated under
        ``only_rdm2`` too, as in the JAX method, because that rebuild
        needs it.
        """
        rdm1AO, rdm2AO = self._rdms_ao(with_rdm2=not only_rdm1,
                                       strip_mf=return_RDM2)
        dev = self.device
        C = torch.as_tensor(self.C, device=dev)
        S = torch.as_tensor(self.S, device=dev)
        W = torch.as_tensor(self.W, device=dev)
        CmoT_S, CloT_S = C.T @ S, W.T @ S
        out = {}
        if not only_rdm1:
            rdm2AO = 0.5 * (rdm2AO + rdm2AO.permute(3, 2, 1, 0))
            if return_RDM2:
                rdm2AO = rdm2AO + (
                    torch.einsum("ij,kl->ijkl", rdm1AO, rdm1AO)
                    - 0.5 * torch.einsum("ij,kl->iklj", rdm1AO, rdm1AO)
                )
            out["rdm2AO"] = rdm2AO
            if not return_ao:
                out["rdm2MO"] = batched_mo_eri(rdm2AO[None],
                                               CmoT_S.T[None])[0]
            if return_lo:
                out["rdm2LO"] = batched_mo_eri(rdm2AO[None],
                                               CloT_S.T[None])[0]
        if not only_rdm2:
            rdm1AO = 0.5 * (rdm1AO + rdm1AO.T)
            out["rdm1AO"] = rdm1AO
            out["rdm1MO"] = CmoT_S @ rdm1AO @ CmoT_S.T
            out["rdm1LO"] = CloT_S @ rdm1AO @ CloT_S.T
        if return_RDM2 and print_energy:
            Eh1 = float((torch.as_tensor(self.hcore, device=dev)
                         * rdm1AO).sum())
            E2 = 0.5 * float((self.mf.get_eri_dev() * rdm2AO).sum())
            E_tot = Eh1 + E2 + self.E_core + self.enuc
            print(f" 1-elec E : {Eh1:.8f} Ha; 2-elec E : {E2:.8f} Ha; "
                  f"E_BE : {E_tot:.8f} Ha")
        if only_rdm1:
            names = ("rdm1AO",) if return_ao else ("rdm1MO",)
        elif only_rdm2:
            names = ("rdm2AO",) if return_ao else ("rdm2MO",)
        elif return_lo:
            names = (("rdm1AO", "rdm2AO") if return_ao
                     else ("rdm1MO", "rdm2MO")) + ("rdm1LO", "rdm2LO")
        else:
            names = ("rdm1AO", "rdm2AO") if return_ao \
                else ("rdm1MO", "rdm2MO")
        res = tuple(out[k].cpu().numpy() for k in names)
        return res[0] if len(res) == 1 else res

    def compute_energy_full(
        self,
        approx_cumulant: bool = False,
        use_full_rdm: bool = False,
        return_rdm: bool = True,
    ):
        """Total energy from the reassembled full-basis RDMs (reference
        ``molbe/mbe.py:703 compute_energy_full``; the JAX method's
        expressions), on ``self.device``: one J/K build of the mean
        field's AO ERI (``chem/scf.py:get_jk``) over the reassembled
        density and the cumulant traced against the same ERI.  Sets
        ``ebe_tot``: the approximate-cumulant energy on top of the BE-HF
        energy, or with ``approx_cumulant=False`` the expression with
        every potential built from the reassembled density.

        The JAX method reassembles the pure cumulant twice, once beside
        the LO RDMs and once under ``only_rdm2``; both are the same sum,
        so it is built once here.  ``use_full_rdm`` is accepted and, as
        there, not read.
        """
        dev = self.device
        dm1, cum2 = self._rdms_ao(with_rdm2=True, strip_mf=False)
        dm1 = 0.5 * (dm1 + dm1.T)
        cum2 = 0.5 * (cum2 + cum2.permute(3, 2, 1, 0))
        eri = self.mf.get_eri_dev()
        vj, vk = get_jk(eri, dm1)
        veff = vj - 0.5 * vk
        e_cum = float((eri * cum2).sum())
        hcore = torch.as_tensor(self.hcore, device=dev)
        d_dm = dm1 - torch.as_tensor(self.hf_dm, device=dev)
        e_approx = self.ebe_hf + float(
            (hcore * d_dm).sum()
            + (torch.as_tensor(self.hf_veff, device=dev) * d_dm).sum()
        ) + 0.5 * e_cum
        self.ebe_tot = e_approx
        if not approx_cumulant:
            e_true = (
                float((hcore * dm1).sum())
                + 0.5 * float((veff * dm1).sum())
                + 0.5 * e_cum
                + self.enuc
                + self.E_core
            )
            self.ebe_tot = e_true
            logger.info(
                f"E_BE(true) = {e_true:.8f} Ha, approx = {e_approx:.8f} Ha"
            )
        else:
            logger.info(f"E_BE(approx) = {e_approx:.8f} Ha")
        if not return_rdm:
            return None
        rdm2_full = (torch.einsum("ij,kl->ijkl", dm1, dm1)
                     - 0.5 * torch.einsum("ij,kl->iklj", dm1, dm1) + cum2)
        return dm1.cpu().numpy(), rdm2_full.cpu().numpy()
