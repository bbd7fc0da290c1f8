"""Matrix-form spin-orbital CCSD update, batched over fragments.

JAX counterpart: ``quemb_tpu/solvers/ccsd_mat.py``.  Mathematically
identical to :func:`quemb_tpu_torch.solvers.ccsd._ccsd_update` (the SGWB
equations), but every large contraction runs over fused composite indices
-- [no^2, nv^2] pair layouts and [no*nv, no*nv] ring layouts -- so the
update is a short chain of batched matrix products.  Where the JAX module
is written for one fragment and vmapped, every tensor here carries the
fragment axis first (a single fragment is a batch of one); ``_p(x,
*perm)`` permutes the axes behind it.  Nothing is written in place, so
``torch.func`` can differentiate the update (the relaxed densities of
:mod:`quemb_tpu_torch.solvers.ccsd_relaxed`).
"""

from __future__ import annotations

import torch

from quemb_tpu_torch.solvers.rccsd_mat import _p, _T

BLOCK_KEYS = (
    "Vp", "M_me_nf", "V_mnf_e", "V_m_nef", "A_mf_ae", "B_mef_a",
    "C_mbe_f", "D_m_bef", "G2_mni_e", "K_mi_ne", "Q_i_mne", "R1_mje_n",
    "O_mn_ij", "V4_ab_ef", "S1_ia_nf", "ovvo_r", "ovoo_m_bij", "V2_e_abj",
)


def fused_blocks(blocks: dict, no: int, nv: int) -> dict:
    """Fuse the 9 antisymmetrized 4-D blocks [nf, ...] into 2-D operand
    layouts [nf, rows, cols]."""
    oovv = blocks["oovv"]
    ovvv = blocks["ovvv"]
    ooov = blocks["ooov"]
    nf = oovv.shape[0]

    def r(x, *shape):
        return x.reshape(nf, *shape)

    return dict(
        Vp=r(oovv, no * no, nv * nv),
        M_me_nf=r(_p(oovv, 0, 2, 1, 3), no * nv, no * nv),
        V_mnf_e=r(_p(oovv, 0, 1, 3, 2), no * no * nv, nv),
        V_m_nef=r(oovv, no, no * nv * nv),
        A_mf_ae=r(_p(ovvv, 0, 2, 1, 3), no * nv, nv * nv),
        B_mef_a=r(_p(ovvv, 0, 2, 3, 1), no * nv * nv, nv),
        C_mbe_f=r(ovvv, no * nv * nv, nv),
        D_m_bef=r(ovvv, no, nv * nv * nv),
        G2_mni_e=r(ooov, no * no * no, nv),
        K_mi_ne=r(_p(ooov, 0, 2, 1, 3), no * no, no * nv),
        Q_i_mne=r(_p(ooov, 2, 1, 0, 3), no, no * no * nv),
        R1_mje_n=r(_p(ooov, 0, 2, 3, 1), no * no * nv, no),
        O_mn_ij=r(blocks["oooo"], no * no, no * no),
        V4_ab_ef=r(blocks["vvvv"], nv * nv, nv * nv),
        S1_ia_nf=r(_p(blocks["ovov"], 2, 1, 0, 3), no * nv, no * nv),
        ovvo_r=r(_p(blocks["ovvo"], 0, 2, 3, 1), no * nv, no * nv),
        ovoo_m_bij=r(blocks["ovoo"], no, nv * no * no),
        V2_e_abj=r(_p(blocks["vvvo"], 2, 0, 1, 3), nv, nv * nv * no),
    )


def _p_to_r(Xp, no, nv):
    """[nf, no^2, nv^2] (ij),(ab) -> [nf, no*nv, no*nv] (ia),(jb)."""
    nf = Xp.shape[0]
    return _p(Xp.reshape(nf, no, no, nv, nv), 0, 2, 1, 3).reshape(
        nf, no * nv, no * nv
    )


def _r_to_p(Xr, no, nv):
    nf = Xr.shape[0]
    return _p(Xr.reshape(nf, no, nv, no, nv), 0, 2, 1, 3).reshape(
        nf, no * no, nv * nv
    )


def _P_ab(Xp, no, nv):
    """Antisymmetrize the (a,b) pair of a P-layout matrix."""
    X4 = Xp.reshape(-1, no * no, nv, nv)
    return (X4 - _T(X4)).reshape(-1, no * no, nv * nv)


def _P_ij(Xp, no, nv):
    X4 = Xp.reshape(-1, no, no, nv * nv)
    return (X4 - X4.transpose(1, 2)).reshape(-1, no * no, nv * nv)


def ccsd_update_mat(t1, T2p, moe_o, moe_v, fb: dict, f_oo_off=None,
                    f_ov=None, f_vv_off=None):
    """One CCSD amplitude update in fused-matrix form.

    t1: [nf, no, nv]; T2p: [nf, no^2, nv^2] pair layout; moe_o [nf, no],
    moe_v [nf, nv].  ``f_*`` are the one-particle Fock blocks [nf, ...]
    (off-diagonal parts for oo/vv, the full ov block); None for canonical
    orbitals.  Returns (t1new, T2p_new, e_corr [nf]).
    """
    nf, no, nv = t1.shape
    t1f = t1.reshape(nf, no * nv, 1)
    t1T = _T(t1)
    T4 = T2p.reshape(nf, no, no, nv, nv)

    # tau matrices (P layout): Kk[(ij),(ab)] = t1[i,a] t1[j,b]
    Kk = torch.einsum("zia,zjb->zijab", t1, t1)
    t1t1 = (Kk - _p(Kk, 0, 1, 3, 2)).reshape(nf, no * no, nv * nv)
    tau_t = T2p + 0.5 * t1t1
    tau = T2p + t1t1

    # --- F intermediates
    Fae = (_T(t1f) @ fb["A_mf_ae"]).reshape(nf, nv, nv) - 0.5 * (
        _T(_p(tau_t.reshape(nf, no, no, nv, nv), 0, 1, 3, 2).reshape(
            nf, no * no * nv, nv
        )) @ fb["V_mnf_e"]
    )
    Fmi = (fb["K_mi_ne"] @ t1f).reshape(nf, no, no) + 0.5 * (
        fb["V_m_nef"] @ _T(tau_t.reshape(nf, no, no * nv * nv))
    )
    Fme = (fb["M_me_nf"] @ t1f).reshape(nf, no, nv)
    if f_ov is not None:
        Fae = Fae + _T(f_vv_off) - 0.5 * _T(_T(f_ov) @ t1)
        Fmi = Fmi + f_oo_off + 0.5 * _T(t1 @ _T(f_ov))
        Fme = Fme + f_ov

    # --- W intermediates
    # Wmnij [(mn),(ij)]
    G2t = fb["G2_mni_e"] @ t1T  # [(m,n,i),j]
    H1 = G2t.reshape(nf, no * no, no * no)
    H2 = _p(G2t.reshape(nf, no * no, no, no), 0, 2, 1).reshape(
        nf, no * no, no * no
    )
    Wmnij = fb["O_mn_ij"] + H1 - H2 + 0.25 * _T(tau @ _T(fb["Vp"]))
    # Wabef [(ab),(ef)]
    E1 = (t1T @ fb["D_m_bef"]).reshape(nf, nv, nv, nv * nv)  # [b,a,(ef)]
    Wabef = (
        fb["V4_ab_ef"]
        + _p(E1, 1, 0, 2).reshape(nf, nv * nv, nv * nv)
        - E1.reshape(nf, nv * nv, nv * nv)
        + 0.25 * (_T(tau) @ fb["Vp"])
    )
    # Wmbej ring [(me),(jb)]
    W1b = _p(
        (fb["C_mbe_f"] @ t1T).reshape(nf, no, nv, nv, no),  # [m,b,e,j]
        0, 2, 3, 1,
    ).reshape(nf, no * nv, no * nv)
    W2 = _p(
        (fb["R1_mje_n"] @ t1).reshape(nf, no, no, nv, nv),  # [m,j,e,b]
        0, 2, 1, 3,
    ).reshape(nf, no * nv, no * nv)
    # tt[(nf),(jb)] with tt = 0.5 t2 + t1 x t1 (plain outer)
    T2_r2 = _p(T4, 1, 2, 0, 3).reshape(nf, no * nv, no * nv)  # [n,f,j,b]
    t1o_r2 = torch.einsum("zjf,znb->znfjb", t1, t1).reshape(
        nf, no * nv, no * nv
    )
    Wmbej = fb["ovvo_r"] + W1b + W2 - fb["M_me_nf"] @ (0.5 * T2_r2 + t1o_r2)

    # --- T1 equation
    T2r = _p_to_r(T2p, no, nv)  # [(ia),(me)]
    t1new = (
        t1 @ _T(Fae)
        - _T(Fmi) @ t1
        + (T2r @ Fme.reshape(nf, no * nv, 1)).reshape(nf, no, nv)
        - (fb["S1_ia_nf"] @ t1f).reshape(nf, no, nv)
        - 0.5 * (T2p.reshape(nf, no, no * nv * nv) @ fb["B_mef_a"])
        + 0.5 * (
            fb["Q_i_mne"]
            @ _p(T4, 0, 1, 3, 2).reshape(nf, no * no * nv, nv)
        )
    )
    if f_ov is not None:
        t1new = t1new + f_ov

    # --- T2 equation
    FF_b = Fae - 0.5 * t1T @ Fme
    T2new = fb["Vp"] + _P_ab(
        (T2p.reshape(nf, no * no * nv, nv) @ _T(FF_b)).reshape(
            nf, no * no, nv * nv
        ),
        no, nv,
    )
    FF_m = Fmi + 0.5 * Fme @ t1T  # [m,j]
    T2new = T2new - _P_ij(
        torch.einsum(
            "zimx,zmj->zijx", T2p.reshape(nf, no, no, nv * nv), FF_m
        ).reshape(nf, no * no, nv * nv),
        no, nv,
    )
    T2new = T2new + 0.5 * (_T(Wmnij) @ tau)
    T2new = T2new + 0.5 * (tau @ _T(Wabef))
    # ring contributions
    X2 = torch.einsum("zie,zma->ziame", t1, t1).reshape(nf, no * nv, no * nv)
    Rring = T2r @ Wmbej - X2 @ fb["ovvo_r"]
    T2new = T2new + _P_ij(_P_ab(_r_to_p(Rring, no, nv), no, nv), no, nv)
    # one-particle dressed integrals
    W3 = _p(
        (t1 @ fb["V2_e_abj"]).reshape(nf, no, nv, nv, no),  # [i,a,b,j]
        0, 3, 1, 2,
    ).reshape(nf, no * no, nv * nv)
    T2new = T2new + _P_ij(W3, no, nv)
    U = _p(
        (t1T @ fb["ovoo_m_bij"]).reshape(nf, nv, nv, no, no),  # [a,b,i,j]
        2, 3, 0, 1,
    ).reshape(nf, no * no, nv * nv)
    T2new = T2new - _P_ab(U, no, nv)

    # denominators
    Dov = moe_o[:, :, None] - moe_v[:, None, :]
    Doo = (moe_o[:, :, None] + moe_o[:, None, :]).reshape(nf, -1)
    Dvv = (moe_v[:, :, None] + moe_v[:, None, :]).reshape(nf, -1)
    t1new = t1new / Dov
    T2new = T2new / (Doo[:, :, None] - Dvv[:, None, :])

    e_corr = 0.25 * (fb["Vp"] * tau).sum((1, 2))
    if f_ov is not None:
        e_corr = e_corr + (f_ov * t1).sum((1, 2))
    return t1new, T2new, e_corr
