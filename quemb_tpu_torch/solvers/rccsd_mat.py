"""Fused-matrix closed-shell RCCSD update, batched over fragments.

JAX counterpart: ``quemb_tpu/solvers/rccsd_mat.py``.  Every contraction
runs over fused composite indices -- [no^2, nv^2] pair layouts and
[no*nv, no*nv] ring layouts -- so the update is a chain of batched matrix
products.  Where the JAX module is written for one fragment and vmapped,
every tensor here carries the fragment axis first; ``_p(x, *perm)``
permutes the axes behind it.
"""

from __future__ import annotations

import torch

RBLOCK_KEYS = (
    "Vp", "VpX", "G_me_nf", "G_me_fn", "GT_me_nf", "GTmnf_e", "GTm_nef",
    "A1_mf_ae", "E1_mef_a", "F1_mne_i", "OO12_mi_ne", "D12_ia_nf",
    "OOOV_mni_e", "OONV_mnj_e", "Op", "Wp", "G1_m_aef", "G2_m_bef",
    "OVVV_mbe_f", "OVVVx_mbe_f", "OONJ_mej_n", "OOJE_mej_n",
    "GOVVO_me_jb", "GOVOV_me_jb", "GV_e_jba", "OO_m_ijb",
)


def _p(x: torch.Tensor, *perm: int) -> torch.Tensor:
    """Permute the axes after the leading batch axis."""
    return x.permute(0, *(p + 1 for p in perm))


def _T(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


def rccsd_fused_blocks(eri_mo: torch.Tensor, no: int) -> dict:
    """Fused 2-D operand layouts from chemist MO ERIs (pq|rs) [nf, nmo]^4.

    Convention: g[p,q,r,s] = <pq|rs> physicist.  ``_p(x, *p)`` places
    source axis ``p[k]`` at target axis ``k`` (behind the batch axis).
    """
    nf, nmo = eri_mo.shape[0], eri_mo.shape[1]
    nv = nmo - no
    g = _p(eri_mo, 0, 2, 1, 3)
    o = slice(0, no)
    v = slice(no, None)
    goovv = g[:, o, o, v, v]
    govvv = g[:, o, v, v, v]
    gooov = g[:, o, o, o, v]
    goooo = g[:, o, o, o, o]
    gvvvv = g[:, v, v, v, v]
    govov = g[:, o, v, o, v]
    govvo = g[:, o, v, v, o]

    def r(x, *shape):
        return x.reshape(nf, *shape)

    G_me_nf = r(_p(goovv, 0, 2, 1, 3), no * nv, no * nv)
    G_me_fn = r(_p(goovv, 0, 3, 1, 2), no * nv, no * nv)
    gt = 2.0 * goovv - _p(goovv, 0, 1, 3, 2)
    return dict(
        Vp=r(goovv, no * no, nv * nv),
        VpX=r(_p(goovv, 0, 1, 3, 2), no * no, nv * nv),
        G_me_nf=G_me_nf,
        G_me_fn=G_me_fn,
        GT_me_nf=2.0 * G_me_nf - G_me_fn,
        # [(m,n,f),e] = 2 g[m,n,e,f] - g[m,n,f,e]
        GTmnf_e=r(_p(gt, 0, 1, 3, 2), no * no * nv, nv),
        GTm_nef=r(gt, no, no * nv * nv),
        # [(m,f),(a,e)] = 2 g[m,a,f,e] - g[m,a,e,f]
        A1_mf_ae=r(
            2.0 * _p(govvv, 0, 2, 1, 3) - _p(govvv, 0, 3, 1, 2),
            no * nv, nv * nv,
        ),
        # [(m,e,f),a] = 2 g[m,a,f,e] - g[m,a,e,f]
        E1_mef_a=r(
            2.0 * _p(govvv, 0, 3, 2, 1) - _p(govvv, 0, 2, 3, 1),
            no * nv * nv, nv,
        ),
        # [(m,n,e),i] = g[m,n,e,i] - 2 g[m,n,i,e]; g[m,n,e,i]=gooov[n,m,i,e]
        F1_mne_i=r(
            _p(gooov, 1, 0, 3, 2) - 2.0 * _p(gooov, 0, 1, 3, 2),
            no * no * nv, no,
        ),
        # [(m,i),(n,e)] = 2 g[m,n,i,e] - g[n,m,i,e]
        OO12_mi_ne=r(
            2.0 * _p(gooov, 0, 2, 1, 3) - _p(gooov, 1, 2, 0, 3),
            no * no, no * nv,
        ),
        # [(i,a),(n,f)] = -g[n,a,i,f] + 2 g[n,a,f,i]
        D12_ia_nf=r(
            -_p(govov, 2, 1, 0, 3) + 2.0 * _p(govvo, 3, 1, 0, 2),
            no * nv, no * nv,
        ),
        OOOV_mni_e=r(gooov, no * no * no, nv),
        # [(m,n,j),e] = g[m,n,e,j] = gooov[n,m,j,e]
        OONV_mnj_e=r(_p(gooov, 1, 0, 2, 3), no * no * no, nv),
        Op=r(goooo, no * no, no * no),
        Wp=r(gvvvv, nv * nv, nv * nv),
        # [m,(a,e,f)] = g[a,m,e,f] = g[m,a,f,e]
        G1_m_aef=r(_p(govvv, 0, 1, 3, 2), no, nv * nv * nv),
        G2_m_bef=r(govvv, no, nv * nv * nv),
        OVVV_mbe_f=r(govvv, no * nv * nv, nv),
        # [(m,b,e),f] = g[m,b,f,e]
        OVVVx_mbe_f=r(_p(govvv, 0, 1, 3, 2), no * nv * nv, nv),
        # [(m,e,j),n] = g[m,n,e,j] (src gooov[n,m,j,e])
        OONJ_mej_n=r(_p(gooov, 1, 3, 2, 0), no * nv * no, no),
        # [(m,e,j),n] = g[m,n,j,e]
        OOJE_mej_n=r(_p(gooov, 0, 3, 2, 1), no * nv * no, no),
        # [(m,e),(j,b)] ring operands: g[m,b,e,j] / g[m,b,j,e]
        GOVVO_me_jb=r(_p(govvo, 0, 2, 3, 1), no * nv, no * nv),
        GOVOV_me_jb=r(_p(govov, 0, 3, 2, 1), no * nv, no * nv),
        # [e,(j,b,a)] = g[a,b,e,j] = govvv[j,e,b,a]
        GV_e_jba=r(_p(govvv, 1, 0, 2, 3), nv, no * nv * nv),
        # [m,(i,j,b)] = g[m,b,i,j] = gooov[i,j,m,b]
        OO_m_ijb=r(_p(gooov, 2, 0, 1, 3), no, no * no * nv),
    )


def _r_to_p(Xr, no, nv):
    """[(i,a),(j,b)] ring -> [(i,j),(a,b)] pair layout."""
    nf = Xr.shape[0]
    return _p(Xr.reshape(nf, no, nv, no, nv), 0, 2, 1, 3).reshape(
        nf, no * no, nv * nv
    )


def _cross_to_p(Xc, no, nv):
    """[(j,a),(i,b)] cross layout -> [(i,j),(a,b)] pair layout."""
    nf = Xc.shape[0]
    return _p(Xc.reshape(nf, no, nv, no, nv), 2, 0, 1, 3).reshape(
        nf, no * no, nv * nv
    )


def rccsd_update_mat(t1, T2p, moe_o, moe_v, fb: dict):
    """One closed-shell CCSD update in fused-matrix form (canonical MOs).

    t1: [nf, no, nv]; T2p: [nf, no^2, nv^2] pair layout of the mixed-spin
    t2; moe_o [nf, no], moe_v [nf, nv].  Returns (t1new, T2p_new, e_corr).
    """
    nf, no, nv = t1.shape
    t1f = t1.reshape(nf, no * nv, 1)
    T4 = T2p.reshape(nf, no, no, nv, nv)
    t1T = _T(t1)

    # tau in P layout: Kk[(ij),(ab)] = t1[i,a] t1[j,b]
    Kk = torch.einsum("zia,zjb->zijab", t1, t1).reshape(nf, no * no, nv * nv)
    tau_h = T2p + 0.5 * Kk
    tau = T2p + Kk
    tau_h4 = tau_h.reshape(nf, no, no, nv, nv)

    # ---- F intermediates
    Fvv = (_T(t1f) @ fb["A1_mf_ae"]).reshape(nf, nv, nv) - (
        _T(_p(tau_h4, 0, 1, 3, 2).reshape(nf, no * no * nv, nv))
        @ fb["GTmnf_e"]
    )
    Foo = (fb["OO12_mi_ne"] @ t1f).reshape(nf, no, no) + (
        fb["GTm_nef"] @ _T(tau_h.reshape(nf, no, no * nv * nv))
    )
    Fov = (fb["GT_me_nf"] @ t1f).reshape(nf, no, nv)

    # ---- T1
    T2r = _p(T4, 0, 2, 1, 3).reshape(nf, no * nv, no * nv)
    T2c = _p(T4, 0, 3, 1, 2).reshape(nf, no * nv, no * nv)
    t1new = (
        t1 @ _T(Fvv)
        - _T(Foo) @ t1
        + ((2.0 * T2r - T2c) @ Fov.reshape(nf, -1, 1)).reshape(nf, no, nv)
        + (fb["D12_ia_nf"] @ t1f).reshape(nf, no, nv)
        + T2p.reshape(nf, no, no * nv * nv) @ fb["E1_mef_a"]
        + _T(
            _T(_p(T4, 0, 1, 3, 2).reshape(nf, no * no * nv, nv))
            @ fb["F1_mne_i"]
        )
    )

    # ---- W intermediates
    # Wmix [(mn),(ij)]
    H1 = (fb["OOOV_mni_e"] @ t1T).reshape(nf, no * no, no * no)
    H2 = _p(
        (fb["OONV_mnj_e"] @ t1T).reshape(nf, no * no, no, no), 0, 2, 1
    ).reshape(nf, no * no, no * no)
    Wmix = fb["Op"] + H1 + H2 + 0.5 * _T(tau @ _T(fb["Vp"]))

    # Wvmix [(ab),(ef)]
    E1t = _p(
        (t1T @ fb["G1_m_aef"]).reshape(nf, nv, nv, nv * nv), 1, 0, 2
    ).reshape(nf, nv * nv, nv * nv)
    E2t = (t1T @ fb["G2_m_bef"]).reshape(nf, nv * nv, nv * nv)
    Wvmix = fb["Wp"] - E1t - E2t + 0.5 * (_T(tau) @ fb["Vp"])

    # ring quadratic amplitude layouts [(n,f),(j,b)]
    T2q1 = _p(T4, 1, 2, 0, 3).reshape(nf, no * nv, no * nv)
    T2q2 = _p(T4, 1, 3, 0, 2).reshape(nf, no * nv, no * nv)
    # X2p[(n,f),(j,b)] = t1[j,f] t1[n,b]
    X2p = torch.einsum("znb,zjf->znfjb", t1, t1).reshape(
        nf, no * nv, no * nv
    )

    def ring_d1(A):
        # [(m,b,e),f] @ t1^T -> [(m,e),(j,b)]
        return _p((A @ t1T).reshape(nf, no, nv, nv, no), 0, 2, 3, 1).reshape(
            nf, no * nv, no * nv
        )

    # W1 [(m,e),(j,b)]
    d1 = ring_d1(fb["OVVV_mbe_f"])
    d2 = (fb["OONJ_mej_n"] @ t1).reshape(nf, no * nv, no * nv)
    W1 = (
        fb["GOVVO_me_jb"]
        + d1
        - d2
        + fb["G_me_nf"] @ (-0.5 * T2q1 + T2q2 - X2p)
        - 0.5 * (fb["G_me_fn"] @ T2q2)
    )

    # W2 [(m,e),(j,b)]
    d1b = ring_d1(fb["OVVV_mbe_f"] - fb["OVVVx_mbe_f"])
    d2b = ((fb["OOJE_mej_n"] - fb["OONJ_mej_n"]) @ t1).reshape(
        nf, no * nv, no * nv
    )
    W2 = (
        fb["GOVVO_me_jb"]
        - fb["GOVOV_me_jb"]
        + d1b
        + d2b
        - (fb["G_me_nf"] - fb["G_me_fn"]) @ (0.5 * (T2q1 - T2q2) + X2p)
        + 0.5 * (fb["G_me_nf"] @ T2q2)
    )

    # W3 [(m,e),(i,b)]
    d1c = ring_d1(fb["OVVVx_mbe_f"])
    d2c = (fb["OOJE_mej_n"] @ t1).reshape(nf, no * nv, no * nv)
    W3 = -fb["GOVOV_me_jb"] - d1c + d2c + fb["G_me_fn"] @ (0.5 * T2q1 + X2p)

    # ---- T2
    FF = Fvv - 0.5 * (t1T @ Fov)
    FFo = Foo + 0.5 * (Fov @ t1T)
    S = (T2p.reshape(nf, no * no * nv, nv) @ _T(FF)).reshape(
        nf, no * no, nv * nv
    )
    S = S - torch.einsum(
        "zimx,zmj->zijx", T4.reshape(nf, no, no, nv * nv), FFo
    ).reshape(nf, no * no, nv * nv)
    # rings
    A_r = T2r - T2c
    S = S + _r_to_p(A_r @ W1 + T2r @ W2, no, nv)
    S = S + _cross_to_p(T2c @ W3, no, nv)
    # -(t1 t1 <|>) ring pieces
    X2r = torch.einsum("zie,zma->ziame", t1, t1).reshape(
        nf, no * nv, no * nv
    )
    S = S - _r_to_p(X2r @ fb["GOVVO_me_jb"], no, nv)
    S = S - _cross_to_p(X2r @ fb["GOVOV_me_jb"], no, nv)
    # one-particle dressed: +t1[i,e] g[a,b,e,j]  and  -t1[m,a] g[m,b,i,j]
    S = S + _p(
        (t1 @ fb["GV_e_jba"]).reshape(nf, no, no, nv, nv), 0, 1, 3, 2
    ).reshape(nf, no * no, nv * nv)
    S = S - _p(
        (t1T @ fb["OO_m_ijb"]).reshape(nf, nv, no, no, nv), 1, 2, 0, 3
    ).reshape(nf, no * no, nv * nv)

    Ssym = _p(S.reshape(nf, no, no, nv, nv), 1, 0, 3, 2).reshape(
        nf, no * no, nv * nv
    )
    T2new = fb["Vp"] + S + Ssym + _T(Wmix) @ tau + tau @ _T(Wvmix)

    # ---- denominators
    Dov = moe_o[:, :, None] - moe_v[:, None, :]
    Doo = (moe_o[:, :, None] + moe_o[:, None, :]).reshape(nf, -1)
    Dvv = (moe_v[:, :, None] + moe_v[:, None, :]).reshape(nf, -1)
    t1new = t1new / Dov
    T2new = T2new / (Doo[:, :, None] - Dvv[:, None, :])

    e_corr = (tau * (2.0 * fb["Vp"] - fb["VpX"])).sum((1, 2))
    return t1new, T2new, e_corr
