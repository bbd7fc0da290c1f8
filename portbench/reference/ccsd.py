"""Closed-shell CCSD through the spin-orbital equations.

The amplitude equations are those of Stanton, Gauss, Watts and Bartlett,
J. Chem. Phys. 94, 4334 (1991), in spin orbitals built from the spatial
MO integrals, iterated with DIIS from the MP2 amplitudes.  The spatial
amplitudes returned are t1[i, a] = t(i alpha -> a alpha) and t2[i, j, a,
b] = t(i alpha, j beta -> a alpha, b beta).  float64 throughout.
"""

from __future__ import annotations

import torch

es = torch.einsum


def _spin_integrals(eri_mo, nocc: int):
    """Antisymmetrized <pq||rs> over spin orbitals p = 2 x spatial + spin,
    occupied first: (oooo, ooov, oovv, ovov, ovvv, vvvv) blocks."""
    n = eri_mo.shape[0]
    dev = eri_mo.device
    ph = eri_mo.permute(0, 2, 1, 3)                   # <pq|rs> = (pr|qs)
    occ = torch.arange(2 * nocc, device=dev)
    vir = torch.arange(2 * nocc, 2 * n, device=dev)

    def so(idx):
        return idx // 2, idx % 2

    def block(a, b, c, d):
        (pa, sa), (pb, sb), (pc, sc), (pd, sd) = so(a), so(b), so(c), so(d)

        def direct(pc, sc, pd, sd):
            g = ph[pa][:, pb][:, :, pc][:, :, :, pd]
            m = ((sa[:, None, None, None] == sc[None, None, :, None])
                 & (sb[None, :, None, None] == sd[None, None, None, :]))
            return g * m
        return direct(pc, sc, pd, sd) - direct(pd, sd, pc, sc).transpose(2, 3)

    o, v = occ, vir
    return dict(oooo=block(o, o, o, o), ooov=block(o, o, o, v),
                oovv=block(o, o, v, v), ovov=block(o, v, o, v),
                ovvv=block(o, v, v, v), vvvv=block(v, v, v, v))


def _update(t1, t2, f_o, f_v, I):
    """One Jacobi step of the amplitude equations (diagonal Fock)."""
    oooo, ooov, oovv = I["oooo"], I["ooov"], I["oovv"]
    ovov, ovvv, vvvv = I["ovov"], I["ovvv"], I["vvvv"]
    tau_t = t2 + 0.5 * (es("ia,jb->ijab", t1, t1) - es("ib,ja->ijab", t1, t1))
    tau = t2 + es("ia,jb->ijab", t1, t1) - es("ib,ja->ijab", t1, t1)

    Fae = (es("mf,mafe->ae", t1, ovvv)
           - 0.5 * es("mnaf,mnef->ae", tau_t, oovv))
    Fmi = (es("ne,mnie->mi", t1, ooov)
           + 0.5 * es("inef,mnef->mi", tau_t, oovv))
    Fme = es("nf,mnef->me", t1, oovv)
    Wmnij = (oooo + es("je,mnie->mnij", t1, ooov)
             - es("ie,mnje->mnij", t1, ooov)
             + 0.25 * es("ijef,mnef->mnij", tau, oovv))
    # <mb||ej> = -<mb||je>, <mn||ej> = -<mn||je>
    Wmbej = (-ovov.permute(0, 1, 3, 2) + es("jf,mbef->mbej", t1, ovvv)
             + es("nb,mnje->mbej", t1, ooov)
             - es("jnfb,mnef->mbej", 0.5 * t2 + es("jf,nb->jnfb", t1, t1),
                  oovv))

    # T1; <na||if> = ovov[n, a, i, f], <nm||ei> = -<nm||ie>
    r1 = (es("ie,ae->ia", t1, Fae) - es("ma,mi->ia", t1, Fmi)
          + es("imae,me->ia", t2, Fme) - es("nf,naif->ia", t1, ovov)
          - 0.5 * es("imef,maef->ia", t2, ovvv)
          + 0.5 * es("mnae,nmie->ia", t2, ooov))

    # T2
    Fbe_t = Fae - 0.5 * es("mb,me->be", t1, Fme)
    Fmj_t = Fmi + 0.5 * es("je,me->mj", t1, Fme)
    r2 = oovv.clone()
    x = es("ijae,be->ijab", t2, Fbe_t)
    r2 = r2 + x - x.transpose(2, 3)
    x = es("imab,mj->ijab", t2, Fmj_t)
    r2 = r2 - x + x.transpose(0, 1)
    r2 = r2 + 0.5 * es("mnab,mnij->ijab", tau, Wmnij)
    # 1/2 tau_ijef W_abef, W_abef = <ab||ef> - P(ab) t_mb <am||ef>
    # + 1/4 tau_mnab <mn||ef>, without forming W_abef; <am||ef> = -<ma||ef>
    r2 = r2 + 0.5 * es("ijef,abef->ijab", tau, vvvv)
    x = 0.5 * es("ijma,mb->ijab", es("ijef,maef->ijma", tau, ovvv), t1)
    r2 = r2 + x - x.transpose(2, 3)
    r2 = r2 + 0.125 * es("mnab,ijmn->ijab", tau,
                         es("ijef,mnef->ijmn", tau, oovv))
    # -<mb||ej> = <mb||je>
    x = (es("imae,mbej->ijab", t2, Wmbej)
         + es("ie,ma,mbje->ijab", t1, t1, ovov))
    r2 = r2 + x - x.transpose(0, 1) - x.transpose(2, 3) \
        + x.transpose(0, 1).transpose(2, 3)
    # <ab||ej> = <ej||ab> = -<je||ab>
    x = -es("ie,jeab->ijab", t1, ovvv)
    r2 = r2 + x - x.transpose(0, 1)
    # <mb||ij> = <ij||mb>
    x = es("ma,ijmb->ijab", t1, ooov)
    r2 = r2 - x + x.transpose(2, 3)

    d1 = f_o[:, None] - f_v[None, :]
    d2 = d1[:, None, :, None] + d1[None, :, None, :]
    return r1 / d1, r2 / d2


def _energy(t1, t2, oovv):
    return float(0.25 * (oovv * t2).sum()
                 + 0.5 * es("ijab,ia,jb->", oovv, t1, t1))


def rccsd(eri_mo, moe, nocc: int, tol: float = 1e-10, max_cycle: int = 300,
          diis_space: int = 8):
    """CCSD of a closed-shell fragment in its canonical orbitals.

    eri_mo [n]^4 (chemist), moe [n], float64 tensors.  Returns spatial
    (t1 [no, nv], t2 [no, no, nv, nv], e_corr, n_iter, max|dt|)."""
    I = _spin_integrals(eri_mo, nocc)
    f = moe.repeat_interleave(2)
    f_o, f_v = f[: 2 * nocc], f[2 * nocc:]
    d1 = f_o[:, None] - f_v[None, :]
    d2 = d1[:, None, :, None] + d1[None, :, None, :]
    t1 = torch.zeros_like(d1)
    t2 = I["oovv"] / d2
    hist_t, hist_e = [], []
    delta = float("inf")
    for it in range(1, max_cycle + 1):
        n1, n2 = _update(t1, t2, f_o, f_v, I)
        new = torch.cat([n1.reshape(-1), n2.reshape(-1)])
        old = torch.cat([t1.reshape(-1), t2.reshape(-1)])
        delta = float((new - old).abs().max())
        hist_t.append(new)
        hist_e.append(new - old)
        hist_t, hist_e = hist_t[-diis_space:], hist_e[-diis_space:]
        if len(hist_t) > 1:
            m = len(hist_t)
            E = torch.stack(hist_e)
            B = torch.zeros((m + 1, m + 1), dtype=E.dtype, device=E.device)
            B[:m, :m] = E @ E.T
            B[:m, m] = B[m, :m] = -1.0
            rhs = torch.zeros(m + 1, dtype=E.dtype, device=E.device)
            rhs[m] = -1.0
            c = torch.linalg.lstsq(B.cpu(), rhs.cpu()[:, None]).solution
            new = (c[:m, 0].to(E.device)[:, None]
                   * torch.stack(hist_t)).sum(0)
        t1 = new[: t1.numel()].reshape(t1.shape)
        t2 = new[t1.numel():].reshape(t2.shape)
        if delta < tol:
            break
    e = _energy(t1, t2, I["oovv"])
    return (t1[0::2, 0::2].clone(), t2[0::2, 1::2, 0::2, 1::2].clone(), e,
            it, delta)
