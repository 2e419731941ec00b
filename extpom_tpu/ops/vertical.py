"""Implicit vertical solvers (Richtmyer-Morton tridiagonal sweeps).

* :func:`proft` — vertical diffusion of T or S with 4 surface-BC variants
  including Paulson-Simpson shortwave penetration (solver.f:1541-1683).
* :func:`profu`/:func:`profv` — vertical diffusion of momentum with wind
  stress surface BC and implicit quadratic bottom friction
  (solver.f:1686-1877).
* :func:`profq` — Mellor-Yamada level-2.5 closure: implicit q2/q2l solves,
  stability functions, and the km/kh/kq update (solver.f:1212-1538).

The Thomas forward elimination / back substitution is sequential in k but
batched over the whole (im, jm) slab: each ``lax.scan`` step is one
elementwise op over the horizontal plane (k is the leading axis).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from extpom_tpu.core.config import Config
from extpom_tpu.core.grid import Grid
from extpom_tpu.ops.stencil import sft, sfk, put, set_i, set_j, set_k, s_

# Paulson & Simpson (1977) irradiance parameters by Jerlov type
# (solver.f:1558-1563); index ntp-1.
_R_JERLOV = (0.58, 0.62, 0.67, 0.77, 0.78)
_AD1_JERLOV = (0.35, 0.60, 1.0, 1.5, 1.4)
_AD2_JERLOV = (23.0, 20.0, 17.0, 14.0, 7.9)


def _forward(a, c, den, r, ee0, gg0, k0, unroll: int = 1):
    """Forward elimination: for k >= k0,
    gg_ = 1/(a[k] + c[k]*(1-ee[k-1]) - den[k]); ee[k] = a[k]*gg_;
    gg[k] = (r[k] + c[k]*gg[k-1]) * gg_, with ee[k0-1]=ee0, gg[k0-1]=gg0.

    Returns full-kb (ee, gg) stacks; entries below k0-1 are zeros and
    ee[k0-1], gg[k0-1] are the seeds.
    """
    def body(carry, xs):
        eep, ggp = carry
        ak, ck, dk, rk = xs
        g_ = 1.0 / (ak + ck * (1.0 - eep) - dk)
        ee = ak * g_
        gg = (rk + ck * ggp) * g_
        return (ee, gg), (ee, gg)

    n = a.shape[0] - k0
    if unroll >= n:
        # full unroll: straight-line Python loop (identical association)
        ee, gg, ee_l, gg_l = ee0, gg0, [], []
        for k in range(k0, a.shape[0]):
            (ee, gg), _ = body((ee, gg), (a[k], c[k], den[k], r[k]))
            ee_l.append(ee)
            gg_l.append(gg)
        ees = jnp.stack(ee_l, axis=0)
        ggs = jnp.stack(gg_l, axis=0)
    else:
        (_, _), (ees, ggs) = lax.scan(
            body, (ee0, gg0), (a[k0:], c[k0:], den[k0:], r[k0:]),
            unroll=min(unroll, n) if unroll > 1 else 1)
    kb = a.shape[0]
    if k0 > 1:   # no zero-sized pad
        pad = jnp.zeros((k0 - 1,) + ee0.shape, ee0.dtype)
        lead = [pad, ee0[None]], [pad, gg0[None]]
    else:
        lead = [ee0[None]], [gg0[None]]
    ee = jnp.concatenate(lead[0] + [ees], axis=0)
    gg = jnp.concatenate(lead[1] + [ggs], axis=0)
    assert ee.shape[0] == kb
    return ee, gg


def _backward(ee, gg, f_last, k_last, unroll: int = 1):
    """Back substitution f[k] = ee[k]*f[k+1] + gg[k] for k = k_last-1 .. 0,
    seeded with f[k_last] = f_last.  Returns stack f[0..k_last]."""
    def body(fnext, xs):
        eek, ggk = xs
        fk = eek * fnext + ggk
        return fk, fk

    if unroll >= k_last:
        # full unroll (see _forward)
        f, fs = f_last, []
        for k in range(k_last - 1, -1, -1):
            f = ee[k] * f + gg[k]
            fs.append(f)
        fs = jnp.stack(fs[::-1], axis=0)
    else:
        _, fs = lax.scan(body, f_last, (ee[:k_last], gg[:k_last]),
                         reverse=True,
                         unroll=min(unroll, k_last) if unroll > 1 else 1)
    return jnp.concatenate([fs, f_last[None]], axis=0)


def _solve(cfg: Config, a, c, den, rhs, ee0, gg0, cl, rb, db, mask,
           k0: int, k_last: int):
    """One full vertical Thomas solve: forward elimination from the
    (ee0, gg0) seeds at k0-1, the closed-form bottom row

        f[k_last] = (cl gg[k_last-1] + rb) / (cl (1 - ee[k_last-1]) + db)
                    * mask,

    and back substitution to k=0 (each level * mask).  Returns the
    (kb, im, jm) stack with rows > k_last zeroed.  ``cfg.scan_unroll``
    picks the sweeps: a ``lax.scan`` pair, or straight-line code when it
    covers every level.
    """
    kb = a.shape[0]
    with jax.named_scope("thomas_solve"):
        ee, gg = _forward(a, c, den, rhs, ee0, gg0, k0, cfg.scan_unroll)
        f_last = ((cl * gg[k_last - 1] + rb)
                  / (cl * (1.0 - ee[k_last - 1]) + db))
        f = _backward(ee, gg, f_last, k_last, cfg.scan_unroll) * mask
        if k_last + 1 < kb:
            f = jnp.concatenate(
                [f, jnp.zeros((kb - k_last - 1,) + f.shape[1:], f.dtype)],
                axis=0)
    return f


def proft(grid: Grid, cfg: Config,
          f: jnp.ndarray, wfsurf: jnp.ndarray, fsurf: jnp.ndarray, nbc: int,
          kh: jnp.ndarray, etf: jnp.ndarray,
          swrad: jnp.ndarray) -> jnp.ndarray:
    """Implicit vertical diffusion of a tracer (solver.f:1541-1683).

    ``f`` enters as the post-advection field at time n+1 and leaves with the
    implicit vertical diffusion applied (layers 0..kb-2; the kb-1 ghost
    layer passes through).
    """
    h = grid.h
    dz, dzz = grid.dz3, grid.dzz3
    kb, kbm1, kbm2 = cfg.kb, cfg.kbm1, cfg.kbm2
    dh = h + etf
    z3 = jnp.zeros_like(f)

    # coefficient arrays (solver.f:1589-1598): a[k] couples k to k+1,
    # c[k] couples k to k-1
    kdif = kh + cfg.umol
    a = put(z3, (-cfg.dti2 * sfk(kdif, 1) / (dz * dzz * dh * dh)), *s_[:kbm2])
    c = put(z3, (-cfg.dti2 * kdif / (dz * sfk(dzz, -1) * dh * dh)), *s_[1:kbm1])

    # penetrative shortwave (solver.f:1600-1615)
    if nbc in (2, 4):
        r = _R_JERLOV[cfg.ntp - 1]
        ad1 = _AD1_JERLOV[cfg.ntp - 1]
        ad2 = _AD2_JERLOV[cfg.ntp - 1]
        rad = put(z3, (swrad * (r * jnp.exp(grid.z3 * dh / ad1)
                      + (1.0 - r) * jnp.exp(grid.z3 * dh / ad2))), *s_[:kbm1])
    else:
        rad = z3

    # surface boundary condition (solver.f:1617-1648)
    if nbc == 1:
        ee0 = a[0] / (a[0] - 1.0)
        gg0 = (cfg.dti2 * wfsurf / (dz[0] * dh) - f[0]) / (a[0] - 1.0)
    elif nbc == 2:
        ee0 = a[0] / (a[0] - 1.0)
        gg0 = (cfg.dti2 * (wfsurf + rad[0] - rad[1]) / (dz[0] * dh)
               - f[0]) / (a[0] - 1.0)
    elif nbc in (3, 4):
        ee0 = jnp.zeros_like(h)
        gg0 = fsurf
    else:
        raise ValueError(f"invalid nbc {nbc}")

    # forward elimination k=1..kbm2-1 + bottom adiabatic BC at k=kbm1
    # + back substitution (solver.f:1650-1680), as one fused solve
    den = jnp.ones_like(f)
    rhs = -f + cfg.dti2 * (rad - sfk(rad, 1)) / (dh * dz)
    rb = (-f[kbm2]
          + cfg.dti2 * (rad[kbm2] - rad[kbm1]) / (dh * dz[kbm2]))
    sol = _solve(cfg, a, c, den, rhs, ee0, gg0,
                 cl=c[kbm2], rb=rb, db=-jnp.ones_like(h),
                 mask=jnp.ones_like(h), k0=1, k_last=kbm2)
    return jnp.concatenate([sol[:kbm1], f[kbm1:]], axis=0)


def _profuv_solve(cfg: Config, grid: Grid, cm: jnp.ndarray, dh: jnp.ndarray,
                  wsurf: jnp.ndarray, fin: jnp.ndarray, ub_bot, vb_bot,
                  cbc2, mask):
    """Shared full solve of profu/profv (solver.f:1712-1770 / 1810-1870):
    coefficients, surface BC, implicit quadratic bottom friction and back
    substitution.  Returns (solution stack rows 0..kbm2, tps)."""
    dz, dzz = grid.dz3, grid.dzz3
    kbm1, kbm2 = cfg.kbm1, cfg.kbm2
    z3 = jnp.zeros_like(fin)
    kdif = cm + cfg.umol
    a = put(z3, (-cfg.dti2 * sfk(kdif, 1)
                          / (dz * dzz * dh * dh)), *s_[:kbm2])
    c = put(z3, (-cfg.dti2 * kdif
                           / (dz * sfk(dzz, -1) * dh * dh)), *s_[1:kbm1])
    ee0 = a[0] / (a[0] - 1.0)
    gg0 = (-cfg.dti2 * wsurf / (-dz[0] * dh) - fin[0]) / (a[0] - 1.0)
    # implicit quadratic bottom friction (solver.f:1750-1761)
    tps = cbc2 * jnp.sqrt(ub_bot ** 2 + vb_bot ** 2)
    db = tps * cfg.dti2 / (-grid.dz[kbm2] * dh) - 1.0
    sol = _solve(cfg, a, c, jnp.ones_like(fin), -fin, ee0, gg0,
                 cl=c[kbm2], rb=-fin[kbm2], db=db, mask=mask,
                 k0=1, k_last=kbm2)
    return sol, tps


def profu(grid: Grid, cfg: Config,
          uf: jnp.ndarray, ub: jnp.ndarray, vb: jnp.ndarray,
          km: jnp.ndarray, etf: jnp.ndarray, wusurf: jnp.ndarray,
          ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Vertical diffusion of u + implicit bottom friction
    -> (uf, wubot) (solver.f:1686-1780)."""
    h = grid.h
    kbm1, kbm2 = cfg.kbm1, cfg.kbm2

    # u-point depth (solver.f:1699-1705): 1 on the west/south edge rows
    dh = jnp.ones_like(h)
    dh = put(dh, (0.5 * (h + etf + sft(h, -1, 0) + sft(etf, -1, 0))), *s_[1:, 1:])
    # km averaged to u points (solver.f:1712-1718)
    cm = jnp.zeros_like(km)
    cm = put(cm, (0.5 * (km + sft(km, -1, 0))), *s_[:, 1:, 1:])

    sol, tps = _profuv_solve(
        cfg, grid, cm, dh, wusurf, uf,
        ub_bot=ub[kbm1 - 1],
        vb_bot=(0.25 * (vb + sft(vb, 0, 1) + sft(vb, -1, 0)
                        + sft(vb, -1, 1)))[kbm1 - 1],
        cbc2=0.5 * (grid.cbc + sft(grid.cbc, -1, 0)), mask=grid.dum)
    # bottom row and back substitution are interior-only in the reference
    # (solver.f:1750-1770); edge columns keep the incoming values
    uf = put(uf, jnp.concatenate([sol[:kbm1], uf[kbm1:]], axis=0),
             *s_[:kbm1, 1:-1, 1:-1])

    wubot = put(jnp.zeros_like(h), -tps * uf[kbm1 - 1],
                *s_[1:-1, 1:-1])
    return uf, wubot


def profv(grid: Grid, cfg: Config,
          vf: jnp.ndarray, ub: jnp.ndarray, vb: jnp.ndarray,
          km: jnp.ndarray, etf: jnp.ndarray, wvsurf: jnp.ndarray,
          ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Vertical diffusion of v + implicit bottom friction
    -> (vf, wvbot) (solver.f:1783-1877)."""
    h = grid.h
    kbm1, kbm2 = cfg.kbm1, cfg.kbm2

    dh = jnp.ones_like(h)
    dh = put(dh, (0.5 * (h + etf + sft(h, 0, -1) + sft(etf, 0, -1))), *s_[1:, 1:])
    cm = jnp.zeros_like(km)
    cm = put(cm, (0.5 * (km + sft(km, 0, -1))), *s_[:, 1:, 1:])

    sol, tps = _profuv_solve(
        cfg, grid, cm, dh, wvsurf, vf,
        ub_bot=(0.25 * (ub + sft(ub, 1, 0) + sft(ub, 0, -1)
                        + sft(ub, 1, -1)))[kbm1 - 1],
        vb_bot=vb[kbm1 - 1],
        cbc2=0.5 * (grid.cbc + sft(grid.cbc, 0, -1)), mask=grid.dvm)
    vf = put(vf, jnp.concatenate([sol[:kbm1], vf[kbm1:]], axis=0),
             *s_[:kbm1, 1:-1, 1:-1])

    wvbot = put(jnp.zeros_like(h), -tps * vf[kbm1 - 1],
                *s_[1:-1, 1:-1])
    return vf, wvbot


def profq(grid: Grid, cfg: Config,
          q2f: jnp.ndarray, q2lf: jnp.ndarray,
          q2: jnp.ndarray, q2b: jnp.ndarray, q2lb: jnp.ndarray,
          u: jnp.ndarray, v: jnp.ndarray,
          t: jnp.ndarray, s: jnp.ndarray, rho: jnp.ndarray,
          km: jnp.ndarray, kh: jnp.ndarray, kq: jnp.ndarray, l: jnp.ndarray,
          etf: jnp.ndarray,
          wusurf: jnp.ndarray, wvsurf: jnp.ndarray,
          wubot: jnp.ndarray, wvbot: jnp.ndarray):
    """Mellor-Yamada 2.5 closure (solver.f:1212-1538).

    ``q2f``/``q2lf`` enter as the advected TKE quantities (advq output) and
    leave with the implicit vertical solve applied.  Returns
    (q2f, q2lf, km, kh, kq, l, q2b_abs, q2lb_abs); the last two are the
    |.|-rectified time-(n-1) fields the reference mutates in place
    (solver.f:1325-1326) and later reads in the Asselin filter
    (advance.f:416-417).
    """
    h = grid.h
    dz, dzz, z, zz = grid.dz3, grid.dzz3, grid.z3, grid.zz3
    kb, kbm1 = cfg.kb, cfg.kbm1
    K2 = slice(1, kbm1)
    z3 = jnp.zeros_like(q2)
    dt_ = q2.dtype

    a1, b1, a2, b2, c1 = 0.92, 16.6, 0.74, 10.1, 0.08
    e1, e2 = 1.8, 1.33
    sef = 1.0
    cbcnst, surfl, shiw = 100.0, 2.0e5, 0.0

    dh = h + etf

    # tridiagonal coefficients (solver.f:1258-1267)
    a = put(z3, (-cfg.dti2 * (sfk(kq, 1) + kq + 2.0 * cfg.umol) * 0.5
                       / (sfk(dzz, -1) * dz * dh * dh)), *s_[K2])
    c = put(z3, (-cfg.dti2 * (sfk(kq, -1) + kq + 2.0 * cfg.umol) * 0.5
                       / (sfk(dzz, -1) * sfk(dz, -1) * dh * dh)), *s_[K2])

    const1 = (16.6 ** (2.0 / 3.0)) * sef

    # surface friction velocity^2 and bottom TKE BC (solver.f:1281-1290)
    z2 = jnp.zeros_like(h)
    utau2 = put(z2, jnp.sqrt((0.5 * (wusurf + sft(wusurf, 1, 0))) ** 2
                 + (0.5 * (wvsurf + sft(wvsurf, 0, 1))) ** 2), *s_[:-1, :-1])
    q2f = put(q2f,
              jnp.sqrt((0.5 * (wubot + sft(wubot, 1, 0))) ** 2
                       + (0.5 * (wvbot + sft(wvbot, 0, 1))) ** 2) * const1,
              *s_[kb - 1, :-1, :-1])

    # wave-breaking surface TKE (Craig & Banner via Mellor & Blumberg 2003,
    # solver.f:1292-1301) and Stacey surface length scale
    ee0 = jnp.zeros_like(h)
    gg0 = (15.8 * cbcnst) ** (2.0 / 3.0) * utau2
    l0 = surfl * utau2 / cfg.grav

    # speed of sound (solver.f:1303-1319); pressure in decibars
    tp = t + cfg.tbias
    sp = s + cfg.sbias
    p = cfg.grav * cfg.rhoref * (-zz * h) * 1.0e-4
    cc = 1449.1 + 0.00821 * p + 4.55 * tp - 0.045 * tp ** 2 \
        + 1.34 * (sp - 35.0)
    cc = cc / jnp.sqrt((1.0 - 0.01642 * p / cc)
                       * (1.0 - 0.40 * p / cc ** 2))
    cc = put(z3, cc, *s_[:kbm1])

    # |.|-rectification (solver.f:1325-1326); persists into the caller
    q2b = put(q2b, jnp.abs(q2b), *s_[K2])
    q2lb = put(q2lb, jnp.abs(q2lb), *s_[K2])

    # buoyancy gradient incl. compressibility (solver.f:1321-1333)
    boygr = put(z3, (cfg.grav * (sfk(rho, -1) - rho) / (sfk(dzz, -1) * h)
         + (cfg.grav ** 2) * 2.0 / (sfk(cc, -1) ** 2 + cc ** 2)), *s_[K2])

    # length scale and stability parameter (solver.f:1335-1356)
    l_mid = jnp.abs(q2lb / jnp.where(q2b == 0, 1.0, q2b))
    l_mid = jnp.where(z > -0.5, jnp.maximum(l_mid, cfg.kappa * l0), l_mid)
    l = put(l, l_mid, *s_[K2])
    l = set_k(l, 0, cfg.kappa * l0)
    l = set_k(l, kb - 1, 0.0)
    gh = put(z3, jnp.minimum((l ** 2) * boygr / jnp.where(q2b == 0, 1.0, q2b),
                    0.028), *s_[K2])

    # shear + buoyancy production (solver.f:1358-1373), interior only
    prod = put(z3, (km * 0.25 * sef
         * ((u - sfk(u, -1) + sft(u, 1, 0) - sfk(sft(u, 1, 0), -1)) ** 2
            + (v - sfk(v, -1) + sft(v, 0, 1) - sfk(sft(v, 0, 1), -1)) ** 2)
         / (sfk(dzz, -1) * dh) ** 2
         - shiw * km * boygr
         + kh * boygr), *s_[K2, 1:-1, 1:-1])

    # dissipation frequency (solver.f:1379-1392); stf == 1
    stf = jnp.ones_like(q2)
    dtef = jnp.sqrt(jnp.abs(q2b)) * stf / (b1 * l + cfg.small)

    # ---- q2 solve (solver.f:1394-1413) ----
    den = 2.0 * cfg.dti2 * dtef + 1.0
    rhs = -2.0 * cfg.dti2 * prod - q2f
    ones2 = jnp.ones_like(h)
    q2f = _solve(cfg, a, c, den, rhs, ee0, gg0,
                 cl=jnp.zeros_like(h), rb=q2f[kb - 1], db=ones2,
                 mask=ones2, k0=1, k_last=kb - 1)

    # ---- q2l solve (solver.f:1415-1455) ----
    # (1, 1)-shaped level reads (z[k], not z[k, 0, 0]) broadcast identically
    q2lf = set_k(set_k(q2lf, 0, 0.0), kb - 1, 0.0)
    ee1 = jnp.zeros_like(h)
    gg1 = -cfg.kappa * z[1] * dh * q2[1]
    q2lf = set_k(q2lf, kb - 2,
                 cfg.kappa * (1.0 + z[kbm1 - 1]) * dh * q2[kbm1 - 1])
    # wall-proximity dissipation enhancement (solver.f:1426-1435)
    dzk = jnp.abs(z - z[0])
    dzkb = jnp.abs(z - z[kb - 1])
    wallfac = jnp.where(
        (dzk > 0) & (dzkb > 0),
        1.0 + e2 * ((1.0 / jnp.where(dzk == 0, 1.0, dzk)
                     + 1.0 / jnp.where(dzkb == 0, 1.0, dzkb))
                    * l / (dh * cfg.kappa)) ** 2,
        1.0)
    dtef2 = put(z3, (dtef * wallfac), *s_[K2])
    den2 = cfg.dti2 * dtef2 + 1.0
    rhs2 = cfg.dti2 * (-prod * l * e1) - q2lf
    # back substitution down to k=1 (solver.f:1448-1455); k=0 stays 0
    q2l_low = _solve(cfg, a, c, den2, rhs2, ee1, gg1,
                     cl=jnp.zeros_like(h), rb=q2lf[kb - 1], db=ones2,
                     mask=ones2, k0=2, k_last=kb - 1)
    q2lf = put(q2lf, q2l_low, *s_[1:kb - 1])

    # rectify (solver.f:1460-1471)
    q2f = put(q2f, jnp.abs(q2f), *s_[K2])
    q2lf = put(q2lf, jnp.abs(q2lf), *s_[K2])

    # ---- stability functions and mixing coefficients (solver.f:1474-1506) --
    coef4 = 18.0 * a1 * a1 + 9.0 * a1 * a2
    coef5 = 9.0 * a1 * a2
    coef1 = a2 * (1.0 - 6.0 * a1 / b1 * stf)
    coef2 = 3.0 * a2 * b2 / stf + 18.0 * a1 * a2
    coef3 = a1 * (1.0 - 3.0 * c1 - 6.0 * a1 / b1 * stf)
    sh = coef1 / (1.0 - coef2 * gh)
    sm = (coef3 + sh * coef4 * gh) / (1.0 - coef5 * gh)

    kn = l * jnp.sqrt(jnp.abs(q2))
    kq = (kn * 0.41 * sh + kq) * 0.5
    km = (kn * sm + km) * 0.5
    kh = (kn * sh + kh) * 0.5

    # boundary cosmetics, in the reference's order N,S,E,W
    # (solver.f:1510-1529); sft-based full-array form (SPMD/pad-safe)
    for arr_name in ("km", "kh", "kq"):
        arr = {"km": km, "kh": kh, "kq": kq}[arr_name]
        arr = set_j(arr, -1, sft(arr, 0, -1))
        arr = set_j(arr, 0, sft(arr, 0, 1))
        arr = set_i(arr, -1, sft(arr, -1, 0))
        arr = set_i(arr, 0, sft(arr, 1, 0))
        if arr_name == "km":
            km = arr
        elif arr_name == "kh":
            kh = arr
        else:
            kq = arr

    km = km * grid.fsm
    kh = kh * grid.fsm
    kq = kq * grid.fsm

    return q2f, q2lf, km, kh, kq, l, q2b, q2lb
