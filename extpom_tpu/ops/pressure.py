"""Baroclinic pressure gradient.

* :func:`baropg`     — 2nd-order sigma-coordinate integral (solver.f:848-940).
* :func:`baropg_mcc` — 4th-order McCalpin scheme (Berntsen & Oey 2010;
  solver.f:943-1159).

Both subtract the horizontally averaged density ``rmean`` to reduce the
sigma-coordinate PG truncation error (solver.f:854), integrate downward
cumulatively in k (expressed here as a ``cumsum`` over layer increments, so
XLA sees a single associative scan instead of a sequential loop), and apply
the inertial ``ramp``.

The reference's wide-halo one-sided exchange (order2d/3d_mpi,
parallel_mpi.f:353-480) exists only to supply the i-2/j-2 points of the
4th-order stencil across tile boundaries; with global-array ops the shifted
slice provides them directly (XLA inserts a 2-cell halo exchange when
sharded).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from extpom_tpu.core.config import Config
from extpom_tpu.core.grid import Grid
from extpom_tpu.ops.stencil import sft, sfk, put, set_i, set_j, set_k, s_


def _cumk(inc: jnp.ndarray) -> jnp.ndarray:
    """drho[k] = sum_{k'<=k} inc[k'] along leading axis.

    Written as an unrolled sequential sum (kb is small and static) rather
    than ``jnp.cumsum``: the strictly sequential association matches the
    reference's ascending-k loop (solver.f:864-878) bit-for-bit."""
    rows = [inc[0]]
    for k in range(1, inc.shape[0]):
        rows.append(rows[-1] + inc[k])
    return jnp.stack(rows, axis=0)


def baropg(grid: Grid, cfg: Config,
           rho: jnp.ndarray, rmean: jnp.ndarray, dt: jnp.ndarray,
           ramp) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """2nd-order baroclinic pressure gradient -> (drhox, drhoy)."""
    dx, dy = grid.dx, grid.dy
    zz = grid.zz3
    kbm1 = cfg.kbm1
    KM1 = slice(0, kbm1)
    rr = rho - rmean
    z3 = jnp.zeros_like(rho)

    def component(shift, mask, dperp):
        # shift: lambda a: a at (i-1,j) (x) or (i,j-1) (y)
        drr = rr - shift(rr)
        srr = rr + shift(rr)
        dts = dt + shift(dt)
        dtd = dt - shift(dt)
        # surface increment (solver.f:857-862)
        inc0 = 0.5 * cfg.grav * (-zz[0]) * dts * drr[0]
        # interior increments (solver.f:864-878)
        inck = (cfg.grav * 0.25 * (sfk(zz, -1) - zz) * dts
                * (drr + sfk(drr, -1))
                + cfg.grav * 0.25 * (sfk(zz, -1) + zz) * dtd
                * (srr - sfk(srr, -1)))
        inc = set_k(inck, 0, inc0)
        dr = _cumk(inc)
        # scale (solver.f:880-888)
        dr = 0.25 * dts * dr * mask * (dperp + shift(dperp))
        out = put(z3, dr, *s_[KM1, 1:-1, 1:-1])
        return out

    drhox = component(lambda a: sft(a, -1, 0), grid.dum, dy)
    drhoy = component(lambda a: sft(a, 0, -1), grid.dvm, dx)

    # inertial ramp over all k (solver.f:928-935)
    drhox = put(drhox, drhox * ramp, *s_[:, 1:-1, 1:-1])
    drhoy = put(drhoy, drhoy * ramp, *s_[:, 1:-1, 1:-1])
    return drhox, drhoy


def baropg_mcc(grid: Grid, cfg: Config,
               rho: jnp.ndarray, rmean: jnp.ndarray,
               d: jnp.ndarray, dt: jnp.ndarray,
               ramp) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """4th-order McCalpin baroclinic pressure gradient -> (drhox, drhoy).

    Global-array equivalent of solver.f:943-1159 with the physical-edge
    (n_west/n_south == -1) 4th-order correction regions.
    """
    dx, dy = grid.dx, grid.dy
    zz, dzz = grid.zz3, grid.dzz3
    kbm1 = cfg.kbm1
    KM1 = slice(0, kbm1)
    rr = rho - rmean
    z3 = jnp.zeros_like(rho)

    def component(shift, shift_p, mask, dperp, corr_region):
        """shift: read at upstream point (i-1 / j-1); shift_p: downstream
        (i+1 / j+1); corr_region: slices of the 4th-order correction."""
        # 2nd-order building blocks (solver.f:968-977)
        drho = (rr - shift(rr)) * mask
        rhou = 0.5 * (rr + shift(rr)) * mask
        ddx = (d - shift(d)) * mask
        d4 = 0.5 * (d + shift(d)) * mask

        # 4th-order corrections (solver.f:979-999 x / 1072-1091 y);
        # shift(shift(.)) reaches the i-2 / j-2 point
        mp = shift_p(mask)
        mm = shift(mask)
        drho_c = drho - (1.0 / 24.0) * (
            mp * (shift_p(rr) - rr) - 2.0 * (rr - shift(rr))
            + mm * (shift(rr) - shift(shift(rr))))
        rhou_c = rhou + (1.0 / 16.0) * (
            mp * (rr - shift_p(rr)) + mm * (shift(rr) - shift(shift(rr))))
        ddx_c = ddx - (1.0 / 24.0) * (
            mp * (shift_p(d) - d) - 2.0 * (d - shift(d))
            + mm * (shift(d) - shift(shift(d))))
        d4_c = d4 + (1.0 / 16.0) * (
            mp * (d - shift_p(d)) + mm * (shift(d) - shift(shift(d))))

        ks, isl, jsl = corr_region
        drho = put(drho, drho_c, *s_[ks, isl, jsl])
        rhou = put(rhou, rhou_c, *s_[ks, isl, jsl])
        ddx = put(ddx, ddx_c, *s_[isl, jsl])
        d4 = put(d4, d4_c, *s_[isl, jsl])

        # vertical integral (solver.f:1023-1040)
        inc0 = cfg.grav * (-zz[0]) * d4 * drho[0]
        inck = (cfg.grav * 0.5 * sfk(dzz, -1) * d4 * (sfk(drho, -1) + drho)
                + cfg.grav * 0.5 * (sfk(zz, -1) + zz) * ddx
                * (rhou - sfk(rhou, -1)))
        dr = _cumk(set_k(inck, 0, inc0))
        dr = 0.25 * (dt + shift(dt)) * dr * mask * (dperp + shift(dperp))
        return put(z3, dr, *s_[KM1, 1:-1, 1:-1])

    drhox = component(lambda a: sft(a, -1, 0), lambda a: sft(a, 1, 0),
                      grid.dum, dy, (KM1, slice(2, -1), slice(None)))
    drhoy = component(lambda a: sft(a, 0, -1), lambda a: sft(a, 0, 1),
                      grid.dvm, dx, (KM1, slice(None), slice(2, -1)))

    drhox = put(drhox, drhox * ramp, *s_[:, 1:-1, 1:-1])
    drhoy = put(drhoy, drhoy * ramp, *s_[:, 1:-1, 1:-1])
    return drhox, drhoy
