"""Tracer and turbulence-quantity advection.

* :func:`advq`  — horizontal advection/diffusion + vertical advection +
  leapfrog step for the TKE pair q2/q2l (solver.f:411-477).
* :func:`advt1` — central (2nd-order leapfrog) tracer scheme
  (solver.f:480-574).
* :func:`advt2` — Smolarkiewicz MPDATA iterative upstream scheme with
  antidiffusive velocities (solver.f:577-731) and :func:`smol_adif`
  (solver.f:1880-1967).

Functional-design notes vs the reference (documented deviations, none of
which affect prognostic fields):

* The reference temporarily mutates ``fb`` as ``fb-fclim`` and restores it
  by adding ``fclim`` back (solver.f:511-532), which perturbs ``fb`` by one
  rounding.  We use the non-mutating difference directly.
* The reference reuses the uf/vf scratch buffers across kernels, so the
  MPDATA work array ``ff`` initially contains stale q2 values outside the
  computed interior (advance.f:406-449).  We initialize ``ff`` to zeros;
  with the MPDATA value_min cutoff this zeroes antidiffusive fluxes at the
  outermost faces, and open-boundary values are set by bcond afterwards in
  both designs.
"""

from __future__ import annotations

import jax.numpy as jnp

from extpom_tpu.core.config import Config
from extpom_tpu.core.grid import Grid
from extpom_tpu.ops.stencil import sft, sfk, put, set_i, set_j, set_k, s_


def advq(grid: Grid, cfg: Config,
         qb: jnp.ndarray, q: jnp.ndarray,
         u: jnp.ndarray, v: jnp.ndarray, w: jnp.ndarray, aam: jnp.ndarray,
         dt: jnp.ndarray, etb: jnp.ndarray, etf: jnp.ndarray) -> jnp.ndarray:
    """Advect a turbulence quantity (q2 or q2l) -> qf (solver.f:411-477)."""
    h, dx, dy, art = grid.h, grid.dx, grid.dy, grid.art
    kbm1 = cfg.kbm1
    K2 = slice(1, kbm1)   # k = 2..kbm1
    z3 = jnp.zeros_like(q)

    # horizontal advection at layer interfaces (solver.f:425-434)
    xflux = put(z3, (0.125 * (q + sft(q, -1, 0)) * (dt + sft(dt, -1, 0))
         * (u + sfk(u, -1))), *s_[K2, 1:, 1:])
    yflux = put(z3, (0.125 * (q + sft(q, 0, -1)) * (dt + sft(dt, 0, -1))
         * (v + sfk(v, -1))), *s_[K2, 1:, 1:])
    # horizontal diffusion (solver.f:437-456)
    xflux = put(xflux, (0.5 * (dy + sft(dy, -1, 0))
         * (xflux
            - 0.25 * (aam + sft(aam, -1, 0) + sfk(aam, -1)
                      + sfk(sft(aam, -1, 0), -1))
            * (h + sft(h, -1, 0)) * (qb - sft(qb, -1, 0)) * grid.dum
            / (dx + sft(dx, -1, 0)))), *s_[K2, 1:, 1:])
    yflux = put(yflux, (0.5 * (dx + sft(dx, 0, -1))
         * (yflux
            - 0.25 * (aam + sft(aam, 0, -1) + sfk(aam, -1)
                      + sfk(sft(aam, 0, -1), -1))
            * (h + sft(h, 0, -1)) * (qb - sft(qb, 0, -1)) * grid.dvm
            / (dy + sft(dy, 0, -1)))), *s_[K2, 1:, 1:])

    # vertical advection + leapfrog step (solver.f:462-474)
    qf = put(z3, (((sfk(w, -1) * sfk(q, -1) - sfk(w, 1) * sfk(q, 1)) * art
          / (grid.dz3 + sfk(grid.dz3, -1))
          + sft(xflux, 1, 0) - xflux + sft(yflux, 0, 1) - yflux)), *s_[K2, 1:-1, 1:-1])
    qf = put(qf, (((h + etb) * art * qb - cfg.dti2 * qf) / ((h + etf) * art)), *s_[K2, 1:-1, 1:-1])
    return qf


def _horizontal_diff_fluxes(grid: Grid, cfg: Config, fbmc: jnp.ndarray,
                            aam: jnp.ndarray):
    """Climatology-deviation diffusive fluxes shared by advt1/advt2
    (solver.f:513-530 / 693-713); fbmc = fb - fclim."""
    h, dx, dy = grid.h, grid.dx, grid.dy
    xdif = (-0.5 * (aam + sft(aam, -1, 0)) * (h + sft(h, -1, 0)) * cfg.tprni
            * (fbmc - sft(fbmc, -1, 0)) * grid.dum / (dx + sft(dx, -1, 0)))
    ydif = (-0.5 * (aam + sft(aam, 0, -1)) * (h + sft(h, 0, -1)) * cfg.tprni
            * (fbmc - sft(fbmc, 0, -1)) * grid.dvm / (dy + sft(dy, 0, -1)))
    return xdif, ydif


def advt1(grid: Grid, cfg: Config,
          fb: jnp.ndarray, f: jnp.ndarray, fclim: jnp.ndarray,
          u: jnp.ndarray, v: jnp.ndarray, w: jnp.ndarray, aam: jnp.ndarray,
          dt: jnp.ndarray, etb: jnp.ndarray, etf: jnp.ndarray) -> jnp.ndarray:
    """Central-difference tracer step -> ff (solver.f:480-574)."""
    h, dx, dy, art = grid.h, grid.dx, grid.dy, grid.art
    kbm1 = cfg.kbm1
    KM1 = slice(0, kbm1)
    z3 = jnp.zeros_like(f)

    # ghost bottom layer (solver.f:495-496); positive static indices —
    # negative value-indexing lowers through dynamic_slice
    f = set_k(f, -1, f[cfg.kb - 2])
    fb = set_k(fb, -1, fb[cfg.kb - 2])

    xflux = put(z3, (0.25 * (dt + sft(dt, -1, 0)) * (f + sft(f, -1, 0)) * u), *s_[KM1, 1:, 1:])
    yflux = put(z3, (0.25 * (dt + sft(dt, 0, -1)) * (f + sft(f, 0, -1)) * v), *s_[KM1, 1:, 1:])

    xdif, ydif = _horizontal_diff_fluxes(grid, cfg, fb - fclim, aam)
    xflux = put(xflux, (0.5 * (dy + sft(dy, -1, 0)) * (xflux + xdif)), *s_[KM1, 1:, 1:])
    yflux = put(yflux, (0.5 * (dx + sft(dx, 0, -1)) * (yflux + ydif)), *s_[KM1, 1:, 1:])

    # vertical advective flux at layer interfaces (solver.f:535-548)
    zflux = put(z3, f[0] * w[0] * art, *s_[0, 1:-1, 1:-1])
    zflux = put(zflux, (0.5 * (sfk(f, -1) + f) * w * art), *s_[1:kbm1, 1:-1, 1:-1])

    ff = put(z3, (sft(xflux, 1, 0) - xflux + sft(yflux, 0, 1) - yflux
         + (zflux - sfk(zflux, 1)) / grid.dz3), *s_[KM1, 1:-1, 1:-1])
    ff = put(ff, ((fb * (h + etb) * art - cfg.dti2 * ff) / ((h + etf) * art)), *s_[KM1, 1:-1, 1:-1])
    return ff


def smol_adif(grid: Grid, cfg: Config,
              xmassflux: jnp.ndarray, ymassflux: jnp.ndarray,
              zwflux: jnp.ndarray, ff: jnp.ndarray, dt: jnp.ndarray):
    """MPDATA antidiffusive velocities (solver.f:1880-1967).

    Returns (xmassflux, ymassflux, zwflux, ff_masked); values outside the
    recomputed regions pass through unchanged, as in the reference.
    """
    value_min, epsilon = 1.0e-9, 1.0e-14
    kbm1 = cfg.kbm1
    KM1 = slice(0, kbm1)

    ff = ff * grid.fsm

    # x antidiffusion (solver.f:1903-1922), region i=2..im, j=2..jmm1
    udx = jnp.abs(xmassflux)
    u2dt = (cfg.dti2 * xmassflux * xmassflux * 2.0
            / (grid.aru * (sft(dt, -1, 0) + dt)))
    molx = (ff - sft(ff, -1, 0)) / (sft(ff, -1, 0) + ff + epsilon)
    xm_new = jnp.where((udx < u2dt)
                       | (ff < value_min) | (sft(ff, -1, 0) < value_min),
                       0.0, (udx - u2dt) * molx * cfg.sw)
    xmassflux = put(xmassflux, xm_new, *s_[KM1, 1:, 1:-1])

    # y antidiffusion (solver.f:1924-1943), region i=2..imm1, j=2..jm
    vdy = jnp.abs(ymassflux)
    v2dt = (cfg.dti2 * ymassflux * ymassflux * 2.0
            / (grid.arv * (sft(dt, 0, -1) + dt)))
    moly = (ff - sft(ff, 0, -1)) / (sft(ff, 0, -1) + ff + epsilon)
    ym_new = jnp.where((vdy < v2dt)
                       | (ff < value_min) | (sft(ff, 0, -1) < value_min),
                       0.0, (vdy - v2dt) * moly * cfg.sw)
    ymassflux = put(ymassflux, ym_new, *s_[KM1, 1:-1, 1:])

    # z antidiffusion (solver.f:1945-1964), region k=2..kbm1, interior
    wdz = jnp.abs(zwflux)
    w2dt = cfg.dti2 * zwflux * zwflux / sfk(grid.dzz3, -1) / dt
    molz = (sfk(ff, -1) - ff) / (ff + sfk(ff, -1) + epsilon)
    zw_new = jnp.where((wdz < w2dt)
                       | (ff < value_min) | (sfk(ff, -1) < value_min),
                       0.0, (wdz - w2dt) * molz * cfg.sw)
    zwflux = put(zwflux, zw_new, *s_[1:kbm1, 1:-1, 1:-1])

    return xmassflux, ymassflux, zwflux, ff


def advt2(grid: Grid, cfg: Config,
          fb: jnp.ndarray, f: jnp.ndarray, fclim: jnp.ndarray,
          u: jnp.ndarray, v: jnp.ndarray, w: jnp.ndarray, aam: jnp.ndarray,
          dt: jnp.ndarray, etb: jnp.ndarray, etf: jnp.ndarray) -> jnp.ndarray:
    """Smolarkiewicz MPDATA upstream tracer step -> ff (solver.f:577-731)."""
    h, dx, dy, art = grid.h, grid.dx, grid.dy, grid.art
    kbm1 = cfg.kbm1
    KM1 = slice(0, kbm1)
    z3 = jnp.zeros_like(f)

    # horizontal mass fluxes (solver.f:602-616)
    xmassflux = put(z3, (0.25 * (sft(dy, -1, 0) + dy) * (sft(dt, -1, 0) + dt) * u), *s_[KM1, 1:, 1:-1])
    ymassflux = put(z3, (0.25 * (sft(dx, 0, -1) + dx) * (sft(dt, 0, -1) + dt) * v), *s_[KM1, 1:-1, 1:])

    fb = set_k(fb, -1, fb[cfg.kb - 2])   # solver.f:618
    eta = etb                    # solver.f:619
    zwflux = w
    fbmem = fb
    # Work array: interior is overwritten every iteration; boundary columns
    # keep fb (the reference leaves stale scratch there — see module note).
    ff = fb

    for itera in range(cfg.nitera):   # solver.f:625-688
        # upwind fluxes
        xflux = put(z3, (0.5 * ((xmassflux + jnp.abs(xmassflux)) * sft(fbmem, -1, 0)
                    + (xmassflux - jnp.abs(xmassflux)) * fbmem)), *s_[KM1, 1:, 1:])
        yflux = put(z3, (0.5 * ((ymassflux + jnp.abs(ymassflux)) * sft(fbmem, 0, -1)
                    + (ymassflux - jnp.abs(ymassflux)) * fbmem)), *s_[KM1, 1:, 1:])

        zflux = z3
        if itera == 0:
            zflux = put(zflux, w[0] * f[0] * art, *s_[0, 1:-1, 1:-1])
        zflux = put(zflux, (0.5 * ((zwflux + jnp.abs(zwflux)) * fbmem
                    + (zwflux - jnp.abs(zwflux)) * sfk(fbmem, -1)) * art), *s_[1:kbm1, 1:-1, 1:-1])

        # net fluxes + upstream step (solver.f:667-677)
        ff_new = (sft(xflux, 1, 0) - xflux + sft(yflux, 0, 1) - yflux
                  + (zflux - sfk(zflux, 1)) / grid.dz3)
        ff_new = ((fbmem * (h + eta) * art - cfg.dti2 * ff_new)
                  / ((h + etf) * art))
        ff = put(ff, ff_new, *s_[KM1, 1:-1, 1:-1])

        # antidiffusive velocities (solver.f:682)
        xmassflux, ymassflux, zwflux, ff = smol_adif(
            grid, cfg, xmassflux, ymassflux, zwflux, ff, dt)

        eta = etf                 # solver.f:684
        fbmem = ff

    # climatology-deviation horizontal diffusion (solver.f:691-726)
    aamx = 0.5 * (aam + sft(aam, -1, 0))
    aamy = 0.5 * (aam + sft(aam, 0, -1))
    fbmc = fb - fclim
    xflux = put(z3, (-aamx * (h + sft(h, -1, 0)) * cfg.tprni
         * (fbmc - sft(fbmc, -1, 0)) * grid.dum
         * (dy + sft(dy, -1, 0)) * 0.5 / (dx + sft(dx, -1, 0))), *s_[KM1, 1:, 1:])
    yflux = put(z3, (-aamy * (h + sft(h, 0, -1)) * cfg.tprni
         * (fbmc - sft(fbmc, 0, -1)) * grid.dvm
         * (dx + sft(dx, 0, -1)) * 0.5 / (dy + sft(dy, 0, -1))), *s_[KM1, 1:, 1:])

    ff = put(ff, (ff - cfg.dti2 * (sft(xflux, 1, 0) - xflux
                          + sft(yflux, 0, 1) - yflux)
         / ((h + etf) * art)), *s_[KM1, 1:-1, 1:-1])
    return ff
