"""Open lateral boundary conditions (file-driven set).

Mirrors ``bcond(idx)`` (bounds_forcing.f:6-328).  The reference's
``n_west.eq.-1``-style rank conditionals disappear: on global arrays the
physical edges are simply the first/last active rows and columns, and every
edge write is a branch-free masked select (:func:`extpom_tpu.ops.stencil.
set_i` etc.), so under SPMD sharding each shard executes the identical
program and the mask picks out the shard that owns the edge.

Every edge expression is written in FULL-ARRAY form: the value committed at
an edge row is a whole-field expression built from :func:`sft` shifted
reads, evaluated everywhere but masked onto the edge only.  This makes the
same code valid in all three execution regimes — plain global arrays,
pad-and-mask ragged decomposition, and shard_map local blocks where ``sft``
is an explicit ppermute halo exchange (no global row reads anywhere).

Each function is pure: it takes the fields it modifies plus what it reads,
and returns the updated fields.  Side order within each function matches the
reference exactly (corners are decided by whichever side writes last).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from extpom_tpu.core.config import Config
from extpom_tpu.core.grid import Grid
from extpom_tpu.core.state import Forcing
from extpom_tpu.ops.stencil import sft, sfk, put, set_i, set_j, s_


def _bj(a1d: jnp.ndarray) -> jnp.ndarray:
    """Broadcast a (jm,) or (kb, jm) boundary series along the i axis.

    Full-rank 3-D fields (already broadcast) pass through unchanged."""
    if a1d.ndim >= 3:
        return a1d
    return a1d[..., None, :]


def _bi(a1d: jnp.ndarray) -> jnp.ndarray:
    """Broadcast an (im,) or (kb, im) boundary series along the j axis.

    Full-rank 3-D fields and 2-D (im, jm) series (already broadcast)
    pass through unchanged."""
    if a1d.ndim >= 3:
        return a1d
    if a1d.ndim == 2:
        from extpom_tpu.ops.stencil import _ctx
        c = _ctx()
        if c is not None and c.windowed:
            return a1d
    return a1d[..., :, None]


def _smooth_j(a: jnp.ndarray) -> jnp.ndarray:
    """Tangential 1-2-1 average along j (bounds_forcing.f:96-100 pattern).

    Edge cells of the side itself are never committed (j range 2..jmm1), so
    the zero-fill ends of the shifted reads are discarded."""
    return 0.25 * sft(a, 0, -1) + 0.5 * a + 0.25 * sft(a, 0, 1)


def _smooth_i(a: jnp.ndarray) -> jnp.ndarray:
    return 0.25 * sft(a, -1, 0) + 0.5 * a + 0.25 * sft(a, 1, 0)


def bc_el(grid: Grid, cfg: Config, elf: jnp.ndarray,
          fc: Forcing) -> jnp.ndarray:
    """idx=1: external elevation, zero-gradient at open edges
    (bounds_forcing.f:18-41)."""
    elf = set_i(elf, 0, sft(elf, 1, 0))       # west:  elf(1,:) = elf(2,:)
    elf = set_i(elf, -1, sft(elf, -1, 0))     # east
    elf = set_j(elf, 0, sft(elf, 0, 1))       # south
    elf = set_j(elf, -1, sft(elf, 0, -1))     # north
    return elf * grid.fsm


def bc_vel2d(grid: Grid, cfg: Config,
             uaf: jnp.ndarray, vaf: jnp.ndarray,
             el: jnp.ndarray, d: jnp.ndarray,
             fc: Forcing, ramp) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """idx=2: external velocity, Flather-type radiation
    (bounds_forcing.f:43-83)."""
    g = cfg.grav
    J = slice(1, -1)
    I = slice(1, -1)
    # west: uaf(2,:) = uabw - rfw sqrt(g/d(2,:)) (el(2,:) - elw); the
    # committed row i=1 reads d/el at itself, so the full-array expression
    # uses the unshifted fields
    uaf = set_i(uaf, 1, ramp * (
        _bj(fc.uabw) - cfg.rfw * jnp.sqrt(g / d) * (el - _bj(fc.elw))),
        j=J)
    uaf = set_i(uaf, 0, sft(uaf, 1, 0), j=J)
    vaf = set_i(vaf, 0, _bj(fc.vabw), j=J)
    # east: row im-1 reads d/el one row inside (im-2)
    uaf = set_i(uaf, -1, ramp * (
        _bj(fc.uabe) + cfg.rfe * jnp.sqrt(g / sft(d, -1, 0))
        * (sft(el, -1, 0) - _bj(fc.ele))), j=J)
    vaf = set_i(vaf, -1, _bj(fc.vabe), j=J)
    # south
    vaf = set_j(vaf, 1, ramp * (
        _bi(fc.vabs) - cfg.rfs * jnp.sqrt(g / d) * (el - _bi(fc.els))),
        i=I)
    vaf = set_j(vaf, 0, sft(vaf, 0, 1), i=I)
    uaf = set_j(uaf, 0, _bi(fc.uabs), i=I)
    # north
    vaf = set_j(vaf, -1, ramp * (
        _bi(fc.vabn) + cfg.rfn * jnp.sqrt(g / sft(d, 0, -1))
        * (sft(el, 0, -1) - _bi(fc.eln))), i=I)
    uaf = set_j(uaf, -1, _bi(fc.uabn), i=I)

    return uaf * grid.dum, vaf * grid.dvm


def bc_vel3d(grid: Grid, cfg: Config,
             uf: jnp.ndarray, vf: jnp.ndarray,
             u: jnp.ndarray, v: jnp.ndarray, d: jnp.ndarray,
             fc: Forcing) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """idx=3: internal velocity — depth-blended partial clamp toward the
    boundary profile with tangential 1-2-1 smoothing
    (bounds_forcing.f:85-149).

    ``grid.hmax`` replaces the reference's per-call ``maxval(d)``
    (bounds_forcing.f:90) — see the Grid field note."""
    kbm1 = cfg.kbm1
    K = slice(0, kbm1)
    J = slice(1, -1)
    I = slice(1, -1)
    hmax = grid.hmax

    # east (edge row im-1 reads u one row inside)
    ga = jnp.sqrt(d / hmax)
    uf = set_i(uf, -1, ga * _smooth_j(sft(u, -1, 0))
               + (1.0 - ga) * _smooth_j(_bj(fc.ube)), j=J, k=K)
    vf = set_i(vf, -1, _bj(fc.vbe), j=J, k=K)
    # west (u-face at i=1 reads d at i=0 and u at i=2)
    ga_w = jnp.sqrt(sft(d, -1, 0) / hmax)
    uf = set_i(uf, 1, ga_w * _smooth_j(sft(u, 1, 0))
               + (1.0 - ga_w) * _smooth_j(_bj(fc.ubw)), j=J, k=K)
    uf = set_i(uf, 0, sft(uf, 1, 0), j=J, k=K)
    vf = set_i(vf, 0, _bj(fc.vbw), j=J, k=K)
    # south (v-face at j=1 reads d at j=0 and v at j=2)
    ga_s = jnp.sqrt(sft(d, 0, -1) / hmax)
    vf = set_j(vf, 1, ga_s * _smooth_i(sft(v, 0, 1))
               + (1.0 - ga_s) * _smooth_i(_bi(fc.vbs)), i=I, k=K)
    vf = set_j(vf, 0, sft(vf, 0, 1), i=I, k=K)
    uf = set_j(uf, 0, _bi(fc.ubs), i=I, k=K)
    # north
    ga_n = jnp.sqrt(d / hmax)
    vf = set_j(vf, -1, ga_n * _smooth_i(sft(v, 0, -1))
               + (1.0 - ga_n) * _smooth_i(_bi(fc.vbn)), i=I, k=K)
    uf = set_j(uf, -1, _bi(fc.ubn), i=I, k=K)

    return uf * grid.dum, vf * grid.dvm


def bc_ts(grid: Grid, cfg: Config,
          uf: jnp.ndarray, vf: jnp.ndarray,
          t: jnp.ndarray, s: jnp.ndarray,
          u: jnp.ndarray, v: jnp.ndarray, w: jnp.ndarray,
          dt: jnp.ndarray, fc: Forcing) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """idx=4: T/S advective open boundary with vertical-advection correction
    on outflow (bounds_forcing.f:151-242).  ``uf``/``vf`` hold the new T/S
    fields."""
    kbm1 = cfg.kbm1
    K = slice(0, kbm1)
    zz3 = grid.zz3  # (kb, 1, 1)
    # vertical-advection correction applies for 0 < k < kbm1-1 (a 3-D
    # broadcasted iota, not a captured numpy constant)
    import jax.lax as _lax
    kidx = _lax.broadcasted_iota(jnp.int32, (cfg.kb, 1, 1), 0)
    kmask = ((kidx > 0) & (kidx < kbm1 - 1)).astype(t.dtype)
    dzz2 = sfk(zz3, -1) - sfk(zz3, 1)
    dzz2 = jnp.where(dzz2 == 0, 1.0, dzz2)

    def wm_corr(w_in, dt_in, f_in):
        # wm = .5 (w_k + w_{k+1}) dti / ((zz_{k-1} - zz_{k+1}) dt)
        wm = 0.5 * (w_in + sfk(w_in, 1)) * cfg.dti / (dzz2 * dt_in)
        return kmask * wm * (sfk(f_in, -1) - sfk(f_in, 1))

    def side(f_edge, f_in, fb_ext, u1, w_in, dt_in, out_is_le):
        """Upstream advective boundary value (full-array expression):
        f_edge/f_in are the tracer at the edge row and one row inside;
        u1 the normalized normal velocity at the edge."""
        if out_is_le:   # east/north: inflow when u1 <= 0
            inflow = u1 <= 0.0
            f_inf = f_edge - u1 * (fb_ext - f_edge)
            f_out = f_edge - u1 * (f_edge - f_in) - wm_corr(w_in, dt_in, f_in)
        else:           # west/south
            inflow = u1 >= 0.0
            f_inf = f_edge - u1 * (f_edge - fb_ext)
            f_out = f_edge - u1 * (f_in - f_edge) - wm_corr(w_in, dt_in, f_in)
        return jnp.where(inflow, f_inf, f_out)

    # east, full j range (bounds_forcing.f:157-173): edge row im-1 reads
    # u at itself (u(im) is the face at the boundary) and t/w/dt at im-2
    u1e = 2.0 * u * cfg.dti / (grid.dx + sft(grid.dx, -1, 0))
    uf = set_i(uf, -1, side(t, sft(t, -1, 0), _bj(fc.tbe), u1e,
                            sft(w, -1, 0), sft(dt, -1, 0), True), k=K)
    vf = set_i(vf, -1, side(s, sft(s, -1, 0), _bj(fc.sbe), u1e,
                            sft(w, -1, 0), sft(dt, -1, 0), True), k=K)
    # west (bounds_forcing.f:175-191): edge row 0 reads u/t/w/dt at row 1
    u1w = 2.0 * sft(u, 1, 0) * cfg.dti / (grid.dx + sft(grid.dx, 1, 0))
    uf = set_i(uf, 0, side(t, sft(t, 1, 0), _bj(fc.tbw), u1w,
                           sft(w, 1, 0), sft(dt, 1, 0), False), k=K)
    vf = set_i(vf, 0, side(s, sft(s, 1, 0), _bj(fc.sbw), u1w,
                           sft(w, 1, 0), sft(dt, 1, 0), False), k=K)
    # south, full i range (bounds_forcing.f:194-211)
    u1s = 2.0 * sft(v, 0, 1) * cfg.dti / (grid.dy + sft(grid.dy, 0, 1))
    uf = set_j(uf, 0, side(t, sft(t, 0, 1), _bi(fc.tbs), u1s,
                           sft(w, 0, 1), sft(dt, 0, 1), False), k=K)
    vf = set_j(vf, 0, side(s, sft(s, 0, 1), _bi(fc.sbs), u1s,
                           sft(w, 0, 1), sft(dt, 0, 1), False), k=K)
    # north (bounds_forcing.f:213-229)
    u1n = 2.0 * v * cfg.dti / (grid.dy + sft(grid.dy, 0, -1))
    uf = set_j(uf, -1, side(t, sft(t, 0, -1), _bi(fc.tbn), u1n,
                            sft(w, 0, -1), sft(dt, 0, -1), True), k=K)
    vf = set_j(vf, -1, side(s, sft(s, 0, -1), _bi(fc.sbn), u1n,
                            sft(w, 0, -1), sft(dt, 0, -1), True), k=K)

    uf = put(uf, uf * grid.fsm, *s_[K])
    vf = put(vf, vf * grid.fsm, *s_[K])
    return uf, vf


def bc_w(grid: Grid, cfg: Config, w: jnp.ndarray) -> jnp.ndarray:
    """idx=5: vertical velocity mask (bounds_forcing.f:244-255)."""
    return put(w, w * grid.fsm, *s_[:cfg.kbm1])


def bc_turb(grid: Grid, cfg: Config,
            uf: jnp.ndarray, vf: jnp.ndarray,
            q2: jnp.ndarray, q2l: jnp.ndarray,
            u: jnp.ndarray, v: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """idx=6: q2/q2l upstream open boundary toward ``small``; covers all kb
    levels (bounds_forcing.f:257-325)."""
    small = cfg.small

    def side(f_edge, f_in, u1, out_is_le):
        if out_is_le:
            inflow = u1 <= 0.0
            f_inf = f_edge - u1 * (small - f_edge)
            f_out = f_edge - u1 * (f_edge - f_in)
        else:
            inflow = u1 >= 0.0
            f_inf = f_edge - u1 * (f_edge - small)
            f_out = f_edge - u1 * (f_in - f_edge)
        return jnp.where(inflow, f_inf, f_out)

    # west (bounds_forcing.f:263-273): edge row 0 reads u/q2 at row 1
    u1w = 2.0 * sft(u, 1, 0) * cfg.dti / (grid.dx + sft(grid.dx, 1, 0))
    uf = set_i(uf, 0, side(q2, sft(q2, 1, 0), u1w, False))
    vf = set_i(vf, 0, side(q2l, sft(q2l, 1, 0), u1w, False))
    # east
    u1e = 2.0 * u * cfg.dti / (grid.dx + sft(grid.dx, -1, 0))
    uf = set_i(uf, -1, side(q2, sft(q2, -1, 0), u1e, True))
    vf = set_i(vf, -1, side(q2l, sft(q2l, -1, 0), u1e, True))
    # south
    u1s = 2.0 * sft(v, 0, 1) * cfg.dti / (grid.dy + sft(grid.dy, 0, 1))
    uf = set_j(uf, 0, side(q2, sft(q2, 0, 1), u1s, False))
    vf = set_j(vf, 0, side(q2l, sft(q2l, 0, 1), u1s, False))
    # north
    u1n = 2.0 * v * cfg.dti / (grid.dy + sft(grid.dy, 0, -1))
    uf = set_j(uf, -1, side(q2, sft(q2, 0, -1), u1n, True))
    vf = set_j(vf, -1, side(q2l, sft(q2l, 0, -1), u1n, True))

    uf = uf * grid.fsm + 1.0e-10
    vf = vf * grid.fsm + 1.0e-10
    return uf, vf
