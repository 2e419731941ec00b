"""Global diagnostics and runtime guards.

* :func:`domain_stats` — area/volume/mass/salt totals, T/S/elevation
  averages, kinetic energy (advance.f:644-756).  On global arrays the
  reference's careful interior-vs-physical-edge bookkeeping (only counting
  rank-boundary rows at true domain edges) reduces to fixed slice sums; the
  MPI reduce/bcast pair disappears (sharded reductions lower to psums).
  The sums are COMPENSATED (double-single pairwise, :func:`_csum`) so the
  conservation diagnostic is trustworthy in the production float32 runs —
  plain f32 accumulation drifts ~1e-5 relative over a 512^2x31 volume sum,
  drowning the physical drift the print exists to expose (SURVEY §7:
  "compensated summation where conservation demands it"; the test anchor
  is tests/test_tolerance.py's scalar ladder).  Cost is irrelevant: stats
  run once per print interval.
* :func:`check_velocity` — blow-up detector on ``|vaf|`` (advance.f:611-641).
* :func:`cfl_min` — external-mode CFL advisory (parallel_mpi.f:483-514).
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from extpom_tpu.core.config import Config
from extpom_tpu.core.grid import Grid
from extpom_tpu.core.state import State


def _csum(x: jnp.ndarray) -> jnp.ndarray:
    """Compensated pairwise sum (double-single): ~f64-quality totals from
    f32 inputs, branch-free and fully vectorized (a log2(N)-level TwoSum
    reduction tree carrying an error channel; Ogita-Rump-Oishi cascade).
    Works in any float dtype; in f64 it simply adds accuracy."""
    x = x.reshape(-1)
    n = x.shape[0]
    if n == 0:
        return jnp.zeros((), x.dtype)
    p = 1 << max(n - 1, 1).bit_length()
    if p != n:
        x = jnp.concatenate([x, jnp.zeros((p - n,), x.dtype)])
    s, c = x, jnp.zeros_like(x)
    while s.shape[0] > 1:
        a, b = s[0::2], s[1::2]
        t = a + b
        # TwoSum error term: exact rounding error of a+b
        e = (a - (t - b)) + (b - (t - a))
        s = t
        c = c[0::2] + c[1::2] + e
    return s[0] + c[0]


def domain_stats(grid: Grid, cfg: Config, st: State) -> Dict[str, jnp.ndarray]:
    """Returns dict with vtot, atot, mtot, tsalt, taver, saver, eaver, ekin.

    Edge handling follows advance.f:669-745: sums cover the interior plus
    the four physical edge rows/columns, i.e. everything except the four
    corner points; ekin additionally counts only the east/north edges
    (advance.f:735-739).  Each stat concatenates its pieces and runs ONE
    compensated sum so the edge bookkeeping costs no accuracy.
    """
    kbm1 = cfg.kbm1
    # restrict to the active region when arrays are padded (mesh.padding)
    ia = cfg.im_act or cfg.im
    ja = cfg.jm_act or cfg.jm
    # carry the accumulation in f64 where the runtime has it (CPU
    # validation; also any x64-enabled host check of an f32 state): the
    # stats then expose STATE drift, not summation noise.  With x64 off
    # (production) this is a no-op and the compensated tree below
    # still delivers totals exact to the f32 ulp.
    wide = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    act = lambda a: a[..., :ia, :ja].astype(wide)
    grid_dx, grid_dy, grid_fsm = act(grid.dx), act(grid.dy), act(grid.fsm)
    darea = grid_dx * grid_dy * grid_fsm

    def edge_sum(a2d):
        # interior + all four physical edges, corners excluded
        return _csum(jnp.concatenate([
            a2d[1:-1, 1:-1].reshape(-1),
            a2d[0, 1:-1], a2d[-1, 1:-1], a2d[1:-1, 0], a2d[1:-1, -1]]))

    atot = edge_sum(darea)
    eavg = edge_sum(act(st.et) * darea)
    eavg = jnp.where(atot != 0, eavg / atot, 0.0)

    dt2 = act(grid.h) + act(st.et)
    dvol = darea[None] * dt2[None] * grid.dz3[:kbm1]     # (kbm1, im, jm)

    def edge_sum3(a3d):
        return _csum(jnp.concatenate([
            a3d[:, 1:-1, 1:-1].reshape(-1),
            a3d[:, 0, 1:-1].reshape(-1), a3d[:, -1, 1:-1].reshape(-1),
            a3d[:, 1:-1, 0].reshape(-1), a3d[:, 1:-1, -1].reshape(-1)]))

    vtot = edge_sum3(dvol)
    dmass = dvol * (act(st.rho)[:kbm1] * cfg.rhoref + 1000.0)
    # mtot sums the interior only (advance.f:700-702)
    mtot = _csum(dmass[:, 1:-1, 1:-1])
    tavg = edge_sum3(act(st.tb)[:kbm1] * dvol)
    stot = edge_sum3(act(st.sb)[:kbm1] * dvol)
    tavg = jnp.where(vtot != 0, tavg / vtot, 0.0)
    savg = jnp.where(vtot != 0, stot / vtot, 0.0)

    # kinetic energy: interior + east/north edges only (advance.f:733-740)
    ke = dmass * (act(st.u)[:kbm1] ** 2 + act(st.v)[:kbm1] ** 2)
    ekin = _csum(jnp.concatenate([
        (0.5 * ke[:, 1:-1, 1:-1]).reshape(-1),
        ke[:, -1, 1:-1].reshape(-1), ke[:, 1:-1, -1].reshape(-1)]))

    return dict(vtot=vtot, atot=atot, mtot=mtot, tsalt=stot,
                taver=tavg, saver=savg, eaver=eavg, ekin=ekin)


def check_velocity(cfg: Config, vaf: jnp.ndarray
                   ) -> Tuple[jnp.ndarray, Tuple[jnp.ndarray, jnp.ndarray]]:
    """Blow-up detector (advance.f:611-641).

    Returns (vamax, (i, j) argmax location); the caller compares
    vamax > cfg.vmaxl and reports the grid location plus coordinates, like
    the reference's imax/jmax + east_e/north_e printout (advance.f:625-636).
    """
    a = jnp.abs(vaf)
    i, j = jnp.unravel_index(jnp.argmax(a), a.shape)
    return jnp.max(a), (i, j)


def cfl_min(grid: Grid, cfg: Config) -> jnp.ndarray:
    """Minimum external-mode CFL time step over water points
    (parallel_mpi.f:488-502): 0.5 / sqrt(1/dx^2 + 1/dy^2) / sqrt(g h)."""
    tps = (0.5 / jnp.sqrt(1.0 / grid.dx ** 2 + 1.0 / grid.dy ** 2)
           / jnp.sqrt(cfg.grav * jnp.maximum(grid.h, 1.0e-12)))
    big = jnp.asarray(1.0e30, tps.dtype)
    return jnp.min(jnp.where(grid.fsm > 0, tps, big))
