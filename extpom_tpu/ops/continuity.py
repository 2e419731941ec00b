"""Vertical velocity from continuity.

* :func:`vertvl` — sigma-coordinate vertical velocity w (solver.f:1970-2021).
* :func:`realvertvl` — physical (z-coordinate) vertical velocity wr
  diagnostic (solver.f:2024-2067).
"""

from __future__ import annotations

import jax.numpy as jnp

from extpom_tpu.core.config import Config
from extpom_tpu.core.grid import Grid
from extpom_tpu.ops.stencil import sft, sfk, put, set_i, set_j, set_k, s_


def vertvl(grid: Grid, cfg: Config,
           w: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray,
           dt: jnp.ndarray, etf: jnp.ndarray, etb: jnp.ndarray,
           vfluxb: jnp.ndarray, vfluxf: jnp.ndarray) -> jnp.ndarray:
    """Integrate continuity downward for w on the interior; boundary columns
    of ``w`` pass through unchanged (the reference never recomputes them,
    solver.f:2002-2018)."""
    dx, dy = grid.dx, grid.dy
    kbm1 = cfg.kbm1
    KM1 = slice(0, kbm1)
    z3 = jnp.zeros_like(w)

    xflux = put(z3, (0.25 * (dy + sft(dy, -1, 0)) * (dt + sft(dt, -1, 0)) * u), *s_[KM1, 1:, 1:])
    yflux = put(z3, (0.25 * (dx + sft(dx, 0, -1)) * (dt + sft(dt, 0, -1)) * v), *s_[KM1, 1:, 1:])

    # surface volume flux (solver.f:2002-2006)
    w = put(w, 0.5 * (vfluxb + vfluxf), *s_[0, 1:-1, 1:-1])

    # downward cumulative divergence (solver.f:2008-2018):
    # w[k+1] = w[k] + dz[k]*(div[k] + (etf-etb)/dti2)
    inc = (grid.dz3 * ((sft(xflux, 1, 0) - xflux + sft(yflux, 0, 1) - yflux)
                       / (dx * dy)
                       + (etf - etb) / cfg.dti2))
    # sequential downward sum (not jnp.cumsum): matches the reference's
    # ascending-k loop association exactly
    rows = [w[0]]
    for k in range(kbm1):
        rows.append(rows[-1] + inc[k])
    w = put(w, jnp.stack(rows, axis=0), *s_[1:, 1:-1, 1:-1])
    return w


def realvertvl(grid: Grid, cfg: Config,
               w: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray,
               dt: jnp.ndarray, et: jnp.ndarray,
               etf: jnp.ndarray, etb: jnp.ndarray) -> jnp.ndarray:
    """Physical vertical velocity wr (diagnostic; solver.f:2024-2067)."""
    dx, dy = grid.dx, grid.dy
    kbm1 = cfg.kbm1
    KM1 = slice(0, kbm1)
    z3 = jnp.zeros_like(w)

    tps = grid.zz3 * dt + et   # (kb, im, jm)
    dxr = 2.0 / (sft(dx, 1, 0) + dx)
    dxl = 2.0 / (dx + sft(dx, -1, 0))
    dyt = 2.0 / (sft(dy, 0, 1) + dy)
    dyb = 2.0 / (dy + sft(dy, 0, -1))

    wr = put(z3, (0.5 * (w + sfk(w, 1))
         + 0.5 * (sft(u, 1, 0) * (sft(tps, 1, 0) - tps) * dxr
                  + u * (tps - sft(tps, -1, 0)) * dxl
                  + sft(v, 0, 1) * (sft(tps, 0, 1) - tps) * dyt
                  + v * (tps - sft(tps, 0, -1)) * dyb)
         + (1.0 + grid.zz3) * (etf - etb) / cfg.dti2), *s_[KM1, 1:-1, 1:-1])

    # physical-edge copies, reference order S, N, W, E (solver.f:2057-2060);
    # sft-based full-array form (SPMD/pad-safe)
    wr = set_j(wr, 0, sft(wr, 0, 1))
    wr = set_j(wr, -1, sft(wr, 0, -1))
    wr = set_i(wr, 0, sft(wr, 1, 0))
    wr = set_i(wr, -1, sft(wr, -1, 0))

    return put(wr * grid.fsm, wr, *s_[kbm1:])
