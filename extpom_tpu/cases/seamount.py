"""Seamount test case.

The canonical POM validation problem: a stratified f-plane basin with a
Gaussian seamount, optional uniform zonal inflow, radiation open boundaries
(the reference's ``bcondorl`` is "specialized for the seamount problem",
bounds_forcing.f:333-334).  The reference reads this setup from prepared
netCDF files; here it is generated directly.

Defaults follow the classic seamount configuration: 8 km spacing, 4500 m
depth with a 90 % Gaussian bump of 25 km e-folding radius, exponential
thermal stratification ``t = 5 + 15 exp(zz h / 1000)``, uniform salinity.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from extpom_tpu.core.config import Config
from extpom_tpu.core.grid import Grid, make_grid, sigma_levels


def seamount_case(im: int = 65, jm: int = 49, kb: int = 21,
                  dx0: float = 8000.0,
                  depth: float = 4500.0, delh: float = 0.9,
                  ra: float = 25000.0,
                  lat: float = 45.0,
                  vel: float = 0.2,
                  tbias: float = 10.0, sbias: float = 20.0,
                  stretched: bool = True,
                  **cfg_kw) -> Tuple[Config, Grid, dict]:
    """Build (cfg, grid, ics).

    ``ics`` holds numpy arrays: tb, sb, tclim, sclim, elb, uab, vab
    (3-D fields shaped (kb, im, jm)).  ``vel`` is the uniform eastward
    depth-mean inflow; 0 gives a closed adjustment problem.
    """
    cfg_kw.setdefault("mode", 3)
    cfg_kw.setdefault("bc_scheme", "extpom")
    cfg_kw.setdefault("dte", 6.0)
    cfg_kw.setdefault("isplit", 30)
    cfg_kw.setdefault("lramp", True)
    cfg = Config(im=im, jm=jm, kb=kb, tbias=tbias, sbias=sbias, **cfg_kw)

    z, zz = sigma_levels(kb, kl1=6 if stretched else None)

    dx = np.full((im, jm), dx0)
    dy = np.full((im, jm), dx0)

    # Gaussian seamount centered in the domain
    x = (np.arange(im) - (im - 1) / 2.0)[:, None] * dx0
    y = (np.arange(jm) - (jm - 1) / 2.0)[None, :] * dx0
    h = depth * (1.0 - delh * np.exp(-(x ** 2 + y ** 2) / ra ** 2))
    # flatten the rim rows so open boundaries see uniform depth
    h[0, :] = h[1, :]
    h[-1, :] = h[-2, :]
    h[:, 0] = h[:, 1]
    h[:, -1] = h[:, -2]

    fsm = np.ones((im, jm))
    cor = np.full((im, jm), 2.0 * 7.29e-5 * np.sin(np.deg2rad(lat)))

    grid = make_grid(cfg, z, zz, dx, dy, h, fsm, cor=cor)

    # exponential stratification; biases removed as the reference stores
    # anomalies (initialize.f:161-162 tbias/sbias)
    tb = 5.0 + 15.0 * np.exp(zz[:, None, None] * h[None] / 1000.0) - tbias
    tb = np.broadcast_to(tb, (kb, im, jm)).copy()
    tb[-1] = tb[-2]
    sb = np.full((kb, im, jm), 35.0 - sbias)

    uab = np.full((im, jm), vel)
    vab = np.zeros((im, jm))
    elb = np.zeros((im, jm))

    ics = dict(tb=tb, sb=sb, tclim=tb.copy(), sclim=sb.copy(),
               elb=elb, uab=uab, vab=vab)
    return cfg, grid, ics


def seamount_model(donate: bool = False, **kw):
    """Convenience: build a ready-to-run Model for the seamount case.

    ``donate`` donates the state buffers of the step-at-a-time path
    (:meth:`Model.step_once`); the scanned segments never donate."""
    from extpom_tpu.core.model import Model
    cfg, grid, ics = seamount_case(**kw)
    return Model(grid, cfg, tb=ics["tb"], sb=ics["sb"],
                 tclim=ics["tclim"], sclim=ics["sclim"],
                 elb=ics["elb"], uab=ics["uab"], vab=ics["vab"],
                 donate=donate)
