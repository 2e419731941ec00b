"""Provenance-independent physics validation.

Every numerical test elsewhere in the suite ultimately compares against
tests/reference/pom_ref.py — the builder's own NumPy transcription of
solver.f — so a systematic misreading of the Fortran could co-sign itself.
These tests check physical invariants no transcription error can fake:

* mirror symmetry on a symmetric seamount (a single transposed index or
  swapped i/j constant in any kernel breaks it loudly),
* the analytic shallow-water gravity-wave phase speed sqrt(gH),
* persistence of an exact geostrophic balance,
* volume/salt conservation drift bounds over hundreds of steps.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from extpom_tpu.core.config import Config
from extpom_tpu.core.grid import make_grid, sigma_levels
from extpom_tpu.core.model import Model
from extpom_tpu.cases.seamount import seamount_model


def _sym_model(n_steps, im=33, jm=33, kb=7, mode=3):
    """Symmetric seamount, f=0, started from a centered elevation bump at
    rest: the solution must stay mirror-symmetric in BOTH horizontal
    directions for all time."""
    cfg = Config(im=im, jm=jm, kb=kb, mode=mode, dte=6.0, isplit=6,
                 dtype="float64", bc_scheme="orlanski", lramp=False)
    z, zz = sigma_levels(kb)
    dx0 = 8000.0
    x = (np.arange(im) - (im - 1) / 2.0)[:, None] * dx0
    y = (np.arange(jm) - (jm - 1) / 2.0)[None, :] * dx0
    h = 4500.0 * (1.0 - 0.9 * np.exp(-(x ** 2 + y ** 2) / 25000.0 ** 2))
    dx = np.full((im, jm), dx0)
    grid = make_grid(cfg, z, zz, dx, dx, h, np.ones((im, jm)),
                     cor=np.zeros((im, jm)))
    tb = np.broadcast_to(
        5.0 + 15.0 * np.exp(zz[:, None, None] * h[None] / 1000.0),
        (kb, im, jm)).copy()
    tb[-1] = tb[-2]
    sb = np.full((kb, im, jm), 35.0)
    elb = 0.2 * np.exp(-(x ** 2 + y ** 2) / 30000.0 ** 2)
    m = Model(grid, cfg, tb=tb, sb=sb, elb=elb, donate=False)
    for _ in range(n_steps):
        m.step_once()
    return m


@pytest.mark.parametrize("mode", [2, 3])
def test_mirror_symmetry(mode):
    m = _sym_model(30, mode=mode)
    st = m.state
    tol = 1e-11

    def sym(a, name):   # cell-centered fields: a == flip(a)
        a = np.asarray(a)
        for ax in (-2, -1):
            err = np.max(np.abs(a - np.flip(a, axis=ax)))
            assert err < tol * max(1.0, np.abs(a).max()), (name, ax, err)

    def antisym_i(a, name):  # u-staggered: u[i] == -u[im-i], faces 1..im-1
        a = np.asarray(a)[..., 1:, :]
        err = np.max(np.abs(a + np.flip(a, axis=-2)))
        assert err < tol * max(1.0, np.abs(a).max()), (name, err)

    def antisym_j(a, name):
        a = np.asarray(a)[..., :, 1:]
        err = np.max(np.abs(a + np.flip(a, axis=-1)))
        assert err < tol * max(1.0, np.abs(a).max()), (name, err)

    sym(st.el, "el")
    antisym_i(st.ua, "ua")
    antisym_j(st.va, "va")
    if mode != 2:
        # 3-D fields: interior cells only — the reference's own edge loop
        # ranges are one-sided (e.g. profq's i=1..imm1 surface-stress
        # average, solver.f:1281-1290), so exact mirror symmetry holds on
        # the interior; a transposed interior index still breaks this
        def sym_int(a, name):
            b = np.asarray(a)[..., 2:-2, 2:-2]
            for ax in (-2, -1):
                err = np.max(np.abs(b - np.flip(b, axis=ax)))
                assert err < tol * max(1.0, np.abs(b).max()), (name, ax,
                                                               err)

        sym_int(st.t, "t")
        sym_int(st.s, "s")
        sym_int(st.q2, "q2")
        # staggered faces: u[i] pairs with -u[im-i] -> slice [2:-1]
        u = np.asarray(st.u)[..., 2:-1, 2:-2]
        assert np.max(np.abs(u + np.flip(u, axis=-2))) < tol, "u anti"
        assert np.max(np.abs(u - np.flip(u, axis=-1))) < tol, "u tang"
        v = np.asarray(st.v)[..., 2:-2, 2:-1]
        assert np.max(np.abs(v + np.flip(v, axis=-1))) < tol, "v anti"
        assert np.max(np.abs(v - np.flip(v, axis=-2))) < tol, "v tang"


def test_gravity_wave_phase_speed():
    """Barotropic gravity wave on a flat bottom: crest speed = sqrt(gH)
    to ~1 % (solver.f:848-940's external dynamics; independent of any
    oracle)."""
    im, jm, kb = 201, 7, 5
    depth = 100.0
    dx0 = 1000.0
    cfg = Config(im=im, jm=jm, kb=kb, mode=2, dte=2.0, isplit=5,
                 dtype="float64", bc_scheme="orlanski", lramp=False)
    z, zz = sigma_levels(kb)
    fsm = np.ones((im, jm))
    fsm[:, 0] = fsm[:, -1] = 0.0     # channel walls
    grid = make_grid(cfg, z, zz, np.full((im, jm), dx0),
                     np.full((im, jm), dx0), np.full((im, jm), depth),
                     fsm, cor=np.zeros((im, jm)))
    x = (np.arange(im) - (im - 1) / 2.0)[:, None] * dx0
    elb = 0.05 * np.exp(-(x ** 2) / 5000.0 ** 2) * np.ones((1, jm))
    tb = np.full((kb, im, jm), 10.0)
    sb = np.full((kb, im, jm), 35.0)
    m = Model(grid, cfg, tb=tb, sb=sb, elb=elb, donate=False)

    def crest(el):
        """Sub-cell rightward crest position by parabolic fit."""
        prof = np.asarray(el)[:, jm // 2]
        half = prof.copy()
        half[: im // 2 + 2] = -1.0    # track the right-going crest only
        i = int(np.argmax(half))
        a, b, c = prof[i - 1], prof[i], prof[i + 1]
        return i + 0.5 * (a - c) / (a - 2 * b + c)

    n1, n2 = 32, 80
    for _ in range(n1):
        m.step_once()
    x1 = crest(m.state.el)
    for _ in range(n2 - n1):
        m.step_once()
    x2 = crest(m.state.el)
    speed = (x2 - x1) * dx0 / ((n2 - n1) * cfg.dti)
    c_exact = np.sqrt(cfg.grav * depth)
    assert abs(speed - c_exact) / c_exact < 0.01, (speed, c_exact)


def test_geostrophic_balance_persists():
    """An exactly balanced jet (f u = -g d el/dy) on a flat-bottom f-plane
    channel must stay steady: el drift over 60 external steps bounded by a
    small fraction of the initial tilt."""
    im, jm, kb = 65, 33, 5
    depth = 1000.0
    dx0 = 10000.0
    f0 = 1.0e-4
    u0 = 0.5
    cfg = Config(im=im, jm=jm, kb=kb, mode=2, dte=6.0, isplit=6,
                 dtype="float64", bc_scheme="file", lramp=False)
    z, zz = sigma_levels(kb)
    fsm = np.ones((im, jm))
    fsm[:, 0] = fsm[:, -1] = 0.0
    grid = make_grid(cfg, z, zz, np.full((im, jm), dx0),
                     np.full((im, jm), dx0), np.full((im, jm), depth),
                     fsm, cor=np.full((im, jm), f0))
    y = (np.arange(jm) - (jm - 1) / 2.0)[None, :] * dx0
    elb = np.broadcast_to(-(f0 * u0 / cfg.grav) * y, (im, jm)).copy()
    uab = np.full((im, jm), u0)
    tb = np.full((kb, im, jm), 10.0)
    sb = np.full((kb, im, jm), 35.0)
    m = Model(grid, cfg, tb=tb, sb=sb, elb=elb, uab=uab, donate=False)
    el0 = np.asarray(m.state.el)
    for _ in range(10):
        m.step_once()
    drift = np.abs(np.asarray(m.state.el) - el0)[2:-2, 2:-2].max()
    tilt = el0.max() - el0.min()
    assert drift < 0.02 * tilt, (drift, tilt)


def test_internal_wave_phase_speed():
    """Mode-1 internal gravity wave on a two-layer stratification in a
    flat non-rotating channel: crest speed = sqrt(g' h1 h2 / (h1+h2)) to
    ~10 % (two-layer analytic; the tanh interface and sigma
    discretization account for the slack).  Exercises the BAROCLINIC
    dynamics — baropg (solver.f:848-940), tracer advection, dens, and
    the mode split — against an analytic number no transcription of the
    Fortran can fake."""
    im, jm, kb = 201, 7, 17
    depth = 100.0
    h1 = 50.0
    dx0 = 1000.0
    cfg = Config(im=im, jm=jm, kb=kb, mode=3, dte=8.0, isplit=30,
                 dtype="float64", bc_scheme="orlanski", lramp=False,
                 smoth=0.1)
    z, zz = sigma_levels(kb)
    fsm = np.ones((im, jm))
    fsm[:, 0] = fsm[:, -1] = 0.0     # channel walls
    grid = make_grid(cfg, z, zz, np.full((im, jm), dx0),
                     np.full((im, jm), dx0), np.full((im, jm), depth),
                     fsm, cor=np.zeros((im, jm)))

    # two layers (T 20 over T 10, S uniform) with the interface displaced
    # downward by a Gaussian bump: a pure mode-1 internal wave initial
    # condition (started at rest; it splits into +-x-going crests)
    x = (np.arange(im) - (im - 1) / 2.0)[None, :, None] * dx0
    zdep = zz[:, None, None] * depth           # (kb, 1, 1), negative down
    amp, sigma_x, thick = 5.0, 8000.0, 10.0
    eta = amp * np.exp(-(x ** 2) / sigma_x ** 2)        # (1, im, 1)
    tb = np.broadcast_to(
        15.0 + 5.0 * np.tanh((zdep + h1 + eta) / thick),
        (kb, im, jm)).copy()
    tb[-1] = tb[-2]
    sb = np.full((kb, im, jm), 35.0)
    # climatology = the UNDISTURBED stratification: rmean (initialize.f:416)
    # is subtracted inside baropg (solver.f:854), so a tclim equal to tb
    # (the Model default) would cancel the very pressure anomaly that
    # drives the wave
    tclim = np.broadcast_to(
        15.0 + 5.0 * np.tanh((zdep + h1) / thick), (kb, im, jm)).copy()
    tclim[-1] = tclim[-2]
    m = Model(grid, cfg, tb=tb, sb=sb, tclim=tclim, sclim=sb,
              donate=False)

    # reduced gravity from the model's own (oracle-tested) EOS: dens
    # returns (rho-1000)/rhoref, so g' = g (rho_bot - rho_top) rhoref/rho0
    # ~ g * d(rho_model)
    rho0 = np.asarray(m.state.rho)
    drho = float(rho0[kb - 2, 5, jm // 2] - rho0[1, 5, jm // 2])
    c_exact = np.sqrt(cfg.grav * drho * (h1 * (depth - h1) / depth))

    def crest(st):
        """Rightward interface-depression crest via the column heat
        anomaly (interface deeper by d -> column-mean T up by d dT/H)."""
        t = np.asarray(st.t)[: kb - 1, :, jm // 2]
        col = (t * (z[:-1] - z[1:])[:, None]).sum(axis=0)
        prof = col - col[5]
        half = prof.copy()
        half[: im // 2 + 3] = -1e9
        i = int(np.argmax(half))
        a, b, c = prof[i - 1], prof[i], prof[i + 1]
        return i + 0.5 * (a - c) / (a - 2 * b + c)

    n1, n2 = 40, 140
    for _ in range(n1):
        m.step_once()
    x1 = crest(m.state)
    for _ in range(n2 - n1):
        m.step_once()
    x2 = crest(m.state)
    speed = (x2 - x1) * dx0 / ((n2 - n1) * cfg.dti)
    assert abs(speed - c_exact) / c_exact < 0.10, (speed, c_exact)


def test_kelvin_wave_speed_and_direction():
    """Coastal Kelvin wave on an f-plane: a bump trapped against the
    south wall with the Rossby-radius offshore decay must propagate in +x
    (coast on its right, f > 0) at sqrt(gH) to ~5 % (the C-grid carries
    an O((dx/R)^2) discrete-dispersion slowdown; dx/R = 0.16 here,
    measured -3 %), while no comparable signal moves the other way —
    Coriolis, boundary masking, and the external dynamics exercised
    together against analytic numbers."""
    im, jm, kb = 201, 33, 5
    depth = 100.0
    dx0 = 5000.0
    f0 = 5.0e-4      # R = sqrt(gH)/f ~ 63 km = 12.5 cells: trapped well
                     # inside the 165 km channel
    cfg = Config(im=im, jm=jm, kb=kb, mode=2, dte=10.0, isplit=5,
                 dtype="float64", bc_scheme="orlanski", lramp=False)
    z, zz = sigma_levels(kb)
    fsm = np.ones((im, jm))
    fsm[:, 0] = fsm[:, -1] = 0.0
    grid = make_grid(cfg, z, zz, np.full((im, jm), dx0),
                     np.full((im, jm), dx0), np.full((im, jm), depth),
                     fsm, cor=np.full((im, jm), f0))
    c_exact = np.sqrt(cfg.grav * depth)
    R = c_exact / f0                              # Rossby radius (~31 km)
    x = (np.arange(im) - (im - 1) / 2.0)[:, None] * dx0
    y = (np.arange(jm) - 1.0)[None, :] * dx0      # offshore of the wall
    elb = 0.05 * np.exp(-(x ** 2) / 20000.0 ** 2) * np.exp(-y / R)
    # geostrophically balanced alongshore jet of the Kelvin solution:
    # u = el sqrt(g/H)
    uab = elb * np.sqrt(cfg.grav / depth)
    tb = np.full((kb, im, jm), 10.0)
    sb = np.full((kb, im, jm), 35.0)
    m = Model(grid, cfg, tb=tb, sb=sb, elb=elb, uab=uab, donate=False)

    def coast_profile(st):
        return np.asarray(st.el)[:, 1]

    def crest(prof):
        i = int(np.argmax(prof))
        a, b, c = prof[i - 1], prof[i], prof[i + 1]
        return i + 0.5 * (a - c) / (a - 2 * b + c)

    x0 = crest(coast_profile(m.state))
    n = 40
    for _ in range(n):
        m.step_once()
    x1 = crest(coast_profile(m.state))
    speed = (x1 - x0) * dx0 / (n * cfg.dti)
    assert speed > 0, "Kelvin wave must travel with the coast on its right"
    assert abs(speed - c_exact) / c_exact < 0.05, (speed, c_exact)
    # trapped: the crest amplitude holds up (no fast dispersion) and the
    # offshore structure keeps ~the Rossby-radius decay
    j_e = 1 + int(round(R / dx0))
    row = np.asarray(m.state.el)[int(round(x1))]
    assert row[j_e] / row[1] == pytest.approx(np.exp(-1.0), rel=0.25)


def test_wind_driven_gyre_western_intensification():
    """Stommel/Munk gyre on a beta plane (cases/basin.py): a closed basin
    under a single-gyre wind (curl tau < 0 everywhere) must develop a
    southward Sverdrup interior with its return flow intensified against
    the WESTERN boundary — the beta effect, exercising wind forcing,
    Coriolis variation, continuity, and the closed-wall masks together.
    At 20 days' spin-up the measured west/east |v| ratio is ~12; the
    gate is conservative."""
    from extpom_tpu.cases.basin import basin_model

    m = basin_model(im=41, jm=41, kb=5, dtype="float64")
    steps = int(12.0 * 86400 / m.cfg.dti)    # 12 days' spin-up
    m.run_segment(steps)
    va = np.asarray(m.state.va)
    im, jm = va.shape
    third = im // 3
    w = np.abs(va[1:third, 1:-1]).max()
    e = np.abs(va[-third:-1, 1:-1]).max()
    assert w > 3.0 * e, (w, e)               # western intensification
    assert va[third:-third, jm // 3:2 * jm // 3].mean() < 0.0  # Sverdrup
    assert va[2:6, jm // 3:2 * jm // 3].mean() > 0.0   # northward WBC
    assert np.isfinite(np.asarray(m.state.el)).all()


def test_conservation_drift():
    """Volume and salt totals over 200 internal steps: relative drift
    bounds (the domain_stats oracle of advance.f:644-756, tightened from
    'finite' to relative thresholds)."""
    from extpom_tpu.diag import stats as diag_stats
    m = seamount_model(im=33, jm=33, kb=7, dtype="float64", donate=False,
                       isplit=6)
    s0 = {k: float(v) for k, v in diag_stats.domain_stats(
        m.grid, m.cfg, m.state).items()}
    for _ in range(200):
        m.step_once()
    s1 = {k: float(v) for k, v in diag_stats.domain_stats(
        m.grid, m.cfg, m.state).items()}
    assert abs(s1["vtot"] - s0["vtot"]) / s0["vtot"] < 1e-3
    assert abs(s1["saver"] - s0["saver"]) / s0["saver"] < 1e-4
    assert abs(s1["taver"] - s0["taver"]) / max(abs(s0["taver"]), 1.0) < 1e-2
    assert np.isfinite(s1["ekin"])


def test_mpdata_monotonicity():
    """Smolarkiewicz MPDATA (nadv=2, solver.f:577-731) must be positive-
    definite and essentially non-oscillatory: advecting a [0, 1] blob
    with an exactly (discretely) divergence-free rotating flow must
    create no negative values and no new extrema beyond roundoff —
    the property the scheme exists to provide, checked directly on the
    op (no oracle involved).  The central scheme (nadv=1) demonstrably
    rings on the same problem, confirming the test discriminates."""
    from extpom_tpu.core.grid import make_grid, sigma_levels
    from extpom_tpu.ops import tracers

    im = jm = 49
    kb = 5
    dx0 = 1000.0
    depth = 100.0
    cfg = Config(im=im, jm=jm, kb=kb, mode=3, nadv=2, nitera=2, sw=0.5,
                 dte=4.0, isplit=5, dtype="float64", tprni=0.0)
    z, zz = sigma_levels(kb)
    fsm = np.ones((im, jm))
    fsm[0] = fsm[-1] = fsm[:, 0] = fsm[:, -1] = 0.0
    grid = make_grid(cfg, z, zz, np.full((im, jm), dx0),
                     np.full((im, jm), dx0), np.full((im, jm), depth),
                     fsm, cor=np.zeros((im, jm)))

    # corner streamfunction -> EXACTLY divergence-free C-grid velocities
    # (u = dpsi/dy, v = -dpsi/dx): solid-body-like vortex
    xc = (np.arange(im + 1) - im / 2.0)[:, None] * dx0
    yc = (np.arange(jm + 1) - jm / 2.0)[None, :] * dx0
    # scaled for u_max ~ 5 m/s (CFL ~ 0.2 at dti2 = 40 s)
    psi = 6.0e4 * np.exp(-(xc ** 2 + yc ** 2) / (12.0 * dx0) ** 2)
    u2 = (psi[:im, 1:] - psi[:im, :jm]) / dx0
    v2 = -(psi[1:, :jm] - psi[:im, :jm]) / dx0
    u = np.broadcast_to(u2, (kb, im, jm)).copy()
    v = np.broadcast_to(v2, (kb, im, jm)).copy()
    u[-1] = v[-1] = 0.0
    w = np.zeros((kb, im, jm))

    # blob in [0, 1] offset from the vortex center
    x = (np.arange(im) - im / 2.0)[:, None] * dx0
    y = (np.arange(jm) - jm / 2.0)[None, :] * dx0
    blob2 = np.exp(-((x - 8 * dx0) ** 2 + y ** 2) / (4.0 * dx0) ** 2)
    f0 = np.broadcast_to(blob2, (kb, im, jm)).copy()
    f0[-1] = f0[-2]

    dt2 = np.full((im, jm), depth)
    zero2 = np.zeros((im, jm))
    aam = np.zeros((kb, im, jm))
    fclim = np.zeros((kb, im, jm))

    args = [jnp.asarray(a) for a in (fclim, u, v, w, aam, dt2,
                                     zero2, zero2)]

    def run(adv, n=30):
        fb = f = jnp.asarray(f0)
        for _ in range(n):
            ff = adv(grid, cfg, fb, f, *args)
            fb = f
            f = ff
        return np.asarray(f)

    out = run(tracers.advt2)
    assert out.min() >= -1e-12, out.min()             # positive definite
    assert out.max() <= f0.max() * (1.0 + 1e-6), out.max()  # no new max

    # discriminator: the central scheme rings (new extrema) on the same
    # problem, so a broken MPDATA path could not hide behind it
    out1 = run(tracers.advt1)
    assert out1.min() < -1e-4 or out1.max() > f0.max() * 1.001


def test_seamount_sigma_pg_error():
    """The canonical sigma-coordinate pressure-gradient error experiment
    (the seamount problem the reference's rmean subtraction and McCalpin
    scheme exist to mitigate, solver.f:848-940 / 943-1159): LEVEL
    stratification t(z) over a steep seamount, started at rest, no
    forcing, T/S frozen (mode 4).  The exact solution is rest; every
    velocity is discrete PG truncation error.  Provenance-independent
    assertions:

    * npg=1 with a non-cancelling climatology produces spurious currents
      (nonzero: the error exists; bounded: the scheme is sane at the
      classic delh=0.9 steepness — measured 0.50 m/s at 80 steps with
      the FULL stratification uncancelled, far above the cm/s the
      reference achieves in practice because its rmean subtracts the
      bulk z-structure, which is exactly what the cancel case shows);
    * the 4th-order McCalpin scheme (npg=2) cuts the steep-topography
      error roughly in half (measured ratio 0.48; at gentler delh the
      wider stencil does NOT pay on this coarse grid — ratio > 1 at
      delh <= 0.7 — so the assertion pins the steep regime the scheme
      exists for, Berntsen & Oey 2010 via solver.f:943-1159);
    * rmean subtraction with matching climatology cancels the error to
      roundoff — the design intent of initialize.f:416 / solver.f:854.
    """
    from extpom_tpu.cases.seamount import seamount_case
    from extpom_tpu.core.model import Model

    cfg, grid, ics = seamount_case(
        im=33, jm=33, kb=21, vel=0.0, mode=4, dtype="float64",
        lramp=False, bc_scheme="orlanski")
    tb, sb = ics["tb"], ics["sb"]
    tclim_flat = np.full_like(tb, float(tb.mean()))

    def spurious(npg, cancel):
        m = Model(grid, cfg.replace(npg=npg), tb=tb, sb=sb,
                  tclim=(tb if cancel else tclim_flat), sclim=sb,
                  donate=False)
        m.run_segment(80)             # 4 hours at dti = 180 s
        u = np.asarray(m.state.u)[: cfg.kbm1, 2:-2, 2:-2]
        v = np.asarray(m.state.v)[: cfg.kbm1, 2:-2, 2:-2]
        return float(max(np.abs(u).max(), np.abs(v).max()))

    e1 = spurious(1, cancel=False)
    e2 = spurious(2, cancel=False)
    e0 = spurious(1, cancel=True)
    # measured e1 = 0.503, e2 = 0.243 (f64, this grid/horizon)
    assert 1e-3 < e1 < 1.0, e1
    assert e2 < 0.8 * e1, (e2, e1)    # 4th-order better where it counts
    assert e0 < 1e-8, e0              # rmean cancellation
