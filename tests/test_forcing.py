"""Forcing provider: record interpolation, boundary depth-integration, and
the tidal-channel end-to-end run (BASELINE config 3)."""

import numpy as np
import pytest

from extpom_tpu.forcing.provider import ArraySource, ForcingProvider, TBC


def test_linear_interpolation_and_hold():
    from extpom_tpu.cases.seamount import seamount_case
    from extpom_tpu.core.model import Model

    cfg, grid, ics = seamount_case(im=17, jm=17, kb=7, dtype="float64")
    m = Model(grid, cfg, tb=ics["tb"], sb=ics["sb"], donate=False)

    # wind record series: wusurf ramps 0 -> 1 across records (0.125 d apart)
    nrec = 4
    wu = np.arange(nrec)[:, None, None] * np.ones((nrec, 17, 17))
    src = ArraySource({"wusurf": wu})
    prov = ForcingProvider(grid, cfg, m.base_forcing, src)

    # dti = 180 s; at iint such that t = 0.0625 d (half a record) expect 0.5
    iint = int(0.0625 * 86400 / cfg.dti)
    fc = prov(m, iint)
    t_days = cfg.dti * iint / 86400.0
    expected = t_days / 0.125
    np.testing.assert_allclose(np.asarray(fc.wusurf)[0, 0], expected,
                               rtol=1e-6)
    # clamping: far beyond the series -> hold the last record
    fc = prov(m, int(10.0 * 86400 / cfg.dti))
    np.testing.assert_allclose(np.asarray(fc.wusurf)[0, 0], nrec - 1)


def test_boundary_depth_integration():
    from extpom_tpu.cases.seamount import seamount_case
    from extpom_tpu.core.model import Model

    cfg, grid, ics = seamount_case(im=17, jm=17, kb=7, dtype="float64")
    m = Model(grid, cfg, tb=ics["tb"], sb=ics["sb"], donate=False)
    # uniform 0.3 m/s western boundary profile -> uabw = 0.3 (sum dz = 1)
    nrec = 3
    ubw = 0.3 * np.ones((nrec, cfg.kb, cfg.jm))
    prov = ForcingProvider(grid, cfg, m.base_forcing,
                           ArraySource({"ubw": ubw}))
    fc = prov(m, 1)
    dzsum = float(np.asarray(grid.dz)[:cfg.kbm1].sum())
    np.testing.assert_allclose(np.asarray(fc.uabw), 0.3 * dzsum, rtol=1e-6)


def test_tidal_channel_runs():
    from extpom_tpu.cases.channel import channel_model

    m = channel_model(im=49, jm=17, kb=7, dtype="float64", tide_amp=0.2)
    m.run(n_steps=20)
    el = np.asarray(m.state.el)
    assert np.all(np.isfinite(el))
    # the tide must have entered the channel: nonzero elevation inside
    assert float(np.abs(el[1:10, 1:-1]).max()) > 0.005
    # and salinity must remain uniform (no spurious sources)
    s = np.asarray(m.state.s)[:m.cfg.kbm1, :, 1:-1]
    np.testing.assert_allclose(s, 15.0, atol=1e-6)


def test_device_plan_scan_matches_host_path():
    """Staged device-side forcing interpolation inside lax.scan
    (forcing.device) reproduces the per-step host provider path on the
    tidal channel (bounds_forcing.f:841-865 cadence logic)."""
    import numpy as np
    from extpom_tpu.cases.channel import channel_model

    N = 10
    m1 = channel_model(im=33, jm=17, kb=7, dtype="float64")
    m1.run(n_steps=N)
    m2 = channel_model(im=33, jm=17, kb=7, dtype="float64")
    m2.run_segment(N)
    for name in ("el", "ua", "va", "u", "t", "s"):
        a = np.asarray(getattr(m1.state, name))
        b = np.asarray(getattr(m2.state, name))
        tol = 1e-12 * max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=name)


def test_chunked_staging_matches_full():
    """When the forcing series exceeds the HBM budget, run_segment stages
    per-segment record WINDOWS and re-stages between segments
    (forcing/device.py; the one-record-pair streaming analogue,
    bounds_forcing.f:607-613).  Chunked staging must be bit-identical to
    full staging across segment boundaries."""
    import numpy as np
    from extpom_tpu.cases.channel import channel_model
    from extpom_tpu.forcing.device import plan_bytes

    m1 = channel_model(im=33, jm=17, kb=7, dtype="float64")
    for n in (6, 6, 6):
        m1.run_segment(n)

    m2 = channel_model(im=33, jm=17, kb=7, dtype="float64",
                       forcing_hbm_mb=0)     # force windowed staging
    assert plan_bytes(m2.forcing_fn) > 0
    # the staged window is a strict subset of the full series
    win = m2._device_plan(0.0, 6 * m2.cfg.dti / 86400.0)
    full = m2._device_plan()
    assert win.stacks[0].shape[0] < full.stacks[0].shape[0]
    for n in (6, 6, 6):
        m2.run_segment(n)

    for name in ("el", "ua", "va", "u", "t", "s"):
        a = np.asarray(getattr(m1.state, name))
        b = np.asarray(getattr(m2.state, name))
        tol = 1e-12 * max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=name)


def test_multisource_merge_and_native_interp_protocol():
    """MultiSource (forcing/provider.py): ownership resolved once at
    construction, duplicate names loud, and the fused-interp protocol —
    an owner WITH ``interp`` serves it, an owner without declines (None)
    so the provider's cached double-buffer path handles the variable."""
    from extpom_tpu.forcing.provider import MultiSource

    a = ArraySource({"wusurf": np.zeros((2, 4, 4))})

    class Fused(ArraySource):
        def interp(self, name, x):
            return np.full((4, 4), 42.0 + x)

    b = Fused({"wtsurf": np.ones((2, 4, 4))})
    ms = MultiSource([a, b])
    assert sorted(ms.names()) == ["wtsurf", "wusurf"]
    assert ms.nrec("wusurf") == 2
    np.testing.assert_array_equal(ms.read("wtsurf", 1), np.ones((4, 4)))
    # interp protocol: delegate vs decline
    np.testing.assert_allclose(ms.interp("wtsurf", 0.5), 42.5)
    assert ms.interp("wusurf", 0.5) is None
    with pytest.raises(KeyError):
        ms.nrec("nope")
    # duplicate-name policy: loud at construction
    with pytest.raises(ValueError, match="wusurf"):
        MultiSource([a, ArraySource({"wusurf": np.zeros((1, 4, 4))})])


def test_multisource_through_provider():
    """A merged source behind the provider: the declined variable takes
    the generic interpolation path, the fused one bypasses it."""
    from extpom_tpu.cases.seamount import seamount_case
    from extpom_tpu.core.model import Model
    from extpom_tpu.forcing.provider import MultiSource

    cfg, grid, ics = seamount_case(im=17, jm=17, kb=7, dtype="float64")
    m = Model(grid, cfg, tb=ics["tb"], sb=ics["sb"], donate=False)

    wu = np.arange(4)[:, None, None] * np.ones((4, 17, 17))

    class Fused(ArraySource):
        def interp(self, name, x):
            a = self.data[name]
            n = int(np.floor(x))
            lo = a[min(max(n, 0), a.shape[0] - 1)]
            hi = a[min(max(n + 1, 0), a.shape[0] - 1)]
            return (1.0 - (x - n)) * lo + (x - n) * hi

    wt = -np.arange(4)[:, None, None] * np.ones((4, 17, 17))
    src = MultiSource([ArraySource({"wusurf": wu}),
                       Fused({"wtsurf": wt})])
    prov = ForcingProvider(grid, cfg, m.base_forcing, src)
    iint = int(0.0625 * 86400 / cfg.dti)
    t_days = cfg.dti * iint / 86400.0
    fc = prov(m, iint)
    np.testing.assert_allclose(np.asarray(fc.wusurf)[0, 0],
                               t_days / 0.125, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(fc.wtsurf)[0, 0],
                               -t_days / 0.125, rtol=1e-6)
