"""Zarr I/O: restart round-trip seamlessness, output snapshots, and the
Zarr-backed forcing source (BASELINE config 4 machinery)."""

import numpy as np
import pytest

from extpom_tpu.io import zarrstore as zio


@pytest.mark.skipif(not zio.HAVE_TS, reason="tensorstore unavailable")
def test_restart_roundtrip_bitwise(tmp_path):
    """Write restart at step 3, resume, and match a straight 6-step run
    bitwise (the reference's restart is seamless for the same reason:
    every time level is saved, io_pnetcdf.F:1674-1678)."""
    from extpom_tpu.cases.seamount import seamount_model

    m1 = seamount_model(im=17, jm=17, kb=7, donate=False, dtype="float64")
    m1.run(n_steps=6)
    el_a = np.asarray(m1.state.el).copy()

    m2 = seamount_model(im=17, jm=17, kb=7, donate=False, dtype="float64")
    m2.run(n_steps=3)
    zio.write_restart(str(tmp_path / "rst"), m2.state, m2.iint)

    m3 = seamount_model(im=17, jm=17, kb=7, donate=False, dtype="float64")
    st, iint, time0 = zio.read_restart(str(tmp_path / "rst"), m3.cfg)
    m3.state, m3.iint, m3.time0 = st, iint, time0
    m3.run(n_steps=3)
    np.testing.assert_array_equal(el_a, np.asarray(m3.state.el))


@pytest.mark.skipif(not zio.HAVE_TS, reason="tensorstore unavailable")
def test_output_snapshot(tmp_path):
    from extpom_tpu.cases.seamount import seamount_model
    from extpom_tpu.diag import stats as diag_stats

    m = seamount_model(im=17, jm=17, kb=7, donate=False, dtype="float64")
    m.run(n_steps=2)
    stats = {k: float(v) for k, v in
             diag_stats.domain_stats(m.grid, m.cfg, m.state).items()}
    zio.write_output(str(tmp_path / "out"), m.grid, m.cfg, m.state,
                     m.time_days, stats)
    snap = zio.read_output(str(tmp_path / "out"))
    np.testing.assert_array_equal(snap["t"], np.asarray(m.state.t))
    np.testing.assert_array_equal(snap["h"], np.asarray(m.grid.h))
    assert snap["attrs"]["stats"]["vtot"] == stats["vtot"]
    assert snap["attrs"]["time_days"] == m.time_days


@pytest.mark.skipif(not zio.HAVE_TS, reason="tensorstore unavailable")
def test_zarr_forcing_source(tmp_path):
    from extpom_tpu.cases.seamount import seamount_case
    from extpom_tpu.core.model import Model
    from extpom_tpu.forcing.provider import ForcingProvider

    cfg, grid, ics = seamount_case(im=17, jm=17, kb=7, dtype="float64")
    m = Model(grid, cfg, tb=ics["tb"], sb=ics["sb"], donate=False)

    nrec = 5
    wu = np.arange(nrec)[:, None, None] * np.ones((nrec, 17, 17))
    zio.write_forcing_series(str(tmp_path / "sfrc"), {"wusurf": wu})
    src = zio.ZarrSource(str(tmp_path / "sfrc"))
    assert src.nrec("wusurf") == nrec

    prov = ForcingProvider(grid, cfg, m.base_forcing, src)
    iint = int(0.0625 * 86400 / cfg.dti)
    fc = prov(m, iint)
    t_days = cfg.dti * iint / 86400.0
    np.testing.assert_allclose(np.asarray(fc.wusurf)[0, 0],
                               t_days / 0.125, rtol=1e-6)


def test_netcdf_output_bridge(tmp_path):
    """NetCDF-3 snapshot bridge (io/netcdf.py): write_output_nc and the
    zarr->nc converter must carry the reference's variable names,
    (time, z, y, x) dimension order and scalar diagnostics
    (write_output_pnetcdf, io_pnetcdf.F:57-410), bit-equal to the
    in-memory fields."""
    from scipy.io import netcdf_file
    from extpom_tpu.cases.seamount import seamount_model
    from extpom_tpu.diag import stats as diag_stats
    from extpom_tpu.io import netcdf as ncio

    m = seamount_model(im=17, jm=17, kb=7, donate=False, dtype="float64")
    m.step_once()
    s = {k: float(v) for k, v in
         diag_stats.domain_stats(m.grid, m.cfg, m.state).items()}

    # direct writer
    nc1 = str(tmp_path / "snap.nc")
    ncio.write_output_nc(nc1, m.grid, m.cfg, m.state, 0.25, stats=s)
    f = netcdf_file(nc1, "r", mmap=False)
    try:
        assert f.variables["t"].dimensions == ("time", "z", "y", "x")
        assert f.variables["elb"].dimensions == ("time", "y", "x")
        np.testing.assert_array_equal(
            np.asarray(f.variables["t"][0]).swapaxes(-1, -2),
            np.asarray(m.state.t))
        np.testing.assert_array_equal(
            np.asarray(f.variables["h"][...]).swapaxes(-1, -2),
            np.asarray(m.grid.h))
        assert float(f.variables["time"][0]) == 0.25
        # reference scalar names (tavg/savg/eavg, io_pnetcdf.F:84-90)
        np.testing.assert_allclose(float(f.variables["tavg"][0]),
                                   s["taver"])
        np.testing.assert_allclose(float(f.variables["ekin"][0]),
                                   s["ekin"])
    finally:
        f.close()

    # zarr -> nc conversion matches the direct writer's payload
    zdir = str(tmp_path / "snap.zarr")
    zio.write_output(zdir, m.grid, m.cfg, m.state, 0.25, s)
    nc2 = str(tmp_path / "snap2.nc")
    ncio.zarr_output_to_nc(zdir, nc2)
    g = netcdf_file(nc2, "r", mmap=False)
    try:
        np.testing.assert_array_equal(
            np.asarray(g.variables["u"][0]).swapaxes(-1, -2),
            np.asarray(m.state.u))
        np.testing.assert_allclose(float(g.variables["savg"][0]),
                                   s["saver"])
    finally:
        g.close()


def test_netcdf_grid_init_readers(tmp_path):
    """read_grid_nc / read_initial_ts_nc accept reference-format input
    files (read_grid_pnetcdf io_pnetcdf.F:2084-2264 ROMS-style names;
    read_initial_ts_pnetcdf :2771-2844 T/S) and reproduce the
    Zarr-loaded model exactly."""
    from scipy.io import netcdf_file
    from extpom_tpu.cases.seamount import seamount_case
    from extpom_tpu.io import netcdf as ncio

    cfg, grid, ics = seamount_case(im=17, jm=17, kb=7, dtype="float64")

    # build a reference-style grid file (Fortran var(x,y) -> C (y,x))
    ncg = str(tmp_path / "grid.nc")
    f = netcdf_file(ncg, "w", version=2)
    f.createDimension("z", cfg.kb)
    f.createDimension("y", cfg.jm)
    f.createDimension("x", cfg.im)
    for name, arr, dims in (
            ("z", grid.z, ("z",)), ("zz", grid.zz, ("z",)),
            ("dx", grid.dx, ("y", "x")), ("dy", grid.dy, ("y", "x")),
            ("lon_rho", grid.east_e, ("y", "x")),
            ("lat_rho", grid.north_e, ("y", "x")),
            ("angle", grid.rot, ("y", "x")),
            ("h", grid.h, ("y", "x")), ("fsm", grid.fsm, ("y", "x"))):
        a = np.asarray(arr)
        if len(dims) == 2:
            a = a.swapaxes(-1, -2)
        v = f.createVariable(name, a.dtype.newbyteorder("="), dims)
        v[...] = a
    f.close()

    g2 = ncio.read_grid_nc(ncg, cfg)
    # cor is excluded: seamount_case builds an f-plane cor while
    # make_grid re-derives 2*Omega*sin(lat) from the (varying) north_e —
    # both valid; the file reader matches the zarr reader's derivation
    for name in ("h", "fsm", "dum", "dvm", "art", "cbc",
                 "east_e", "rot", "dz"):
        np.testing.assert_array_equal(np.asarray(getattr(grid, name)),
                                      np.asarray(getattr(g2, name)),
                                      err_msg=name)

    # reference-style init file: T/S shaped (z, y, x)
    nci = str(tmp_path / "init.nc")
    f = netcdf_file(nci, "w", version=2)
    f.createDimension("z", cfg.kb)
    f.createDimension("y", cfg.jm)
    f.createDimension("x", cfg.im)
    for name, arr in (("T", ics["tb"]), ("S", ics["sb"])):
        a = np.asarray(arr).swapaxes(-1, -2)
        v = f.createVariable(name, a.dtype.newbyteorder("="),
                             ("z", "y", "x"))
        v[...] = a
    f.close()

    tb, sb, tclim, sclim = ncio.read_initial_ts_nc(nci)
    np.testing.assert_array_equal(tb, np.asarray(ics["tb"]))
    np.testing.assert_array_equal(sb, np.asarray(ics["sb"]))
    np.testing.assert_array_equal(tclim, np.asarray(ics["tb"]))


def test_netcdf_restart_interchange(tmp_path):
    """Reference-format restart interchange (write/read_restart_nc vs
    write/read_restart_pnetcdf, io_pnetcdf.F:1661-2083, 2420-2769): a
    model resumed from the nc restart must evolve identically to one
    resumed from the bit-seamless Zarr restart — the fields the
    reference does not checkpoint (etf/drx2d/dry2d/vfluxb/vfluxf) are
    recomputed or zero before first use."""
    from extpom_tpu.cases.seamount import seamount_model
    from extpom_tpu.io import netcdf as ncio

    kw = dict(im=17, jm=17, kb=7, donate=False, dtype="float64")
    m = seamount_model(**kw)
    for _ in range(3):
        m.step_once()
    zrst = str(tmp_path / "rst.zarr")
    nrst = str(tmp_path / "rst.nc")
    # the nc restart carries only simulation TIME (iint restarts at 0,
    # the reference's time0 convention) — give the zarr restart the
    # same (iint=0, time0=t) split so the ramp/forcing clocks agree
    t = m.time_days
    zio.write_restart(zrst, m.state, 0, t)
    ncio.write_restart_nc(nrst, m.state, t)

    mz = seamount_model(**kw)
    mz.state, mz.iint, mz.time0 = zio.read_restart(zrst, mz.cfg)
    mn = seamount_model(**kw)
    mn.state, mn.iint, mn.time0 = ncio.read_restart_nc(nrst, mn.cfg)
    assert mn.time0 == pytest.approx(t) and mn.iint == 0
    # checkpointed fields come back bit-equal
    for name in ("el", "u", "t", "q2b", "wubot", "egb"):
        np.testing.assert_array_equal(np.asarray(getattr(mz.state, name)),
                                      np.asarray(getattr(mn.state, name)),
                                      err_msg=name)
    # and the resumed trajectories agree after stepping
    for _ in range(2):
        mz.step_once()
        mn.step_once()
    for name in ("el", "ua", "u", "t", "s", "q2"):
        a = np.asarray(getattr(mz.state, name))
        b = np.asarray(getattr(mn.state, name))
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_zarr_without_tensorstore_says_so(tmp_path, monkeypatch):
    """Where tensorstore is missing, Zarr I/O fails with an error that
    names the package and the NetCDF alternative."""
    monkeypatch.setattr(zio, "_tensorstore", None)
    with pytest.raises(RuntimeError, match="tensorstore.*out_format"):
        zio.write_array(str(tmp_path), "x", np.zeros(3))
