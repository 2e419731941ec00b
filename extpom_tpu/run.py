"""Run driver: ``python -m extpom_tpu.run config.json``.

The ``program pom`` equivalent (pom.f:8-39 + read_input initialize.f:67-244):
reads a JSON run configuration (the namelist analogue), builds the model —
from a built-in case generator or from Zarr datasets — and drives the time
loop with periodic diagnostics prints, output snapshots, restart writes,
and optional restart resume (nread_rst, initialize.f:39).

Config schema (all keys optional unless noted)::

    {
      "run_name": "seamount01",
      "case": "seamount" | "channel",        # built-in generator ...
      "case_args": {"im": 65, "jm": 49},     # ... and its arguments
      "grid": "in/grid.zarr",                # or: dataset paths
      "init": "in/init.zarr",
      #   (grid/init paths ending in .nc open through the NetCDF-3
      #    bridge, io/netcdf.py — the reference's own input format)
      "sfrc": "in/sfrc.zarr",                # surface forcing series
      "lbry": "in/lbry.zarr",                # lateral boundary series
      #   (sfrc/lbry accept a Zarr dataset dir, a dir of .efr files —
      #    opened through the native record store, native/recordio —
      #    or a reference-format .nc series file, io/netcdf.py)
      "config": {"mode": 3, "dte": 6.0, "days": 1.0, ...},
      "out_dir": "out",
      "out_format": "zarr" | "nc",           # snapshot and restart format
      #   (default zarr, through tensorstore; "nc" writes reference-layout
      #   NetCDF files via io/netcdf.py, which needs only scipy: one
      #   snapshot stream {run}.nc and restarts {run}.rst.NNNNNN.nc)
      "nread_rst": 0, "read_rst_path": "out/run.rst.0003",
      #   (a read_rst_path ending in .nc resumes from a reference-format
      #    restart file, io/netcdf.py:read_restart_nc)
      "cont_bry": 0,
      # -- parallel execution (distribute_mpi analogue) --
      "mesh": {"px": 2, "py": 4, "mode": "shardmap" | "gspmd"},
      #   shardmap (default): explicit ppermute halo exchange, chunked
      #   halo-ring external loop and whole-segment scans; gspmd: let the
      #   XLA SPMD partitioner insert the halo collectives (refused on a
      #   mesh of several GPUs, where it computes wrong fields)
      # multi-process: every process runs the same config; process_id /
      # num_processes default to JAX_PROCESS_ID / JAX_NUM_PROCESSES env
      "distributed": {"coordinator": "host:1234",
                      "num_processes": 2, "process_id": 0}
    }
"""

from __future__ import annotations

import json
import os
import sys
import time as _time

import numpy as np


def _open_source(path: str):
    """Forcing record source by format sniff: a directory of ``.efr``
    files opens through the native mmap record store
    (native/recordio.cpp, ctypes-bound — the reference's Fortran record
    readers, bounds_forcing.f:871-960, as a native component); anything
    else opens as a Zarr dataset."""
    from extpom_tpu.io import zarrstore as zio
    if path.endswith(".nc"):
        # reference-format NetCDF series file (the .sfrc.nc/.lbry.nc
        # readers, io_pnetcdf.F:2912-3622)
        from extpom_tpu.io.netcdf import NcForcingSource
        return NcForcingSource(path)
    if (os.path.isdir(path)
            and any(fn.endswith(".efr") for fn in os.listdir(path))):
        from extpom_tpu.native import recordio
        if not recordio.available():
            raise RuntimeError(
                f"{path} holds EFR records but librecordio is "
                "unavailable (no g++)")
        return recordio.NativeRecordSource(path)
    return zio.ZarrSource(path)


def build_model(conf: dict):
    from extpom_tpu.core.config import Config
    from extpom_tpu.core.model import Model
    from extpom_tpu.forcing.provider import ForcingProvider
    from extpom_tpu.io import zarrstore as zio

    cfg_kw = dict(conf.get("config", {}))
    case = conf.get("case")
    if case == "seamount":
        from extpom_tpu.cases.seamount import seamount_case
        cfg, grid, ics = seamount_case(**conf.get("case_args", {}), **cfg_kw)
        src = None
    elif case == "channel":
        from extpom_tpu.cases.channel import channel_case
        cfg, grid, ics, src = channel_case(**conf.get("case_args", {}),
                                           **cfg_kw)
    elif "grid" in conf:
        cfg = Config(**cfg_kw)
        # format sniff: .nc files open through the NetCDF-3 bridge (the
        # reference's own input format, read_grid_pnetcdf /
        # read_initial_ts_pnetcdf, io_pnetcdf.F:2084-2264, 2771-2844),
        # anything else as a Zarr dataset directory
        if conf["grid"].endswith(".nc"):
            from extpom_tpu.io import netcdf as ncio
            grid = ncio.read_grid_nc(conf["grid"], cfg)
        else:
            grid = zio.read_grid(conf["grid"], cfg)
        if conf["init"].endswith(".nc"):
            from extpom_tpu.io import netcdf as ncio
            tb, sb, tclim, sclim = ncio.read_initial_ts_nc(conf["init"])
        else:
            tb, sb, tclim, sclim = zio.read_initial_ts(conf["init"])
        ics = dict(tb=tb, sb=sb, tclim=tclim, sclim=sclim,
                   elb=None, uab=None, vab=None)
        src = None
    else:
        raise ValueError("config needs 'case' or 'grid'")

    m = Model(grid, cfg, tb=ics["tb"], sb=ics["sb"],
              tclim=ics.get("tclim"), sclim=ics.get("sclim"),
              elb=ics.get("elb"), uab=ics.get("uab"), vab=ics.get("vab"))

    # forcing sources
    sources = []
    if src is not None:
        sources.append(src)
    for key in ("sfrc", "lbry"):
        if key in conf:
            sources.append(_open_source(conf[key]))
    if sources:
        from extpom_tpu.forcing.provider import MultiSource
        src = sources[0] if len(sources) == 1 else MultiSource(sources)
        m.forcing_fn = ForcingProvider(
            grid, cfg, m.base_forcing, src,
            cont_bry_offset=int(conf.get("cont_bry", 0)))

    # restart resume (initialize.f:39; read_restart_pnetcdf) — .nc paths
    # open reference-format restart files through the bridge
    if conf.get("nread_rst"):
        if conf["read_rst_path"].endswith(".nc"):
            from extpom_tpu.io.netcdf import read_restart_nc
            st, iint, time0 = read_restart_nc(conf["read_rst_path"], cfg)
        else:
            st, iint, time0 = zio.read_restart(conf["read_rst_path"], cfg)
        m.state, m.iint, m.time0 = st, iint, time0

    # mesh decomposition (distribute_mpi analogue, parallel_mpi.f:34-122)
    if "mesh" in conf:
        from extpom_tpu.mesh.sharding import make_mesh
        mk = conf["mesh"]
        mesh = make_mesh(int(mk["px"]), int(mk["py"]))
        # default shardmap: explicit halo exchanges, and whole segments
        # scanned in one dispatch (mesh.shardmap.make_shardmap_run)
        m.shard(mesh, mode=mk.get("mode", "shardmap"))
    return m


def main(argv=None):
    from extpom_tpu.diag import stats as diag_stats
    from extpom_tpu.io import zarrstore as zio
    from extpom_tpu.utils.cache import enable_compile_cache

    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        return 2
    with open(argv[0]) as f:
        conf = json.load(f)

    # multi-process bootstrap (initialize_mpi analogue) — must run before
    # any device use
    if "distributed" in conf:
        from extpom_tpu.mesh.distributed import init_distributed
        dk = conf["distributed"]
        init_distributed(dk.get("coordinator"), dk.get("num_processes"),
                         dk.get("process_id"))
    import jax
    enable_compile_cache()
    master = jax.process_index() == 0

    m = build_model(conf)
    cfg = m.cfg
    run = conf.get("run_name", "run")
    out_dir = conf.get("out_dir", "out")
    os.makedirs(out_dir, exist_ok=True)

    # config echo on the master process only (read_input's summary print,
    # initialize.f:201-241; master_task prints, parallel_mpi.f:16)
    _print = print if master else (lambda *a, **k: None)
    _print(f"run: {run}")
    for k in ("mode", "nadv", "nitera", "sw", "npg", "dte", "isplit",
              "days", "prtd1", "smoth", "horcon", "ntp", "nbct", "nbcs"):
        _print(f"  {k} = {getattr(cfg, k)}")
    _print(f"  dti = {cfg.dti}  iend = {cfg.iend}  iprint = {cfg.iprint}")
    if jax.process_count() > 1:
        _print(f"  processes = {jax.process_count()}  "
               f"devices = {len(jax.devices())}")
    from extpom_tpu.diag.stats import cfl_min
    _print(f"  CFL advisory: min dt_ext = {float(cfl_min(m.grid, cfg)):.2f} s"
           f" (dte = {cfg.dte} s)")

    dev = jax.devices()[0]
    _print(f"  device = {dev.platform} {dev.device_kind} "
           f"x{len(jax.devices())}")

    # Segment execution (the production fast path): when forcing is
    # provider-backed (or static), whole print/restart intervals run under
    # one jitted lax.scan dispatch (stepper.run_segment) — the reference's
    # `do iint=1,iend` loop (pom.f:16-22) without a host round-trip per
    # step.  Arbitrary per-step forcing_fn callables fall back to
    # step-at-a-time.
    from extpom_tpu.forcing.provider import ForcingProvider
    use_segments = (m.forcing_fn is None
                    or isinstance(m.forcing_fn, ForcingProvider))

    # async writer: snapshot/restart writes run on a worker thread while
    # the next segment computes (io.asyncwriter — the compute-stalling
    # collective write of the reference, io_pnetcdf.F:57-410, removed
    # from the critical path).  Requires the donate=False segment path:
    # the step-at-a-time fallback donates state buffers, so it writes
    # synchronously.
    from extpom_tpu.io.asyncwriter import AsyncWriter
    writer = AsyncWriter() if use_segments else None
    submit = (writer.submit if writer is not None
              else (lambda fn, *a, **k: fn(*a, **k)))

    out_nc = conf.get("out_format", "zarr") == "nc"
    if out_nc and jax.process_count() > 1:
        # the NetCDF-3 writer fetches whole arrays (no cooperative shard
        # writes — use zarr + io.netcdf CLI conversion)
        raise RuntimeError(
            "out_format='nc' is single-process only; write zarr and "
            "convert via python -m extpom_tpu.io.netcdf")
    n_out = 0
    t0 = _time.time()
    while m.iint < cfg.iend:
        # next host-visit boundary: print, restart, iswtch, or end
        iprint = cfg.iprint if m.iint < cfg.iswtch else cfg.iprint2
        nxt = min(((m.iint // iprint) + 1) * iprint,
                  ((m.iint // cfg.irestart) + 1) * cfg.irestart,
                  cfg.iend)
        if m.iint < cfg.iswtch:
            nxt = min(nxt, cfg.iswtch)
        if use_segments:
            m.run_segment(nxt - m.iint)
        else:
            for _ in range(nxt - m.iint):
                m.step_once()
        # a segment can land exactly on iswtch: the print cadence switches
        # to prtd2 AT that step (advance.f:65-68), so re-derive iprint from
        # the post-segment step count
        iprint = cfg.iprint if m.iint < cfg.iswtch else cfg.iprint2
        if m.iint % iprint == 0 or m.iint == cfg.iend:
            s = {k: float(v) for k, v in diag_stats.domain_stats(
                m.grid, cfg, m.state).items()}
            vamax, (iloc, jloc) = diag_stats.check_velocity(cfg, m.state.va)
            if not np.isfinite(float(vamax)) or float(vamax) > cfg.vmaxl:
                i, j = int(iloc), int(jloc)
                _print("POM terminated with error: velocity condition "
                       f"violated, vamax={float(vamax):.3e} at (i,j)="
                       f"({i},{j}), iint={m.iint}")
                return 1
            _print(f"time = {m.time_days:9.4f}  iint = {m.iint:8d}  "
                   f"vtot = {s['vtot']:.7e}  eaver = {s['eaver']:.7e}  "
                   f"taver = {s['taver']:.7e}  saver = {s['saver']:.7e}")
            n_out += 1
            extra = {"wr": m.compute_wr()} if cfg.calc_wr else None
            if out_nc:
                from extpom_tpu.io.netcdf import write_output_nc
                # one output stream per run, snapshots as records — the
                # reference's iout record writes (io_pnetcdf.F:180-410);
                # the async writer's single worker preserves order
                submit(write_output_nc,
                       os.path.join(out_dir, f"{run}.nc"),
                       m.grid, cfg, m.state, m.time_days, s, extra=extra,
                       append=True)
            else:
                submit(zio.write_output,
                       os.path.join(out_dir, f"{run}.{m.iint:06d}"),
                       m.grid, cfg, m.state, m.time_days, s, extra=extra)
        if m.iint % cfg.irestart == 0:
            rst = os.path.join(out_dir, f"{run}.rst.{m.iint:06d}")
            if out_nc:
                # the reference's restart layout (io/netcdf.py); resume
                # restarts the step count at the file's time
                from extpom_tpu.io.netcdf import write_restart_nc
                submit(write_restart_nc, rst + ".nc", m.state, m.time_days)
            else:
                submit(zio.write_restart, rst, m.state, m.iint, m.time0)
    if writer is not None:
        writer.close()            # drain the last interval's writes
    mode_s = ("scanned segments + async writes" if use_segments
              else "step-at-a-time")
    wall = _time.time() - t0
    gps = cfg.im * cfg.jm * cfg.kb * m.iint / max(wall, 1e-9)
    _print(f"wall clock: {wall:.1f} s for {m.iint} steps "
           f"({mode_s}; {gps/1e6:.1f} Mgrid-pt-steps/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
