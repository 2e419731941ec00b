"""Chunked Zarr storage via TensorStore.

Replaces the reference's collective PnetCDF I/O (io_pnetcdf.F): the same
logical datasets — grid, initial T/S, climatology, surface forcing, lateral
boundary series, restart, output — stored as Zarr arrays, written once from
host (device arrays are fetched with ``np.asarray``; under multi-host
sharding each host would write its addressable shards, replacing per-rank
hyperslab puts, io_pnetcdf.F:272-275).

* :func:`write_restart` / :func:`read_restart` — full-State checkpoint +
  step counter, bit-seamless like the reference's 37-variable restart file
  (io_pnetcdf.F:1661-2083, 2420-2769).
* :func:`write_output` — snapshot dataset with grid, prognostic fields and
  scalar diagnostics (io_pnetcdf.F:57-410).
* :class:`ZarrSource` — record source for the forcing provider (the
  ``.sfrc``/``.lbry`` series readers, io_pnetcdf.F:2912-3622).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional

import numpy as np

try:
    import tensorstore as _tensorstore
    HAVE_TS = True
except ImportError:
    _tensorstore = None
    HAVE_TS = False

from extpom_tpu.core.config import Config
from extpom_tpu.core.grid import Grid
from extpom_tpu.core.state import State


def _ts():
    """The tensorstore module, or a clear error where it is missing."""
    if _tensorstore is None:
        raise RuntimeError(
            "Zarr I/O needs the 'tensorstore' package, which is not "
            "installed; run with \"out_format\": \"nc\" and .nc inputs "
            "(io/netcdf.py needs only scipy)")
    return _tensorstore


def _spec(path: str, create: bool = False,
          shape=None, dtype=None, chunks=None):
    spec = {
        "driver": "zarr",
        "kvstore": {"driver": "file", "path": path},
    }
    kw = {}
    if create:
        kw = dict(create=True, delete_existing=True,
                  dtype=np.dtype(dtype).name, shape=list(shape))
        if chunks is not None:
            spec["metadata"] = {"chunks": list(chunks)}
    return spec, kw


def write_array(root: str, name: str, arr,
                chunks: Optional[tuple] = None) -> None:
    """Write one array.  A multi-process-sharded ``jax.Array`` (not fully
    addressable) is written cooperatively: every process writes only the
    shards it owns — the per-rank hyperslab puts of the reference's
    collective PnetCDF writes (io_pnetcdf.F:272-275, 2183-2187)."""
    import jax
    if isinstance(arr, jax.Array) and not arr.is_fully_addressable:
        _write_array_multihost(root, name, arr, chunks)
        return
    a = np.asarray(arr)
    if chunks is None:
        # chunk 2-D/3-D fields by horizontal tiles (<= 256 per axis)
        chunks = tuple(min(s, 256) for s in a.shape) if a.ndim else (1,)
    if a.ndim == 0:
        a = a[None]
        chunks = (1,)
    spec, kw = _spec(os.path.join(root, name), create=True,
                     shape=a.shape, dtype=a.dtype, chunks=chunks)
    arr_ts = _ts().open(spec, **kw).result()
    arr_ts[...] = a


def _write_array_multihost(root: str, name: str, arr,
                           chunks: Optional[tuple]) -> None:
    """Cooperative write of a globally-sharded array: process 0 creates the
    store, all processes barrier, then each writes its addressable shards
    (replica 0 only, so replicated shards are written once)."""
    import jax
    from extpom_tpu.mesh.distributed import process_barrier
    shape, dtype = arr.shape, arr.dtype
    if chunks is None:
        chunks = tuple(min(s, 256) for s in shape) if len(shape) else (1,)
    path = os.path.join(root, name)
    if jax.process_index() == 0:
        spec, kw = _spec(path, create=True, shape=shape, dtype=dtype,
                         chunks=chunks)
        _ts().open(spec, **kw).result()
    process_barrier(f"zarr-create:{name}")
    spec, _ = _spec(path)
    h = _ts().open(spec).result()
    futures = []
    for shard in arr.addressable_shards:
        if shard.replica_id == 0:
            futures.append(h[shard.index].write(np.asarray(shard.data)))
    for f in futures:
        f.result()
    process_barrier(f"zarr-written:{name}")


def read_array(root: str, name: str) -> np.ndarray:
    spec, _ = _spec(os.path.join(root, name))
    arr_ts = _ts().open(spec).result()
    return np.asarray(arr_ts.read().result())


def _write_attrs(root: str, attrs: Dict) -> None:
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "attrs.json"), "w") as f:
        json.dump(attrs, f)


def _read_attrs(root: str) -> Dict:
    with open(os.path.join(root, "attrs.json")) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# restart (io_pnetcdf.F:1661-2083 / 2420-2769)
# ---------------------------------------------------------------------------

def write_restart(path: str, state: State, iint: int,
                  time0: float = 0.0) -> None:
    """Checkpoint the full State + step counter.  Restart is bit-seamless
    because State carries every leapfrog time level and the closure state
    (same property as the reference's restart variable list)."""
    for f in dataclasses.fields(State):
        write_array(path, f.name, getattr(state, f.name))
    _write_attrs(path, {"iint": int(iint), "time0": float(time0),
                        "format": "extpom_tpu.restart.v1"})


def read_restart(path: str, cfg: Config):
    """Returns (state, iint, time0); arrays come back in cfg's dtype."""
    import jax.numpy as jnp
    attrs = _read_attrs(path)
    fields = {}
    for f in dataclasses.fields(State):
        fields[f.name] = jnp.asarray(read_array(path, f.name),
                                     cfg.jnp_dtype)
    return State(**fields), attrs["iint"], attrs["time0"]


# ---------------------------------------------------------------------------
# output snapshots (io_pnetcdf.F:57-410)
# ---------------------------------------------------------------------------

OUTPUT_GRID_VARS = ("z", "zz", "dx", "dy", "east_e", "north_e", "east_c",
                    "north_c", "east_u", "north_u", "east_v", "north_v",
                    "rot", "h", "fsm", "dum", "dvm")
OUTPUT_2D = ("uab", "vab", "elb")
OUTPUT_3D = ("u", "v", "w", "t", "s", "rho", "km", "kh", "aam")


def write_output(path: str, grid: Grid, cfg: Config, state: State,
                 time_days: float, stats: Optional[Dict] = None,
                 extra: Optional[Dict] = None) -> None:
    """One snapshot dataset: grid + prognostic fields + diagnostics
    (grid/uab/vab/elb/u/v/w/t/s/rho on zz, w on z; scalars from
    domain_stats — matching write_output_pnetcdf's contents).  ``extra``
    adds derived fields (e.g. wr when cfg.calc_wr)."""
    for name in OUTPUT_GRID_VARS:
        write_array(path, name, getattr(grid, name))
    for name in OUTPUT_2D + OUTPUT_3D:
        write_array(path, name, getattr(state, name))
    if extra:
        for name, arr in extra.items():
            write_array(path, name, arr)
    attrs = {"time_days": float(time_days),
             "tbias": cfg.tbias, "sbias": cfg.sbias,
             "format": "extpom_tpu.output.v1"}
    if stats:
        attrs["stats"] = {k: float(v) for k, v in stats.items()}
    _write_attrs(path, attrs)


def read_output(path: str) -> Dict[str, np.ndarray]:
    out = {name: read_array(path, name)
           for name in OUTPUT_GRID_VARS + OUTPUT_2D + OUTPUT_3D}
    out["attrs"] = _read_attrs(path)
    return out


# ---------------------------------------------------------------------------
# grid / initial-condition / climatology datasets
# (read_grid_pnetcdf io_pnetcdf.F:2084-2264, read_initial_ts :2771-2844,
#  read_clim_ts :2845-2911)
# ---------------------------------------------------------------------------

GRID_VARS = ("z", "zz", "dx", "dy", "east_e", "north_e", "rot", "h", "fsm")


def write_grid(path: str, grid: Grid) -> None:
    """Persist the primary grid variables (masks/metrics/cbc are re-derived
    on read, exactly as read_grid_pnetcdf derives dum/dvm from fsm)."""
    for name in GRID_VARS:
        write_array(path, name, getattr(grid, name))
    _write_attrs(path, {"format": "extpom_tpu.grid.v1"})


def read_grid(path: str, cfg: Config) -> Grid:
    from extpom_tpu.core.grid import make_grid
    v = {name: read_array(path, name) for name in GRID_VARS}
    return make_grid(cfg, v["z"], v["zz"], v["dx"], v["dy"], v["h"],
                     v["fsm"], east_e=v["east_e"], north_e=v["north_e"],
                     rot=v["rot"])


def write_initial_ts(path: str, tb, sb, tclim=None, sclim=None) -> None:
    write_array(path, "tb", tb)
    write_array(path, "sb", sb)
    if tclim is not None:
        write_array(path, "tclim", tclim)
    if sclim is not None:
        write_array(path, "sclim", sclim)
    _write_attrs(path, {"format": "extpom_tpu.init.v1",
                        "has_clim": tclim is not None})


def read_initial_ts(path: str):
    attrs = _read_attrs(path)
    tb = read_array(path, "tb")
    sb = read_array(path, "sb")
    if attrs.get("has_clim"):
        return tb, sb, read_array(path, "tclim"), read_array(path, "sclim")
    return tb, sb, tb, sb


def write_aux(path: str, grid: Grid, cfg: Config, state: State,
              time_days: float = 0.0, extra: Optional[Dict] = None) -> None:
    """Full-state debug dump (the write_aux_pnetcdf equivalent,
    io_pnetcdf.F:413-1658): every State field, all time levels, plus any
    derived arrays passed in ``extra``."""
    for f in dataclasses.fields(State):
        write_array(path, f.name, getattr(state, f.name))
    for name in OUTPUT_GRID_VARS:
        write_array(path, name, getattr(grid, name))
    if extra:
        for name, arr in extra.items():
            write_array(path, name, arr)
    _write_attrs(path, {"time_days": float(time_days),
                        "format": "extpom_tpu.aux.v1"})


# ---------------------------------------------------------------------------
# forcing record source (the .sfrc/.lbry series readers)
# ---------------------------------------------------------------------------

class ZarrSource:
    """Record source over a Zarr dataset directory: each variable is an
    array with a leading record dimension; ``read(name, n)`` fetches one
    record (clamped to the series length, like ArraySource)."""

    def __init__(self, root: str):
        self.root = root
        self._handles: Dict[str, object] = {}
        self._names = [d for d in os.listdir(root)
                       if os.path.isdir(os.path.join(root, d))]

    def names(self):
        return list(self._names)

    def _handle(self, name: str):
        h = self._handles.get(name)
        if h is None:
            spec, _ = _spec(os.path.join(self.root, name))
            h = _ts().open(spec).result()
            self._handles[name] = h
        return h

    def nrec(self, name: str) -> int:
        return self._handle(name).shape[0]

    def read(self, name: str, n: int) -> np.ndarray:
        h = self._handle(name)
        n = min(max(n, 0), h.shape[0] - 1)
        return np.asarray(h[n].read().result())


def write_forcing_series(root: str, data: Dict[str, np.ndarray]) -> None:
    """Write a forcing series dataset consumable by ZarrSource (record
    dimension leading; one chunk per record for streaming reads)."""
    for name, arr in data.items():
        a = np.asarray(arr)
        write_array(root, name, a, chunks=(1,) + a.shape[1:])
