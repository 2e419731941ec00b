"""Device-side forcing interpolation for scanned segments.

The host-side :class:`extpom_tpu.forcing.provider.ForcingProvider` assembles
one Forcing per step — one Python round trip per internal step, which
defeats the ``lax.scan`` segment fast path for any run with time-varying
forcing (the reference's wind/heat/lateral_bc cadences,
bounds_forcing.f:593-1020).

A :class:`DevicePlan` instead stages the whole record series on device as
``(nrec, ...)`` stacks; the cadence arithmetic + bracketing-record gather +
linear time interpolation (bounds_forcing.f:841-865) runs INSIDE the jitted
step, so a multi-day forced run is one device dispatch per segment.  The
reference pays a blocking collective file read every record boundary
mid-loop (SURVEY §3.4); here the data is resident before the loop starts.

Measured (r2): the tidal channel (97x33x16 f32) runs 1.8x faster through
the device-plan scan than through per-step host assembly on CPU, where
compute dominates; where each dispatch costs more, the per-step path is
dispatch-bound and the win is correspondingly larger.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from extpom_tpu.core.config import Config
from extpom_tpu.core.state import Forcing
from extpom_tpu.forcing import provider as prov


@dataclasses.dataclass(frozen=True)
class DevicePlan:
    """Staged forcing series: per-variable record stacks + cadences.

    ``starts`` holds each stack's first GLOBAL record index (a traced
    scalar, so re-staged windows do not recompile).  A fully staged
    series has start 0 and all records; a CHUNKED series (HBM-budgeted,
    see :func:`make_device_plan`) holds only the window a segment needs —
    the on-device analogue of the reference's one-record-pair double
    buffer (bounds_forcing.f:607-613)."""
    names: Tuple[str, ...]        # static
    cadences: Tuple[float, ...]   # static, days/record
    offsets: Tuple[float, ...]    # static, time offset in days (cont_bry)
    interp: Tuple[bool, ...]      # static; False = piecewise-constant
    stacks: Tuple[jnp.ndarray, ...]
    starts: Tuple[jnp.ndarray, ...]   # global record index of stack[0]


jax.tree_util.register_dataclass(
    DevicePlan, data_fields=["stacks", "starts"],
    meta_fields=["names", "cadences", "offsets", "interp"])


def plan_bytes(p: "prov.ForcingProvider") -> int:
    """Total bytes of a FULL staging of the provider's series."""
    if p.source is None:
        return 0
    itemsize = np.dtype(p.cfg.dtype).itemsize
    total = 0
    for v in p.source.names():
        nrec = p.source.nrec(v)
        rec = np.asarray(p.source.read(v, 0))
        total += nrec * rec.size * itemsize
    return total


def make_device_plan(p: "prov.ForcingProvider", dtype=None,
                     budget_bytes: Optional[int] = None,
                     t0_days: Optional[float] = None,
                     t1_days: Optional[float] = None,
                     ) -> Optional[DevicePlan]:
    """Stage the provider's series on device.

    When the full staging exceeds ``budget_bytes`` (default
    ``cfg.forcing_hbm_mb``), each series is CHUNKED: only the records
    covering ``[t0_days, t1_days]`` plus one record of margin per side
    are staged, and the caller re-stages between segments
    (:meth:`extpom_tpu.core.model.Model.run_segment` passes the segment
    bounds).  Window lengths depend only on the segment length, so
    re-staging never recompiles.  The reference's analogue streams one
    record pair per cadence boundary (bounds_forcing.f:607-613).
    """
    if p.source is None:
        return None
    dtype = dtype or p.cfg.jnp_dtype
    if budget_bytes is None:
        budget_bytes = p.cfg.forcing_hbm_mb * 2 ** 20
    chunked = (plan_bytes(p) > budget_bytes
               and t0_days is not None and t1_days is not None)
    names, cadences, offsets, interp, stacks, starts = ([], [], [], [],
                                                        [], [])
    src_names = set(p.source.names())

    def add(v, cad, off=0.0, do_interp=True):
        if v not in src_names:
            return
        nrec = p.source.nrec(v)
        if chunked:
            # window covering the segment + 1 record margin per side;
            # length from the segment DURATION (constant across segments)
            n0 = max(int(np.floor((t0_days + off) / cad)) - 1, 0)
            nw = int(np.ceil((t1_days - t0_days) / cad)) + 3
            n0 = min(n0, max(nrec - nw, 0))
            recs = [min(n0 + k, nrec - 1) for k in range(min(nw, nrec))]
        else:
            n0 = 0
            recs = range(nrec)
        stack = np.stack([np.asarray(p.source.read(v, n)) for n in recs])
        names.append(v)
        cadences.append(float(cad))
        offsets.append(float(off))
        interp.append(do_interp)
        stacks.append(jnp.asarray(stack, dtype))
        starts.append(jnp.asarray(n0, jnp.int32))

    for v in prov.WIND_VARS + prov.HEAT_VARS:
        add(v, p.tsurf_cad)
    for v in prov.WATER_VARS:
        add(v, p.twater_cad)
    for v in prov.SURF_VARS:
        add(v, p.tsurf_cad, do_interp=False)   # bounds_forcing.f:963-983
    for v in prov.RESTORE_VARS:
        add(v, p.trst_cad)
    toff = p.cont_bry_offset * p.tbc
    for v in prov.BRY_2D + prov.BRY_3D:
        add(v, p.tbc, off=toff)
    if not names:
        return None
    return DevicePlan(tuple(names), tuple(cadences), tuple(offsets),
                      tuple(interp), tuple(stacks), tuple(starts))


def forcing_at(plan: DevicePlan, base: Forcing, cfg: Config,
               dz: jnp.ndarray, t_days) -> Forcing:
    """Traced per-step Forcing from the staged series (the double-buffer +
    linear-interp pattern of bounds_forcing.f:841-865, on device)."""
    upd = {}
    for name, cad, off, do_i, stack, start in zip(
            plan.names, plan.cadences, plan.offsets, plan.interp,
            plan.stacks, plan.starts):
        nrec = stack.shape[0]
        x = (t_days + off) / cad
        n = jnp.floor(x).astype(jnp.int32) - start   # window-local index
        nb = jnp.clip(n, 0, nrec - 1)
        if do_i:
            nf = jnp.clip(n + 1, 0, nrec - 1)
            frac = (x - jnp.floor(x)).astype(stack.dtype)
            b = lax.dynamic_index_in_dim(stack, nb, 0, keepdims=False)
            f = lax.dynamic_index_in_dim(stack, nf, 0, keepdims=False)
            upd[name] = (1.0 - frac) * b + frac * f
        else:
            upd[name] = lax.dynamic_index_in_dim(stack, nb, 0,
                                                 keepdims=False)

    # depth-integrate boundary velocity profiles to barotropic values
    # (bounds_forcing.f:626-635, 747-756)
    dzc = dz[:cfg.kbm1, None]
    for side in prov.BRY_SIDES:
        un = f"ub{side}" if side in ("w", "e") else f"vb{side}"
        tn = f"uab{side}" if side in ("w", "e") else f"vab{side}"
        if un in upd:
            upd[tn] = jnp.sum(upd[un][:cfg.kbm1] * dzc, axis=0)
    return base.replace(**upd)
