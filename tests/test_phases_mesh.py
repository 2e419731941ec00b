"""Every internal-mode phase under the shard_map mesh: the explicit
ppermute step (mesh.shardmap), with the chunked halo-ring external loop
(mesh.extchunk), must reproduce the single-device path exactly — the
analogue of the reference's single communication layer serving every
kernel (parallel_mpi.f:154-351).

Runs on the 8-virtual-device CPU mesh at float64.
"""

import numpy as np
import pytest

import jax

from extpom_tpu.cases.seamount import seamount_model
from extpom_tpu.mesh.padding import pad_model, unpad
from extpom_tpu.mesh.sharding import make_mesh
from extpom_tpu.mesh.shardmap import make_shardmap_step, shard_args

CHECK = ("el", "ua", "va", "u", "v", "w", "t", "s", "rho",
         "q2", "q2l", "km", "kh", "l", "wubot", "wvbot")


def _run_ref(n=3, **kw):
    ref = seamount_model(dtype="float64", donate=False, **kw)
    for _ in range(n):
        ref.step_once()
    return ref


def _run_mesh(mesh, n=3, **kw):
    m = seamount_model(dtype="float64", donate=False, **kw)
    step_fn = make_shardmap_step(mesh, m.grid, m.cfg, m.base_forcing)
    grid_s, st, _, rmean_s, tclim_s, sclim_s = shard_args(
        mesh, m.cfg, m.grid, m.state, m.base_forcing,
        m.rmean, m.tclim, m.sclim)
    for i in range(n):
        fc_s = shard_args(mesh, m.cfg, m.grid, m.state,
                          m.forcing_at(i + 1))[2]
        st = step_fn(grid_s, st, fc_s, rmean_s, tclim_s, sclim_s,
                     first=(i == 0))
    return st


def _compare(ref_st, st, tol=1e-10):
    for name in CHECK:
        a = np.asarray(getattr(ref_st, name))
        b = np.asarray(getattr(st, name))
        atol = tol * max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("kw", [
    dict(),                       # extpom mix (bcond 1,2,4,6 + orl 3,5)
    dict(bc_scheme="orlanski"),
    dict(mode=4),                 # frozen T/S: tracer phase skipped
    dict(nadv=2, nitera=2),       # MPDATA tracer scheme inside the kernel
    dict(npg=2),                  # McCalpin 4th-order PG in the lat phase
])
def test_mesh_phases_match_single_device(kw):
    """Boundary schemes, frozen T/S, MPDATA and the 4th-order pressure
    gradient, on a 2x4 mesh."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    base = dict(im=32, jm=64, kb=7, isplit=6)
    n = 3 if not kw else 2
    ref = _run_ref(n=n, **base, **kw)
    st = _run_mesh(make_mesh(2, 4), n=n, **base, **kw)
    _compare(ref.state, st)


@pytest.mark.parametrize("px,py", [(4, 2), (1, 8), (8, 1)])
def test_mesh_phases_mesh_shapes(px, py):
    """x-only, y-only, and tall decompositions: ring widths collapse to 0
    on un-split axes."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    base = dict(im=64, jm=64, kb=7, isplit=6)
    ref = _run_ref(n=2, **base)
    st = _run_mesh(make_mesh(px, py), n=2, **base)
    _compare(ref.state, st)


def test_shardmap_segment_scan_seamount():
    """run_segment with the whole lax.scan inside the shard_map body
    (mesh.shardmap.make_shardmap_run) must match the single-device
    segment — one dispatch per segment on the explicit ppermute path."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    from extpom_tpu.mesh.sharding import make_mesh
    kw = dict(im=32, jm=64, kb=7, isplit=6, dtype="float64", donate=False)
    ref = seamount_model(**kw)
    ref.run_segment(4)
    m = seamount_model(**kw)
    m.shard(make_mesh(2, 4), mode="shardmap")
    m.run_segment(4)
    assert m.iint == ref.iint == 4
    _compare(ref.state, m.state)


def test_shardmap_segment_scan_ragged_padded():
    """A padded ragged grid through the shard_map SEGMENT driver: the
    run_steps scan inside the shard_map body must keep the LOCAL ctx
    (step() once re-installed the padded global ctx over it, silently
    tracing global shifts on local blocks)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    from extpom_tpu.mesh.sharding import make_mesh
    kw = dict(im=33, jm=65, kb=7, isplit=6, dtype="float64", donate=False)
    ref = seamount_model(**kw)
    ref.run_segment(3)
    m = seamount_model(**kw)
    m.shard(make_mesh(2, 4), mode="shardmap")   # pads to 34x68
    m.run_segment(3)
    for name in CHECK:
        a = np.asarray(getattr(ref.state, name))
        b = np.asarray(unpad(getattr(m.state, name), m.cfg))
        tol = 1e-10 * max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=name)


def test_shardmap_segment_scan_channel_deviceplan():
    """Provider-backed forcing through a SHARDED DevicePlan, interpolated
    on device inside the shard_map scan (time-varying lateral BCs under
    the segment driver — the reference's mid-loop record streaming,
    bounds_forcing.f:593-868, with zero host round-trips)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    from extpom_tpu.cases.channel import channel_model
    from extpom_tpu.mesh.sharding import make_mesh
    kw = dict(im=32, jm=16, kb=7, isplit=6, dtype="float64")
    ref = channel_model(**kw)
    ref.run_segment(4)
    m = channel_model(**kw)
    m.shard(make_mesh(2, 4), mode="shardmap")
    m.run_segment(4)
    _compare(ref.state, m.state)


def test_shardmap_config5_column_depth():
    """kb=41, the vertical extent of configs/config5_2048.json, on a 1x2
    mesh against the single-device trace."""
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 devices")
    base = dict(im=32, jm=64, kb=41, isplit=2, dte=4.0)
    ref = _run_ref(n=1, **base)
    st = _run_mesh(make_mesh(1, 2), n=1, **base)
    _compare(ref.state, st)
