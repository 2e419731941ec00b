"""Explicit shard_map + ppermute halo-exchange path (mesh.shardmap) —
the hand-written exchange2d/3d_mpi analogue (parallel_mpi.f:154-480).

Must agree with the single-device run (and hence with the GSPMD path,
which test_sharding.py pins to the same oracle) on:

* the standard seamount step (1-cell halos),
* the 4th-order McCalpin pressure gradient (2-cell halos — the
  order2d/3d_mpi analogue, parallel_mpi.f:353-480),
* a padded ragged grid (global-offset edge masks under shard_map).
"""

import numpy as np
import pytest

import jax

from extpom_tpu.cases.seamount import seamount_model
from extpom_tpu.mesh.padding import pad_model, unpad
from extpom_tpu.mesh.sharding import make_mesh
from extpom_tpu.mesh.shardmap import make_shardmap_step, shard_args

CHECK = ("el", "ua", "va", "u", "v", "t", "s", "q2", "km")


def _run_ref(n=3, **kw):
    ref = seamount_model(dtype="float64", donate=False, **kw)
    for _ in range(n):
        ref.step_once()
    return ref


def _run_shardmap(m, mesh, n=3):
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


def _compare(ref_st, st, cfg=None):
    for name in CHECK:
        a = np.asarray(getattr(ref_st, name))
        b = np.asarray(getattr(st, name))
        if cfg is not None:
            b = np.asarray(unpad(b, cfg))
        tol = 1e-9 * max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=name)


@pytest.mark.parametrize("px,py", [(2, 4), (4, 2), (1, 8)])
def test_shardmap_matches_single_device(px, py):
    if len(jax.devices()) < px * py:
        pytest.skip("needs 8 devices")
    kw = dict(im=32, jm=64, kb=7)
    ref = _run_ref(**kw)
    m = seamount_model(dtype="float64", donate=False, **kw)
    st = _run_shardmap(m, make_mesh(px, py))
    _compare(ref.state, st)


def test_shardmap_mcc_wide_halo():
    """npg=2 exercises the 2-cell sft shifts -> 2-wide ppermute strips."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    kw = dict(im=32, jm=64, kb=7, npg=2)
    ref = _run_ref(**kw)
    m = seamount_model(dtype="float64", donate=False, **kw)
    st = _run_shardmap(m, make_mesh(2, 4))
    _compare(ref.state, st)


def test_shardmap_ragged_padded():
    """Padded 33x65 grid on 2x4: global-offset region masks must fire the
    open-boundary writes on the true (active) edges, not the pad edges."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    kw = dict(im=33, jm=65, kb=7)
    ref = _run_ref(**kw)
    m = seamount_model(dtype="float64", donate=False, **kw)
    pad_model(m, 2, 4)
    st = _run_shardmap(m, make_mesh(2, 4))
    # shape-dependent XLA fusion roundoff (see test_ragged) -> 1e-12 gate
    for name in CHECK:
        a = np.asarray(getattr(ref.state, name))
        b = np.asarray(unpad(getattr(st, name), m.cfg))
        tol = 1e-10 * max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=name)


def test_shardmap_chunked_vs_per_read_exchange():
    """The chunked halo-ring external loop (mesh/extchunk.py, the default
    under shard_map) must match the per-shifted-read ppermute path —
    and both must match the single-device oracle."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    kw = dict(im=32, jm=64, kb=7)
    ref = _run_ref(**kw)
    m1 = seamount_model(dtype="float64", donate=False, **kw)
    st_chunk = _run_shardmap(m1, make_mesh(2, 4))
    m2 = seamount_model(dtype="float64", donate=False,
                        ext_local_chunk="off", **kw)
    st_per = _run_shardmap(m2, make_mesh(2, 4))
    _compare(ref.state, st_chunk)
    _compare(ref.state, st_per)


def test_shardmap_file_bc_scheme():
    """bc_scheme='file' exercises bc_vel3d's smoothing + hmax blend and
    bc_el/bc_ts/bc_turb full-array edge writes under shard_map."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    kw = dict(im=32, jm=64, kb=7, bc_scheme="file")
    ref = _run_ref(**kw)
    m = seamount_model(dtype="float64", donate=False, **kw)
    st = _run_shardmap(m, make_mesh(2, 4))
    _compare(ref.state, st)


def test_shardmap_orlanski_scheme():
    """bc_scheme='orlanski' under shard_map: the radiation phase-speed
    reads (2-cell sft shifts at the edges) and the sharded edge writes
    must match the single-device run (the r1 lesson — sharded edge
    writes are where SPMD bugs live — applied to the Orlanski set)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    kw = dict(im=32, jm=64, kb=7, bc_scheme="orlanski")
    ref = _run_ref(**kw)
    m = seamount_model(dtype="float64", donate=False, **kw)
    st = _run_shardmap(m, make_mesh(2, 4))
    _compare(ref.state, st)


def test_shardmap_trivial_1x1_dispatch():
    """At a 1x1 mesh the shard_map body dispatches the GLOBAL machine by
    default (trivial_shardmap='auto': the local block is the whole
    domain, so the traced-offset masks and O(volume) edge writes are
    pure overhead — the n_proc=1 degenerate case of
    exchange2d_mpi, parallel_mpi.f:154-351).  Both settings must match
    the plain single-device run exactly."""
    kw = dict(im=32, jm=64, kb=7)
    ref = _run_ref(**kw)
    # auto (default): global machine inside the shard_map body
    m1 = seamount_model(dtype="float64", donate=False, **kw)
    st_auto = _run_shardmap(m1, make_mesh(1, 1))
    _compare(ref.state, st_auto)
    # local (the meshbench measurement mode): explicit local-ctx machinery
    m2 = seamount_model(dtype="float64", donate=False,
                        trivial_shardmap="local", **kw)
    st_local = _run_shardmap(m2, make_mesh(1, 1))
    _compare(ref.state, st_local)
