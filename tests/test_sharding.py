"""Decomposition invariance: the sharded step must reproduce the
single-device answer (SURVEY.md §4 — the reference can only validate its
decomposition by startup geometry checks; here it's a real oracle)."""

import functools
import inspect
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from extpom_tpu.cases.seamount import seamount_model
from extpom_tpu.core import stepper
from extpom_tpu.core.model import Model, refuse_gspmd_on_gpus
from extpom_tpu.mesh.sharding import make_mesh, shard_model_arrays


@pytest.mark.parametrize("px,py", [(2, 4), (4, 2), (1, 8)])
def test_decomposition_invariance(px, py):
    if len(jax.devices()) < px * py:
        pytest.skip("needs 8 devices")
    m = seamount_model(im=32, jm=64, kb=7, donate=False, dtype="float64")
    fc = m.forcing_at(1)

    def run3(grid, state, fc, rmean, tclim, sclim):
        st = stepper.step(grid, m.cfg, state, fc, rmean, tclim, sclim,
                          first=True)
        for _ in range(2):
            st = stepper.step(grid, m.cfg, st, fc, rmean, tclim, sclim,
                              first=False)
        return st

    ref = jax.jit(run3)(m.grid, m.state, fc, m.rmean, m.tclim, m.sclim)

    mesh = make_mesh(px, py)
    grid_s, state_s, fc_s, rmean_s, tclim_s, sclim_s = shard_model_arrays(
        m.grid, m.state, fc, mesh, m.rmean, m.tclim, m.sclim)
    out = jax.jit(run3)(grid_s, state_s, fc_s, rmean_s, tclim_s, sclim_s)

    for name in ("el", "ua", "va", "u", "v", "t", "s", "q2", "km"):
        a = np.asarray(getattr(ref, name))
        b = np.asarray(getattr(out, name))
        # sharded reductions reorder sums over ~1e7-magnitude flux
        # intermediates -> ~1e-16 relative noise per step; structural
        # decomposition bugs show up at O(0.1) (see ops.stencil docstring)
        tol = 1e-9 * max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=name)


@pytest.mark.parametrize("mode", ["gspmd", "shardmap"])
def test_decomposition_invariance_with_land(mode):
    """Land (fsm=0) blobs crossing shard boundaries: the masked BC writes
    and dum/dvm-masked stencils must stay decomposition-invariant in both
    mesh modes."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    import numpy as np
    from extpom_tpu.core.config import Config
    from extpom_tpu.core.grid import make_grid, sigma_levels
    from extpom_tpu.core.model import Model

    im, jm, kb = 32, 64, 7
    cfg = Config(im=im, jm=jm, kb=kb, dtype="float64", tbias=10.0,
                 sbias=20.0, dte=6.0, isplit=10)
    z, zz = sigma_levels(kb)
    dx = np.full((im, jm), 8000.0)
    h = np.full((im, jm), 1000.0)
    fsm = np.ones((im, jm))
    # a land blob straddling the x-shard boundary at i=16 and the y-shard
    # boundaries at j=16/32/48 (2x4 and 4x2 meshes)
    fsm[12:22, 12:36] = 0.0
    h = np.where(fsm > 0, h, 1.0)
    cor = np.full((im, jm), 1e-4)
    grid = make_grid(cfg, z, zz, dx, dx, h, fsm, cor=cor)
    tb = np.broadcast_to(
        5.0 + 15.0 * np.exp(zz[:, None, None] * h[None] / 1000.0) - 10.0,
        (kb, im, jm)).copy()
    sb = np.full((kb, im, jm), 15.0)
    uab = np.full((im, jm), 0.1) * fsm

    def build():
        return Model(grid, cfg, tb=tb, sb=sb, uab=uab, donate=False)

    ref = build()
    for _ in range(5):
        ref.step_once()

    m = build().shard(make_mesh(2, 4), mode=mode)
    for _ in range(5):
        m.step_once()

    for name in ("el", "ua", "va", "u", "v", "t", "s", "q2", "km"):
        a = np.asarray(getattr(ref.state, name))
        b = np.asarray(getattr(m.state, name))
        assert np.all(np.isfinite(a)), f"{name} not finite"
        tol = 1e-9 * max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=name)


def _stub_mesh(platform, n):
    dev = types.SimpleNamespace(platform=platform)
    return types.SimpleNamespace(shape={"x": n, "y": 1},
                                 devices=np.array([dev] * n).reshape(n, 1))


def test_gspmd_refused_on_a_gpu_mesh():
    """GSPMD computes wrong fields over several GPUs: Model.shard refuses
    it there before touching the model, and shard_map is the default."""
    m = seamount_model(im=16, jm=16, kb=5, donate=False, dtype="float64")
    with pytest.raises(NotImplementedError, match="shardmap"):
        m.shard(_stub_mesh("gpu", 4), mode="gspmd")
    assert m.mesh is None and m._par_mode is None
    refuse_gspmd_on_gpus(_stub_mesh("gpu", 1))      # one card: allowed
    refuse_gspmd_on_gpus(_stub_mesh("cpu", 4))      # CPU devices: allowed
    assert inspect.signature(Model.shard).parameters["mode"].default \
        == "shardmap"
