"""f32-vs-f64 tolerance ladder (SURVEY §7 hard-parts bullet).

Correctness tests elsewhere run float64; production (bench, every GPU
run, the config-5 JSON) runs float32.  These tests bound the f32 drift of
the SAME code on the SAME machine (CPU backend, both dtypes) over an
N-step flagship run, so every published f32 perf number has a tested
accuracy envelope — the analogue of the reference running its
conservation prints on the production build (advance.f:644-756,
makefile_dist:17).  The measured ladder is documented in VALIDATION.md;
the asserted bounds carry ~10x headroom over the measured drift so the
test flags a real precision regression, not noise.
"""

import numpy as np
import pytest

from extpom_tpu.diag import stats as diag_stats


def _drift(make_model, n_steps):
    """Run n_steps in f64 and f32; return per-field relative drift and
    the conservation-scalar drifts."""
    out = {}
    stats = {}
    for dtype in ("float64", "float32"):
        m = make_model(dtype)
        m.run_segment(n_steps)
        out[dtype] = m.state
        stats[dtype] = {k: float(v) for k, v in diag_stats.domain_stats(
            m.grid, m.cfg, m.state).items()}
    rel = {}
    for name in ("el", "ua", "va", "u", "v", "t", "s", "q2"):
        a = np.asarray(getattr(out["float64"], name))
        b = np.asarray(getattr(out["float32"], name), np.float64)
        scale = max(float(np.abs(a).max()), 1e-12)
        rel[name] = float(np.abs(a - b).max()) / scale
    srel = {}
    for k in ("vtot", "eaver", "taver", "saver", "ekin"):
        a, b = stats["float64"][k], stats["float32"][k]
        srel[k] = abs(a - b) / max(abs(a), 1e-12)
    return rel, srel


# Measured drift this round (CPU, x64 vs f32; VALIDATION.md §2) with the
# asserted bound ~5-10x above it.  The weak-signal fields (v on the
# near-symmetric seamount, q2) have small max-norms, so their RELATIVE
# drift runs largest.
_SEAMOUNT_BOUNDS = {"el": 1e-4, "ua": 1e-4, "va": 6e-4, "u": 1e-2,
                    "v": 1e-1, "t": 2e-4, "s": 5e-5, "q2": 5e-3}
_CHANNEL_BOUNDS = {"el": 1e-4, "ua": 1e-4, "va": 2e-4, "u": 6e-4,
                   "v": 2e-3, "t": 5e-5, "s": 5e-5, "q2": 5e-4}


def test_tolerance_ladder_seamount():
    """Seamount 3-D + MY-2.5 (the BASELINE config-2 core), 60 internal
    steps (3 hours at dti=180 s).  Measured drift (CPU, this round):
    el 7.8e-6, ua 4.1e-6, va 3.2e-5, u 8.1e-4, v 1.4e-2, t 6.0e-6,
    s 3.2e-6, q2 7.9e-4 relative max-norm; conservation scalars vtot
    8.3e-9, saver 1.0e-7, taver 4.2e-8, eaver 1.5e-6, ekin 1.4e-7
    (domain_stats accumulates compensated/f64, so these expose the
    STATE drift, not summation noise — diag/stats.py)."""
    from extpom_tpu.cases.seamount import seamount_model

    def make(dtype):
        return seamount_model(im=33, jm=33, kb=11, dtype=dtype,
                              donate=False)

    rel, srel = _drift(make, 60)
    for name, bound in _SEAMOUNT_BOUNDS.items():
        assert rel[name] < bound, (name, rel)
    assert srel["vtot"] < 1e-6, srel
    assert srel["saver"] < 1e-6, srel
    assert srel["taver"] < 1e-6, srel
    assert srel["eaver"] < 3e-3, srel


def test_tolerance_ladder_channel():
    """Forced channel with file-driven open boundaries (BASELINE
    config 3): the provider/BC path under both dtypes.  Measured:
    el 5.7e-6, ua 4.2e-6, va 1.5e-5, u 5.5e-5, v 1.9e-4, t 1.8e-6,
    s 1.6e-6, q2 3.6e-5; vtot 3.2e-8, saver 4.4e-7."""
    from extpom_tpu.cases.channel import channel_model

    def make(dtype):
        return channel_model(im=32, jm=24, kb=7, dtype=dtype)

    rel, srel = _drift(make, 40)
    for name, bound in _CHANNEL_BOUNDS.items():
        assert rel[name] < bound, (name, rel)
    assert srel["vtot"] < 1e-6, srel
    assert srel["saver"] < 1e-5, srel
