"""Forced run at scale: channel (config-3) physics at config-4 size.

Runs the tidal channel — time-varying lateral boundary forcing served
through the (optionally chunked) DevicePlan — at 512x512x31 f32 on the
attached GPU, in scanned segments.  This
is the production configuration of the reference (file-driven lateral
BCs refreshed inside the time loop, bounds_forcing.f:593-868 +
advance.f:78-93) at BASELINE config-4 scale.

Usage: python tools/config3at4.py [--steps 150] [--segment 50]
                                  [--hbm-mb 0]   # 0 = force chunked staging
Prints one JSON line (ms/step).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from extpom_tpu.utils.cache import enable_compile_cache

enable_compile_cache()

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--segment", type=int, default=50)
    ap.add_argument("--im", type=int, default=512)
    ap.add_argument("--jm", type=int, default=512)
    ap.add_argument("--kb", type=int, default=31)
    ap.add_argument("--hbm-mb", type=int, default=0,
                    help="forcing HBM budget; 0 forces per-segment "
                         "chunked staging (the streaming analogue)")
    args = ap.parse_args()

    from extpom_tpu.cases.channel import channel_model
    from extpom_tpu.diag import stats as diag_stats
    from extpom_tpu.forcing.device import plan_bytes

    m = channel_model(im=args.im, jm=args.jm, kb=args.kb,
                      forcing_hbm_mb=args.hbm_mb)
    chunked_staging = bool(plan_bytes(m.forcing_fn)
                           > m.cfg.forcing_hbm_mb * 2 ** 20)

    m.run_segment(args.segment)
    jax.block_until_ready(m.state.el)
    m.run_segment(args.segment)
    jax.block_until_ready(m.state.el)
    warm = m.iint
    target = max(args.steps, warm + args.segment)
    t0 = time.perf_counter()
    while m.iint < target:
        m.run_segment(args.segment)
    jax.block_until_ready(m.state.el)
    dt = (time.perf_counter() - t0) / (m.iint - warm)

    vamax, _ = diag_stats.check_velocity(m.cfg, m.state.va)
    assert np.isfinite(float(vamax)) and float(vamax) < m.cfg.vmaxl
    s = {k: float(v) for k, v in diag_stats.domain_stats(
        m.grid, m.cfg, m.state).items()}

    print(json.dumps({
        "config": f"channel {args.im}x{args.jm}x{args.kb} f32 with "
                  "time-varying lateral BCs (config-3 physics at "
                  "config-4 size)",
        "chunked_staging": chunked_staging,
        "steps_timed": m.iint - warm,
        "ms_per_step": dt * 1e3,
        "grid_pt_steps_per_s": args.im * args.jm * args.kb / dt,
        "vamax": float(vamax),
        "stats": {k: s[k] for k in ("vtot", "eaver", "taver", "saver")},
    }))


if __name__ == "__main__":
    main()
