"""BASELINE config 4: regional basin 512x512x31 with restart I/O.

Runs the full 3-D mode-split core at 512x512x31 f32 on the attached GPU
in scanned segments, writing Zarr output + restart at the reference's
cadence pattern (write_output/write_restart, advance.f:38-49), then proves
bit-seamless resume from the written restart.

Usage: python tools/config4.py [--steps 200] [--segment 50] [--out /tmp/c4]
Prints one JSON line with throughput + I/O timings.
"""

import argparse
import json
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from extpom_tpu.utils.cache import enable_compile_cache

enable_compile_cache()

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--segment", type=int, default=50)
    ap.add_argument("--im", type=int, default=512)
    ap.add_argument("--kb", type=int, default=31)
    ap.add_argument("--out", default="/tmp/extpom_config4")
    ap.add_argument("--async-io", action="store_true",
                    help="write snapshots/restarts on a background "
                         "thread (io.asyncwriter): interval N+1 computes "
                         "while interval N writes")
    args = ap.parse_args()

    from extpom_tpu.cases.seamount import seamount_model
    from extpom_tpu.io import zarrstore as zio
    from extpom_tpu.diag import stats as diag_stats

    shutil.rmtree(args.out, ignore_errors=True)
    os.makedirs(args.out, exist_ok=True)

    im = jm = args.im
    kb = args.kb
    m = seamount_model(im=im, jm=jm, kb=kb)
    m.run_segment(args.segment)          # compile first-step variant
    jax.block_until_ready(m.state.el)
    m.run_segment(args.segment)          # compile + warm steady variant
    jax.block_until_ready(m.state.el)
    warm = m.iint
    # always time at least one post-warm segment (so a restart exists
    # for the resume check even when --steps <= 2 segments)
    target = max(args.steps, warm + args.segment)
    t_compute = t_io = 0.0
    n_rst = n_out = 0
    writer = None
    if args.async_io:
        from extpom_tpu.io.asyncwriter import AsyncWriter
        writer = AsyncWriter()
    t_all = time.perf_counter()
    while m.iint < target:
        t0 = time.perf_counter()
        m.run_segment(args.segment)
        jax.block_until_ready(m.state.el)
        t_compute += time.perf_counter() - t0
        t0 = time.perf_counter()
        s = {k: float(v) for k, v in diag_stats.domain_stats(
            m.grid, m.cfg, m.state).items()}
        if writer is not None:
            writer.submit(zio.write_output,
                          os.path.join(args.out, f"out.{m.iint:06d}"),
                          m.grid, m.cfg, m.state, m.time_days, s)
            writer.submit(zio.write_restart,
                          os.path.join(args.out, f"rst.{m.iint:06d}"),
                          m.state, m.iint)
        else:
            zio.write_output(os.path.join(args.out, f"out.{m.iint:06d}"),
                             m.grid, m.cfg, m.state, m.time_days, s)
            zio.write_restart(os.path.join(args.out, f"rst.{m.iint:06d}"),
                              m.state, m.iint)
        n_out += 1
        n_rst += 1
        t_io += time.perf_counter() - t0
    if writer is not None:
        t0 = time.perf_counter()
        writer.close()            # only the LAST interval's write remains
        t_io += time.perf_counter() - t0
    wall = time.perf_counter() - t_all

    vamax, _ = diag_stats.check_velocity(m.cfg, m.state.va)
    assert np.isfinite(float(vamax)) and float(vamax) < m.cfg.vmaxl

    # bit-seamless resume check (restart the last segment)
    last_rst = os.path.join(args.out, f"rst.{m.iint:06d}")
    st2, iint2, _ = zio.read_restart(last_rst, m.cfg)
    for f in ("el", "u", "t", "q2"):
        a = np.asarray(getattr(m.state, f))
        b = np.asarray(getattr(st2, f))
        assert np.array_equal(a, b), f"restart not bitwise for {f}"

    steps = m.iint - warm
    print(json.dumps({
        "config": f"seamount {im}x{jm}x{kb} f32 (BASELINE config 4)",
        "async_io": bool(args.async_io),
        "steps_timed": steps,
        "grid_pt_steps_per_s": im * jm * kb * steps / t_compute,
        "s_per_step": t_compute / steps,
        "io_s_total": t_io, "outputs": n_out, "restarts": n_rst,
        "io_s_per_snapshot": t_io / max(n_out + n_rst, 1),
        "wall_s": wall,
        "restart_bitwise": True,
        "stats": s,
    }))


if __name__ == "__main__":
    main()
