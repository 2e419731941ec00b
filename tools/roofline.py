"""Roofline measurement: achieved memory bandwidth of the model step.

Usage:  python tools/roofline.py [--sizes 256,512] [--kb 31] [--mode2]

For each grid size this measures the full mode-split internal step (the
production scanned path), or with ``--mode2`` the external-mode 2-D loop
alone, and reports achieved bytes/s against the card's HBM peak:

* analytic bytes/step from XLA's compiled cost analysis (HLO
  bytes-accessed after fusion), plus a hand model of the external loop's
  minimum traffic (the 2-D working set once in + once out per substep);
* wall time per step from a timed scanned segment.

The peak comes from a table keyed by ``device_kind``; an unknown device is
an error.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

# HBM peak (B/s) by device kind.  Source: NVIDIA H100 Tensor Core GPU
# datasheet — SXM5 80 GB HBM3 3.35 TB/s, PCIe 80 GB HBM2e 2.0 TB/s.
HBM_PEAK = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
}


def device_peak():
    kind = jax.devices()[0].device_kind
    if kind not in HBM_PEAK:
        raise KeyError(f"no HBM peak for device kind {kind!r}; add it to "
                       "tools/roofline.py:HBM_PEAK with its source")
    return HBM_PEAK[kind], kind


def measure_step(im, jm, kb, n=30):
    """Returns (seconds/step, analytic bytes/step, flops/step)."""
    from extpom_tpu.cases.seamount import seamount_model
    from extpom_tpu.core import stepper

    m = seamount_model(im=im, jm=jm, kb=kb)
    run = stepper.make_run_fn(m.cfg, m.period, donate=False)

    lowered = run.lower(m.grid, m.state, m.base_forcing, m.rmean, m.tclim,
                        m.sclim, 0, n, first=False, plan=None)
    compiled = lowered.compile()
    try:
        ca = compiled.cost_analysis()
        ca = ca[0] if isinstance(ca, (list, tuple)) else ca
        bytes_seg = float(ca.get("bytes accessed", 0.0))
        flops_seg = float(ca.get("flops", 0.0))
    except Exception:
        bytes_seg = flops_seg = 0.0

    st = m.state
    st = compiled(m.grid, st, m.base_forcing, m.rmean, m.tclim, m.sclim,
                  jnp.asarray(0), plan=None)
    jax.block_until_ready(st.el)
    t0 = time.perf_counter()
    st = compiled(m.grid, st, m.base_forcing, m.rmean, m.tclim, m.sclim,
                  jnp.asarray(n), plan=None)
    jax.block_until_ready(st.el)
    dt = (time.perf_counter() - t0) / n
    return dt, bytes_seg / n, flops_seg / n


def ext_loop_model_bytes(im, jm, isplit):
    """Hand model: minimum memory traffic of the external loop per
    internal step — the live 2-D working set (14 carry + 11 grid + 5 aux +
    4 forcing reads, 14 writes) moves once per SUBSTEP."""
    n_read, n_write = 34, 14
    return (n_read + n_write) * im * jm * 4 * isplit


def measure_mode2(im, jm, isplit=30, n=20, kb=3, **cfg_kw):
    """External-2-D-mode-only step (mode=2).  Returns (s/step, model
    bytes/step, HLO bytes/step)."""
    from extpom_tpu.cases.seamount import seamount_model
    from extpom_tpu.core import stepper

    m = seamount_model(im=im, jm=jm, kb=kb, mode=2, isplit=isplit,
                       lramp=False, **cfg_kw)
    run = stepper.make_run_fn(m.cfg, 1.0, donate=False)
    lowered = run.lower(m.grid, m.state, m.base_forcing, m.rmean, m.tclim,
                        m.sclim, 0, n, first=False, plan=None)
    compiled = lowered.compile()
    try:
        ca = compiled.cost_analysis()
        ca = ca[0] if isinstance(ca, (list, tuple)) else ca
        hlo_bytes = float(ca.get("bytes accessed", 0.0)) / n
    except Exception:
        hlo_bytes = 0.0
    st = compiled(m.grid, m.state, m.base_forcing, m.rmean, m.tclim,
                  m.sclim, jnp.asarray(0), plan=None)
    jax.block_until_ready(st.el)
    t0 = time.perf_counter()
    st = compiled(m.grid, st, m.base_forcing, m.rmean, m.tclim, m.sclim,
                  jnp.asarray(n), plan=None)
    jax.block_until_ready(st.el)
    dt = (time.perf_counter() - t0) / n
    model_bytes = ext_loop_model_bytes(im, jm, isplit)
    return dt, model_bytes, hlo_bytes


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="256,512")
    ap.add_argument("--kb", type=int, default=31)
    ap.add_argument("--isplit", type=int, default=30)
    ap.add_argument("--mode2", action="store_true",
                    help="external-mode-only (mode=2) measurement")
    args = ap.parse_args()

    from extpom_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    peak, kind = device_peak()
    print(f"device: {kind}; HBM peak {peak/1e9:.0f} GB/s")
    rows = []
    if args.mode2:
        print()
        print(f"external (2-D) mode only, isplit={args.isplit}")
        print()
        print("| grid | s/step | model GB/step | HLO GB/step | model GB/s |"
              " %peak(model) |")
        print("|---|---|---|---|---|---|")
        for s in args.sizes.split(","):
            im = jm = int(s)
            dt, mb, hb = measure_mode2(im, jm, args.isplit)
            print(f"| {im}x{jm} | {dt*1e3:.2f} ms | {mb/1e9:.3f} | "
                  f"{hb/1e9:.3f} | {mb/dt/1e9:.0f} | {100*mb/dt/peak:.0f}% |",
                  flush=True)
            rows.append(dict(im=im, jm=jm, s_per_step=dt, model_bytes=mb,
                             hlo_bytes=hb,
                             pct_peak_model=100 * mb / dt / peak))
    else:
        print()
        print("| grid | s/step | HLO GB/step | achieved GB/s | %peak |"
              " Mpt-steps/s |")
        print("|---|---|---|---|---|---|")
        for s in args.sizes.split(","):
            im = jm = int(s)
            kb = args.kb
            dt, bstep, fstep = measure_step(im, jm, kb)
            bw = bstep / dt
            gps = im * jm * kb / dt
            print(f"| {im}x{jm}x{kb} | {dt*1e3:.2f} ms | {bstep/1e9:.2f} | "
                  f"{bw/1e9:.0f} | {100*bw/peak:.0f}% | {gps/1e6:.0f} |",
                  flush=True)
            rows.append(dict(im=im, jm=jm, kb=kb, s_per_step=dt,
                             hlo_bytes_per_step=bstep, achieved_Bps=bw,
                             pct_peak=100 * bw / peak,
                             grid_pt_steps_per_s=gps))
    print()
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
