"""Throughput of the shard_map path vs the plain single-device path on
one card: the price of the explicit mesh machinery.

Usage: python tools/meshbench.py [--im 256] [--jm 256] [--kb 31]
       [--steps 50] [--modes plain,shardmap]

--im 1024 --jm 512 --kb 41 measures the config-5 PER-CARD tile (the
2048^2x41 run decomposed 2x4, configs/config5_2048.json) on one card
under shard_map(1x1) — the reference's per-rank workload (pom.sh:1 +
pom.h_dist:22-28).

Runs the seamount 3-D core (the bench.py configuration) twice on the
attached device: plain (global arrays) and shard_map(1x1) (explicit-path
machinery: chunked halo-ring external loop, whole-segment scan inside
the shard_map body).
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


def measure(im, jm, kb, n, mesh_mode, trivial="local"):
    from extpom_tpu.cases.seamount import seamount_model
    from extpom_tpu.mesh.sharding import make_mesh

    # trivial_shardmap="local" keeps the explicit local-ctx machinery at
    # the 1x1 mesh — this tool's purpose is to price it on one card; the
    # production default ("auto") runs the global machine at 1x1
    m = seamount_model(im=im, jm=jm, kb=kb, trivial_shardmap=trivial)
    if mesh_mode:
        m.shard(make_mesh(1, 1), mode=mesh_mode)
    m.run_segment(n)
    jax.block_until_ready(m.state.el)
    m.run_segment(n)
    jax.block_until_ready(m.state.el)
    t0 = time.perf_counter()
    m.run_segment(n)
    jax.block_until_ready(m.state.el)
    dt = time.perf_counter() - t0
    return im * jm * kb * n / dt, dt / n


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--im", type=int, default=256)
    ap.add_argument("--jm", type=int, default=0)
    ap.add_argument("--kb", type=int, default=31)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--modes", default="plain,shardmap")
    ap.add_argument("--trivial", default="local", choices=("local", "auto"),
                    help="trivial_shardmap setting for the 1x1 mesh "
                         "(local = price the explicit machinery, the "
                         "tool's default; auto = production dispatch)")
    args = ap.parse_args()
    jm = args.jm or args.im

    rows = {}
    for name in args.modes.split(","):
        mode = None if name == "plain" else name
        gps, spstep = measure(args.im, jm, args.kb, args.steps, mode,
                              trivial=args.trivial)
        rows[name] = dict(gps=gps, ms_per_step=spstep * 1e3)
        print(f"{name:9s}: {gps/1e6:8.1f} Mpt-steps/s "
              f"({spstep*1e3:.2f} ms/step)", flush=True)
    out = {"rows": rows}
    if "plain" in rows and "shardmap" in rows:
        ratio = rows["shardmap"]["gps"] / rows["plain"]["gps"]
        print(f"shardmap(1x1) / plain = {ratio:.3f}")
        out["ratio"] = round(ratio, 4)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
