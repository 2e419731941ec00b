"""Weak-scaling harness: grid-pt-steps/s efficiency vs device count.

Usage:
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python tools/weakscale.py [--base 96] [--kb 16] [--steps 8] \
        [--modes gspmd,shardmap] [--json out.json]

Weak scaling: the PER-DEVICE tile is held at base x base x kb while the
global grid grows with the mesh (1: base^2, 2: 2base x base, 4: 2base x
2base, 8: 4base x 2base ...).  Efficiency(P) = throughput(P) / (P x
throughput(1)).  By default the harness runs on virtual CPU devices, so
the numbers are INDICATIVE (CPU cores emulate collectives); pass
``--backend gpu`` on a multi-GPU host.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

# default to the virtual-CPU mesh; pass --backend gpu on a multi-GPU host
if "--backend" in sys.argv:
    _be = sys.argv[sys.argv.index("--backend") + 1]
else:
    _be = "cpu"
if _be == "cpu":
    jax.config.update("jax_platforms", "cpu")


def mesh_shape(p: int):
    px = 1
    while (px * 2) ** 2 <= p * 2 and px * 2 * max(p // (px * 2), 1) == p \
            and px * 2 <= p:
        px *= 2
    px = {1: 1, 2: 2, 4: 2, 8: 4, 16: 4}.get(p, px)
    return px, p // px


def run_one(p: int, base: int, kb: int, steps: int, mode: str,
            segments: bool = False) -> float:
    from extpom_tpu.cases.seamount import seamount_model
    from extpom_tpu.mesh.sharding import make_mesh

    px, py = mesh_shape(p)
    im, jm = base * px, base * py
    m = seamount_model(im=im, jm=jm, kb=kb, donate=False,
                       dtype="float32")
    if p > 1:
        m.shard(make_mesh(px, py), mode=mode)
    if segments:
        # production path: the whole segment under one dispatch (for
        # shardmap, the scan runs INSIDE the shard_map body —
        # mesh.shardmap.make_shardmap_run)
        m.run_segment(steps)
        jax.block_until_ready(m.state.el)
        m.run_segment(steps)
        jax.block_until_ready(m.state.el)
        t0 = time.perf_counter()
        m.run_segment(steps)
        jax.block_until_ready(m.state.el)
        return im * jm * kb * steps / (time.perf_counter() - t0)
    # warm (compiles both step variants)
    m.step_once()
    m.step_once()
    jax.block_until_ready(m.state.el)
    t0 = time.perf_counter()
    for _ in range(steps):
        m.step_once()
    jax.block_until_ready(m.state.el)
    dt = time.perf_counter() - t0
    return im * jm * kb * steps / dt


_COLLECTIVES = ("collective-permute", "all-reduce", "all-gather",
                "reduce-scatter", "all-to-all")


def collective_census(p: int, base: int, kb: int, mode: str):
    """Count + byte-size the collectives in the COMPILED step for one
    internal step: attributes the GSPMD-vs-shardmap gap to partitioner-
    inserted halo traffic rather than CPU-emulation artifacts.  Bytes =
    product of each
    collective's result shape x dtype size (per device program)."""
    import re
    from extpom_tpu.cases.seamount import seamount_model
    from extpom_tpu.mesh.sharding import make_mesh

    px, py = mesh_shape(p)
    im, jm = base * px, base * py
    m = seamount_model(im=im, jm=jm, kb=kb, donate=False,
                       dtype="float32")
    m.shard(make_mesh(px, py), mode=mode)
    fc = m._shard_fc(m.forcing_at(1))
    txt = m._step.lower(m.grid, m.state, fc, m.rmean, m.tclim, m.sclim,
                        first=False).compile().as_text()
    counts = {k: 0 for k in _COLLECTIVES}
    bytes_ = {k: 0 for k in _COLLECTIVES}
    pat = re.compile(
        r"=\s+(?:\(?)([a-z0-9]+)\[([0-9,]*)\][^=]*?\s("
        + "|".join(_COLLECTIVES) + r")[-.(]")
    dsize = {"f32": 4, "f64": 8, "bf16": 2, "s32": 4, "u32": 4, "pred": 1}
    for mline in pat.finditer(txt):
        dt_, shape, op = mline.groups()
        n = 1
        for d in shape.split(","):
            if d:
                n *= int(d)
        counts[op] += 1
        bytes_[op] += n * dsize.get(dt_, 4)
    return counts, bytes_


def run_one_serial(im, jm, kb, steps) -> float:
    from extpom_tpu.cases.seamount import seamount_model
    m = seamount_model(im=im, jm=jm, kb=kb, donate=False,
                       dtype="float32")
    m.step_once()
    m.step_once()
    jax.block_until_ready(m.state.el)
    t0 = time.perf_counter()
    for _ in range(steps):
        m.step_once()
    jax.block_until_ready(m.state.el)
    return im * jm * kb * steps / (time.perf_counter() - t0)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", type=int, default=96)
    ap.add_argument("--kb", type=int, default=16)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--devices", default="1,2,4,8")
    ap.add_argument("--modes", default="gspmd,shardmap")
    ap.add_argument("--json", default=None)
    ap.add_argument("--backend", default="cpu", choices=("cpu", "gpu"))
    ap.add_argument("--segments", action="store_true",
                    help="time whole scanned segments (production path) "
                         "instead of step-at-a-time")
    ap.add_argument("--census", action="store_true",
                    help="also print the per-step collective census "
                         "(count + bytes) for each mode/device count")
    args = ap.parse_args()

    n_dev = len(jax.devices())
    print(f"backend: {jax.default_backend()}  devices: {n_dev}"
          + ("  (virtual CPU -> numbers are indicative)"
             if jax.default_backend() == "cpu" else ""))
    rows = []
    # equal-work serial references: the same GLOBAL grid on one device.
    # On virtual CPU devices the classic weak-scaling per-device ratio is
    # dominated by host-core contention (P virtual devices share the same
    # cores), so eff_vs_serial = throughput(P dev) / throughput(1 dev,
    # same grid) is the decomposition+collective overhead measure that
    # transfers to real devices.
    serial = {}
    for p in [int(s) for s in args.devices.split(",")]:
        if p > n_dev:
            continue
        px, py = mesh_shape(p)
        serial[p] = run_one_serial(px * args.base, py * args.base,
                                   args.kb, args.steps)
    print()
    print("| mode | devices | mesh | grid | Mpt-steps/s | /device | "
          "weak eff | vs 1-dev same grid |")
    print("|---|---|---|---|---|---|---|---|")
    for mode in args.modes.split(","):
        base_tp = None
        for p in [int(s) for s in args.devices.split(",")]:
            if p > n_dev:
                continue
            px, py = mesh_shape(p)
            tp = run_one(p, args.base, args.kb, args.steps, mode,
                         segments=args.segments)
            per = tp / p
            if base_tp is None:
                base_tp = per
            eff = per / base_tp
            effs = tp / serial[p]
            print(f"| {mode} | {p} | {px}x{py} | "
                  f"{args.base*px}x{args.base*py}x{args.kb} | "
                  f"{tp/1e6:.1f} | {per/1e6:.1f} | {100*eff:.0f}% | "
                  f"{100*effs:.0f}% |",
                  flush=True)
            rows.append(dict(mode=mode, devices=p, px=px, py=py,
                             throughput=tp, per_device=per,
                             efficiency=eff, eff_vs_serial=effs))
    print()
    census_rows = []
    if args.census:
        print("| mode | devices | permute n/bytes | all-reduce n/bytes |"
              " all-to-all n/bytes | total MB/step |")
        print("|---|---|---|---|---|---|")
        for mode in args.modes.split(","):
            for p in [int(s) for s in args.devices.split(",")]:
                if p > n_dev or p < 2:
                    continue
                counts, bytes_ = collective_census(p, args.base, args.kb,
                                                   mode)
                tot = sum(bytes_.values())
                print(f"| {mode} | {p} | "
                      f"{counts['collective-permute']}/"
                      f"{bytes_['collective-permute']//1024} KiB | "
                      f"{counts['all-reduce']}/"
                      f"{bytes_['all-reduce']//1024} KiB | "
                      f"{counts['all-to-all']}/"
                      f"{bytes_['all-to-all']//1024} KiB | "
                      f"{tot/2**20:.2f} |", flush=True)
                census_rows.append(dict(mode=mode, devices=p,
                                        counts=counts, bytes=bytes_))
        print()
    out = dict(backend=jax.default_backend(), base=args.base, kb=args.kb,
               segments=bool(args.segments), rows=rows,
               census=census_rows)
    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
