#!/usr/bin/env python3
"""Smoke test of the ocean model on an NVIDIA GPU.

    python chip_smoke.py                # one card
    python chip_smoke.py --four-cards   # the decomposed path on four cards

One card, each phase in its own child process, one at a time (a JAX
process reserves most of the card when it first uses it, and float64 must
not leak into the float32 run; this parent never imports JAX):

* ``f32``: the main path, ``python -m extpom_tpu.run`` on the seamount case
  at 512x512x31 float32 (BASELINE config 4), with snapshots and a restart
  through the async writer; then the channel case at the same size, its
  time-varying lateral boundaries staged and interpolated on the device.
* ``f64``: the golden regression (33x33x11, 10 steps) and the f32-vs-f64
  ladder of tests/test_tolerance.py (33x33x11, 60 steps), each at its
  test's tolerance; then the 512x512x31 run again in float64, against
  which the parent holds the float32 run.

``--four-cards`` runs only configs/config5_2048.json's case (seamount,
2048x2048x41 float32) for a few steps on one card, then over a 2x2
shard_map mesh, and compares the fields; GSPMD mode, which computes wrong
fields on a mesh of GPUs, must be refused there.

Exits non-zero, printing no result, when JAX finds no GPU or any phase
fails.  The last line of a passing run is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# f32-vs-f64 bounds of tests/test_tolerance.py for its seamount ladder
# (33x33x11, 60 steps): relative max-norm drift of each field, and of the
# conservation scalars
LADDER_BOUNDS = {"el": 1e-4, "ua": 1e-4, "va": 6e-4, "u": 1e-2,
                 "v": 1e-1, "t": 2e-4, "s": 5e-5, "q2": 5e-3}
SCALAR_BOUNDS = {"vtot": 1e-6, "saver": 1e-6, "taver": 1e-6, "eaver": 3e-3}
FIELDS = tuple(LADDER_BOUNDS)
# the 512x512x31 main path after 80 steps: the ladder's bounds but for
# q2, whose float32-vs-float64 drift after 80 steps is 3.3e-2 on an H100
# at 512x512x31 and 2.5e-2 on the CPU at 256x256x31, against 7.6e-4 at
# the ladder's 33x33x11
MAIN_BOUNDS = dict(LADDER_BOUNDS, q2=1e-1)
STATE_FIELDS = FIELDS + ("et", "rho", "tb", "sb")   # what domain_stats reads
# the mesh comparison bound of __graft_entry__.dryrun_multichip at f32
MESH_TOL = 1e-5

DTI = 180.0                      # seamount/channel dte 6 s x isplit 30
MAIN_SIZE = dict(im=512, jm=512, kb=31)
MAIN_GRID = "{im}x{jm}x{kb}".format(**MAIN_SIZE)
MAIN_STEPS, MAIN_PRINT = 80, 20  # 4 print segments, restart at the end
FOUR_CONF = os.path.join(HERE, "configs", "config5_2048.json")
FOUR_STEPS = 3


def ok_line(device: dict) -> str:
    """The result line: the device as JAX reports it."""
    return json.dumps({"ok": True, "device": device})


def gpu_name_and_power() -> str:
    """Name and power limit of each card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return "; ".join(line.strip() for line in out.splitlines()
                     if line.strip())


# ---------------------------------------------------------------------------
# parent
# ---------------------------------------------------------------------------

def _spawn(phase: str, work: str):
    """Run one phase in a child process, echoing its output; returns
    (exit code, device dict or None)."""
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--phase", phase,
         "--work", work],
        cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    device = None
    for line in proc.stdout:
        line = line.rstrip("\n")
        if line.startswith("DEVICE "):
            device = json.loads(line[len("DEVICE "):])
        print(f"[{phase}] {line}", flush=True)
    return proc.wait(), device


def check_drift(label: str, ref: dict, got: dict, ref_stats: dict,
                got_stats: dict, bounds: dict, scalar_bounds: dict) -> bool:
    """Print the relative max-norm drift of each field and of each
    conservation scalar of ``got`` (float32) from ``ref`` (float64), each
    beside its bound; True when all are within."""
    import numpy as np
    ok, parts = True, []
    for name, bound in bounds.items():
        a = np.asarray(ref[name], np.float64)
        err = float(np.abs(a - np.asarray(got[name], np.float64)).max())
        rel = err / max(float(np.abs(a).max()), 1e-12)
        ok &= rel < bound
        parts.append(f"{name} {rel:.3e} (<{bound:g})")
    for name, bound in scalar_bounds.items():
        a = ref_stats[name]
        rel = abs(a - got_stats[name]) / max(abs(a), 1e-12)
        ok &= rel < bound
        parts.append(f"{name} {rel:.3e} (<{bound:g})")
    print(f"{label}: " + ", ".join(parts), flush=True)
    return bool(ok)


def _compare_f32_f64(work: str) -> bool:
    import numpy as np
    with open(os.path.join(work, "main_stats.json")) as f:
        stats = json.load(f)
    return check_drift(
        f"f32 vs f64 drift, seamount {MAIN_GRID} after {MAIN_STEPS} steps",
        np.load(os.path.join(work, "main_float64.npz")),
        np.load(os.path.join(work, "main_float32.npz")),
        stats["float64"], stats["float32"], MAIN_BOUNDS, SCALAR_BOUNDS)


def run_parent(four_cards: bool) -> int:
    work = tempfile.mkdtemp(prefix="extpom_smoke_")
    try:
        device = None
        for phase in (("four",) if four_cards else ("f32", "f64")):
            t0 = time.perf_counter()
            rc, dev = _spawn(phase, work)
            print(f"phase {phase}: exit {rc} after "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            if rc != 0:
                return 1
            device = device or dev
        if not four_cards and not _compare_f32_f64(work):
            print("f32 vs f64 drift exceeds its bounds", flush=True)
            return 1
        if device is None or device.get("platform") != "gpu":
            return 1
        print(f"card: {gpu_name_and_power()}", flush=True)
        print(f"device: {device['kind']} x{device['count']}", flush=True)
        print(ok_line(device), flush=True)
        return 0
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------
# children
# ---------------------------------------------------------------------------

class _Tee:
    """stdout wrapper that keeps each complete line with its arrival
    time (perf_counter), so segment times come from run.py's own prints."""

    def __init__(self, stream):
        self.stream, self.lines, self._buf = stream, [], ""

    def write(self, s):
        self.stream.write(s)
        self._buf += s
        *done, self._buf = self._buf.split("\n")
        now = time.perf_counter()
        self.lines.extend((now, line) for line in done)
        return len(s)

    def flush(self):
        self.stream.flush()


class _CompileClock:
    """Sums JAX's tracing, lowering and backend-compile durations while
    the ``with`` block runs."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __enter__(self):
        import jax
        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)
        return self

    def __exit__(self, *exc):
        import jax
        jax.monitoring.unregister_event_duration_listener(self._on)

    def _on(self, event, duration, **kw):
        if event in self.EVENTS:
            self.seconds += duration


def _require(ok, what: str) -> None:
    """A check of the run's outcome that holds under ``python -O`` too."""
    if not ok:
        raise RuntimeError(what)


def _stats_line(line: str) -> dict:
    """The scalars of one of run.py's print lines."""
    toks = line.replace("=", " ").split()
    return {k: float(toks[toks.index(k) + 1])
            for k in ("vtot", "eaver", "taver", "saver")}


def _run_main(conf: dict, work: str, label: str, card: str) -> list:
    """``run.main`` on ``conf``; checks its exit code, prints and files,
    prints compile seconds and the steady rate; returns the print lines
    as (time, stats)."""
    from extpom_tpu import run

    path = os.path.join(work, f"{conf['run_name']}.json")
    with open(path, "w") as f:
        json.dump(conf, f)
    tee = _Tee(sys.stdout)
    sys.stdout = tee
    try:
        with _CompileClock() as clock:
            t_start = time.perf_counter()
            rc = run.main([path])
    finally:
        sys.stdout = tee.stream
    _require(rc == 0, f"{label}: run.main exited {rc}")
    prints = [(t, _stats_line(line)) for t, line in tee.lines
              if line.lstrip().startswith("time =")]
    _require(len(prints) == MAIN_STEPS // MAIN_PRINT,
             f"{label}: {len(prints)} prints")
    for _, s in prints:
        _require(all(map(_finite, s.values())), f"{label}: {s}")
    # segments 1 and 2 compile the first-step and steady variants;
    # the rest are steady
    (t2, _), (tn, _) = prints[1], prints[-1]
    steps = MAIN_PRINT * (len(prints) - 2)
    pts = conf["case_args"]["im"] * conf["case_args"]["jm"] * \
        conf["case_args"]["kb"]
    print(f"{label}: compile {clock.seconds:.1f} s, first two "
          f"segments {t2 - t_start:.1f} s, steady {(tn - t2) / steps * 1e3:.2f}"
          f" ms/step = {pts * steps / (tn - t2) / 1e6:.1f} "
          f"Mgrid-pt-steps/s over {steps} steps [{card}]", flush=True)
    return prints


def _finite(x) -> bool:
    return x == x and abs(x) != float("inf")


def _main_conf(dtype: str, work: str, out_format: str) -> dict:
    days = MAIN_STEPS * DTI / 86400.0
    return {
        "run_name": f"main_{dtype}",
        "case": "seamount",
        "case_args": dict(MAIN_SIZE),
        "config": {"dtype": dtype, "days": days,
                   "prtd1": MAIN_PRINT * DTI / 86400.0, "write_rst": days},
        "out_dir": os.path.join(work, f"out_{dtype}"),
        "out_format": out_format,
    }


def _save_main(conf: dict, work: str) -> None:
    """Read the run's final restart back and keep the fields that are
    compared or that the conservation scalars read."""
    import numpy as np
    from extpom_tpu.cases.seamount import seamount_case
    from extpom_tpu.io import netcdf as ncio
    from extpom_tpu.io import zarrstore as zio

    cfg, _, _ = seamount_case(**conf["case_args"], **conf["config"])
    out, run_name = conf["out_dir"], conf["run_name"]
    names = sorted(os.listdir(out))
    rst = os.path.join(out, f"{run_name}.rst.{MAIN_STEPS:06d}")
    if conf["out_format"] == "nc":
        _require(f"{run_name}.nc" in names, f"no snapshot in {names}")
        st, _, _ = ncio.read_restart_nc(rst + ".nc", cfg)
    else:
        _require(f"{run_name}.{MAIN_PRINT:06d}" in names,
                 f"no snapshot in {names}")
        st, _, _ = zio.read_restart(rst, cfg)
    arrays = {name: np.asarray(getattr(st, name)) for name in STATE_FIELDS}
    for name, a in arrays.items():
        _require(np.isfinite(a).all(), f"non-finite {name} in the restart")
    np.savez(os.path.join(work, f"main_{cfg.dtype}.npz"), **arrays)


def _stats(grid, cfg, fields) -> dict:
    """domain_stats of saved fields, accumulated in float64."""
    import types
    import jax.numpy as jnp
    from extpom_tpu.diag import stats as diag_stats
    st = types.SimpleNamespace(**{k: jnp.asarray(fields[k])
                                  for k in STATE_FIELDS})
    return {k: float(v) for k, v in
            diag_stats.domain_stats(grid, cfg, st).items()}


def _ladder(card: str) -> None:
    """tests/test_tolerance.py's seamount ladder on the card: 33x33x11,
    60 steps, float32 against float64 in one x64 process."""
    from extpom_tpu.cases.seamount import seamount_model
    states, stats = {}, {}
    for dtype in ("float64", "float32"):
        m = seamount_model(im=33, jm=33, kb=11, dtype=dtype)
        m.run_segment(60)
        states[dtype] = {k: getattr(m.state, k) for k in STATE_FIELDS}
        stats[dtype] = _stats(m.grid, m.cfg, states[dtype])
    _require(check_drift(
        f"tolerance ladder 33x33x11, 60 steps, f32 vs f64 [{card}]",
        states["float64"], states["float32"], stats["float64"],
        stats["float32"], LADDER_BOUNDS, SCALAR_BOUNDS),
        "ladder bounds exceeded")


def _phase_f32(work: str, card: str, out_format: str) -> None:
    conf = _main_conf("float32", work, out_format)
    _run_main(conf, work, f"seamount {MAIN_GRID} float32", card)
    _save_main(conf, work)

    # channel: time-varying lateral boundaries staged on the device
    days = MAIN_STEPS * DTI / 86400.0
    conf = {"run_name": "channel", "case": "channel",
            "case_args": dict(MAIN_SIZE),
            "config": {"dtype": "float32", "days": days,
                       "prtd1": MAIN_PRINT * DTI / 86400.0,
                       "write_rst": days},
            "out_dir": os.path.join(work, "out_channel"),
            "out_format": out_format}
    prints = _run_main(conf, work, f"channel {MAIN_GRID} float32", card)
    s0, s1 = prints[0][1], prints[-1][1]
    dsal = abs(s1["saver"] - s0["saver"]) / abs(s0["saver"])
    dvol = abs(s1["vtot"] - s0["vtot"]) / s0["vtot"]
    # salt: uniform S with inflow of the same S; volume: the west-end tide
    # (amplitude 0.5 m over 100 m depth) can change it by at most 5e-3
    print(f"channel: saver change {dsal:.3e} (<1e-5), vtot change "
          f"{dvol:.3e} (<5e-3) between the first and last print",
          flush=True)
    _require(dsal < 1e-5 and dvol < 5e-3, f"channel: {s0} -> {s1}")


def _phase_f64(work: str, card: str, out_format: str) -> None:
    import numpy as np
    from extpom_tpu.cases.seamount import seamount_model

    g = np.load(os.path.join(HERE, "tests", "golden",
                             "seamount_33x33x11_10steps.npz"))
    im, jm, kb, n = (int(x) for x in g["meta"])
    m = seamount_model(im=im, jm=jm, kb=kb, dtype="float64", donate=False)
    m.run(n_steps=n)
    worst = 0.0
    for name in ("el", "u", "v", "t", "s", "q2", "q2l"):
        ref = g[name]
        tol = 1e-9 * max(1.0, float(np.abs(ref).max()))
        err = float(np.abs(np.asarray(getattr(m.state, name)) - ref).max())
        _require(err <= tol, f"golden {name}: {err:.3e} > {tol:.3e}")
        worst = max(worst, err / tol)
    print(f"golden {im}x{jm}x{kb} float64, {n} steps: worst error "
          f"{worst:.3e} of the 1e-9 x max|field| bound [{card}]", flush=True)

    _ladder(card)

    conf = _main_conf("float64", work, out_format)
    _run_main(conf, work, f"seamount {MAIN_GRID} float64", card)
    _save_main(conf, work)
    # conservation scalars of both runs, each on its own run's grid,
    # accumulated in float64 as the tolerance test does
    from extpom_tpu.cases.seamount import seamount_case
    stats = {}
    for dtype in ("float64", "float32"):
        cfg, grid, _ = seamount_case(**conf["case_args"],
                                     **dict(conf["config"], dtype=dtype))
        stats[dtype] = _stats(grid, cfg, np.load(
            os.path.join(work, f"main_{dtype}.npz")))
    with open(os.path.join(work, "main_stats.json"), "w") as f:
        json.dump(stats, f)


def _phase_four(work: str, card: str) -> None:
    """One process, four cards: config 5's whole domain on one card, then
    over a 2x2 shard_map mesh through run.py's mesh block, compared field
    by field; a 2x2 GSPMD mesh must be refused.  Runs through
    ``run.build_model`` and ``Model.run_segment``, the calls ``run.main``
    makes, without its snapshot and restart writes (9 GB per state at
    this size)."""
    import gc
    import jax
    import numpy as np
    from extpom_tpu import run
    from extpom_tpu.core import stepper

    with open(FOUR_CONF) as f:
        c5 = json.load(f)
    grid = "{im}x{jm}x{kb}".format(**c5["case_args"])

    def conf(mesh):
        c = {"case": c5["case"], "case_args": c5["case_args"],
             "config": c5["config"]}
        if mesh:
            c["mesh"] = {"px": 2, "py": 2, "mode": mesh}
        return c

    def timed(m, label):
        with _CompileClock() as clock:
            t0 = time.perf_counter()
            m.run_segment(FOUR_STEPS)
            jax.block_until_ready(m.state)
            wall = time.perf_counter() - t0
        peak = max((d.memory_stats() or {}).get("peak_bytes_in_use", 0)
                   for d in jax.local_devices())
        print(f"{label}: {FOUR_STEPS} steps in {wall:.1f} s including "
              f"{clock.seconds:.1f} s compile; peak {peak / 2**30:.2f} GiB "
              f"per card [{card}]", flush=True)
        out = {name: np.asarray(getattr(m.state, name)) for name in FIELDS}
        for name, a in out.items():
            _require(np.isfinite(a).all(), f"{label}: non-finite {name}")
        return out

    m = run.build_model(conf(None))
    run_fn = stepper.make_run_fn(m.cfg, m.period, donate=False)
    mem = run_fn.lower(m.grid, m.state, m.base_forcing, m.rmean, m.tclim,
                       m.sclim, 0, FOUR_STEPS, first=True,
                       plan=None).compile().memory_analysis()
    print(f"one card, {grid} float32 segment: memory_analysis "
          f"arguments {mem.argument_size_in_bytes / 2**30:.2f} GiB, "
          f"outputs {mem.output_size_in_bytes / 2**30:.2f} GiB, "
          f"temporaries {mem.temp_size_in_bytes / 2**30:.2f} GiB", flush=True)
    ref = timed(m, "one card")
    del m, run_fn
    gc.collect()

    m = run.build_model(conf("shardmap"))
    got = timed(m, "2x2 shardmap")
    del m
    gc.collect()
    rel = {name: float(np.abs(got[name] - ref[name]).max())
           / max(1.0, float(np.abs(ref[name]).max())) for name in FIELDS}
    print(f"2x2 shardmap vs one card (bound {MESH_TOL:g} x max|field|): "
          + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()), flush=True)
    _require(max(rel.values()) <= MESH_TOL, "shardmap vs one card")

    try:
        run.build_model(conf("gspmd"))
    except NotImplementedError as e:
        print(f"2x2 gspmd: refused ({e})", flush=True)
    else:
        raise RuntimeError("2x2 gspmd was not refused on GPUs")


def run_child(phase: str, work: str) -> int:
    import jax
    if phase == "f64":
        jax.config.update("jax_enable_x64", True)
    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX found {dev.platform}", flush=True)
        return 3
    need = 4 if phase == "four" else 1
    if len(devices) < need:
        print(f"phase {phase} needs {need} cards, found {len(devices)}")
        return 3
    print("DEVICE " + json.dumps({"platform": dev.platform,
                                  "kind": dev.device_kind,
                                  "count": len(devices)}), flush=True)
    card = gpu_name_and_power()

    from extpom_tpu.utils.cache import enable_compile_cache
    print(f"compile cache: {enable_compile_cache()}", flush=True)
    try:
        import tensorstore  # noqa: F401
        have_ts = True
    except ImportError:
        have_ts = False
    out_format = "zarr" if have_ts else "nc"
    print(f"tensorstore: {'available' if have_ts else 'missing'}; "
          f"snapshots and restarts as {out_format}", flush=True)

    if phase == "f32":
        _phase_f32(work, card, out_format)
    elif phase == "f64":
        _phase_f64(work, card, out_format)
    else:
        _phase_four(work, card)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 2048x2048x41 mesh comparison on "
                         "four cards")
    ap.add_argument("--phase", choices=("f32", "f64", "four"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--work", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.phase:
        return run_child(args.phase, args.work)
    return run_parent(args.four_cards)


if __name__ == "__main__":
    sys.exit(main())
