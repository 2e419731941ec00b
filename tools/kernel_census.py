"""Per-kernel and per-layer census of a model segment from a device trace.

Runs a scanned seamount segment on the GPU under ``jax.profiler.trace``,
reads the xplane with ``jax.profiler.ProfileData`` and reports, over the
device's kernel events:

* launches per step, device busy time per step, and the idle share of the
  traced window (1 - union of kernel intervals / window) with its largest
  gaps;
* device time per layer, from the ``jax.named_scope`` names the step
  carries (core/stepper.py, ops/vertical.py): each kernel's HLO op is
  mapped to its ``op_name`` metadata in the compiled module;
* the top kernels by time.

Usage: python tools/kernel_census.py [--size 512] [--kb 31] [--steps 4]
                                     [--mode2] [--top 25] [--out DIR]
"""

import argparse
import collections
import glob
import gzip
import json
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# innermost first: a Thomas solve inside a phase counts as the solve
LAYERS = ("thomas_solve", "forcing_interp", "external_mode",
          "lateral_terms", "mode_interaction", "phase_uvw", "phase_tke",
          "phase_tracer", "phase_mom")


def layer_of(op_name: str) -> str:
    for layer in LAYERS:
        if f"/{layer}/" in f"/{op_name}/":
            return layer
    return "other"


def op_names(hlo_text: str) -> dict:
    """HLO instruction name -> op_name metadata, from compiled HLO text
    (keys also in the kernel-name form, '.' and '-' as '_')."""
    out = {}
    pat = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?'
                     r'metadata=\{[^}]*op_name="([^"]*)"')
    for line in hlo_text.splitlines():
        m = pat.match(line)
        if m:
            name, op = m.groups()
            out[name] = op
            out[re.sub(r"[.\-]", "_", name)] = op
    return out


def run_traced(im, jm, kb, steps, trace_dir, mode2=False):
    """Compile one steady segment of ``steps`` steps, warm it, trace one
    call; returns (trace_dir, compiled HLO text, host seconds of the
    traced call)."""
    import jax
    import jax.numpy as jnp
    from extpom_tpu.cases.seamount import seamount_model
    from extpom_tpu.core import stepper

    kw = dict(mode=2, lramp=False) if mode2 else {}
    m = seamount_model(im=im, jm=jm, kb=kb, dtype="float32", **kw)
    run = stepper.make_run_fn(m.cfg, m.period, donate=False)
    compiled = run.lower(m.grid, m.state, m.base_forcing, m.rmean, m.tclim,
                         m.sclim, 0, steps, first=False, plan=None).compile()
    args = (m.grid, m.state, m.base_forcing, m.rmean, m.tclim, m.sclim)
    st = compiled(*args, jnp.asarray(0), plan=None)
    jax.block_until_ready(st)
    os.makedirs(trace_dir, exist_ok=True)
    with jax.profiler.trace(trace_dir):
        t0 = time.perf_counter()
        st = compiled(m.grid, st, *args[2:], jnp.asarray(steps), plan=None)
        jax.block_until_ready(st)
        host_s = time.perf_counter() - t0
    return trace_dir, compiled.as_text(), host_s


def device_events(trace_dir):
    """Kernel events of every GPU device plane: [(name, start_ns,
    duration_ns, stats dict)]."""
    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(
        trace_dir, "**", "*.xplane.pb"), recursive=True))
    if not paths:
        raise FileNotFoundError(f"no xplane.pb under {trace_dir}")
    data = ProfileData.from_file(paths[-1])
    events, layout = [], []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            layout.append(f"{plane.name} | {line.name}")
            # stream lines carry the kernels; the derived "XLA Ops" /
            # "XLA Modules" lines repeat them at op and module level
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                if ev.duration_ns > 0:
                    events.append((ev.name, ev.start_ns, ev.duration_ns,
                                   {k: v for k, v in ev.stats}))
    if not events:
        raise RuntimeError("no GPU kernel events in the trace; planes and "
                           "lines: " + "; ".join(layout))
    return events, layout


def busy_and_gaps(events):
    """Union of kernel intervals: (busy ns, window ns, sorted gaps ns)."""
    iv = sorted((s, s + d) for _, s, d, _ in events)
    busy, gaps = 0, []
    cur_s, cur_e = iv[0]
    for s, e in iv[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append(s - cur_e)
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy, cur_e - iv[0][0], sorted(gaps)


def census(events, hlo_ops, steps):
    """Aggregate kernel events into per-kernel and per-layer tables."""
    kern = collections.defaultdict(lambda: [0, 0])
    layer = collections.defaultdict(lambda: [0, 0])
    for name, _, dur, stats in events:
        op = None
        for key in ("hlo_op", "tf_op", "long_name"):
            v = stats.get(key)
            if isinstance(v, str) and v:
                op = hlo_ops.get(v, v if "/" in v else None)
                if op:
                    break
        if op is None:
            op = hlo_ops.get(name, "")
        kern[name][0] += 1
        kern[name][1] += dur
        layer[layer_of(op)][0] += 1
        layer[layer_of(op)][1] += dur
    busy, window, gaps = busy_and_gaps(events)
    n = sum(v[0] for v in kern.values())
    return {
        "steps": steps,
        "launches_per_step": n / steps,
        "kernel_ms_per_step": sum(v[1] for v in kern.values()) / 1e6 / steps,
        "busy_ms_per_step": busy / 1e6 / steps,
        "window_ms": window / 1e6,
        "idle_share": 1.0 - busy / window,
        "gaps_over_10us": sum(1 for g in gaps if g > 10_000),
        "gap_ms_total": sum(gaps) / 1e6,
        "gap_us_median": gaps[len(gaps) // 2] / 1e3 if gaps else 0.0,
        "gap_us_top5": [g / 1e3 for g in gaps[-5:]],
        "layers_ms_per_step": {k: v[1] / 1e6 / steps for k, v in
                               sorted(layer.items(), key=lambda kv: -kv[1][1])},
        "layers_launches_per_step": {k: v[0] / steps for k, v in
                                     layer.items()},
        "top_kernels": [(k, v[0], v[1] / 1e6) for k, v in
                        sorted(kern.items(), key=lambda kv: -kv[1][1])],
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--kb", type=int, default=31)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--mode2", action="store_true")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--out", default=os.path.join("out", "census"),
                    help="directory for the trace and the JSON summary")
    args = ap.parse_args()

    import jax
    from extpom_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {dev.platform}")

    trace_dir = os.path.join(args.out, "trace")
    _, hlo, host_s = run_traced(args.size, args.size, args.kb, args.steps,
                                trace_dir, mode2=args.mode2)
    with gzip.open(os.path.join(args.out, "hlo.txt.gz"), "wt") as f:
        f.write(hlo)
    events, layout = device_events(trace_dir)
    sample = [(n, {k: str(v)[:160] for k, v in st.items()})
              for n, _, _, st in events[:8]]
    res = census(events, op_names(hlo), args.steps)
    res.update(device=f"{dev.device_kind} x{len(jax.devices())}",
               grid=f"{args.size}x{args.size}x{args.kb}",
               mode=2 if args.mode2 else 3,
               host_ms_per_step=host_s * 1e3 / args.steps,
               lines=layout, sample_events=sample)
    top = res.pop("top_kernels")
    res["top_kernels"] = top[:args.top]
    with open(os.path.join(args.out, "census.json"), "w") as f:
        json.dump(res, f, indent=1)

    print(f"{res['grid']} mode {res['mode']} on {res['device']}: "
          f"{res['launches_per_step']:.0f} launches/step, kernels "
          f"{res['kernel_ms_per_step']:.3f} ms/step, busy "
          f"{res['busy_ms_per_step']:.3f} ms/step, host "
          f"{res['host_ms_per_step']:.3f} ms/step, idle share "
          f"{res['idle_share']:.3f} ({res['gaps_over_10us']} gaps > 10 us, "
          f"median gap {res['gap_us_median']:.1f} us)")
    print("| layer | ms/step | launches/step |")
    print("|---|---|---|")
    for k, ms in res["layers_ms_per_step"].items():
        print(f"| {k} | {ms:.3f} | "
              f"{res['layers_launches_per_step'][k]:.0f} |")
    print("| kernel | n | total ms |")
    print("|---|---|---|")
    for name, n, ms in res["top_kernels"]:
        print(f"| {name[:72]} | {n} | {ms:.3f} |")


if __name__ == "__main__":
    main()
