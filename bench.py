"""Benchmark: seamount 3-D core throughput on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "device"}.  The metric
is grid-point-steps per second on the full mode-split 3-D step through the
scanned segments of ``Model.run_segment`` (BASELINE.json primary metric),
after both segment variants have compiled.  Exits non-zero when JAX finds
no GPU.
"""

import json
import sys
import time

import jax

from extpom_tpu.utils.cache import enable_compile_cache


def measure(im=256, jm=256, kb=31, n=200) -> float:
    from extpom_tpu.cases.seamount import seamount_model

    m = seamount_model(im=im, jm=jm, kb=kb)
    # one segment size, so only two variants compile (first / steady)
    m.run_segment(n)              # compiles the first-step variant
    jax.block_until_ready(m.state.el)
    m.run_segment(n)              # compiles + warms the steady variant
    jax.block_until_ready(m.state.el)

    t0 = time.perf_counter()
    m.run_segment(n)
    jax.block_until_ready(m.state.el)
    return im * jm * kb * n / (time.perf_counter() - t0)


def main():
    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX found {dev.platform}", file=sys.stderr)
        return 1
    print(json.dumps({
        "metric": "seamount3d_grid_points_per_s_per_chip",
        "value": measure(),
        "unit": "grid-point-steps/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
