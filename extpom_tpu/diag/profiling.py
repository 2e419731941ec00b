"""Tracing and phase timing.

The reference's only instrumentation is a master-rank wall-clock print
(pom.f:10-33).  Here:

* :class:`PhaseTimer` — per-phase wall timers with device synchronization
  (block_until_ready) so compute/comm phases are attributed correctly.
* :func:`trace` — context manager around ``jax.profiler`` producing xplane
  dumps (for verifying collective/compute overlap in sharded runs).
* :func:`step_breakdown` — times the external-only (mode=2) and full
  step variants to split external/internal mode cost.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional

import jax


class PhaseTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                jax.block_until_ready(sync)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        total = sum(self.totals.values()) or 1.0
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:24s} {t:9.3f} s  {t/n*1e3:9.2f} ms/call "
                         f"x{n:<6d} {100*t/total:5.1f} %")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str = "/tmp/extpom_trace"):
    """jax.profiler trace context; view with xprof/tensorboard."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def step_breakdown(im: int = 128, jm: Optional[int] = None, kb: int = 21,
                   n: int = 20, **case_kw) -> Dict[str, float]:
    """Split a seamount step into external-mode and internal-mode cost by
    timing the mode=2 variant against the full mode=3 step."""
    from extpom_tpu.cases.seamount import seamount_model

    jm = im if jm is None else jm
    out = {}
    for label, mode in (("full_step", 3), ("external_only", 2)):
        m = seamount_model(im=im, jm=jm, kb=kb, mode=mode, donate=False,
                           **case_kw)
        m.step_once(); m.step_once()
        jax.block_until_ready(m.state.el)
        t0 = time.perf_counter()
        for _ in range(n):
            m.step_once()
        jax.block_until_ready(m.state.el)
        out[label] = (time.perf_counter() - t0) / n
    out["internal_est"] = out["full_step"] - out["external_only"]
    return out
