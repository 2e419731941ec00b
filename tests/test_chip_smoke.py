"""CPU checks of the GPU smoke script (chip_smoke.py) and of the compile
cache location it and the run driver use (extpom_tpu/utils/cache.py).
The phases themselves need a GPU; here: the refusal without one, the
result line, and the parsing and comparison the parent does."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

from extpom_tpu.utils import cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "chip_smoke.py")


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_no_gpu_exits_nonzero_without_result():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, SCRIPT], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
    assert "no GPU: JAX found cpu" in p.stdout


def test_result_line_format():
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    line = _smoke().ok_line(dev)
    assert line == ('{"ok": true, "device": {"platform": "gpu", "kind": '
                    '"NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line) == {"ok": True, "device": dev}


def test_compile_cache_dir(monkeypatch):
    import jax
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    before = jax.config.jax_compilation_cache_dir
    assert cache.enable_compile_cache() == "/elsewhere/cache"
    assert jax.config.jax_compilation_cache_dir == before   # nothing set

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    try:
        path = cache.enable_compile_cache()
        assert path == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_stats_line_parses_run_print():
    line = ("time =    0.0417  iint =       20  vtot = 1.3200546e+12  "
            "eaver = 4.1271877e-03  taver = 2.1393075e+00  "
            "saver = 1.5000000e+01")
    assert _smoke()._stats_line(line) == {
        "vtot": 1.3200546e+12, "eaver": 4.1271877e-03,
        "taver": 2.1393075e+00, "saver": 15.0}


def test_f32_f64_comparison_holds_the_bounds(tmp_path, capsys):
    mod = _smoke()
    rng = np.random.default_rng(0)
    ref = {name: rng.standard_normal((3, 8, 8)) for name in mod.FIELDS}
    stats = {k: 10.0 + i for i, k in enumerate(mod.SCALAR_BOUNDS)}
    with open(tmp_path / "main_stats.json", "w") as f:
        json.dump({"float64": stats, "float32": stats}, f)
    np.savez(tmp_path / "main_float64.npz", **ref)
    close = {k: (v * (1 + 1e-7)).astype(np.float32) for k, v in ref.items()}
    np.savez(tmp_path / "main_float32.npz", **close)
    assert mod._compare_f32_f64(str(tmp_path))
    assert "el " in capsys.readouterr().out

    far = dict(close, t=(ref["t"] * 1.01).astype(np.float32))
    np.savez(tmp_path / "main_float32.npz", **far)
    assert not mod._compare_f32_f64(str(tmp_path))

    with open(tmp_path / "main_stats.json", "w") as f:
        json.dump({"float64": stats,
                   "float32": dict(stats, saver=stats["saver"] * 1.001)}, f)
    np.savez(tmp_path / "main_float32.npz", **close)
    assert not mod._compare_f32_f64(str(tmp_path))
