"""Runtime plumbing: the compile cache, the benchmark's device table, and
`chip_smoke.py` — its refusal to run without a GPU, and a rehearsal of
every phase at a tiny size on the CPU."""
import importlib.util
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).parent.parent


def _load(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cache_dir_seen(env):
    r = subprocess.run(
        [sys.executable, "-c", "import spasm_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr
    return r.stdout.strip().splitlines()[-1]


def test_compile_cache_honours_env(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cc"))
    assert _cache_dir_seen(env) == str(tmp_path / "cc")


def test_compile_cache_defaults_to_checkout():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    assert _cache_dir_seen(env) == str(ROOT / ".jax_cache")
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()


def test_bench_peaks_by_device_kind():
    bench = _load("bench")
    assert bench.peaks("NVIDIA H100 80GB HBM3")["int8_tops"] == 1979.0
    with pytest.raises(KeyError):
        bench.peaks("cpu")


def test_chip_smoke_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       capture_output=True, text=True, env=env,
                       timeout=600)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok"' not in r.stdout


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_phases_rehearsed_on_cpu(tmp_path, monkeypatch):
    """Phases a-f at the test-only tiny size: control flow, spies and the
    host references, with every check as on the card."""
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    cs = _load("chip_smoke")
    sz = cs.SIZES["tiny"]
    store = {}
    lines = {}
    for name, thunk in [
            ("a", lambda: cs.phase_a(sz, str(tmp_path))),
            ("b", lambda: cs.phase_b(sz, str(tmp_path))),
            ("c", lambda: cs.phase_c(sz, store, None, str(tmp_path))),
            ("d", lambda: cs.phase_d(sz)),
            ("e", lambda: cs.phase_e(sz)),
            ("f", lambda: cs.phase_f(sz, store))]:
        lines[name], _ = thunk()
    assert "filters_backend_free=yes" in lines["a"]
    assert lines["b"].count("exact=") == len(cs.MATMUL_PRIMES)
    assert "finisher=finish_device_dense" in lines["c"]
    assert "device_finisher=ran" in lines["e"]
    assert "R.x==host" in lines["f"]


def test_chip_smoke_mesh_phase_rehearsed_on_cpu():
    import jax
    cs = _load("chip_smoke")
    line, _ = cs.phase_g(cs.SIZES["tiny"], jax.devices()[:4])
    assert "sharded_devices=4" in line


@pytest.mark.gpu
def test_modp_matmul_exact_on_gpu(gpu_device):
    import jax
    from spasm_tpu.dense import reference as ref
    from spasm_tpu.dense.modp import modp_matmul
    rng = np.random.default_rng(0)
    for p in (42013, 4294967291):
        A = rng.integers(-(p // 2), p // 2 + 1, (512, 512)).astype(np.int32)
        B = rng.integers(-(p // 2), p // 2 + 1, (512, 512)).astype(np.int32)
        with jax.default_device(gpu_device):
            C = np.asarray(modp_matmul(A, B, p))
        assert np.array_equal(C.astype(np.int64), ref.matmul_modp(A, B, p))
