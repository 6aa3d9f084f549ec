"""GPU bring-up guards that run on the CPU: no Pallas import on the GPU
dispatch path, the compile-cache rule, and the smoke test's refusal to
run without a GPU."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "wavelets_tpu")


def test_no_pallas_import_with_gpu_platform():
    """With JAX told the platform is the GPU, importing every module of
    the package and tracing the main paths imports no Pallas."""
    code = """
import importlib, pkgutil, sys
import jax
jax.default_backend = lambda: "gpu"
import jax.numpy as jnp
import wavelets_tpu
for m in pkgutil.walk_packages(wavelets_tpu.__path__, "wavelets_tpu."):
    if not m.name.endswith("__main__"):
        importlib.import_module(m.name)
import wavelets_tpu as wt
x = jax.ShapeDtypeStruct((64, 64), jnp.float32)
jax.eval_shape(lambda v: wt.wow(v, denoise_coefficients=[5, 2])[0], x)
jax.eval_shape(lambda v: wt.wow(v, bilateral=1)[0], x)
jax.eval_shape(lambda v: wt.denoise(v, [3, 3]), x)
jax.eval_shape(lambda v: wt.wow_stack(v, with_coefficients=False)[0],
               jax.ShapeDtypeStruct((2, 64, 64), jnp.float32))
bad = sorted(m for m in sys.modules if "pallas" in m)
assert not bad, bad
print("NO-PALLAS-OK")
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "NO-PALLAS-OK" in out.stdout


@pytest.mark.parametrize("needle", [
    "jax.experimental.pallas", "interpret=", "use_pallas", "allow_cpu",
    'default_backend() == "cpu"'])
def test_no_kernel_gates_in_package(needle):
    """No Pallas import, interpret flag, kernel option or CPU kernel gate
    is left anywhere in the package source."""
    hits = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path, encoding="utf-8") as fh:
                    if needle in fh.read():
                        hits.append(os.path.relpath(path, REPO))
    assert not hits, hits


def _enable_cache(monkeypatch):
    """``enable_compile_cache()`` with JAX's config update recorded
    instead of applied."""
    from wavelets_tpu.utils import compile_cache

    calls = []
    monkeypatch.setattr(compile_cache.jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    return compile_cache.enable_compile_cache(), calls


def test_compile_cache_dir_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    path, calls = _enable_cache(monkeypatch)
    assert path == str(tmp_path)
    assert calls == [("jax_compilation_cache_dir", str(tmp_path))]


def test_compile_cache_dir_default_inside_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path, calls = _enable_cache(monkeypatch)
    assert path == os.path.join(REPO, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
    # fixed: the same on every call, and ignored by git
    assert _enable_cache(monkeypatch)[0] == path
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_chip_smoke_device_check_fails_on_cpu(monkeypatch, capsys):
    """The script's own device check refuses the CPU before any phase
    runs and prints no result."""
    from wavelets_tpu.utils import device

    monkeypatch.setattr(device, "gpu_name_and_power_limit",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.main([])
    assert '"ok": true' not in capsys.readouterr().out


def test_require_gpu_fails_on_cpu():
    from wavelets_tpu.utils.device import require_gpu

    with pytest.raises(RuntimeError, match="no GPU"):
        require_gpu()


def _assert_refused(out):
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    _assert_refused(out)


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    """Copied into a directory with nothing else of the repository, the
    script fails and prints no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    _assert_refused(out)


def test_bench_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "bench.py"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no GPU" in out.stderr
