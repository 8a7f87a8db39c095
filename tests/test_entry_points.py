"""The runnable entry points' host-side contracts: the compile-cache
location and chip_smoke.py's refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys

from ecfft_tpu.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)


def test_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.cache_dir() == os.path.join(ROOT, ".jax_cache")


def test_enable_compile_cache_sets_no_dir_when_env_set(monkeypatch,
                                                       tmp_path):
    """With the variable set, the helper leaves JAX's own reading of it
    alone and configures no directory of its own."""
    import jax

    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert all(k != "jax_compilation_cache_dir" for k, _ in calls)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    compile_cache.enable_compile_cache()
    assert ("jax_compilation_cache_dir",
            os.path.join(ROOT, ".jax_cache")) in calls


def _smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu():
    """No GPU: exit non-zero, print no result line, run nothing."""
    res = _smoke(ROOT, "chip_smoke.py")
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "no GPU" in res.stderr


def test_chip_smoke_needs_the_repo(tmp_path):
    """Copied into a directory without the package, the script fails at
    the package import, even past a device check that found a GPU."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    code = ("import sys, types, chip_smoke\n"
            "chip_smoke.device_check = lambda: types.SimpleNamespace(\n"
            "    platform='gpu', device_kind='stand-in')\n"
            "sys.argv = ['chip_smoke.py']\n"
            "chip_smoke.main()\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "No module named 'ecfft_tpu'" in res.stderr
