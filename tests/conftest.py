"""Test config: the CPU platform with 8 virtual devices by default, so tests
are hermetic and multi-device sharding tests run anywhere (SURVEY.md §4
(e)). Tests marked ``gpu`` need the card: run them there with
``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu``.
"""

import os
import resource

# XLA's compiler recurses deeply on large scan programs; lift the 8 MB
# default stack so a long suite process can't hit the guard page mid-pass
try:
    _soft, _hard = resource.getrlimit(resource.RLIMIT_STACK)
    resource.setrlimit(resource.RLIMIT_STACK, (_hard, _hard))
except (ValueError, OSError):  # pragma: no cover - restricted env
    pass

os.environ.setdefault("JAX_PLATFORMS", "cpu")
xla_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

_CACHE_DIR = os.environ.get("ECFFT_TEST_COMPILE_CACHE")
if _CACHE_DIR:
    # zstandard.backend_c segfaults on JAX persistent-cache entries in
    # long-lived processes; block it so the cache uses zlib (same guard
    # as bench.py)
    import sys

    sys.modules["zstandard"] = None

import jax  # noqa: E402
import pytest  # noqa: E402

if _CACHE_DIR:
    # cross-run compile reuse for the sharded runner: each shard process
    # is SHORT, so XLA:CPU's long-process serialize() segfault (see the
    # note at the bottom of this file) stays out of reach; a monolithic
    # `pytest tests/` run does not set this
    jax.config.update("jax_compilation_cache_dir", _CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU. Decided when the test
    runs, never at import: every xdist worker must collect the same
    tests."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda on "
                    "the card)")
    return jax.devices()[0]


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """XLA:CPU's compiler segfaults late in a long full-suite process
    (observed repeatedly at ~150 accumulated compiled programs; the same
    tests pass in isolation). Dropping compiled executables between
    modules keeps the process under that threshold; modules recompile
    what they share (~minutes of extra wall time, deterministic green).

    ``run_tests.py`` instead shards the suite into a few SHORT pytest
    processes, each safely under the threshold, so modules in the same
    shard can share compiled programs — that runner sets
    ECFFT_SUITE_SHARD=1 to skip this fixture (the recompiles it avoids
    are the bulk of the monolithic suite's wall time)."""
    yield
    if not os.environ.get("ECFFT_SUITE_SHARD"):
        jax.clear_caches()
# NO persistent compilation cache in the suite: XLA:CPU's
# executable.serialize() segfaults deterministically partway through a
# long full-suite process (jax compilation_cache.py:265, observed twice
# at the same test; the same test passes in isolation), and cache
# entries compiled on a different machine type trigger an explicit
# SIGILL warning from cpu_aot_loader. In-process jit caching still
# applies; only cross-run reuse is lost (~2 extra minutes cold).
