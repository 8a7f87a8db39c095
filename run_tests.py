#!/usr/bin/env python
"""Full-suite runner: shards tests/ into a few SHORT pytest processes.

Why not one ``pytest tests/`` process: XLA:CPU's compiler segfaults late
in a long process (~150 accumulated compiled programs — see
tests/conftest.py), so the monolithic suite must drop compiled caches
between modules and recompile everything each module (slow). Sharding
into separate processes keeps every process safely under the threshold
while letting modules in the same shard SHARE compiled programs
(ECFFT_SUITE_SHARD=1 skips the per-module cache clear).

Shards are grouped so that modules that compile the same device
programs (same field/size schedules) land together.

Usage:  python run_tests.py [extra pytest args...]
Exit code: 0 iff every shard passed. Prints a per-shard timing summary.
"""

import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Grouped so shared compilations amortize within a shard and no shard
# accumulates enough compiled programs to trip the XLA:CPU segfault.
SHARDS = [
    # pure-host math: no jit at all (poly/EC/Schoof/serde/fixtures)
    ("host", [
        "test_poly.py", "test_ec.py", "test_ec_binary.py",
        "test_host_fftree.py", "test_fftree_binary.py",
        "test_find_curve_schoof.py", "test_serialize.py",
        "test_ark_fixture.py", "test_native.py",
    ]),
    # small-field device paths: field kernels, step kernel, NTT, registry
    ("device-small", [
        "test_device_field.py", "test_pallas_step.py", "test_ntt.py",
        "test_custom_fields.py",
    ]),
    # schedule machine over m31 + device trees
    ("device-tree", [
        "test_device_fftree.py", "test_sched_chunk.py",
    ]),
    # multi-limb secp schedules + multichip mesh
    ("device-secp", [
        "test_scheduled_secp.py", "test_parallel.py",
    ]),
]


def main() -> int:
    extra = sys.argv[1:]
    env = dict(os.environ, ECFFT_SUITE_SHARD="1")
    # cross-run compile reuse (safe in short shard processes; see
    # tests/conftest.py). ECFFT_TEST_COMPILE_CACHE= (empty) disables.
    env.setdefault("ECFFT_TEST_COMPILE_CACHE",
                   os.path.join(HERE, ".jax_cache_tests"))
    results = []
    t_all = time.time()
    for name, modules in SHARDS:
        paths = [os.path.join(HERE, "tests", m) for m in modules]
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", *extra, *paths],
            env=env, cwd=HERE)
        dt = time.time() - t0
        results.append((name, proc.returncode, dt))
        print(f"[shard {name}] rc={proc.returncode} in {dt:.1f}s",
              flush=True)
    total = time.time() - t_all
    print("\n=== suite summary ===")
    for name, rc, dt in results:
        print(f"  {name:14s} {'PASS' if rc == 0 else 'FAIL':4s} {dt:7.1f}s")
    print(f"  {'total':14s} {'':4s} {total:7.1f}s")
    return 0 if all(rc == 0 for _, rc, _ in results) else 1


if __name__ == "__main__":
    sys.exit(main())
