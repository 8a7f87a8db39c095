#!/usr/bin/env python
"""ecfft-tpu benchmark: batched ENTER throughput on one GPU.

Prints exactly ONE JSON line:
  {"metric": ..., "value": N, "unit": "polys/sec", "vs_baseline": N,
   "device": {"platform", "kind", "count", "card"}, ...}

Workload (BASELINE.md target, env-overridable):
  field=secp256k1, n=2^16, batch=256 — batched coefficient->evaluation
  transform (the reference's `enter`, benches/fftree.rs:28-31 scaled up).
  It exits non-zero when JAX's first device is not a GPU.

vs_baseline compares against a MEASURED single-core run of the same
workload on the native C++ engine (native/ecfft_native.cpp — arkworks-
class 4×64 Montgomery arithmetic, the same backend family as the Rust
reference, which itself publishes no numbers; see BASELINE.md). The
native baseline is re-measured on EVERY invocation (best-of-3) so the
ratio is self-contained: rounds 2–4 each compared against a baseline
cached on a differently-loaded machine, and the same device throughput
read three different ratios depending on which cache survived. The
raw per-poly seconds for both sides are included in the JSON.

Tree construction runs through the native builder and is cached as an
.npz next to this file (first run builds; later runs load) so the
measured region is the transform itself.
"""

import json
import os
import subprocess
import sys
import time

# zstandard.backend_c segfaults on JAX persistent-cache entries in
# long-lived processes; block it so the cache uses zlib (must match
# tests/conftest.py so every process reads/writes the same format)
sys.modules["zstandard"] = None


def log(*a):
    print(*a, file=sys.stderr)


FIELD = os.environ.get("ECFFT_BENCH_FIELD", "secp256k1")
# default = the BASELINE.md north-star config: ENTER n=2^16, batch 256
N = int(os.environ.get("ECFFT_BENCH_N", str(1 << 16)))
BATCH = int(os.environ.get("ECFFT_BENCH_BATCH", "256"))
REPS = int(os.environ.get("ECFFT_BENCH_REPS", "5"))


def main():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench: no GPU (JAX's first device is {dev.platform}); "
                 "nothing was measured")
    import numpy as np

    import ecfft_tpu as ec
    from ecfft_tpu.serialize_native import load_tables_npz, save_tables_npz
    from ecfft_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"bench: field={FIELD} n={N} batch={BATCH} on {dev} ({card})")

    here = os.path.dirname(os.path.abspath(__file__))
    cache = os.path.join(here, f".bench_tree_{FIELD}_{N}.npz")
    if os.path.exists(cache):
        log("loading cached tree", cache)
        with jax.default_device(jax.devices("cpu")[0]):
            tree = load_tables_npz(cache)
    else:
        from ecfft_tpu.native import build_fftree_native

        log("building tree via native engine (one-time)...")
        t0 = time.time()
        cpu = jax.devices("cpu")[0]
        with jax.default_device(cpu):
            tree = build_fftree_native(FIELD, N)
        log(f"tree built in {time.time()-t0:.1f}s")
        save_tables_npz(tree, cache)

    # measure the single-core native baseline on the same workload, on
    # EVERY run: 3 reps, best-of. A cached single rep is at the mercy of
    # machine load at cache-build time — round 3 cached a 4.43 s rep
    # where an unloaded core does ~1.1-1.5 s, silently inflating
    # vs_baseline 3x, and rounds 2/4 disagreed the other way. Best-of-3
    # measured in the SAME run is the only self-contained protocol.
    from ecfft_tpu.native import NativeFFTree

    log("measuring native single-core ENTER baseline (3 reps)...")
    import random as _r

    nt = NativeFFTree(FIELD, N)
    rng_ = _r.Random(1)
    base_reps = []
    for _ in range(3):
        cs = [rng_.randrange(ec.FIELDS[FIELD].p) for _ in range(N)]
        t0 = time.time()
        nt.enter(cs)
        base_reps.append(time.time() - t0)
    native_enter_s = min(base_reps)
    del nt
    log(f"native single-core ENTER: {native_enter_s:.3f}s/poly "
        f"(reps {[round(t, 3) for t in base_reps]})")
    # pool + schedules build on CPU (fast, persistently cached), then move
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        tree.prepare((N,), cache_dir=here)
    tree.place_on(jax.devices()[0])

    spec = ec.FIELDS[FIELD]
    L = spec.num_limbs
    rng = np.random.RandomState(1)
    if L == 1:
        coeffs = rng.randint(0, spec.p, size=(BATCH, N, 1)).astype(np.uint32)
    else:
        # uniform 16-bit limbs with a constrained top limb keeps values < p
        top = spec.to_limbs(spec.p)[-1]
        coeffs = rng.randint(0, 1 << 16, size=(BATCH, N, L)).astype(np.uint32)
        coeffs[..., -1] = rng.randint(0, top, size=(BATCH, N))
    coeffs = jax.device_put(coeffs, jax.devices()[0])

    log("compiling enter...")
    t0 = time.time()
    out = tree.enter(coeffs)
    out.block_until_ready()
    log(f"first call (compile+run): {time.time()-t0:.1f}s")

    # correctness gate: the device result must match the native engine
    # bit-for-bit on several polys of the batch, in BOTH directions
    from ecfft_tpu.native import NativeFFTree as _NT

    nt_check = _NT(FIELD, N)
    for bi in (0, BATCH // 2, BATCH - 1):
        check = [int(spec.from_limbs(l)) for l in np.asarray(coeffs[bi])]
        expected = nt_check.enter(check)
        got = [int(v) for v in tree.decode(out[bi])]
        assert got == expected, \
            f"device ENTER does not match the native engine (poly {bi})"
    back = tree.exit(out[:1])
    assert np.array_equal(np.asarray(back[0]), np.asarray(coeffs[0])), \
        "device EXIT does not round-trip ENTER (poly 0)"
    log("correctness gate passed (device == native: ENTER x3 polys, "
        "EXIT roundtrip)")

    # fresh inputs every rep so no caching effect can flatter the number,
    # generated ON DEVICE so the timed region is the transform alone
    import jax.numpy as jnp

    @jax.jit
    def fresh_input(key):
        if L == 1:
            return jax.random.randint(
                key, (BATCH, N, 1), 0, spec.p, dtype=jnp.uint32)
        limbs = jax.random.randint(
            key, (BATCH, N, L), 0, 1 << 16, dtype=jnp.uint32)
        tl = jax.random.randint(
            key, (BATCH, N, 1), 0, int(top), dtype=jnp.uint32)
        return jnp.concatenate([limbs[..., :-1], tl], axis=-1)

    times = []
    for rep in range(REPS):
        fresh = fresh_input(jax.random.PRNGKey(rep)).block_until_ready()
        t0 = time.perf_counter()
        tree.enter(fresh).block_until_ready()
        times.append(time.perf_counter() - t0)
    best = min(times)
    polys_per_sec = BATCH / best
    base = 1.0 / native_enter_s
    log(f"warm times: {[round(t, 4) for t in times]}; "
        f"throughput {polys_per_sec:.2f} polys/s; native 1-core {base:.2f}")

    ndev = len(jax.devices())
    print(json.dumps({
        "metric": f"batched ENTER throughput, {FIELD}, n=2^{N.bit_length()-1}, "
                  f"batch {BATCH}, 1 {dev.device_kind} ({card})",
        "value": polys_per_sec,
        "unit": "polys/sec",
        "vs_baseline": polys_per_sec / base,
        "device_s_per_poly": best / BATCH,
        "native_1core_s_per_poly": native_enter_s,
        "native_baseline_reps_s": base_reps,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": ndev, "card": card},
    }))


if __name__ == "__main__":
    main()
