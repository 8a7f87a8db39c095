"""Criterion-parity benchmark suite CLI.

Reproduces the reference's benchmark protocol (benches/fftree.rs:14-109:
all eight algorithms at n=2048 with seed-fixed inputs on both fields,
plus FFTree generate / serialize / deserialize ×{compressed,uncompressed})
and the ECFFT-side of benches/comparison.rs (n=8192 evaluate/interpolate),
batched for the accelerator.

Usage::

    python -m ecfft_tpu.bench_suite --field m31 --n 2048 --batch 8
    python -m ecfft_tpu.bench_suite --comparison        # n=8192 protocol
"""

from __future__ import annotations

import argparse
import random
import sys
import time

# zstandard.backend_c segfaults on JAX persistent-cache entries in
# long-lived processes; block it so the cache uses zlib (must match
# tests/conftest.py so every process reads/writes the same format)
sys.modules["zstandard"] = None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--field", default="m31", choices=["m31", "secp256k1"])
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--comparison", action="store_true",
                    help="run the benches/comparison.rs protocol (n=8192)")
    ap.add_argument("--native", action="store_true",
                    help="also time the single-core native engine")
    ap.add_argument("--device", default=None,
                    help="cpu to force CPU, default = best available")
    args = ap.parse_args(argv)

    import jax

    from ecfft_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.device == "cpu":
        jax.config.update("jax_platforms", "cpu")

    import ecfft_tpu as ec
    from ecfft_tpu.native import build_fftree_native
    from ecfft_tpu.serialize import deserialize_fftree, serialize_fftree
    from ecfft_tpu.utils.profiling import time_op

    if args.comparison:
        args.field, args.n = "secp256k1", 8192
        # the classical-FFT side of benches/comparison.rs: radix-2 NTT on
        # the 2-adic STARK prime, same n, same batch, same interpreter
        from ecfft_tpu.ntt import NTTPlan

        plan = NTTPlan(args.n)
        rngc = random.Random(1)
        vals_ntt = [[rngc.randrange(plan.p) for _ in range(args.n)]
                    for _ in range(args.batch)]
        enc_ntt = plan.encode(vals_ntt)
        from ecfft_tpu.utils.profiling import time_op as _t

        best, _ = _t(lambda: plan.ntt(enc_ntt), reps=args.reps)
        print(f"# NTT evaluate (STARK prime): {best:.4f}s total, "
              f"{best / args.batch * 1e3:.3f} ms/poly", file=sys.stderr)
        best, _ = _t(lambda: plan.intt(enc_ntt), reps=args.reps)
        print(f"# NTT interpolate (STARK prime): {best:.4f}s total, "
              f"{best / args.batch * 1e3:.3f} ms/poly", file=sys.stderr)

    field, n, batch = args.field, args.n, args.batch
    spec = ec.FIELDS[field]
    p = spec.p
    dev = jax.devices()[0]
    print(f"# field={field} n={n} batch={batch} device={dev}", file=sys.stderr)

    t0 = time.time()
    tree = build_fftree_native(field, 2 * n)  # bench protocol: tree of 2n
    gen_s = time.time() - t0
    tree.tables = jax.device_put(tree.tables, dev)

    rng = random.Random(1)
    vals = [[rng.randrange(p) for _ in range(n)] for _ in range(batch)]
    enc = jax.device_put(tree.encode(vals), dev)
    half_enc = enc[:, : n // 2]
    a = tree.tables[n]["xnn_s"]
    c = tree.tables[n]["z0z0_rem_xnn_s"]

    rows = [("tree generate (native)", gen_s, 1)]

    cases = [
        ("ENTER", lambda: tree.enter(enc)),
        ("EXIT", lambda: tree.exit(enc)),
        ("DEGREE", lambda: tree.degree(enc)),
        ("EXTEND", lambda: tree.extend(enc, ec.S1)),
        ("MEXTEND", lambda: tree.mextend(enc, ec.S1)),
        ("MOD", lambda: tree.modular_reduce(enc)),
        ("REDC", lambda: tree.redc_z0(enc)),
        ("VANISH", lambda: tree.vanish(half_enc)),
    ]
    for name, fn in cases:
        best, _ = time_op(fn, reps=args.reps)
        rows.append((name, best, batch))

    t0 = time.time()
    data = serialize_fftree(tree, compress=True)
    rows.append(("serialize compressed", time.time() - t0, 1))
    t0 = time.time()
    deserialize_fftree(field, data, compress=True)
    rows.append(("deserialize compressed", time.time() - t0, 1))

    if args.native:
        from ecfft_tpu.native import NativeFFTree

        nt = NativeFFTree(field, 2 * n)
        for name, fn in (
            ("native ENTER (1 core)", lambda: nt.enter(vals[0])),
            ("native EXTEND (1 core)", lambda: nt.extend(vals[0][: n // 2], 1)),
        ):
            t0 = time.time()
            fn()
            rows.append((name, time.time() - t0, 1))

    w = max(len(r[0]) for r in rows) + 2
    print(f"{'op':<{w}}{'total s':>12}{'per poly ms':>14}")
    for name, secs, cnt in rows:
        print(f"{name:<{w}}{secs:>12.4f}{secs / cnt * 1e3:>14.3f}")


if __name__ == "__main__":
    main()
