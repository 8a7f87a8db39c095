"""End-to-end demo mirroring the reference's examples/interp_eval.rs:
build a secp256k1 FFTree, ENTER a random polynomial, check against naive
O(n^2) evaluation, then EXIT back to coefficients — with wall-clock
prints. Runs on whatever device JAX picks (the GPU when there is one).

    python examples/interp_eval.py [log2_n] [batch]
"""

import os
import random
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# zstd segfaults on JAX cache entries in long-lived processes; use zlib
# (must match tests/conftest.py — same cache dir, same format)
sys.modules["zstandard"] = None

import jax  # noqa: E402

import ecfft_tpu as ec  # noqa: E402
from ecfft_tpu.native import build_fftree_native  # noqa: E402
from ecfft_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from ecfft_tpu.utils.poly import evaluate  # noqa: E402

enable_compile_cache()


def main():
    log2_n = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    batch = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    n = 1 << log2_n
    p = ec.FIELDS["secp256k1"].p

    now = time.time()
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        tree = build_fftree_native("secp256k1", n)
        tree.prepare((n,))
    tree.place_on(jax.devices()[0])
    print(f"FFTree generation time: {time.time()-now:.2f}s")

    rng = random.Random()
    polys = [[rng.randrange(p) for _ in range(n)] for _ in range(batch)]
    enc = tree.encode(polys)

    now = time.time()
    evals = tree.enter(enc).block_until_ready()
    print(f"evaluation time (fft), batch {batch}: {time.time()-now:.3f}s")

    now = time.time()
    dom = list(tree.eval_domain())
    naive = [evaluate(polys[0], x, p) for x in dom]
    print(f"naive O(n^2) eval (1 poly, host): {time.time()-now:.2f}s")
    assert list(tree.decode(evals[0])) == naive, "ECFFT != naive"

    now = time.time()
    coeffs = tree.exit(evals).block_until_ready()
    print(f"interpolation time (ifft): {time.time()-now:.3f}s")
    assert [list(r) for r in tree.decode(coeffs)] == polys
    print("roundtrip exact ✓")


if __name__ == "__main__":
    main()
