#!/usr/bin/env python
"""Smoke run of the ECFFT main path on one NVIDIA GPU, bit-exact.

    python chip_smoke.py               # one card: phases (a)-(f)
    python chip_smoke.py --four-cards  # batch-sharded ENTER/EXIT, 4 cards

Phases, all through the public API, every comparison ``==`` on exact
integers (there is no float anywhere, so no tolerance applies):

(a) the device is a GPU, or exit 1 — there is no CPU run;
(b) secp256k1 n=2^16 batch 256 ENTER, equal to the native engine on polys
    0, 127 and 255, then EXIT of the whole batch equal to the input;
(c) the reference's eight-op protocol at n=2048 (tree of 2n) on m31 and
    secp256k1, batch 8, each op against the native engine on the first
    and last lanes;
(d) m31 n=2^16 batch 256 ENTER/EXIT against the native engine;
(e) NTTPlan n=8192 on the STARK prime: naive evaluation at sample points
    of one lane, and an INTT round trip;
(f) each in-place step kernel against the XLA step math at the flagship
    window (65536 rows, 16 limbs, 256 lanes) for secp256k1 and the STARK
    prime, with the compiled kernel's memory analysis.

The phases, and the ops inside (c), run concurrently in threads of one
process so that their compiles overlap on the host's cores; the
first-call seconds they print include that overlap. A warm pass then
calls every timed op once more, one at a time: those are the warm
seconds.

A failed phase prints its traceback; the script then exits 1 without the
result line. The last line on success is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``,
with the number of cards the run used as ``count``.
"""

import argparse
import json
import subprocess
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from functools import partial

# zstandard.backend_c segfaults on JAX persistent-cache entries in
# long-lived processes; block it so the cache uses zlib
sys.modules["zstandard"] = None

SEED = 1
# full widths: the flagship tree and batch, the reference protocol, the
# NTT comparison, and the kernel check's (rows, lanes, state rows, start)
FLAG_N, FLAG_B = 1 << 16, 256
PROTO_N, PROTO_B = 2048, 8
NTT_N = 8192
WINDOW = (65536, 256, 131200, 1 << 15)


def log(*a):
    print(*a, flush=True)


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    lines = out.stdout.strip().splitlines()
    if out.returncode or not lines:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return lines[0]


def device_check():
    """Phase (a): refuse anything but a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX's first device is {dev.platform}: "
              f"{dev.device_kind}); nothing was run", file=sys.stderr)
        sys.exit(1)
    return dev


def draw(key, B, n, spec):
    """A seeded (B, n, L) batch of field elements, made on the device."""
    import jax
    import jax.numpy as jnp

    L = spec.num_limbs
    if L == 1:
        return jax.random.randint(key, (B, n, 1), 0, spec.p,
                                  dtype=jnp.uint32)
    k1, k2 = jax.random.split(key)
    x = jax.random.randint(k1, (B, n, L), 0, 1 << 16, dtype=jnp.uint32)
    top = jax.random.randint(k2, (B, n), 0, spec.to_limbs(spec.p)[-1],
                             dtype=jnp.uint32)
    return x.at[..., -1].set(top)


def ints(tree, row):
    return [int(v) for v in tree.decode(row)]


_PRINT = threading.Lock()


class Phase:
    """One phase's log; its lines print together when the phase ends, so
    phases that run concurrently do not interleave their output. Timed
    ops are kept in ``warm`` for the warm pass."""

    def __init__(self, name, card, warm):
        self.name, self.card, self.lines = name, card, []
        self.warm = warm

    def log(self, msg):
        self.lines.append(msg)

    def run(self, fn) -> bool:
        t0 = time.perf_counter()
        try:
            fn(self)
            ok = True
            self.log(f"phase {self.name}: ok in "
                     f"{time.perf_counter() - t0:.1f} s on {self.card}")
        except Exception:
            ok = False
            self.log(traceback.format_exc())
            self.log(f"phase {self.name}: FAILED after "
                     f"{time.perf_counter() - t0:.1f} s")
        with _PRINT:
            log("\n".join([f"--- phase {self.name} on {self.card}"]
                          + self.lines))
        return ok

    def timed(self, label, fn):
        """First call of ``fn`` (compile + run, overlapping the other
        phases); ``fn`` is timed warm later, alone."""
        import jax

        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        self.log(f"  {label}: first call (compile+run, phases overlapping)"
                 f" {time.perf_counter() - t0:.2f} s")
        self.warm.append((label, fn))
        return out


def warm_pass(warm, card):
    """Each timed op once more, one at a time, nothing else running."""
    import jax

    for label, fn in warm:
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        log(f"warm {label}: {time.perf_counter() - t0:.4f} s on {card}")


def concurrently(fns: dict) -> dict:
    """Call each of ``fns`` in its own thread; their results by key. XLA
    compiles with the interpreter lock released, so the compiles of
    independent programs overlap on the host's cores."""
    with ThreadPoolExecutor(len(fns)) as pool:
        futs = {k: pool.submit(f) for k, f in fns.items()}
        return {k: f.result() for k, f in futs.items()}


def big_tree(ph, field, n):
    """Native build on the host, schedules prepared, moved to the GPU."""
    import jax

    from ecfft_tpu.native import build_fftree_native

    t0 = time.perf_counter()
    with jax.default_device(jax.devices("cpu")[0]):
        tree = build_fftree_native(field, n)
        tree.prepare((n,))
    tree.place_on(jax.devices()[0])
    ph.log(f"  set-up {field} n={n}: {time.perf_counter() - t0:.1f} s "
           f"(native build + pool/schedule prep, host, phases overlapping)")
    return tree


def flagship(ph, field):
    """ENTER then EXIT of a seeded batch of 256 at n=2^16, checked against
    the native engine on polys 0, 127, 255 and by the round trip."""
    import jax
    import jax.numpy as jnp

    from ecfft_tpu.native import NativeFFTree

    n, B = FLAG_N, FLAG_B
    tree = big_tree(ph, field, n)
    coeffs = jax.jit(draw, static_argnums=(1, 2, 3))(
        jax.random.PRNGKey(SEED), B, n, tree.spec)
    evals = ph.timed(f"{field} ENTER n=2^16 b={B}",
                     lambda: tree.enter(coeffs))
    nt = NativeFFTree(field, n)
    for b in (0, B // 2 - 1, B - 1):
        assert ints(tree, evals[b]) == nt.enter(ints(tree, coeffs[b])), \
            f"{field} ENTER != native engine on poly {b}"
    ph.log(f"  {field} ENTER == native engine on polys 0, 127, 255")
    back = ph.timed(f"{field} EXIT n=2^16 b={B}", lambda: tree.exit(evals))
    assert bool(jnp.array_equal(back, coeffs)), f"{field} EXIT != input"
    ph.log(f"  {field} EXIT of the whole batch == input")
    stats = jax.devices()[0].memory_stats() or {}
    ph.log(f"  peak device memory so far (all phases): "
           f"{stats.get('peak_bytes_in_use', 0) / 1e9:.2f} GB of "
           f"{stats.get('bytes_limit', 0) / 1e9:.2f} GB")


def phase_b(ph):
    flagship(ph, "secp256k1")


def phase_c(ph, field):
    """The eight-op protocol of the reference's benches at n=2048: ENTER,
    then the other seven ops on its output, concurrently."""
    import random

    import numpy as np

    from ecfft_tpu import S1
    from ecfft_tpu.native import NativeFFTree

    n, B = PROTO_N, PROTO_B
    tree = big_tree(ph, field, 2 * n)
    nt = NativeFFTree(field, 2 * n)
    p = tree.spec.p
    rng = random.Random(SEED)
    vals = [[rng.randrange(p) for _ in range(n)] for _ in range(B)]
    # distinct degrees per lane for DEGREE
    for b in range(1, B):
        k = b * n // (2 * B)
        vals[b][n - k:] = [0] * k
    enc = tree.encode(vals)
    pts = tree.encode([[rng.randrange(p) for _ in range(n // 2)]
                       for _ in range(B)])
    a = nt.table(n, "xnn_s")
    c = nt.table(n, "z0z0_rem_xnn_s")
    ev = ph.timed(f"{field} ENTER", lambda: tree.enter(enc))
    e0 = ev[:, 0::2]
    ops = {
        "EXIT": (lambda: tree.exit(ev),
                 lambda b: nt.exit(ints(tree, ev[b]))),
        "EXTEND": (lambda: tree.extend(e0, S1),
                   lambda b: nt.extend(ints(tree, e0[b]), S1)),
        "MEXTEND": (lambda: tree.mextend(e0, S1),
                    lambda b: nt.mextend(ints(tree, e0[b]), S1)),
        "MOD": (lambda: tree.modular_reduce(ev),
                lambda b: nt.modular_reduce(ints(tree, ev[b]), a, c)),
        "REDC_Z0": (lambda: tree.redc_z0(ev),
                    lambda b: nt.redc_z0(ints(tree, ev[b]), a)),
        "REDC_Z1": (lambda: tree.redc_z1(ev),
                    lambda b: nt.redc_z1(ints(tree, ev[b]), a)),
        "VANISH": (lambda: tree.vanish(pts),
                   lambda b: nt.vanish(ints(tree, pts[b]))),
    }
    outs = concurrently({
        k: (lambda k=k, f=f: ph.timed(f"{field} {k}", f))
        for k, (f, _) in ops.items()} | {
        "DEGREE": lambda: np.asarray(ph.timed(f"{field} DEGREE",
                                              lambda: tree.degree(ev)))})
    for b in (0, B - 1):
        assert ints(tree, ev[b]) == nt.enter(vals[b]), \
            f"{field} ENTER != native engine on lane {b}"
        for name, (_, want) in ops.items():
            assert ints(tree, outs[name][b]) == want(b), \
                f"{field} {name} != native engine on lane {b}"
        assert int(outs["DEGREE"][b]) == nt.degree(ints(tree, ev[b])), \
            f"{field} DEGREE != native engine on lane {b}"
    ph.log(f"  {field}: all eight ops == native engine on lanes 0, {B - 1}")


def phase_d(ph):
    flagship(ph, "m31")


def phase_e(ph):
    """The Montgomery-resident step path: radix-2 NTT on the STARK prime."""
    import random

    import jax.numpy as jnp

    from ecfft_tpu.ntt import NTTPlan

    n, B = NTT_N, 8
    t0 = time.perf_counter()
    plan = NTTPlan(n)
    ph.log(f"  set-up NTTPlan n={n}: {time.perf_counter() - t0:.1f} s")
    p = plan.p
    rng = random.Random(SEED)
    vals = [[rng.randrange(p) for _ in range(n)] for _ in range(B)]
    enc = plan.encode(vals)
    ev = ph.timed("NTT n=8192 b=8", lambda: plan.ntt(enc))
    w = pow(3, (p - 1) // n, p)
    got = [int(v) for v in plan.decode(ev[B - 1])]
    for k in [0, 1, 2, n // 2, n - 1] + [rng.randrange(n) for _ in range(27)]:
        x, acc = pow(w, k, p), 0
        for cf in reversed(vals[B - 1]):
            acc = (acc * x + cf) % p
        assert got[k] == acc, f"NTT != naive evaluation at index {k}"
    ph.log("  NTT == naive evaluation at 32 points of lane 7")
    back = ph.timed("INTT n=8192 b=8", lambda: plan.intt(ev))
    assert bool(jnp.array_equal(back, enc)), "INTT(NTT(x)) != x"
    ph.log("  INTT round trip exact")


def phase_f(ph):
    """Each in-place step kernel against the XLA step math, flagship
    window, both reduction paths."""
    import jax
    import jax.numpy as jnp

    from ecfft_tpu.fields.registry import FIELDS, spec_for_prime
    from ecfft_tpu.ntt import STARK_P
    from ecfft_tpu.ops import pallas_step as ps
    from ecfft_tpu.ops import schedule as sch

    A, B, W, start = WINDOW
    for spec in (FIELDS["secp256k1"], spec_for_prime(STARK_P, "stark")):
        L = spec.num_limbs
        ks = jax.random.split(jax.random.PRNGKey(SEED), 5)
        mk = jax.jit(lambda k, rows: jnp.transpose(
            draw(k, B, rows, spec), (1, 2, 0)), static_argnums=1)
        state, x1, x2 = mk(ks[0], W), mk(ks[1], A), mk(ks[2], A)
        ca = mk(ks[3], A)[..., 0]
        cb = mk(ks[4], A)[..., 0]
        s = jnp.int32(start)

        @jax.jit
        def window(st):
            return jax.lax.dynamic_slice(st, (s, 0, 0), (A, L, B))

        rows = min(A, 8192)

        @partial(jax.jit, static_argnums=0)
        def blocked(fn, *args):
            """The XLA step math over row blocks: its product-column temps
            for the whole window do not fit the card."""
            blk = [a.reshape(A // rows, rows, *a.shape[1:]) for a in args]
            return jax.lax.map(lambda t: fn(*t), tuple(blk)).reshape(
                A, L, B)

        def m1(c, a, b):
            return sch._muladd1_cols(spec, c[:, :, None], a, b)

        def m2(c, d, a, b):
            return sch._muladd2_cols(spec, c[:, :, None], a, d[:, :, None], b)

        cases = {
            "aff1s": (lambda: ps.pallas_aff1s_ip(spec, cb, state, x2, s),
                      lambda: blocked(m1, cb, window(state), x2)),
            "aff1g": (lambda: ps.pallas_aff1g_ip(spec, cb, state, x1, x2, s),
                      lambda: blocked(m1, cb, x1, x2)),
            "aff2g": (lambda: ps.pallas_aff2g_ip(spec, ca, cb, state, x1, x2,
                                                 s),
                      lambda: blocked(m2, ca, cb, x1, x2)),
        }
        for name, (got, want) in cases.items():  # one at a time: memory
            assert bool(jnp.array_equal(window(got()), want())), \
                f"{spec.name} {name} kernel != XLA step math"
        ph.log(f"  {spec.name}: aff1s, aff1g, aff2g kernels == XLA step "
               f"math at (A={A}, L={L}, B={B})")
        comp = ps.pallas_aff1s_ip.lower(spec, cb, state, x2, s).compile()
        ph.log(f"  {spec.name} aff1s step memory_analysis: "
               f"{comp.memory_analysis()}")
        del state, x1, x2


COLLECTIVES = ("all-reduce", "all-gather", "collective-permute",
               "all-to-all", "reduce-scatter")


def four_cards(ph):
    """Batch sharding over four cards, secp256k1 n=2^16 b=256 (64 lanes a
    card): sharded ENTER equal to one card's and to the native engine on
    3 polys, sharded EXIT equal to the input, no collective in the
    compiled segment programs, and no collective kernel on any card."""
    import tempfile

    import jax
    import jax.numpy as jnp

    from ecfft_tpu.native import NativeFFTree
    from ecfft_tpu.ops import schedule as sch
    from ecfft_tpu.parallel.sharding import ShardedFFTree, make_mesh
    from ecfft_tpu.utils.profiling import device_times

    devs = jax.devices()
    assert len(devs) >= 4, f"need 4 GPUs, have {devs}"
    n, B = FLAG_N, FLAG_B
    tree = big_tree(ph, "secp256k1", n)
    coeffs = jax.jit(draw, static_argnums=(1, 2, 3))(
        jax.random.PRNGKey(SEED), B, n, tree.spec)
    stree = ShardedFFTree(tree, make_mesh(devs[:4]))

    # every sharded segment program the run compiles, by opcode and state
    # shape, as abstract arguments for its compiled HLO below
    programs = {}
    run_segment = sch._run_segment_sharded

    def record(*args):
        programs.setdefault((args[10], args[5].shape), jax.tree.map(
            lambda a: jax.ShapeDtypeStruct(
                a.shape, a.dtype, sharding=a.sharding
                if len(a.sharding.device_set) > 1 else None)
            if isinstance(a, jax.Array) else a, args))
        return run_segment(*args)

    sch._run_segment_sharded = record
    nt = NativeFFTree("secp256k1", n)
    polys = (0, B // 2 - 1, B - 1)

    def sharded():
        ev = ph.timed("4-card ENTER", lambda: stree.enter(coeffs))
        back = ph.timed("4-card EXIT", lambda: stree.exit(ev))
        return ev, back

    outs = concurrently({
        "one": lambda: ph.timed("one card ENTER", lambda: tree.enter(coeffs)),
        "four": sharded,
        # compiles the sharded EXIT programs alongside the ENTER ones
        "exit": lambda: jax.block_until_ready(stree.exit(coeffs)),
        "native": lambda: [nt.enter(ints(tree, coeffs[b])) for b in polys]})
    evals, (sev, sback) = outs["one"], outs["four"]
    assert bool(jnp.array_equal(sev, jax.device_put(evals, sev.sharding))), \
        "sharded ENTER != single-card ENTER"
    for b, want in zip(polys, outs["native"]):
        assert ints(tree, sev[b]) == want, \
            f"sharded ENTER != native engine on poly {b}"
    assert bool(jnp.array_equal(
        sback, jax.device_put(coeffs, sback.sharding))), \
        "sharded EXIT != input"
    ph.log(f"  sharded ENTER == one card == native engine on polys "
           f"{polys}; sharded EXIT == input; output sharding {sev.sharding}")

    texts = concurrently({
        op: lambda a=a: run_segment.lower(*a).compile().as_text()
        for op, a in programs.items()})
    sch._run_segment_sharded = run_segment
    for op, txt in texts.items():
        bad = [c for c in COLLECTIVES if c in txt]
        assert bad == [], f"segment program (opcode {op}) has {bad}"
    ph.log(f"  {len(texts)} compiled sharded segment programs (opcode, "
           f"state shape {sorted(texts)}): no collective op in their HLO")

    d = tempfile.mkdtemp()
    jax.profiler.start_trace(d)
    jax.block_until_ready(stree.enter(coeffs))
    jax.profiler.stop_trace()
    names = device_times(d)["kernels"]
    assert names, "the trace of the sharded ENTER holds no device kernel"
    bad = sorted(k for k in names if "nccl" in k.lower() or any(
        c in k.lower().replace("_", "-") for c in COLLECTIVES))
    assert not bad, f"collectives ran during the sharded ENTER: {bad[:5]}"
    ph.log(f"  sharded ENTER trace: {len(names)} distinct kernels, "
           f"no collective among them")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card batch-sharded ENTER/EXIT")
    args = ap.parse_args()

    dev = device_check()
    import jax

    from ecfft_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    card = card_name()
    log(card)
    log(f"jax {jax.__version__}; compile cache {cache}; device "
        f"{dev.device_kind} x{len(jax.devices())}")
    if args.four_cards:
        phases = {"four-cards": four_cards}
        count = 4
    else:
        phases = {"b": phase_b, "c m31": partial(phase_c, field="m31"),
                  "c secp256k1": partial(phase_c, field="secp256k1"),
                  "d": phase_d, "e": phase_e, "f": phase_f}
        count = 1
    t0 = time.perf_counter()
    warm = []
    ok = concurrently({k: partial(Phase(k, card, warm).run, fn)
                       for k, fn in phases.items()})
    failed = [k for k, v in ok.items() if not v]
    log(f"all phases: {time.perf_counter() - t0:.1f} s wall on {card}")
    if failed:
        log(f"FAILED phases: {failed}")
        sys.exit(1)
    warm_pass(warm, card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": count}}))


if __name__ == "__main__":
    main()
