#!/usr/bin/env python
"""A/B of the schedule step on one GPU: the Triton-route step kernel
against the XLA step math, and run-split pieces against the legacy switch
interpreter.

    python tools/step_ab.py [--phases kernel,e2e] [--out chiprun_out]

``kernel``: each in-place variant at the flagship window (A = 65536 rows,
L = 16, B = 256) for secp256k1 and the STARK prime, checked bit for bit
against the XLA step math, then timed against it per step. ``e2e``: ENTER and EXIT of secp256k1 n = 2^16, batch 256,
through the public FFTree API under each route, bit-exact across routes
and against the native engine, timed in turns, with a device trace of one
warm ENTER per split route. Every result line also goes to
``<out>/step_ab.jsonl``.
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.modules["zstandard"] = None

OUT = None


def emit(**rec):
    print(json.dumps(rec), flush=True)
    with open(os.path.join(OUT, "step_ab.jsonl"), "a") as f:
        f.write(json.dumps(rec) + "\n")


def draw(jax, jnp, key, shape, top):
    """Uniform 16-bit limbs on axis 1, the top limb below ``top``."""
    k1, k2 = jax.random.split(key)
    x = jax.random.randint(k1, shape, 0, 1 << 16, dtype=jnp.uint32)
    t = jax.random.randint(k2, shape[:1] + shape[2:], 0, top,
                           dtype=jnp.uint32)
    return x.at[:, -1].set(t)


def timed(fn, reps):
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return out


def phase_kernel(card):
    import jax
    import jax.numpy as jnp

    from ecfft_tpu.fields.registry import FIELDS, spec_for_prime
    from ecfft_tpu.ntt import STARK_P
    from ecfft_tpu.ops import pallas_step as ps
    from ecfft_tpu.ops import schedule as sch

    A, B, W = 65536, 256, 131200
    start = 1 << 15
    for name, spec in (("secp256k1", FIELDS["secp256k1"]),
                       ("stark", spec_for_prime(STARK_P, "stark"))):
        L = spec.num_limbs
        top = spec.to_limbs(spec.p)[-1]
        ks = jax.random.split(jax.random.PRNGKey(0), 5)
        state = draw(jax, jnp, ks[0], (W, L, B), top)
        x1 = draw(jax, jnp, ks[1], (A, L, B), top)
        x2 = draw(jax, jnp, ks[2], (A, L, B), top)
        ca = draw(jax, jnp, ks[3], (A, L, 1), top)[..., 0]
        cb = draw(jax, jnp, ks[4], (A, L, 1), top)[..., 0]
        s0 = jnp.int32(start)

        def win(st):
            return jax.lax.dynamic_slice(st, (s0, 0, 0), (A, L, B))

        @jax.jit
        def ref1(cb, st, x2, s):
            out = sch._muladd1_cols(spec, cb[:, :, None],
                                    jax.lax.dynamic_slice(
                                        st, (s, 0, 0), (A, L, B)), x2)
            return jax.lax.dynamic_update_slice(st, out, (s, 0, 0))

        @jax.jit
        def ref2(ca, cb, st, x1, x2, s):
            out = sch._muladd2_cols(spec, ca[:, :, None], x1,
                                    cb[:, :, None], x2)
            return jax.lax.dynamic_update_slice(st, out, (s, 0, 0))

        def chain(f, *args, reps=5):
            """Per-step seconds of ``f`` with the state donated, so
            neither side pays a defensive copy of the state."""
            st = jnp.copy(state).block_until_ready()
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                st = f(st, *args).block_until_ready()
                ts.append(time.perf_counter() - t0)
            return sorted(ts)

        def blocked(fn, *wins, rows=8192):
            """The XLA step math over row blocks of the window: the
            whole window at once may not fit the card."""
            def one(args):
                return fn(*args)
            blk = [w.reshape(A // rows, rows, *w.shape[1:]) for w in wins]
            out = jax.lax.map(one, tuple(blk))
            return out.reshape(A, L, B)

        m1 = jax.jit(lambda cb, x1, x2: blocked(
            lambda c, a, b: sch._muladd1_cols(spec, c[:, :, None], a, b),
            cb, x1, x2))
        m2 = jax.jit(lambda ca, cb, x1, x2: blocked(
            lambda c, d, a, b: sch._muladd2_cols(
                spec, c[:, :, None], a, d[:, :, None], b), ca, cb, x1, x2))
        want = {"aff1s": m1(cb, win(state), x2),
                "aff2g": m2(ca, cb, x1, x2),
                "aff1g": m1(cb, x1, x2)}
        xla = {
            "aff1s": (jax.jit(lambda st, cb, x2, s: ref1(cb, st, x2, s),
                              donate_argnums=0), (cb, x2, s0)),
            "aff2g": (jax.jit(lambda st, ca, cb, x1, x2, s: ref2(
                ca, cb, st, x1, x2, s), donate_argnums=0),
                (ca, cb, x1, x2, s0)),
        }
        for k, (f, args) in xla.items():
            try:
                emit(phase="kernel", field=name, variant=k, route="xla",
                     step_s=chain(f, *args), card=card)
            except Exception as e:
                emit(phase="kernel", field=name, variant=k, route="xla",
                     error=f"{type(e).__name__}: {str(e)[:300]}")
        kerns = {
            "aff1s": (lambda st, cb, x2, s: ps.pallas_aff1s_ip(
                spec, cb, st, x2, s), (cb, x2, s0)),
            "aff2g": (lambda st, ca, cb, x1, x2, s: ps.pallas_aff2g_ip(
                spec, ca, cb, st, x1, x2, s), (ca, cb, x1, x2, s0)),
            "aff1g": (lambda st, cb, x1, x2, s: ps.pallas_aff1g_ip(
                spec, cb, st, x1, x2, s), (cb, x1, x2, s0)),
        }
        for k, (f, args) in kerns.items():
            try:
                t0 = time.perf_counter()
                got = win(f(state, *args)).block_until_ready()
                first = time.perf_counter() - t0
                ok = bool(jnp.array_equal(got, want[k]))
                del got
                emit(phase="kernel", field=name, variant=k, route="kernel",
                     tile=ps.step_tiles(A, B) + (ps.NUM_WARPS,),
                     first_s=first, exact=ok, card=card,
                     step_s=chain(jax.jit(f, donate_argnums=0), *args))
            except Exception as e:  # keep timing the other variants
                emit(phase="kernel", field=name, variant=k,
                     error=f"{type(e).__name__}: {str(e)[:600]}")
        try:
            comp = ps.pallas_aff1s_ip.lower(spec, cb, state, x2,
                                            s0).compile()
            emit(phase="kernel", field=name,
                 memory_analysis=str(comp.memory_analysis()))
            for k, ref in (("aff1s", ref1.lower(cb, state, x2, s0)),
                           ("aff2g", ref2.lower(ca, cb, state, x1, x2, s0))):
                emit(phase="kernel", field=name, route="xla", variant=k,
                     memory_analysis=str(ref.compile().memory_analysis()))
        except Exception as e:
            emit(phase="kernel", field=name, error=repr(e)[:400])
        del state, x1, x2


_TREES = {}


def phase_e2e(card, n=1 << 16, B=256):
    import jax
    import jax.numpy as jnp

    import ecfft_tpu as ec
    from ecfft_tpu.native import NativeFFTree, build_fftree_native
    from ecfft_tpu.ops import schedule as sch
    from ecfft_tpu.utils.profiling import device_times

    field = "secp256k1"
    spec = ec.FIELDS[field]
    gpu = jax.devices()[0]
    cpu = jax.devices("cpu")[0]
    t0 = time.perf_counter()
    if n not in _TREES:
        with jax.default_device(cpu):
            _TREES[n] = build_fftree_native(field, n)
            _TREES[n].prepare((n,))
        _TREES[n].place_on(gpu)
    tree = _TREES[n]
    emit(phase="e2e", B=B, setup_s=time.perf_counter() - t0)
    top = spec.to_limbs(spec.p)[-1]
    coeffs = jnp.transpose(draw(jax, jnp, jax.random.PRNGKey(1),
                                (B, spec.num_limbs, n), top), (0, 2, 1))
    coeffs = jax.device_put(coeffs, gpu).block_until_ready()
    nt = NativeFFTree(field, n)
    want0 = nt.enter([int(v) for v in tree.decode(coeffs[0])])
    routes = {"kernel+split": sch.StepRoute(True, True),
              "kernel+legacy": sch.StepRoute(True, False)}
    if B <= 64:  # the XLA step math runs out of memory at B=256
        routes["xla+split"] = sch.StepRoute(False, True)
    real = sch.step_route
    ref = None
    ok_routes = []
    for name, route in routes.items():
        sch.step_route = lambda backend=None, r=route: r
        try:
            t0 = time.perf_counter()
            out = tree.enter(coeffs).block_until_ready()
            first = time.perf_counter() - t0
            if ref is None:
                ref = out
                exact = [int(v) for v in tree.decode(out[0])] == want0
            else:
                exact = bool(jnp.array_equal(out, ref))
            del out
            t0 = time.perf_counter()
            back = tree.exit(ref).block_until_ready()
            first_exit = time.perf_counter() - t0
            rt = bool(jnp.array_equal(back, coeffs))
            del back
            emit(phase="e2e", B=B, route=name, enter_first_s=first,
                 enter_exact=exact, exit_first_s=first_exit,
                 exit_roundtrip=rt,
                 peak_gb=(gpu.memory_stats() or {}).get("peak_bytes_in_use", 0)
                 / 1e9, card=card)
            ok_routes.append(name)
        except Exception as e:
            emit(phase="e2e", B=B, route=name,
                 error=f"{type(e).__name__}: {str(e)[:800]}")
    for rnd in range(2):
        for name in ok_routes:
            sch.step_route = lambda backend=None, r=routes[name]: r
            ts = timed(lambda: tree.enter(coeffs).block_until_ready(), 1)
            rec = dict(phase="e2e", B=B, route=name, round=rnd,
                       enter_s=ts[0],
                       enter_polys_per_s=B / ts[0], card=card)
            if rnd == 0:
                te = timed(lambda: tree.exit(ref).block_until_ready(), 1)
                rec.update(exit_s=te[0], exit_polys_per_s=B / te[0])
            emit(**rec)
    for name in ok_routes:
        if not routes[name].split:
            continue
        sch.step_route = lambda backend=None, r=routes[name]: r
        d = os.path.join(OUT, f"trace_b{B}_" + name.replace("+", "_"))
        jax.profiler.start_trace(d)
        tree.enter(coeffs).block_until_ready()
        jax.profiler.stop_trace()
        red = device_times(d)
        topk = sorted(red["kernels"].items(), key=lambda kv: -kv[1])[:15]
        emit(phase="trace", B=B, route=name, busy_s=red["busy_s"],
             window_s=red["window_s"], idle=red["idle"], top=topk,
             n_kernels=len(red["kernels"]), card=card)
    sch.step_route = real


def main():
    global OUT
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="kernel,e2e")
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()
    OUT = args.out
    os.makedirs(OUT, exist_ok=True)
    import jax

    from ecfft_tpu.utils.compile_cache import enable_compile_cache

    if jax.devices()[0].platform != "gpu":
        sys.exit("step_ab: no GPU")
    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    emit(card=card, jax=jax.__version__, device=jax.devices()[0].device_kind)
    for ph in args.phases.split(","):
        if ph == "kernel":
            phase_kernel(card)
        else:
            phase_e2e(card, B=256)


if __name__ == "__main__":
    main()
