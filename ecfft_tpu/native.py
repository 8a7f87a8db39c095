"""ctypes bindings for the native C++ ECFFT engine (native/ecfft_native.cpp).

The native engine is the framework's host runtime: an independent
single-core oracle (arkworks-class 4×64 Montgomery arithmetic), the
measured baseline for bench.py, and a fast FFTree builder for large n.
It is compiled with ``g++`` from ``native/ecfft_native.cpp`` into
``native/libecfft_native.so`` on first use (or ``python -m ecfft_tpu.native``).

All boundary values are 32-byte little-endian canonical integers.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from ecfft_tpu.fields.registry import FIELDS, FieldSpec, build_domain

_SO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "native", "libecfft_native.so")
_SRC = _SO.replace("libecfft_native.so", "ecfft_native.cpp")

_lib = None


def build_native() -> None:
    subprocess.run(
        ["g++", "-O3", "-march=native", "-shared", "-fPIC",
         "-o", _SO, _SRC],
        check=True,
    )


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        if (not os.path.exists(_SO)
                or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            build_native()
        _lib = ctypes.CDLL(_SO)
        _lib.ecn_tree_new.restype = ctypes.c_void_p
        _lib.ecn_tree_new.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                      ctypes.c_uint64, ctypes.c_char_p,
                                      ctypes.c_uint64]
        _lib.ecn_tree_free.argtypes = [ctypes.c_void_p]
        for name in ("ecn_enter", "ecn_exit"):
            fn = getattr(_lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
                           ctypes.c_char_p]
        for name in ("ecn_extend", "ecn_mextend"):
            fn = getattr(_lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
                           ctypes.c_int, ctypes.c_char_p]
        _lib.ecn_degree.restype = ctypes.c_uint64
        _lib.ecn_degree.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_uint64]
        _lib.ecn_redc.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_char_p, ctypes.c_uint64,
                                  ctypes.c_int, ctypes.c_char_p]
        _lib.ecn_mod.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_char_p, ctypes.c_char_p,
                                 ctypes.c_uint64, ctypes.c_char_p]
        _lib.ecn_vanish.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_uint64, ctypes.c_char_p]
        _lib.ecn_table.restype = ctypes.c_uint64
        _lib.ecn_table.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                   ctypes.c_int, ctypes.c_char_p]
        _lib.ecn_mats.restype = ctypes.c_uint64
        _lib.ecn_mats.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                  ctypes.c_uint64, ctypes.c_int,
                                  ctypes.c_char_p]
        _lib.ecn_layer.restype = ctypes.c_uint64
        _lib.ecn_layer.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                   ctypes.c_char_p]
        _lib.ecn_mul_throughput.restype = ctypes.c_double
        _lib.ecn_mul_throughput.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        _lib.ecn_batch_inv.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                       ctypes.c_uint64, ctypes.c_char_p]
        _lib.ecn_find_curve.restype = ctypes.c_uint64
        _lib.ecn_find_curve.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                        ctypes.c_uint64, ctypes.c_uint64,
                                        ctypes.c_char_p, ctypes.c_char_p,
                                        ctypes.c_char_p, ctypes.c_char_p]
        _lib.ecn_schoof_trace.restype = ctypes.c_int64
        _lib.ecn_schoof_trace.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                          ctypes.c_char_p, ctypes.c_uint32]
    return _lib


def _pack(vals: list[int]) -> bytes:
    return b"".join(int(v).to_bytes(32, "little") for v in vals)


def _unpack(buf: bytes) -> list[int]:
    return [int.from_bytes(buf[i : i + 32], "little")
            for i in range(0, len(buf), 32)]


TABLE_IDS = {
    "leaves": 0, "xnn_s": 1, "xnn_s_inv": 2, "z0_s1": 3, "z1_s0": 4,
    "z0_inv_s1": 5, "z1_inv_s0": 6, "z0z0_rem_xnn_s": 7,
    "z1z1_rem_xnn_s": 8,
}


class NativeFFTree:
    """Single-core native FFTree mirroring the public python surface."""

    def __init__(self, field: str | FieldSpec, n: int,
                 leaves: list[int] | None = None, maps=None):
        self.spec = FIELDS[field] if isinstance(field, str) else field
        self.n = n
        if leaves is None:
            dom = build_domain(self.spec, n)
            if dom is None:
                raise ValueError("n exceeds the field's curve two-adicity")
            leaves, maps = dom
        blob = b""
        for m in maps:
            num = list(m.numerator)
            den = list(m.denominator)
            blob += len(num).to_bytes(4, "little") + _pack(num)
            blob += len(den).to_bytes(4, "little") + _pack(den)
        self._lib = lib()
        self._h = self._lib.ecn_tree_new(
            self.spec.p.to_bytes(32, "little"), _pack(leaves), n, blob,
            len(blob),
        )

    def __del__(self):
        # guard against interpreter-shutdown teardown ordering
        h = getattr(self, "_h", None)
        l = getattr(self, "_lib", None)
        if h and l is not None:
            try:
                l.ecn_tree_free(h)
            except TypeError:
                pass
            self._h = None

    def _io(self, fname, vals, out_count, *extra):
        out = ctypes.create_string_buffer(32 * out_count)
        getattr(lib(), fname)(self._h, _pack(vals), len(vals), *extra, out)
        return _unpack(out.raw)

    def enter(self, coeffs: list[int]) -> list[int]:
        return self._io("ecn_enter", coeffs, len(coeffs))

    def exit(self, evals: list[int]) -> list[int]:
        return self._io("ecn_exit", evals, len(evals))

    def extend(self, evals: list[int], moiety: int) -> list[int]:
        return self._io("ecn_extend", evals, len(evals), moiety)

    def mextend(self, evals: list[int], moiety: int) -> list[int]:
        return self._io("ecn_mextend", evals, len(evals), moiety)

    def degree(self, evals: list[int]) -> int:
        return int(lib().ecn_degree(self._h, _pack(evals), len(evals)))

    def redc_z0(self, evals: list[int], a: list[int]) -> list[int]:
        out = ctypes.create_string_buffer(32 * len(evals))
        lib().ecn_redc(self._h, _pack(evals), _pack(a), len(evals), 0, out)
        return _unpack(out.raw)

    def redc_z1(self, evals: list[int], a: list[int]) -> list[int]:
        out = ctypes.create_string_buffer(32 * len(evals))
        lib().ecn_redc(self._h, _pack(evals), _pack(a), len(evals), 1, out)
        return _unpack(out.raw)

    def modular_reduce(self, evals, a, c) -> list[int]:
        out = ctypes.create_string_buffer(32 * len(evals))
        lib().ecn_mod(self._h, _pack(evals), _pack(a), _pack(c), len(evals),
                      out)
        return _unpack(out.raw)

    def vanish(self, points: list[int]) -> list[int]:
        out = ctypes.create_string_buffer(32 * 2 * len(points))
        lib().ecn_vanish(self._h, _pack(points), len(points), out)
        return _unpack(out.raw)

    def table(self, size: int, name: str) -> list[int]:
        cnt = lib().ecn_table(self._h, size, TABLE_IDS[name], None)
        out = ctypes.create_string_buffer(32 * cnt)
        lib().ecn_table(self._h, size, TABLE_IDS[name], out)
        return _unpack(out.raw)

    def eval_domain(self, size: int | None = None) -> list[int]:
        return self.table(size or self.n, "leaves")

    def mats(self, size: int, depth: int, which: int) -> list[int]:
        cnt = lib().ecn_mats(self._h, size, depth, which, None)
        out = ctypes.create_string_buffer(32 * 4 * cnt)
        lib().ecn_mats(self._h, size, depth, which, out)
        return _unpack(out.raw)

    def layer(self, li: int) -> list[int]:
        cnt = lib().ecn_layer(self._h, li, None)
        out = ctypes.create_string_buffer(32 * cnt)
        lib().ecn_layer(self._h, li, out)
        return _unpack(out.raw)


def batch_inv_limbs(spec: FieldSpec, arr: np.ndarray) -> np.ndarray:
    """Batched modular inverse of an (N, L) uint32 16-bit-limb array via
    the native engine (Montgomery's trick, ~3 muls/element) — serves the
    pool build's scaled-extend tables where a pure-XLA product scan on
    CPU costs minutes at n=2^16. Requires 16-bit limbs and p < 2^256."""
    assert spec.limb_bits == 16 and spec.num_limbs <= 16
    n, L = arr.shape
    rows = np.zeros((n, 16), dtype=np.uint16)
    rows[:, :L] = arr.astype(np.uint16)
    buf = rows.tobytes()
    out = ctypes.create_string_buffer(32 * n)
    lib().ecn_batch_inv(spec.p.to_bytes(32, "little"), buf, n, out)
    res = np.frombuffer(out.raw, dtype=np.uint16).reshape(n, 16)
    return res[:, :L].astype(np.uint32)


def _ints_to_limbs(spec: FieldSpec, vals: list[int]) -> np.ndarray:
    """Bulk canonical ints → (n, L) uint32 limb array, vectorized via a
    byte view (no per-element python loop)."""
    raw = b"".join(int(v).to_bytes(32, "little") for v in vals)
    arr = np.frombuffer(raw, dtype=np.uint16).reshape(len(vals), 16)
    out = arr.astype(np.uint32)
    if spec.num_limbs == 1:  # m31: single packed limb
        merged = out[:, 0] | (out[:, 1] << 16)
        return merged.reshape(-1, 1)
    return out[:, : spec.num_limbs]


def build_fftree_native(field: str | FieldSpec, n: int):
    """Build the device FFTree with the native engine doing the whole
    O(n log³ n) bootstrap (single-core, ~100 ns/mul), then lift the
    tables straight into device arrays.

    This is the fast construction path for large n — the JAX bootstrap
    (ecfft_tpu/fftree.py) remains the fully-on-device path and the two
    must agree bit-for-bit (tested)."""
    import jax.numpy as jnp

    from ecfft_tpu.fftree import FFTree

    spec = FIELDS[field] if isinstance(field, str) else field
    dom = build_domain(spec, n)
    if dom is None:
        return None
    leaves, maps = dom
    nt = NativeFFTree(spec, n, leaves, maps)

    tables: dict[int, dict] = {}
    m = 2
    while m <= n:
        t: dict = {}
        for name in TABLE_IDS:
            t[name] = jnp.asarray(_ints_to_limbs(spec, nt.table(m, name)))
        depths = max(m.bit_length() - 2, 0)
        mats = []
        for d in range(depths):
            parts = []
            for which in range(4):
                flat = _ints_to_limbs(spec, nt.mats(m, d, which))
                parts.append(
                    jnp.asarray(flat.reshape(-1, 2, 2, spec.num_limbs))
                )
            mats.append(tuple(parts))
        t["mats"] = mats
        tables[m] = t
        m *= 2

    tree = FFTree(spec, n, tables)
    tree.f_layers = [nt.layer(li) for li in range(n.bit_length())]
    tree.maps = maps
    return tree


def mont_mul_ns(field: str = "secp256k1", iters: int = 2_000_000) -> float:
    """Measured single-core Montgomery-mul latency (ns) — the baseline
    constant for bench.py's vs_baseline."""
    import time

    spec = FIELDS[field]
    p_bytes = spec.p.to_bytes(32, "little")
    t0 = time.perf_counter()
    lib().ecn_mul_throughput(p_bytes, iters)
    return (time.perf_counter() - t0) / iters * 1e9


if __name__ == "__main__":
    build_native()
    print("built", _SO)


def find_curve_parallel(p: int, k: int, threads: int = 10,
                        seed: int = 1, chunk: int = 20000):
    """Race ``threads`` native searches with distinct seeds and return the
    first hit — the reference's rayon fan-out example
    (examples/find_curve.rs:11-36) on top of the C++ engine. Each thread
    searches in finite chunks (ctypes releases the GIL during the C call)
    and stops once any thread has found a curve."""
    import concurrent.futures as cf
    import threading

    found: list = []
    lock = threading.Lock()

    def worker(t: int):
        s = seed + 1000003 * t
        while True:
            with lock:
                if found:
                    return None
            r = find_curve_native(p, k, s, chunk)
            if r is not None:
                with lock:
                    found.append(r)
                return r
            s += 777767777

    with cf.ThreadPoolExecutor(max_workers=threads) as ex:
        futs = [ex.submit(worker, t) for t in range(threads)]
        for f in cf.as_completed(futs):
            pass
    return max(found, key=lambda r: r[0]) if found else None


def find_curve_native(p: int, k: int, seed: int = 1,
                      max_iters: int = 0):
    """Native FIND_CURVE (find_curve.rs:224-246 at C++ speed): returns
    (n, a, B, gen_x, gen_y) with n ≥ k the 2-adicity of the cyclic
    2-Sylow generator, or None if max_iters exhausted. ~1000× the python
    search throughput — practical for 256-bit primes and larger k."""
    bufs = [ctypes.create_string_buffer(32) for _ in range(4)]
    n = lib().ecn_find_curve(p.to_bytes(32, "little"), k, seed, max_iters,
                             *bufs)
    if n == 0:
        return None
    a, bb, x, y = (int.from_bytes(b.raw, "little") for b in bufs)
    return int(n), a, bb, x, y


def schoof_trace_native(p: int, a: int, b: int, ell: int) -> int:
    """Frobenius trace t mod ell of y² = x³ + ax + b over F_p, computed
    by the native engine's endomorphism arithmetic in F_p[x]/ψ_ℓ
    (schoofs.rs:76-138; ℓ=2 parity test schoofs.rs:345-366). 4×64
    Montgomery field ops make this practical far beyond the pure-python
    path's ~64-bit ceiling (see ecfft_tpu.schoof.cardinality_native)."""
    t = lib().ecn_schoof_trace(
        p.to_bytes(32, "little"),
        (a % p).to_bytes(32, "little"),
        (b % p).to_bytes(32, "little"),
        ell,
    )
    if t < 0:
        raise ArithmeticError(f"native schoof trace failed for l={ell}")
    return int(t)
