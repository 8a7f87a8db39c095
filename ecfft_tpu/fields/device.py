"""Device (JAX) prime-field arithmetic on limb tensors.

This replaces the reference's dependency on arkworks' Montgomery backend
(`Fp256<MontBackend<..,4>>`, src/lib.rs:37 of the reference) with a
limb-tensor representation:

- A field-element batch of shape ``(...,)`` is a ``uint32`` array of shape
  ``(..., L)`` holding L limbs of 16 bits each. 16-bit limbs make every
  partial product exact in a u32 lane with no 64-bit arithmetic, and
  column sums stay far below 2^32 so carries can be fully deferred.
- secp256k1 (p = 2^256 − 2^32 − 977) uses L=16 limbs in **canonical** form
  with pseudo-Mersenne reduction: 2^256 ≡ 2^32 + 977 (mod p), so the high
  half of a product folds into the low half with two sparse
  multiply-shift-adds. No Montgomery form, no sequential carry chains.
- M31 (p = 2^31 − 1) uses an L=1 fast path with shift-add Mersenne
  reduction.

Design notes (why this shape of code):
- **No scalar loops, no lax.scan in the hot path.** Every op below is a
  whole-tensor VPU op; carry propagation is O(log L) via carry-lookahead
  ``associative_scan`` rather than an O(L) ripple chain. This keeps both
  the XLA op count (compile time) and the critical path (runtime) small.
- **Anti-diagonal convolution by reshape.** The limb product columns
  c_k = Σ_{i+j=k} a_i·b_j are computed from the (L, L) outer product by a
  pad/flatten/reshape stagger — a classic dense-linear-algebra trick that
  XLA turns into pure data movement.
- All ops are shape-polymorphic over leading batch dims, pure, and
  jit/vmap/shard_map-friendly. The Pallas step kernel in
  ``ecfft_tpu/ops/pallas_step.py`` fuses the same math for the hot
  schedule step on the GPU; this module is the portable XLA path and the
  semantic ground truth.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ecfft_tpu.fields.registry import LIMB_MASK, M31_P, FieldSpec

MASK = jnp.uint32(LIMB_MASK)


# --------------------------------------------------------------------------
# host <-> device conversion


def encode(spec: FieldSpec, values) -> jnp.ndarray:
    """Python ints → device limb array (canonical form).

    ``values`` may be an int, a flat list, or a nested list; the result has
    one extra trailing limb axis of size ``spec.num_limbs``. Vectorized via
    a byte view — one ``to_bytes`` call per element, no per-limb loop.
    """
    arr = np.asarray(values, dtype=object)
    flat = arr.reshape(-1)
    nbytes = 4 if spec.limb_bits > 16 else 2 * spec.num_limbs
    raw = b"".join(
        (int(v) % spec.p).to_bytes(nbytes, "little") for v in flat
    )
    if spec.limb_bits > 16:
        out = np.frombuffer(raw, "<u4").astype(np.uint32).reshape(-1, 1)
    else:
        out = (
            np.frombuffer(raw, "<u2")
            .astype(np.uint32)
            .reshape(-1, spec.num_limbs)
        )
    return jnp.asarray(out.reshape(arr.shape + (spec.num_limbs,)))


def decode(spec: FieldSpec, limbs) -> np.ndarray:
    """Device limb array → object array of python ints (vectorized byte
    route: one ``from_bytes`` call per element)."""
    arr = np.asarray(limbs, dtype=np.uint32)
    shape = arr.shape[:-1]
    flat = np.ascontiguousarray(arr.reshape(-1, spec.num_limbs))
    if spec.limb_bits > 16:
        raw = flat.astype("<u4").tobytes()
        fs = 4 * spec.num_limbs
    else:
        raw = flat.astype("<u2").tobytes()
        fs = 2 * spec.num_limbs
    out = np.empty(flat.shape[0], dtype=object)
    for i in range(flat.shape[0]):
        out[i] = int.from_bytes(raw[i * fs : (i + 1) * fs], "little")
    return out.reshape(shape)


def zeros(spec: FieldSpec, shape=()) -> jnp.ndarray:
    return jnp.zeros((*shape, spec.num_limbs), dtype=jnp.uint32)


def ones(spec: FieldSpec, shape=()) -> jnp.ndarray:
    return jnp.broadcast_to(encode(spec, 1), (*shape, spec.num_limbs))


def _p_limbs(spec: FieldSpec) -> jnp.ndarray:
    return jnp.asarray(spec.to_limbs(spec.p), dtype=jnp.uint32)


def _is_m31(spec: FieldSpec) -> bool:
    return spec.num_limbs == 1 and spec.p == M31_P


# --------------------------------------------------------------------------
# M31 fast path: single uint32 limb, Mersenne shift-add reduction


_M31 = jnp.uint32(M31_P)


def _m31_canon(x):
    # input < 2^32; fold twice then subtract once: result in [0, p)
    x = (x & _M31) + (x >> 31)
    x = (x & _M31) + (x >> 31)
    return jnp.where(x >= _M31, x - _M31, x)


def _m31_add(a, b):
    s = a + b  # < 2p < 2^32
    return jnp.where(s >= _M31, s - _M31, s)


def _m31_sub(a, b):
    return jnp.where(a >= b, a - b, a + (_M31 - b))


def _m31_mul(a, b):
    """Full 62-bit product via 16-bit splits, Mersenne-reduced.

    a·b = t0 + mid·2^16 + hi·2^32 with every intermediate exact in uint32;
    then x ≡ (x mod 2^31) + (x >> 31)  (mod 2^31 − 1).
    """
    a_lo = a & MASK
    a_hi = a >> 16  # < 2^15
    b_lo = b & MASK
    b_hi = b >> 16
    t0 = a_lo * b_lo  # < 2^32, exact
    mid = a_lo * b_hi + a_hi * b_lo  # < 2^32 − 2^17 + 2, exact
    hi = a_hi * b_hi  # < 2^30
    s = (t0 >> 16) + mid  # < 2^32, exact
    lo32 = (t0 & MASK) | ((s & MASK) << 16)
    hi30 = (s >> 16) + hi  # full value = hi30·2^32 + lo32 < 2^62
    # hi30·2^32 ≡ 2·hi30 ; lo32 = (lo32>>31)·2^31 + low31 ≡ (lo32>>31) + low31
    r = 2 * hi30 + (lo32 >> 31) + (lo32 & _M31)
    return _m31_canon(r)


# --------------------------------------------------------------------------
# generic multi-limb machinery (pseudo-Mersenne primes)
#
# Value model: a number is a vector of uint32 "columns", value = Σ c_k·2^16k.
# Canonical means every column < 2^16. Intermediate columns may hold up to
# 2^32 − 1; every step documents its bound.


def _carry_normalize(c: jnp.ndarray) -> jnp.ndarray:
    """Columns (any values < 2^32) → canonical columns, width + 1.

    Phase 1 is a single ripple step (c_k & mask) + (c_{k-1} >> 16) after
    which every column is < 2^16 + 2^16 = 2^17, so remaining carries are
    boolean. Phase 2 resolves them with O(log W) carry-lookahead:
    carry_into_k = g_{k-1} ∨ (p_{k-1} ∧ carry_into_{k-1}) computed by an
    inclusive ``associative_scan`` over (generate, propagate) pairs.
    """
    g = c >> 16
    lo = c & MASK
    zero_col = jnp.zeros_like(g[..., :1])
    # widen by one: top carries land in a fresh column
    t1 = jnp.concatenate([lo, zero_col], -1) + jnp.concatenate([zero_col, g], -1)

    g2 = t1 >> 16  # boolean: t1 < 2^17
    p2 = (t1 & MASK) == MASK

    def combine(lhs, rhs):
        g1, p1 = lhs
        gr, pr = rhs
        return gr | (pr & g1), pr & p1

    G, _ = jax.lax.associative_scan(combine, (g2.astype(bool), p2), axis=-1)
    carry_in = jnp.concatenate(
        [jnp.zeros_like(G[..., :1]), G[..., :-1]], -1
    ).astype(jnp.uint32)
    return (t1 + carry_in) & MASK


def _stagger_sum(m: jnp.ndarray, L: int) -> jnp.ndarray:
    """Anti-diagonal sums of (..., L, L): out_k = Σ_i m[i, k−i], width 2L−1.

    Implemented as pad-to-(L,2L) → flatten → drop the last L elements →
    reshape (L, 2L−1): row i of the reshape is row i of the original
    shifted right by i (row-major index arithmetic), so a plain sum over
    rows yields the anti-diagonal (convolution) columns. Pure data
    movement + one reduction; no gathers.
    """
    batch = m.shape[:-2]
    pad = [(0, 0)] * len(batch) + [(0, 0), (0, L)]
    mp = jnp.pad(m, pad)  # (..., L, 2L)
    flat = mp.reshape(*batch, 2 * L * L)
    flat = flat[..., : L * (2 * L - 1)]
    st = flat.reshape(*batch, L, 2 * L - 1)
    return st.sum(axis=-2, dtype=jnp.uint32)


def _conv_columns(a: jnp.ndarray, b: jnp.ndarray, L: int) -> jnp.ndarray:
    """Product columns of two canonical limb vectors: width 2L, cols < 2^21.

    Partial products are split into 16-bit halves *before* column
    accumulation so each column sums ≤ 2L terms of < 2^16 — far below
    uint32 overflow, with zero sequential carries.
    """
    prods = a[..., :, None] * b[..., None, :]  # (..., L, L) exact uint32
    lo = prods & MASK
    hi = prods >> 16
    c_lo = _stagger_sum(lo, L)  # width 2L−1, < L·2^16
    c_hi = _stagger_sum(hi, L)  # width 2L−1, < L·2^16
    zero_col = jnp.zeros_like(c_lo[..., :1])
    # hi columns shift up by one limb
    return jnp.concatenate([c_lo, zero_col], -1) + jnp.concatenate(
        [zero_col, c_hi], -1
    )  # width 2L, cols < 2^21


def _fold(c: jnp.ndarray, spec: FieldSpec) -> jnp.ndarray:
    """Fold columns ≥ L back into the low half using 2^(16L) ≡ R mod p.

    With fold terms {(off_t, d_t)}: value = lo + hi·Σ d_t·2^16·off_t, so
    each high column block re-enters at offset off_t scaled by the digit
    d_t. Digit bound (Σ d_t < 2^11, checked in FieldSpec) keeps every
    product < 2^32 even for non-canonical inputs < 2^21.
    """
    L = spec.num_limbs
    w = c.shape[-1]
    assert w > L
    lo = c[..., :L]
    hi = c[..., L:]
    hw = w - L
    out_w = max(L, max(off for off, _ in spec.fold_terms) + hw)
    batch = c.shape[:-1]

    def place(x, off):
        pre = jnp.zeros((*batch, off), dtype=jnp.uint32)
        post = jnp.zeros((*batch, out_w - off - x.shape[-1]), dtype=jnp.uint32)
        return jnp.concatenate([pre, x, post], -1)

    out = place(lo, 0)
    for off, digit in spec.fold_terms:
        out = out + place(hi * jnp.uint32(digit), off)
    return out


def _cond_sub_p(spec: FieldSpec, x: jnp.ndarray, extra_bit: jnp.ndarray):
    """x (canonical, width L) minus p if extra_bit·2^(16L) + x ≥ p.

    Subtraction by complement-add: y = x + (2^(16L) − p); its carry-out is
    exactly the predicate x ≥ p. Single conditional subtract suffices for
    all callers (values < 2p).
    """
    L = spec.num_limbs
    comp = jnp.asarray(spec.to_limbs((1 << (16 * L)) - spec.p), dtype=jnp.uint32)
    s = x + comp
    y = _carry_normalize(s)  # width L+1
    need = (extra_bit > 0) | (y[..., L] > 0)
    return jnp.where(need[..., None], y[..., :L], x)


def _gen_add(spec: FieldSpec, a, b):
    s = _carry_normalize(a + b)  # width L+1, top ∈ {0,1}
    L = spec.num_limbs
    return _cond_sub_p(spec, s[..., :L], s[..., L])


def _gen_sub(spec: FieldSpec, a, b):
    """a − b via complement: a + (2^(16L) − 1 − b) + 1 + p = a − b + p + R."""
    L = spec.num_limbs
    p_limbs = _p_limbs(spec)
    one_hot = jnp.zeros((L,), dtype=jnp.uint32).at[0].set(1)
    s = a + (MASK - b) + p_limbs + one_hot  # cols < 3·2^16 ✓
    y = _carry_normalize(s)  # width L+1; top = 1 + (a−b+p ≥ R) ∈ {1,2}
    return _cond_sub_p(spec, y[..., :L], y[..., L] - 1)


def _gen_mul(spec: FieldSpec, a, b):
    """Canonical × canonical → canonical, pseudo-Mersenne reduction.

    conv (width 2L, <2^21) → fold (<2^32) → normalize → fold → normalize.
    After two folds the value is < 2^(16L) + 2^(2d+2) (d = bit-length of
    R mod p), so the top column is a single bit consumed by the final
    conditional subtract.
    """
    L = spec.num_limbs
    c = _conv_columns(a, b, L)
    c = _carry_normalize(_fold(c, spec))
    c = _carry_normalize(_fold(c, spec))
    # width is now ≥ L+1 with at most one set bit above column L−1
    slack = 16 * L - spec.p.bit_length()
    if slack == 0:
        top = c[..., L:].sum(axis=-1, dtype=jnp.uint32)
        return _cond_sub_p(spec, c[..., :L], top)
    # p may be several bits below R (e.g. 2^61−1 in 4 limbs): the value
    # after folding is < 2R < 2^(slack+2)·p, so run a binary subtract
    # chain 2^j·p, j = slack..0 (plus one extra unit step) on the
    # (L+1)-wide columns.
    return _reduce_slack(spec, c[..., : L + 1])


def _reduce_slack(spec: FieldSpec, cols):
    """Reduce a canonical (L+1)-column value < 2^(slack+2)·p into [0, p)
    by the standard binary chain: for j = slack+1 .. 0, conditionally
    subtract p·2^j (invariant: value < p·2^(j+1) entering step j).
    Subtraction is complement-add; the carry-out bit is the ≥ predicate.
    """
    L = spec.num_limbs
    W = L + 1
    slack = 16 * L - spec.p.bit_length()
    x = cols
    for j in range(slack + 1, -1, -1):
        comp = jnp.asarray(
            [((1 << (16 * W)) - (spec.p << j)) >> (16 * i) & 0xFFFF
             for i in range(W)],
            dtype=jnp.uint32,
        )
        y = _carry_normalize(x + comp)  # width W+1; top bit = (x ≥ p·2^j)
        need = y[..., W] > 0
        x = jnp.where(need[..., None], y[..., :W], x)
    return x[..., :L]


def _mont_reduce_once(spec: FieldSpec, c):
    """Word-serial Montgomery reduction of product columns (< 2^22) as a
    ``lax.scan``: returns value·R⁻¹ mod p, canonical."""
    L = spec.num_limbs
    n_prime = jnp.uint32(spec.n_prime)
    p_limbs = _p_limbs(spec)
    pad = jnp.zeros_like(c[..., :1])
    state = jnp.concatenate([c, pad], axis=-1)  # (..., 2L+1)

    def body(t, _):
        m = (t[..., 0] * n_prime) & MASK
        mp = m[..., None] * p_limbs  # (..., L) exact
        lo = mp & MASK
        hi = mp >> 16
        add = jnp.zeros_like(t)
        add = add.at[..., :L].add(lo)
        add = add.at[..., 1 : L + 1].add(hi)
        t = t + add
        carry = (t[..., 0] >> 16)
        t = jnp.concatenate(
            [t[..., 1:], jnp.zeros_like(t[..., :1])], axis=-1
        )
        t = t.at[..., 0].add(carry)
        return t, None

    state, _ = jax.lax.scan(body, state, None, length=L)
    res = _carry_normalize(state[..., : L + 1])  # canonical + top bits
    top = res[..., L:].sum(axis=-1, dtype=jnp.uint32)
    return _cond_sub_p(spec, res[..., :L], top)


def _mont_reduce_scan(spec: FieldSpec, c):
    """Product columns → canonical product: Montgomery-reduce (·R⁻¹) then
    Montgomery-multiply by the precomputed R² to cancel the factor.
    Generic-prime fallback for fold-unfriendly moduli; columns stay < 2^22
    throughout (deferred-carry argument as in the pseudo-Mersenne path)."""
    L = spec.num_limbs
    red = _mont_reduce_once(spec, c)
    r2 = jnp.asarray(spec.to_limbs(spec.r2_mod_p), dtype=jnp.uint32)
    return _mont_reduce_once(spec, _conv_columns(red, r2, L))


def _mont_mul_scan(spec: FieldSpec, a, b):
    """Generic-prime fallback multiply (see _mont_reduce_scan)."""
    return _mont_reduce_scan(spec, _conv_columns(a, b, spec.num_limbs))


# --------------------------------------------------------------------------
# public field ops (dispatch on spec)


def add(spec: FieldSpec, a, b):
    if _is_m31(spec):
        return _m31_add(a, b)
    return _gen_add(spec, a, b)


def sub(spec: FieldSpec, a, b):
    if _is_m31(spec):
        return _m31_sub(a, b)
    return _gen_sub(spec, a, b)


def neg(spec: FieldSpec, a):
    return sub(spec, jnp.zeros_like(a), a)


def mul(spec: FieldSpec, a, b):
    if _is_m31(spec):
        return _m31_mul(a, b)
    if spec.fold_terms is not None:
        return _gen_mul(spec, a, b)
    return _mont_mul_scan(spec, a, b)


def square(spec: FieldSpec, a):
    return mul(spec, a, a)


def pow_int(spec: FieldSpec, a, e: int):
    """a^e for a python-int exponent, square-and-multiply.

    Long exponents run as a ``lax.scan`` over the bit string (small HLO,
    one fused step per bit); short ones unroll for fusion.
    """
    if e == 0:
        return ones(spec, a.shape[:-1])
    bits = [(e >> i) & 1 for i in range(e.bit_length())]
    if len(bits) <= 16:
        acc = a
        res = None
        for i, bit in enumerate(bits):
            if bit:
                res = acc if res is None else mul(spec, res, acc)
            if i + 1 < len(bits):
                acc = square(spec, acc)
        return res
    bits_arr = jnp.asarray(bits, dtype=jnp.uint32)
    one = ones(spec, a.shape[:-1])

    def body(carry, bit):
        acc, res = carry
        res = jnp.where(bit > 0, mul(spec, res, acc), res)
        acc = square(spec, acc)
        return (acc, res), None

    (_, res), _ = jax.lax.scan(body, (a, one), bits_arr)
    return res


def inv(spec: FieldSpec, a):
    """Batched inversion via Fermat: a^(p−2), fully parallel.

    Replaces ark_ff::batch_inversion (fftree.rs:330-333 etc.): the
    sequential Montgomery trick is hostile to vector units, while
    per-element Fermat is embarrassingly parallel — the data-parallel choice.
    Maps 0 → 0 (matching arkworks batch_inversion's skip-zeros semantics).
    """
    r = pow_int(spec, a, spec.p - 2)
    is_zero = jnp.all(a == 0, axis=-1, keepdims=True)
    return jnp.where(is_zero, jnp.zeros_like(r), r)


def muladd2(spec: FieldSpec, a1, x1, a2, x2):
    """Fused a1·x1 + a2·x2 — the schedule-machine step primitive.

    Column sums of both products are added BEFORE the fold/normalize
    chain (columns < 2·L·2^16 < 2^22, still uint32-safe), so the whole
    affine step costs one reduction instead of two muls plus an add —
    roughly 3× fewer normalization passes over the state.
    """
    if _is_m31(spec):
        return _m31_add(_m31_mul(a1, x1), _m31_mul(a2, x2))
    L = spec.num_limbs
    if spec.fold_terms is None:
        c = _conv_columns(a1, x1, L) + _conv_columns(a2, x2, L)
        return _mont_reduce_scan(spec, c)
    # fold-digit bound for the doubled columns: Σd·2^22 must stay < 2^32
    assert sum(d for _, d in spec.fold_terms) < (1 << 10), (
        "fold digits too large for the fused path; use mul+add"
    )
    c = _conv_columns(a1, x1, L) + _conv_columns(a2, x2, L)
    c = _carry_normalize(_fold(c, spec))
    c = _carry_normalize(_fold(c, spec))
    slack = 16 * L - spec.p.bit_length()
    if slack == 0:
        top = c[..., L:].sum(axis=-1, dtype=jnp.uint32)
        return _cond_sub_p(spec, c[..., :L], top)
    return _reduce_slack(spec, c[..., : L + 1])


def eq(spec: FieldSpec, a, b):
    """Elementwise equality, reduced over the limb axis."""
    return jnp.all(a == b, axis=-1)


def mat2_apply(spec: FieldSpec, m, v0, v1):
    """Batched 2×2 matrix–vector product over the field.

    ``m`` has shape (..., 2, 2, L), ``v0``/``v1`` shape (..., L). Returns
    (m00·v0 + m01·v1, m10·v0 + m11·v1) — the inner loop of EXTEND
    (/root/reference/src/fftree.rs:83-118 matrix sweeps).

    One stacked mul + one stacked add (rather than 4 + 2): fewer, larger
    tensor ops — the XLA-friendly way to keep both compile time and
    kernel-launch overhead down at identical FLOPs.
    """
    v = jnp.stack([v0, v1], axis=-2)[..., None, :, :]  # (..., 1, 2, L)
    prods = mul(spec, m, v)  # (..., 2, 2, L)
    r = add(spec, prods[..., 0, :], prods[..., 1, :])  # (..., 2, L)
    return r[..., 0, :], r[..., 1, :]
