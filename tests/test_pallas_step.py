"""Triton-route step kernels: interpret-mode exactness against python
ints (the compiled kernels are compared with the XLA step math on the
card by chip_smoke.py and by the ``gpu``-marked test below)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest

from ecfft_tpu.fields import device as fd
from ecfft_tpu.fields.registry import FIELDS, spec_for_prime
from ecfft_tpu.ntt import STARK_P
from ecfft_tpu.ops import pallas_step as ps

SPECS = {
    "secp256k1": FIELDS["secp256k1"],  # pseudo-Mersenne fold path
    "stark": spec_for_prime(STARK_P, "stark_step_test"),  # CIOS path
    # a 256-bit prime (2p > R) with large digits in R mod p: CIOS with the
    # two conditional subtracts (2p, then p)
    "slack0": spec_for_prime(2**255 + 95, "slack0_step_test"),
}
W, A, START = 32, 16, 8


def _r_inv(spec):
    """The Montgomery path computes on value·R residents: one product
    picks up R⁻¹ (composing with the schedule's conversions, exact)."""
    if spec.fold_terms is not None:
        return 1
    return pow(1 << (16 * spec.num_limbs), -1, spec.p)


def _state(spec, rows, B, rng, vals=None):
    vals = vals or [[rng.randrange(spec.p) for _ in range(B)]
                    for _ in range(rows)]
    return vals, jnp.transpose(fd.encode(spec, vals), (0, 2, 1))


def _decode(spec, out):
    return fd.decode(spec, jnp.transpose(out, (0, 2, 1)))


def _check(got, st_i, start, rows, want):
    """Window rows hold want(q, b); every other row is untouched."""
    for w, row in enumerate(got):
        for b, v in enumerate(row):
            if start <= w < start + rows:
                assert v == want(w - start, b), (w, b)
            else:
                assert v == st_i[w][b], (w, b)


def _aff1s(field, seed, start=START):
    """OP_AFF1S: state[start+q] ← state[start+q] + C·x2, x1 read from the
    state window itself."""
    spec = SPECS[field]
    p, ri = spec.p, _r_inv(spec)
    rng = random.Random(seed)
    st_i, state = _state(spec, W, 4, rng)
    x2_i, x2 = _state(spec, A, 4, rng)
    C_i = [rng.randrange(p) for _ in range(A)]
    out = ps.pallas_aff1s_ip(spec, fd.encode(spec, C_i), state, x2,
                             jnp.int32(start), True)
    _check(_decode(spec, out), st_i, start, A,
           lambda q, b: (st_i[start + q][b] + C_i[q] * x2_i[q][b] * ri) % p)


def _aff1g(field, seed, start=START):
    """OP_AFF1: state[start+q] ← x1 + C·x2 with a gathered x1."""
    spec = SPECS[field]
    p, ri = spec.p, _r_inv(spec)
    rng = random.Random(seed)
    st_i, state = _state(spec, W, 4, rng)
    x1_i, x1 = _state(spec, A, 4, rng)
    x2_i, x2 = _state(spec, A, 4, rng)
    C_i = [rng.randrange(p) for _ in range(A)]
    out = ps.pallas_aff1g_ip(spec, fd.encode(spec, C_i), state, x1, x2,
                             jnp.int32(start), True)
    _check(_decode(spec, out), st_i, start, A,
           lambda q, b: (x1_i[q][b] + C_i[q] * x2_i[q][b] * ri) % p)


def _aff2g(field, seed, start=START):
    """OP_AFFINE: state[start+q] ← A·x1 + B·x2."""
    spec = SPECS[field]
    p, ri = spec.p, _r_inv(spec)
    rng = random.Random(seed)
    st_i, state = _state(spec, W, 4, rng)
    x1_i, x1 = _state(spec, A, 4, rng)
    x2_i, x2 = _state(spec, A, 4, rng)
    A_i = [rng.randrange(p) for _ in range(A)]
    B_i = [rng.randrange(p) for _ in range(A)]
    out = ps.pallas_aff2g_ip(spec, fd.encode(spec, A_i), fd.encode(spec, B_i),
                             state, x1, x2, jnp.int32(start), True)
    _check(_decode(spec, out), st_i, start, A,
           lambda q, b: (A_i[q] * x1_i[q][b] + B_i[q] * x2_i[q][b]) * ri % p)


def test_pallas_muladd2_matches_ints():
    """A·x1 + B·x2 on the fold path (secp256k1)."""
    _aff2g("secp256k1", 3)


def test_pallas_mont_kernel_matches_ints():
    """Fold-unfriendly prime (the comparison bench's STARK prime): the CIOS
    kernel computes (A·x1 + B·x2)·R⁻¹ on Montgomery-form residents, which
    composes with the schedule's entry/exit conversions to exact field
    arithmetic."""
    assert SPECS["stark"].fold_terms is None
    _aff2g("stark", 7)


def test_pallas_muladd1_matches_ints():
    """The 1-mul step x1 + C·x2 (scaled butterfly levels)."""
    _aff1g("secp256k1", 11)


def test_pallas_muladd1_mont_matches_ints():
    """Montgomery variant: x1 + (C·x2)·R⁻¹ on Montgomery residents."""
    _aff1g("stark", 13)


def test_pallas_inplace_aff1s_matches_ints():
    """In-place self-read 1-mul step (OP_AFF1S): the window
    [start, start+A) becomes state + C·x2 and every row outside it is
    untouched."""
    _aff1s("secp256k1", 17)


def test_pallas_inplace_aff1s_mont_matches_ints():
    _aff1s("stark", 19)


def test_pallas_inplace_aff1g_and_aff2g_match_ints():
    """In-place gathered-x1 variants (OP_AFF1 / OP_AFFINE) at a window
    start that is not the default one."""
    _aff1g("secp256k1", 19, start=16)
    _aff2g("secp256k1", 23, start=16)


def test_pallas_muladd2_edge_values():
    """Carry and conditional-subtract extremes on the fold path: 0, 1,
    p−1, p−2, limb boundaries."""
    spec = SPECS["secp256k1"]
    p = spec.p
    E = [0, 1, p - 1, p - 2, p // 2, 2**16, 2**255 % p, (p - 1) // 2] * 2
    rng = random.Random(29)
    st_i, state = _state(spec, W, 4, rng)
    _, xe = _state(spec, A, 4, rng, vals=[[v] * 4 for v in E])
    ce = fd.encode(spec, E)
    out = ps.pallas_aff2g_ip(spec, ce, ce, state, xe, xe, jnp.int32(START),
                             True)
    _check(_decode(spec, out), st_i, START, A,
           lambda q, b: 2 * E[q] * E[q] % p)


def _edges(spec):
    """16 canonical values at the reduction's extremes: 0, 1, p−1, p−2,
    (p±1)/2, R mod p, R² mod p, the top limb at p's and one below it
    with every lower limb full, limb boundaries."""
    p, L = spec.p, spec.num_limbs
    top = (p >> (16 * (L - 1))) << (16 * (L - 1))
    E = [0, 1, 2, p - 1, p - 2, p - 3, (p - 1) // 2, (p + 1) // 2,
         spec.r_mod_p, spec.r2_mod_p, top - 1, top, 2**16 - 1, 2**16,
         2**(16 * (L - 1)) - 1, p - 2**16]
    assert len(E) == A and all(0 <= v < p for v in E)
    return E


@pytest.mark.parametrize("field", ["stark", "slack0"])
@pytest.mark.parametrize("variant", ["aff2g", "aff1g", "aff1s"])
def test_pallas_mont_edge_values(field, variant):
    """The CIOS kernels with edge values in both operands of every
    product (coefficient row q against lane b), against python ints."""
    spec = SPECS[field]
    p, ri = spec.p, _r_inv(spec)
    assert spec.fold_terms is None
    E = _edges(spec)
    n = len(E)
    rng = random.Random(37)
    st_i, state = _state(spec, W, n, rng)
    xe_i, xe = _state(spec, A, n, rng, vals=[list(E) for _ in range(A)])
    xs_i, xs = _state(spec, A, n, rng, vals=[
        [E[(q + b) % n] for b in range(n)] for q in range(A)])
    ce = fd.encode(spec, E)
    s = jnp.int32(START)
    if variant == "aff2g":
        cs = fd.encode(spec, [E[(q + 5) % n] for q in range(A)])
        out = ps.pallas_aff2g_ip(spec, ce, cs, state, xe, xs, s, True)
        want = (lambda q, b: (E[q] * E[b] + E[(q + 5) % n]
                              * E[(q + b) % n]) * ri % p)
    elif variant == "aff1g":
        out = ps.pallas_aff1g_ip(spec, ce, state, xs, xe, s, True)
        want = (lambda q, b: (E[(q + b) % n] + E[q] * E[b] * ri) % p)
    else:
        st_i[START:START + A] = xs_i
        state = state.at[START:START + A].set(xs)
        out = ps.pallas_aff1s_ip(spec, ce, state, xe, s, True)
        want = (lambda q, b: (E[(q + b) % n] + E[q] * E[b] * ri) % p)
    _check(_decode(spec, out), st_i, START, A, want)


@pytest.mark.parametrize("field", ["stark", "slack0"])
def test_mont_reduce_cols_edge_values(field):
    """The XLA path's CIOS reduction at its input bound, a sum of two
    products of canonical edge values, and the Montgomery conversions
    around it, against python ints."""
    from ecfft_tpu.ops import schedule as sch

    spec = SPECS[field]
    p, ri = spec.p, _r_inv(spec)
    E = _edges(spec)
    n = len(E)
    rng = random.Random(41)
    _, xa = _state(spec, n, n, rng, vals=[[E[q]] * n for q in range(n)])
    _, xb = _state(spec, n, n, rng, vals=[list(E) for _ in range(n)])
    _, xc = _state(spec, n, n, rng, vals=[[E[(q + 3) % n]] * n
                                          for q in range(n)])
    _, xd = _state(spec, n, n, rng, vals=[[E[(q + b) % n] for b in range(n)]
                                          for q in range(n)])
    cols = sch._conv_cols(spec, xa, xb) + sch._conv_cols(spec, xc, xd)
    got = _decode(spec, sch._mont_reduce_cols(spec, cols))
    mont = _decode(spec, sch._to_mont_cols(spec, xd))
    back = _decode(spec, sch._from_mont_cols(spec, sch._to_mont_cols(
        spec, xd)))
    for q in range(n):
        for b in range(n):
            v = E[(q + b) % n]
            assert got[q][b] == (E[q] * E[b] + E[(q + 3) % n] * v) * ri % p
            assert mont[q][b] == v * spec.r % p
            assert back[q][b] == v


def test_pallas_rejects_unpadded_width(monkeypatch):
    """A tile that does not divide the window or the batch is refused."""
    spec = SPECS["secp256k1"]
    monkeypatch.setattr(ps, "step_tiles", lambda A_, B: (4, 4))
    z = jnp.zeros((32, 16, 4), jnp.uint32)
    c = jnp.zeros((10, 16), jnp.uint32)
    x = jnp.zeros((10, 16, 4), jnp.uint32)
    with pytest.raises(AssertionError):
        ps.pallas_aff1s_ip(spec, c, z, x, jnp.int32(0), True)


def test_batch_not_power_of_two():
    """B=6: the batch tile falls to the largest power-of-two divisor (2)
    and a zero window start works; lanes stay independent."""
    spec = SPECS["secp256k1"]
    p = spec.p
    rng = random.Random(31)
    st_i, state = _state(spec, W, 6, rng)
    x2_i, x2 = _state(spec, A, 6, rng)
    C_i = [rng.randrange(p) for _ in range(A)]
    assert ps.step_tiles(A, 6) == (A, 2)
    out = ps.pallas_aff1s_ip(spec, fd.encode(spec, C_i), state, x2,
                             jnp.int32(0), True)
    _check(_decode(spec, out), st_i, 0, A,
           lambda q, b: (st_i[q][b] + C_i[q] * x2_i[q][b]) % p)


@pytest.mark.parametrize("A_, B, elems, want", [
    (65536, 256, 128, (1, 128)),
    (65536, 64, 128, (2, 64)),
    (128, 6, 128, (64, 2)),
    (16, 1, 128, (16, 1)),
    (128, 256, 256, (1, 256)),
])
def test_step_tiles(A_, B, elems, want):
    """Powers of two that divide the window and the batch and fill the
    tile where they can."""
    tw, tb = ps.step_tiles(A_, B, elems)
    assert (tw, tb) == want
    assert A_ % tw == 0 and B % tb == 0


def test_kernel_supports_and_reduction_path():
    """secp256k1 folds (digit sum 978); the STARK prime's R mod p has
    large digits, so it runs CIOS on Montgomery residents with a single
    conditional subtract (2p < R); m31's one limb stays on XLA."""
    assert ps.kernel_supports(SPECS["secp256k1"])
    assert ps.kernel_supports(SPECS["stark"])
    assert not ps.kernel_supports(FIELDS["m31"])
    assert not ps.helpers(SPECS["secp256k1"]).mont
    h = ps.helpers(SPECS["stark"])
    assert h.mont and len(h.comps) == 1
    h = ps.helpers(SPECS["slack0"])
    assert h.mont and len(h.comps) == 2


@pytest.mark.gpu
def test_compiled_kernels_match_xla_step(gpu):
    """On the card: the compiled in-place kernels equal the XLA step math
    bit for bit at a moderate window."""
    import jax

    from ecfft_tpu.ops import schedule as sch

    rng = np.random.RandomState(3)
    for spec in (SPECS["secp256k1"], SPECS["stark"]):
        L, Wn, An, B = spec.num_limbs, 4096, 2048, 64
        top = spec.to_limbs(spec.p)[-1]

        def draw(*shape):
            x = rng.randint(0, 1 << 16, size=shape).astype(np.uint32)
            x[:, L - 1] = rng.randint(0, top, size=x[:, L - 1].shape)
            return jnp.asarray(x)

        state, x1, x2 = draw(Wn, L, B), draw(An, L, B), draw(An, L, B)
        ca = draw(An, L, 1)[..., 0]
        cb = draw(An, L, 1)[..., 0]
        start = 1024
        win = jax.lax.dynamic_slice(state, (start, 0, 0), (An, L, B))
        want1 = sch._muladd1_cols(spec, cb[:, :, None], win, x2)
        want2 = sch._muladd2_cols(spec, ca[:, :, None], x1,
                                  cb[:, :, None], x2)
        got1 = ps.pallas_aff1s_ip(spec, cb, state, x2, jnp.int32(start))
        got2 = ps.pallas_aff2g_ip(spec, ca, cb, state, x1, x2,
                                  jnp.int32(start))
        assert np.array_equal(np.asarray(got1[start:start + An]),
                              np.asarray(want1))
        assert np.array_equal(np.asarray(got2[start:start + An]),
                              np.asarray(want2))
