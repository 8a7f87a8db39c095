"""Pallas step kernels for the schedule machine, on the Triton route.

The affine step writes ``A·x1 + B·x2`` (or its 1-mul form ``x1 + C·x2``)
into a window of the (W, L, B) limb state. It is pure u32 integer work:
a 16×16-limb shift-accumulate convolution, a pseudo-Mersenne fold or a
CIOS Montgomery pass, an exact carry ripple and a conditional-subtract
chain. These kernels run that whole pipeline per element with the 2L
product columns in registers, so a step reads x1 and x2 once and writes
its window once, straight into the state buffer (input_output_aliases).
The arithmetic is plain elementwise jnp on lists of per-limb planes.

Each program owns a (TW positions × TB batch lanes) tile. The batch is
the state's contiguous axis, so every per-limb load and store coalesces;
the L limbs are unrolled. The window start is a one-element operand read
inside the kernel, so one compiled scan serves every step. Block sizes
are powers of two (``step_tiles``).

The in-place write is race-free: a program writes only the rows and
lanes it owns, and the self-read variant (OP_AFF1S) reads x1 from
exactly those rows before writing them; x1 and x2 of the gathered
variants are separate temps.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ecfft_tpu.fields.registry import FieldSpec

MASK16 = 0xFFFF  # python int: jnp scalars become captured consts in pallas


def kernel_supports(spec: FieldSpec) -> bool:
    """Fields the step kernels cover: multi-limb, with either a fold small
    enough for u32 columns or the CIOS Montgomery path (m31's single limb
    takes XLA's elementwise path)."""
    return spec.num_limbs > 1 and (
        spec.fold_terms is None
        or sum(d for _, d in spec.fold_terms) < (1 << 10))


class Helpers:
    """Per-field constants and the reduction tail: exact carry ripple,
    pseudo-Mersenne fold, CIOS Montgomery pass, conditional subtract."""

    def __init__(self, spec: FieldSpec):
        L = self.L = spec.num_limbs
        self.mont = spec.fold_terms is None
        slack = 16 * L - spec.p.bit_length()
        if self.mont:
            # canonical operands: a CIOS input T < 2p² (two products)
            # reduces below T/R + p, i.e. below 2p when 2p < R, else 3p
            js = [0] if slack else [1, 0]
        else:
            js = [0] if slack == 0 else list(range(slack + 1, -1, -1))
        self.W1 = W1 = L + 1
        self.comps = [
            tuple(((1 << (16 * W1)) - (spec.p << j)) >> (16 * i) & 0xFFFF
                  for i in range(W1))
            for j in js
        ]
        self.fold_terms = spec.fold_terms
        self.p_limbs = spec.to_limbs(spec.p)
        self.n_prime = spec.n_prime

    def ripple(self, cols):
        """Exact serial carry propagation; returns canonical cols + top."""
        out = []
        carry = jnp.zeros_like(cols[0])
        for c in cols:
            v = c + carry
            out.append(v & MASK16)
            carry = v >> 16
        out.append(carry)
        return out

    def fold(self, cols):
        """cols (list, width > L) → width max(L, off+hw) via fold terms."""
        L = self.L
        hw = len(cols) - L
        out_w = max(L, max(off for off, _ in self.fold_terms) + hw)
        out = [cols[k] if k < L else jnp.zeros_like(cols[0])
               for k in range(out_w)]
        for off, digit in self.fold_terms:
            for t in range(hw):
                out[off + t] = out[off + t] + cols[L + t] * digit
        return out

    def cios(self, cols):
        """Word-serial Montgomery reduction: 2L product columns (< 2^22)
        → canonical·R⁻¹ columns plus the top carry."""
        L = self.L
        cols = list(cols)
        for _ in range(L):
            m = (cols[0] * self.n_prime) & MASK16
            for t in range(L):
                prod = m * self.p_limbs[t]
                cols[t] = cols[t] + (prod & MASK16)
                cols[t + 1] = cols[t + 1] + (prod >> 16)
            carry = cols[0] >> 16  # low 16 bits are exactly zero
            cols = cols[1:]
            cols[0] = cols[0] + carry
        return self.ripple(cols[: L + 1])

    def cond_subtract(self, x, sub_comps):
        """Canonical W1-wide columns → x mod p (first L cols)."""
        W1 = self.W1
        for comp in sub_comps:
            y = self.ripple([x[i] + comp[i] for i in range(W1)])
            need = y[W1] > 0
            x = [jnp.where(need, y[i], x[i]) for i in range(W1)]
        return x

    def reduce(self, cols):
        """2L product columns → the field value's L canonical planes."""
        if self.mont:
            c = self.cios(cols)
        else:
            c = self.ripple(self.fold(cols))
            c = self.ripple(self.fold(c))
        return self.cond_subtract(c[:self.W1], self.comps)[:self.L]


@lru_cache(maxsize=None)
def helpers(spec: FieldSpec) -> Helpers:
    return Helpers(spec)


def conv(L: int, prods):
    """Σᵥ cᵥ·xᵥ as 2L product-column planes. ``prods``: (c, x) pairs of
    L planes each (a coefficient plane broadcasts against x; python ints
    are constants)."""
    cols = [None] * (2 * L)

    def acc(k, v):
        cols[k] = v if cols[k] is None else cols[k] + v

    for i in range(L):
        for j in range(L):
            for c, x in prods:
                p = c[i] * x[j]
                acc(i + j, p & MASK16)
                acc(i + j + 1, p >> 16)
    return cols


def aff2(h: Helpers, a, b, x1, x2):
    """a·x1 + b·x2 with a single reduction."""
    return h.reduce(conv(h.L, [(a, x1), (b, x2)]))


def aff1(h: Helpers, c_co, x1, x2):
    """x1 + C·x2. The fold path injects x1 into the product columns before
    reduction (it is smaller than a second product, so the aff2 bounds
    cover it); the Montgomery path adds x1 after CIOS with one conditional
    subtract."""
    L, W1 = h.L, h.W1
    cols = conv(L, [(c_co, x2)])
    if h.mont:
        x = h.cond_subtract(h.cios(cols)[:W1], h.comps)
        s = [x[i] + x1[i] for i in range(L)] + [x[L]]
        return h.cond_subtract(h.ripple(s)[:W1], h.comps[-1:])[:L]
    for j in range(L):
        cols[j] = cols[j] + x1[j]
    return h.reduce(cols)


# elements per program and warps per program; one element per thread
# keeps the ~70 live limb planes of a secp step inside the 255-register
# budget (see step_tiles)
TILE_ELEMS = 128
NUM_WARPS = 4


def step_tiles(A: int, B: int, elems: int = TILE_ELEMS) -> tuple[int, int]:
    """(TW, TB) for an A-row window over B lanes: TB the largest power of
    two dividing B (capped at ``elems``), TW the power of two that fills
    the tile and divides A."""
    tb = min(B & -B, elems)
    tw = max(1, elems // tb)
    while A % tw:
        tw //= 2
    return tw, tb


def _ip_call(planes_fn, n_coef, self_x1, state, operands, start,
             interpret):
    """pallas_call plumbing shared by the in-place variants.

    ``operands`` = ``n_coef`` coefficient rows (A, L) then window tensors
    (A, L, B); the state rides last, aliased to the output. With
    ``self_x1`` the kernel reads x1 from the state window itself."""
    W, L, B = state.shape
    A = operands[-1].shape[0]
    tw, tb = step_tiles(A, B)
    assert A % tw == 0 and B % tb == 0, (A, B, tw, tb)

    def kernel(start_ref, *refs):
        *in_refs, st_ref, o_ref = refs
        g = pl.program_id(0)
        j = pl.program_id(1)
        rows = pl.ds(g * tw, tw)
        lanes = pl.ds(j * tb, tb)
        srows = pl.ds(start_ref[0] + g * tw, tw)
        coefs = [[r[rows, pl.ds(li, 1)] for li in range(L)]
                 for r in in_refs[:n_coef]]
        wins = [[r[rows, li, lanes] for li in range(L)]
                for r in in_refs[n_coef:]]
        if self_x1:
            wins.insert(0, [st_ref[srows, li, lanes] for li in range(L)])
        out = planes_fn(*coefs, *wins)
        for li in range(L):
            o_ref[srows, li, lanes] = out[li]

    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((W, L, B), jnp.uint32),
        grid=(A // tw, B // tb),
        # the state is the last operand (after start and the others)
        input_output_aliases={1 + len(operands): 0},
        backend="triton",
        compiler_params=plt.CompilerParams(
            num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="ecfft_step",
    )(start.astype(jnp.int32).reshape(1), *operands, state)


@partial(jax.jit, static_argnums=(0, 5))
def pallas_aff1s_ip(spec: FieldSpec, C, state, x2, start,
                    interpret: bool = False):
    """state[start+q] ← state[start+q] + C·x2 in place (OP_AFF1S)."""
    return _ip_call(partial(aff1, helpers(spec)), 1, True, state,
                    (C, x2), start, interpret)


@partial(jax.jit, static_argnums=(0, 6))
def pallas_aff1g_ip(spec: FieldSpec, C, state, x1, x2, start,
                    interpret: bool = False):
    """state[start+q] ← x1 + C·x2 in place (OP_AFF1, gathered x1)."""
    return _ip_call(partial(aff1, helpers(spec)), 1, False, state,
                    (C, x1, x2), start, interpret)


@partial(jax.jit, static_argnums=(0, 7))
def pallas_aff2g_ip(spec: FieldSpec, A_, B_, state, x1, x2, start,
                    interpret: bool = False):
    """state[start+q] ← A·x1 + B·x2 in place (OP_AFFINE, gathered x1)."""
    return _ip_call(partial(aff2, helpers(spec)), 2, False, state,
                    (A_, B_, x1, x2), start, interpret)
