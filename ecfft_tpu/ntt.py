"""Classical radix-2 NTT over 2-adic primes, on the schedule machine.

The reference's comparison benchmark (benches/comparison.rs:16-55) pits
ECFFT on secp256k1's Fp against arkworks' Radix2EvaluationDomain FFT on
the 2-adic STARK prime 0x0800…0001. This module is our side of that
comparison: a decimation-in-time NTT whose every butterfly stage

    bit clear:  out[p] = x[p] + w·x[p ⊕ 2^b]
    bit set:    out[p] = x[p ⊕ 2^b] − w·x[p]

is exactly one affine schedule step — so the SAME compiled interpreter
(and the same fused step kernel) that runs ECFFT runs the classical
FFT. The input bit-reversal permutation is folded into the first stage's
gather maps; the inverse transform appends one 1/n scaling step.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from ecfft_tpu.fields import device as fd
from ecfft_tpu.fields.registry import FieldSpec, spec_for_prime
from ecfft_tpu.ops import schedule as sch

# the reference comparison's 2-adic prime (benches/comparison.rs:19-23)
STARK_P = int(
    "0800000000000011000000000000000000000000000000000000000000000001", 16
)
STARK_GENERATOR = 3


def _bitrev(i: int, bits: int) -> int:
    out = 0
    for _ in range(bits):
        out = (out << 1) | (i & 1)
        i >>= 1
    return out


class NTTPlan:
    """Precomputed twiddle pool + forward/inverse schedules for size n."""

    def __init__(self, n: int, p: int = STARK_P,
                 generator: int = STARK_GENERATOR,
                 spec: FieldSpec | None = None):
        assert n & (n - 1) == 0
        two_adicity = (p - 1 & -(p - 1)).bit_length() - 1
        logn = n.bit_length() - 1
        assert logn <= two_adicity, "prime's 2-adicity too small for n"
        self.n = n
        self.spec = spec or spec_for_prime(p, f"ntt_{p % 99991}")
        self.p = p
        w = pow(generator, (p - 1) >> logn, p)  # primitive n-th root
        w_inv = pow(w, -1, p)
        n_inv = pow(n, -1, p)
        # pool: [0]=0, [1]=1, powers of w (n/2), powers of w_inv (n/2), 1/n,
        # and negations of both power tables (the bit-set butterfly arm)
        pows, ipows = [], []
        acc = iacc = 1
        for _ in range(n // 2):
            pows.append(acc)
            ipows.append(iacc)
            acc = acc * w % p
            iacc = iacc * w_inv % p
        rows = ([0, 1] + pows + ipows + [n_inv]
                + [(-v) % p for v in pows] + [(-v) % p for v in ipows])
        self.pool = fd.encode(self.spec, rows)
        self._off_w = 2
        self._off_iw = 2 + n // 2
        self._off_ninv = 2 + n
        self._off_nw = 3 + n
        self._off_niw = 3 + n + n // 2
        self._fwd = self._build(False)
        self._fwd = self._fwd._replace(
            xs=tuple(jnp.asarray(a) for a in self._fwd.xs))
        self._inv = self._build(True)
        self._inv = self._inv._replace(
            xs=tuple(jnp.asarray(a) for a in self._inv.xs))

    def _build(self, inverse: bool):
        n = self.n
        logn = n.bit_length() - 1
        bld = sch._Builder(n)
        brev = np.array([_bitrev(i, logn) for i in range(n)], dtype=np.int64)
        off_w = self._off_iw if inverse else self._off_w
        off_nw = self._off_niw if inverse else self._off_nw
        pos = np.arange(n)
        for s in range(logn):  # stage: butterflies over bit s
            half = 1 << s
            bit = (pos & half) != 0
            partner = pos ^ half
            # twiddle index: w^( (p mod 2^(s+1) without the bit) * n/2^(s+1) )
            tw = (pos & (half - 1)) * (n >> (s + 1))
            ar, g1, br, g2 = bld.new_step()
            src = (lambda q: brev[q]) if s == 0 else (lambda q: q)
            # bit clear: out = u + w·v ; bit set: out = u − w·v
            # (u lives at the clear position, v at the set position)
            ar[pos] = sch.ONE
            g1[pos] = np.where(bit, src(partner), src(pos))
            br[pos] = np.where(bit, off_nw + tw, off_w + tw)
            g2[pos] = np.where(bit, src(pos), src(partner))
        if inverse:
            ar, g1, br, g2 = bld.new_step()
            ar[pos] = self._off_ninv
        return bld.arrays()

    def _run(self, batch, sched):
        lead = batch.shape[:-2]
        flat = batch.reshape((-1,) + batch.shape[-2:])
        out = sch.run_schedule(self.spec, self.pool, sched, flat,
                               self.n - 1, self.n, sch.step_route())
        return out.reshape(lead + out.shape[-2:])

    def ntt(self, coeffs):
        """coeffs → evaluations at powers of the n-th root (natural order)."""
        return self._run(coeffs, self._fwd)

    def intt(self, evals):
        """evaluations → coefficients."""
        return self._run(evals, self._inv)

    def encode(self, values):
        return fd.encode(self.spec, values)

    def decode(self, arr):
        return fd.decode(self.spec, arr)
