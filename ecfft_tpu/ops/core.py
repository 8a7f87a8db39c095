"""Device ECFFT algorithms as iterative batched layer scans.

The reference implements all eight algorithms as recursive divide-and-
conquer over a pointer-chased subtree chain (/root/reference/src/
fftree.rs:72-316). That shape is wrong for an accelerator: recursion becomes
sequential host control flow, and per-node 2×2 matrix structs defeat
vectorization. Here every algorithm is re-derived as a *flat iteration
over levels*, where each level is one whole-tensor batched operation:

- EXTEND's recursion tree is a radix-2 butterfly network: all 2^d
  subproblems at depth d share the same decompose/recombine matrices, so
  one level = one batched 2×2 mat-vec over an (..., 2^d, k/2, L) tensor
  (down sweep), mirrored on the way up.
- ENTER/EXIT/VANISH recurse over *subtree sizes*; their per-size work is
  itself data-parallel over blocks, so they become log n levels each of
  batched EXTEND + elementwise combines.
- DEGREE's data-dependent branch (fftree.rs:180-191) becomes a batched
  `where`: both paths are computed and selected per batch element, which
  is the vmap-friendly formulation.

Conventions:
- an evaluation batch has shape (..., n, L): leading dims are free batch
  dims, n the domain size, L the limb axis.
- `moiety` is static: S1 means "input lives on S0, produce values on S1"
  (the reference's `extend(evals, Moiety::S1)` semantics, SURVEY §2.3).
- every function takes the minimal per-size tables it needs; the FFTree
  container in ecfft_tpu/fftree.py wires them up and jits.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ecfft_tpu.fields import device as fd
from ecfft_tpu.fields.registry import FieldSpec

S0 = 0
S1 = 1


def _ilog2(n: int) -> int:
    return n.bit_length() - 1


def extend(spec: FieldSpec, ext, evals, moiety: int):
    """EXTEND: evals on one moiety of a size-2m domain → the other moiety.

    The reference's recursion (fftree.rs:72-120) is a radix-2 butterfly
    network. Flattening the (subproblem, offset) state to one position
    axis shows that depth d pairs exactly the positions differing in bit
    b = log2(m)−1−d, and both butterfly outputs land back on the pair's
    own positions. So each level is ONE branch-free tensor statement:

        out[p] = c_self[d,p]·x[p] + c_partner[d,p]·x[p XOR 2^b]

    with the 2×2 matrix entries pre-scattered into per-position
    coefficient tables c (see fftree._tile_extend). The whole algorithm
    is two ``lax.scan``s (down over decompose coeffs, up over recombine
    coeffs) — a CONSTANT-size trace regardless of m, which keeps XLA
    compile time flat while the reference-shaped unrolled version grows
    O(log² n) and chokes the compiler at STARK sizes.

    ``ext`` is the per-tree-size table: {"shifts": (logm,) int32,
    "s0"/"s1": (dec_coeffs, rec_coeffs)} with coeff arrays of shape
    (logm, m, 2, L). Input (..., m, L).
    """
    m = evals.shape[-2]
    if m == 1:
        return evals
    dec_c, rec_c = ext["s0" if moiety == S0 else "s1"]
    shifts = ext["shifts"]
    iota = jax.lax.broadcasted_iota(jnp.int32, (m, 1), 0).squeeze(-1)

    def body(x, inp):
        coeff, half = inp
        partner = jnp.take(x, iota ^ half, axis=-2)
        out = fd.add(
            spec,
            fd.mul(spec, coeff[:, 0], x),
            fd.mul(spec, coeff[:, 1], partner),
        )
        return out, None

    x, _ = jax.lax.scan(body, evals, (dec_c, shifts))
    x, _ = jax.lax.scan(body, x, (rec_c[::-1], shifts[::-1]))
    return x


def mextend(spec: FieldSpec, ext, z_table, evals, moiety: int):
    """MEXTEND: EXTEND for monic polynomials of degree exactly m
    (fftree.rs:128-141) — extend then add the vanishing table
    (z0_s1 for an S1 target, z1_s0 for S0)."""
    return fd.add(spec, extend(spec, ext, evals, moiety), z_table)


def _interleave(a, b):
    """[a0,b0,a1,b1,...] along axis -2; a,b (..., k, L) → (..., 2k, L)."""
    x = jnp.stack([a, b], axis=-2)  # (..., k, 2, L)
    return x.reshape(*a.shape[:-2], a.shape[-2] * 2, a.shape[-1])


def enter(spec: FieldSpec, ext_by_size, xnn_by_size, coeffs):
    """ENTER (fft): coefficients → evaluations, O(n log² n)
    (fftree.rs:143-167).

    Bottom-up sweep over block sizes: at level k every 2^k-block combines
    two 2^(k−1)-blocks via P = U + X^(k/2)·V — u-evals stay, v-evals are
    extended to the block's S1 and merged with the xnn table. All blocks
    at a level share one tree size, so the whole level is a single batched
    EXTEND + butterfly combine.

    ``ext_by_size[k]``/``xnn_by_size[k]`` are the tables of tree size k.
    """
    n = coeffs.shape[-2]
    x = coeffs[..., :, None, :]  # (..., n blocks, 1, L)
    size = 1
    while size < n:
        size *= 2
        u0 = x[..., 0::2, :, :]  # (..., nb, size/2, L): low-half coeffs
        v0 = x[..., 1::2, :, :]
        u1 = extend(spec, ext_by_size[size], u0, S1)
        v1 = extend(spec, ext_by_size[size], v0, S1)
        xnn = xnn_by_size[size]  # (size, L)
        even = fd.add(spec, u0, fd.mul(spec, v0, xnn[0::2]))
        odd = fd.add(spec, u1, fd.mul(spec, v1, xnn[1::2]))
        x = _interleave(even, odd)  # (..., nb/2, size, L)
    return x[..., 0, :, :]


def redc(spec: FieldSpec, ext, z_inv, evals, a1, a0_inv, moiety: int):
    """REDC: ⟨P·Z⁻¹ mod a ≀ S⟩, O(n log n) (fftree.rs:232-259).

    ``a1`` = odd-position values of the modulus table, ``a0_inv`` =
    inverted even-position values (precomputed when a is a precomputed
    table — the EXIT path — or Fermat-inverted by the caller otherwise;
    the reference burns a batch_inversion here every call, fftree.rs:236).
    ``z_inv`` is z0_inv_s1 for moiety S0, z1_inv_s0 for S1.
    """
    e0 = evals[..., 0::2, :]
    e1 = evals[..., 1::2, :]
    t0 = fd.mul(spec, e0, a0_inv)
    g1 = extend(spec, ext, t0, S0 if moiety == S1 else S1)
    h1 = fd.mul(spec, fd.sub(spec, e1, fd.mul(spec, g1, a1)), z_inv)
    h0 = extend(spec, ext, h1, moiety)
    return _interleave(h0, h1)


def modular_reduce(spec: FieldSpec, ext, z0_inv_s1, evals, a1, a0_inv, c):
    """MOD = REDC ∘ (·c) ∘ REDC (fftree.rs:277-289); ``c`` is
    ⟨Z₀² mod a ≀ S⟩."""
    h = redc(spec, ext, z0_inv_s1, evals, a1, a0_inv, S0)
    hc = fd.mul(spec, h, c)
    return redc(spec, ext, z0_inv_s1, hc, a1, a0_inv, S0)


def exit_(spec: FieldSpec, tables, evals):
    """EXIT (ifft): evaluations → coefficients, O(n log² n)
    (fftree.rs:200-230).

    Top-down block splitting: each size-k block yields (u0 = low-half
    coeff evals via MOD by X^(k/2), v0 = (e0−u0)/X^(k/2)) and the two
    half-blocks recurse in place; after log n levels the state *is* the
    coefficient vector (depth-first left-right = coefficient order).

    ``tables[k]`` = dict with ext, xnn_s, xnn_s_inv, z0_inv_s1,
    z0z0_rem_xnn_s for tree size k.
    """
    n = evals.shape[-2]
    x = evals[..., None, :, :]  # (..., 1 block, n, L)
    k = n
    while k > 1:
        t = tables[k]
        xnn = t["xnn_s"]
        u = modular_reduce(
            spec,
            t["ext"],
            t["z0_inv_s1"],
            x,
            xnn[1::2],
            t["xnn_s_inv"][0::2],
            t["z0z0_rem_xnn_s"],
        )
        u0 = u[..., 0::2, :]
        e0 = x[..., 0::2, :]
        v0 = fd.mul(spec, fd.sub(spec, e0, u0), t["xnn_s_inv"][0::2])
        x = jnp.stack([u0, v0], axis=-3)  # (..., nb, 2, k/2, L)
        x = x.reshape(*x.shape[:-4], x.shape[-4] * 2, k // 2, x.shape[-1])
        k //= 2
    return x[..., 0, :]


def degree(spec: FieldSpec, tables, evals):
    """DEGREE, O(n log n) (fftree.rs:169-198), batched.

    The reference's early-exit branch (extend(e0) == e1 ⇒ recurse low)
    becomes a per-batch-element select: compute both the low path (e0)
    and the high-isolation path (t0), pick per element, and accumulate
    k/2 where the high path was taken. Data-dependent control flow is
    replaced by lane-wise `where` — the price is computing both paths,
    the payoff is full batching under jit/vmap.

    Returns an int32 array of shape (...).
    """
    n = evals.shape[-2]
    x = evals
    res = jnp.zeros(evals.shape[:-2], dtype=jnp.int32)
    k = n
    while k > 1:
        t = tables[k]
        e0 = x[..., 0::2, :]
        e1 = x[..., 1::2, :]
        g1 = extend(spec, t["ext"], e0, S1)
        low = jnp.all(fd.eq(spec, g1, e1), axis=-1)  # (...)
        t1 = fd.mul(spec, fd.sub(spec, e1, g1), t["z0_inv_s1"])
        t0 = extend(spec, t["ext"], t1, S0)
        x = jnp.where(low[..., None, None], e0, t0)
        res = res + jnp.where(low, 0, k // 2).astype(jnp.int32)
        k //= 2
    return res


def vanish(spec: FieldSpec, tables, leaves2, points):
    """VANISH: evals of Z(x) = Π(x − aᵢ) over S, O(n log² n)
    (fftree.rs:291-316, ECFFT-I §7.1).

    A bottom-up product tree: groups of points merge pairwise — multiply
    the two children's evaluation tables over S0 of the next size, then
    MEXTEND the (monic, degree-exactly-half) product onto S1 and
    interleave. Base case: each point α over the size-2 subtree gives
    [α − l₀, α − l₁] (fftree.rs:293-298).

    ``leaves2`` = the 2-leaf subtree's domain, shape (2, L).
    ``tables[k]`` = dict with ext + z0_s1 for tree size k.
    """
    v = points.shape[-2]
    x = fd.sub(spec, points[..., :, None, :], leaves2)  # (..., v, 2, L)
    size = 2
    while size < 2 * v:
        size *= 2
        q_s0 = fd.mul(spec, x[..., 0::2, :, :], x[..., 1::2, :, :])
        t = tables[size]
        q_s1 = mextend(spec, t["ext"], t["z0_s1"], q_s0, S1)
        x = _interleave(q_s0, q_s1)
    return x[..., 0, :, :]
