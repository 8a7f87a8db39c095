"""The schedule machine: ECFFT transforms as data.

Motivation: every distinct XLA computation pays a compile, and the
multi-scan ENTER/EXIT traces compile for minutes. But every ECFFT
algorithm is a composition of one primitive shape:

    out[p] = A[p] · x[g1[p]]  +  B[p] · x[g2[p]]

- EXTEND's butterflies: A/B the Lemma-3.2 coefficients, g1 = p,
  g2 = p XOR half (ops/core.py::extend derivation);
- ENTER's combine P = U + X^(k/2)·V: A = 1, B = xnn, block-affine g's
  (fftree.rs:155-159);
- REDC/MOD/EXIT's elementwise stages: (e − g·a)·z⁻¹ etc. are affine in
  the state with coefficients that are *products of precomputed tables*
  (fused into the pool ahead of time);
- interleave/deinterleave/subsample: pure index permutations, absorbed
  into g1/g2 for free.

So a whole transform compiles to ONE ``lax.scan`` over per-step scalars
— the "schedule" — with coefficients fetched from a flat "pool" of table
rows. The FFTree stops being code and becomes a program: one tiny
compiled interpreter runs ALL EIGHT algorithms (ENTER, EXIT, EXTEND,
MEXTEND, DEGREE, REDC, MOD, VANISH — matching the reference's uniform
treatment, fftree.rs:123-316) for every size, and adding an algorithm
adds data, not a compile.

PARAMETRIC SCHEDULES (the O(n) redesign). Round 2 stored every step's
index rows as materialized (steps, A) arrays and every butterfly level's
scaled coefficients as pool rows — both O(n·log n), which dominated HBM
(319 MB of index banks + 314 MB of scaled tables at n=2^16 secp). Round
3 exploits that ECFFT steps are REGULAR: each index row is synthesized
inside the scan from a 16-scalar closed form (see ``CP_*``), and each
butterfly level's coefficients are computed on the fly from the O(n)
compact Lemma-3.2 matrix planes by a running-diagonal engine carried
through the scan (see ``DP_*``). Operational precomputation is O(n) like
the reference's FFTree (README.md:24); a tiny row bank remains only for
index rows with no closed form (e.g. the NTT's bit-reversal stage).

Universal per-column index formula, parameters cp[0..15]:

    t   = p − cp[OFF]                 (p = absolute state position)
    u   = t >> cp[S2]  (or t << −S2 when S2 < 0)
    act = (0 ≤ t < SPAN) ∧ (ALO ≤ (t & KM) < AHI)
    sel = ((t >> SB) & 1) ? C1 : C0
    v   = sel + (t & M1) + (u & M2) + (((u + DD) ^ XX) & M3)
    idx = act ? v : (DK == 0 ? p : DC)

This covers every index pattern the emitters produce: butterfly partner
maps (R0 + (t ^ half)), per-position coefficient indices (base + (t &
mask)), block-strided source reads (base + i + j·stride via the two mask
terms), parity-selected interleaves (SB = 0), and stride-2 subsamples
(S2 = ±1). The builder VERIFIES each formula against the actually
emitted numpy row at build time and raises on mismatch, so the closed
forms can never silently disagree with the reference algorithm.

Scaled butterflies (the twiddle-absorption analogue): all but the
last level of every EXTEND run as the 1-mul form out[p] = x[p] +
C·x[p^half] and the last recombine level applies the accumulated per-row
diagonal as a 2-mul step — outputs bit-identical to the reference at
~55% of the multiply work. The per-level C table is now COMPUTED in-scan:

    C_level[r]  = (Mpart[r]·Mself⁻¹[r]) · D[r ^ half] · invD[r]
    D    ← Mself·D        invD ← Mself⁻¹·invD      (per level)
    final level:  A[r] = Mself[r]·D[r],  B[r] = Mpart[r]·D[r ^ half]

with Mself/Mpart/Mself⁻¹ gathered from compact per-depth matrix planes
(6·half pool rows per (size, depth, matrix-kind) — O(n) total) and
(D, invD) riding the scan carry. Fields where some Mself entry is zero
(the 1-mul rewrite's precondition) are detected at pool build and fall
back to exact 2-mul butterflies gathered straight from the planes.

Opcode set:
- OP_AFFINE: out[p] = pool[a[p]]·x[g1[p]] + pool[b[p]]·x[g2[p]]
- OP_AFF1:   out[p] = x[g1[p]] + pool[b[p]]·x[g2[p]] — the 1-mul
  workhorse (pure scales read x1 = an always-zero pad row; copies C = 0)
- OP_AFF1S:  OP_AFF1 with x1 read as the window slice itself
- OP_MUL:    out[p] = x[g1[p]]·x[g2[p]] — state×state products
- OP_CMPSEL: comp_b = ∀p: x[a[p]] == x[b[p]] (one bool per batch lane);
  out[p] = comp ? x[g1[p]] : x[g2[p]] — DEGREE's branch as a select
- OP_AFF1S_C / OP_AFF1_C / OP_AFFINE_C: as their pool counterparts but
  with coefficients read from the in-scan C scratch (row 0 of the
  scratch is the passthrough constant: one for A, zero for B/C).

State layout: (W, L, B) — position-major so each gather moves a
contiguous (L, B) row, batch-last so the batch is the contiguous axis of
every limb plane (see the runtime section below). For ENTER/EXIT, W = 2n+1: positions
[0, n) are the value lane, [n, 2n) the extend/scratch lane, and position
2n is a constant 1 so additive table terms (MEXTEND's +Z) stay affine.

Step counts: ENTER ≈ log²n, EXIT ≈ 4·log²n — the same O(n log² n) work
as the reference's recursion (README.md:7-8), one n-wide step per level.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec

from ecfft_tpu.fields import device as fd
from ecfft_tpu.fields.registry import FieldSpec
from ecfft_tpu.ops.core import S0, S1, _ilog2

ZERO = 0  # pool row of zeros
ONE = 1   # pool row of one

OP_AFFINE = 0
OP_MUL = 1
OP_CMPSEL = 2
OP_AFF1 = 3    # out[p] = x[g1[p]] + pool[b[p]]·x[g2[p]] — 1-mul step
OP_AFF1S = 4   # same, but x1 = the window slice itself (g1 ≡ identity)
OP_AFF1S_C = 5  # OP_AFF1S with C from the in-scan coefficient scratch
OP_AFF1_C = 6   # OP_AFF1 with C from the scratch
OP_AFFINE_C = 7  # OP_AFFINE with (A, B) from the scratch

# universal column-formula parameter slots (16 int32 per column)
(CP_OFF, CP_SPAN, CP_KM, CP_ALO, CP_AHI, CP_SB, CP_C0, CP_C1, CP_M1,
 CP_S2, CP_M2, CP_DD, CP_XX, CP_M3, CP_DK, CP_DC) = range(16)
NCP = 16

# running-diagonal (D-engine) step parameter slots
(DP_DOP, DP_SHALF, DP_HM, DP_HALF, DP_MS0, DP_MS1, DP_MP0, DP_MP1,
 DP_MSI0, DP_MSI1) = range(10)
NDP = 10
DOP_NONE = 0
DOP_LEVEL = 1   # C = ratio·D[perm]·invD;  D ← Ms·D,  invD ← Msi·invD
DOP_LEVEL0 = 2  # first level of an extend: C = ratio; D ← Ms, invD ← Msi
DOP_FINAL = 3   # A = Ms·D, B = Mp·D[perm] (the unscaling 2-mul level)

COLS = ("a", "g1", "b", "g2")


class Schedule(NamedTuple):
    """A compiled-to-data transform.

    ``W``: full state width (static python int). ``A``: per-step window
    width — each step computes only rows [start, start+A) and writes
    them back with one dynamic_update_slice. ``bs_max``: D-engine
    scratch rows (0 = no in-scan coefficients, e.g. the NTT). ``xs`` =
    (op, start, colp, dp, rid, bank): per-step opcode and window start
    (steps,), per-column formula parameters (steps, 4, 16), D-engine
    parameters (steps, 10), residual bank row ids (steps, 4; −1 = use
    the formula), and the shared residual row bank (rows, A).
    ``out_perm`` optionally maps output rows to state rows post-scan."""

    W: int
    A: int
    bs_max: int
    xs: tuple
    out_perm: np.ndarray | None = None


def _synth_np(cp, W: int) -> np.ndarray:
    """Numpy mirror of the in-scan column-formula synthesis, over the
    FULL state width (used to verify hints against emitted rows)."""
    p = np.arange(W, dtype=np.int64)
    t = p - int(cp[CP_OFF])
    s2 = int(cp[CP_S2])
    u = (t >> s2) if s2 >= 0 else (t << -s2)
    inb = t & int(cp[CP_KM])
    act = ((t >= 0) & (t < int(cp[CP_SPAN]))
           & (inb >= int(cp[CP_ALO])) & (inb < int(cp[CP_AHI])))
    sel = np.where((t >> int(cp[CP_SB])) & 1 == 1,
                   int(cp[CP_C1]), int(cp[CP_C0]))
    v = (sel + (t & int(cp[CP_M1])) + (u & int(cp[CP_M2]))
         + (((u + int(cp[CP_DD])) ^ int(cp[CP_XX])) & int(cp[CP_M3])))
    dflt = p if int(cp[CP_DK]) == 0 else np.full(W, int(cp[CP_DC]),
                                                 np.int64)
    return np.where(act, v, dflt).astype(np.int32)


def _P(off=0, span=0, km=-1, alo=0, ahi=None, sb=31, c0=0, c1=0, m1=0,
       s2=0, m2=0, dd=0, xx=0, m3=0, dk=0, dc=0) -> np.ndarray:
    """Build a 16-slot formula parameter row (see module docstring).
    ``ahi`` defaults to ``span`` (plain contiguous activity range)."""
    if ahi is None:
        ahi = span
    return np.asarray([off, span, km, alo, ahi, sb, c0, c1, m1, s2, m2,
                       dd, xx, m3, dk, dc], dtype=np.int32)


# ----------------------------------------------------------------- pool


def _batch_inv(spec: FieldSpec, a):
    """Batched modular inverse of (N, L) rows: two associative product
    scans + ONE Fermat chain on the total product (Montgomery's batch-
    inversion trick, log-depth — the reference leans on
    ark_ff::batch_inversion the same way, fftree.rs:330-333)."""
    mulf = lambda x, y: fd.mul(spec, x, y)  # noqa: E731
    pre = jax.lax.associative_scan(mulf, a, axis=0)
    suf = jax.lax.associative_scan(mulf, a, axis=0, reverse=True)
    inv_tot = fd.inv(spec, pre[-1])
    ones = fd.ones(spec, (1,))
    pre_excl = jnp.concatenate([ones, pre[:-1]], axis=0)
    suf_excl = jnp.concatenate([suf[1:], ones], axis=0)
    return mulf(mulf(pre_excl, suf_excl), inv_tot)


def _host_batch_inv(spec: FieldSpec, denoms) -> jnp.ndarray:
    """Invert (N, L) denominators host-side via the native engine when
    possible, else the jnp product-scan fallback (_batch_inv)."""
    if spec.limb_bits == 16 and spec.num_limbs <= 16:
        try:
            from ecfft_tpu.native import batch_inv_limbs

            return jnp.asarray(batch_inv_limbs(spec, np.asarray(denoms)))
        except Exception:  # no toolchain: fall through to the XLA path
            pass
    return _batch_inv(spec, denoms)


def _plane_meta(sizes: tuple) -> list:
    """(k, d, pi, half) for every compact matrix plane block, in pool
    order. Per (size k, depth d) the four matrix kinds pi = dec_S0,
    dec_S1, rec_S0, rec_S1 each contribute a 6·half-row block
    [ms0 ‖ ms1 ‖ mp0 ‖ mp1 ‖ msi0 ‖ msi1]: the (0,0)/(1,1) diagonal
    entries, the (0,1)/(1,0) off-diagonal entries, and the elementwise
    inverses of the diagonals (for the in-scan invD chain)."""
    meta = []
    for k in sizes:
        if k < 4:
            continue
        for d in range(_ilog2(k) - 1):
            half = k >> (d + 2)
            for pi in range(4):
                meta.append((k, d, pi, half))
    return meta


@partial(jax.jit, static_argnums=(0, 2))
def _build_pool_arrays(spec: FieldSpec, tables, sizes: tuple, msi_all):
    """One jitted computation for the whole pool: tiny eager ops would
    each pay a dispatch and a compile.
    ``msi_all``: host-inverted diagonal planes, (Σ 2·half, L), in
    _plane_meta order (zeros for unscaled-fallback fields)."""
    L = spec.num_limbs
    rows = [jnp.zeros((1, L), jnp.uint32), fd.ones(spec, (1,))]
    cur = 0
    for k, d, pi, half in _plane_meta(sizes):
        q = tables[k]["mats"][d][pi]  # (half, 2, 2, L)
        rows.append(q[:, 0, 0, :])
        rows.append(q[:, 1, 1, :])
        rows.append(q[:, 0, 1, :])
        rows.append(q[:, 1, 0, :])
        rows.append(msi_all[cur:cur + 2 * half])
        cur += 2 * half
    for k in sorted(tables):
        t = tables[k]
        for name in ("xnn_s", "xnn_s_inv", "z0_s1", "z1_s0", "z0_inv_s1",
                     "z1_inv_s0", "z0z0_rem_xnn_s"):
            rows.append(t[name])
        # fused vectors for the EXIT/MOD pipeline with a = X^(k/2),
        # c = <Z0² mod a ≀ S> (fftree.rs:200-289)
        xnn = t["xnn_s"]
        xnninv = t["xnn_s_inv"]
        z0inv = t["z0_inv_s1"]
        z00 = t["z0z0_rem_xnn_s"]
        rows.append(fd.neg(spec, fd.mul(spec, xnn[1::2], z0inv)))
        rows.append(fd.neg(spec, fd.mul(spec, xnn[1::2],
                                        t["z1_inv_s0"])))
        rows.append(fd.mul(spec, z00[0::2], xnninv[0::2]))
        rows.append(fd.mul(spec, z0inv, z00[1::2]))
        rows.append(fd.neg(spec, xnninv))
        # negated inverse tables (DEGREE's t1 term, general-modulus REDC)
        rows.append(fd.neg(spec, z0inv))
        rows.append(fd.neg(spec, t["z1_inv_s0"]))
        # const k/2 (DEGREE's accumulator increment, fftree.rs:188)
        rows.append(fd.encode(spec, [k // 2]))
    # negated 2-leaf domain (VANISH's base case x − l_b, fftree.rs:293-298)
    rows.append(fd.neg(spec, tables[sizes[0]]["leaves2"]))
    return jnp.concatenate(rows, axis=0)


def build_pool(tree) -> tuple[jnp.ndarray, dict]:
    """Concatenate every table row a schedule can reference into one
    (P, L) array; returns (pool, offsets). O(n) total: compact matrix
    planes (the in-scan coefficient engine's inputs) + the z/fused
    tables. Offsets are computed host-side from shapes; the array build
    is a single jitted computation.

    Sets ``offsets["unscaled"] = True`` when any Lemma-3.2 diagonal
    entry is zero — the 1-mul scaled rewrite divides by those entries,
    so such (pathological) fields run exact 2-mul butterflies instead.
    """
    spec = tree.spec
    tables = {
        k: {kk: tree.tables[k][kk]
            for kk in ("mats", "xnn_s", "xnn_s_inv", "z0_s1", "z1_s0",
                       "z0_inv_s1", "z1_inv_s0", "z0z0_rem_xnn_s")}
        for k in tree.tables
    }
    sizes = tuple(sorted(tables))
    tables[sizes[0]]["leaves2"] = tree.tables[2]["leaves"]
    meta = _plane_meta(sizes)
    off = {}
    cursor = 2
    for k, d, pi, half in meta:
        off[f"bm_{k}_{d}_{pi}"] = cursor
        cursor += 6 * half
    for k in sizes:
        t = tables[k]
        for name in ("xnn_s", "xnn_s_inv", "z0_s1", "z1_s0", "z0_inv_s1",
                     "z1_inv_s0", "z0z0_rem_xnn_s"):
            off[f"{name}_{k}"] = cursor
            cursor += t[name].shape[0]
        half = k // 2
        for name, cnt in (("neg_a1_z0inv", half), ("neg_a1_z1inv", half),
                          ("c0_a0inv", half),
                          ("zc1", half), ("neg_xnninv", k),
                          ("neg_z0_inv_s1", half), ("neg_z1_inv_s0", half),
                          ("half_const", 1)):
            off[f"{name}_{k}"] = cursor
            cursor += cnt
    off["neg_leaf2"] = cursor
    cursor += 2
    # diagonal planes: host check for zeros (the scaled form's
    # precondition), then ONE batched inversion for every msi row
    diags = []
    for k, d, pi, half in meta:
        q = np.asarray(tables[k]["mats"][d][pi])
        diags.append(q[:, 0, 0, :])
        diags.append(q[:, 1, 1, :])
    if diags:
        diags = np.concatenate(diags, axis=0)
        if bool(np.all(diags == 0, axis=-1).any()):
            off["unscaled"] = True
            msi_all = jnp.zeros(diags.shape, jnp.uint32)
        else:
            msi_all = _host_batch_inv(spec, jnp.asarray(diags))
    else:
        msi_all = jnp.zeros((0, spec.num_limbs), jnp.uint32)
    return _build_pool_arrays(spec, tables, sizes, msi_all), off




# ------------------------------------------------------------- schedules


class _StepRef:
    """One schedule step under construction: four full-width numpy index
    rows (the emitters' ground truth) plus an optional formula hint per
    column and the D-engine parameters. ``hints[c]`` is a 16-slot param
    row (see _P); at finalize the builder verifies the formula
    reproduces the emitted row EXACTLY and then discards the row."""

    __slots__ = ("op", "rows", "hints", "dp", "_dflts")

    def __init__(self, op: int, rows, dflts):
        self.op = op
        self.rows = rows  # [a, g1, b, g2] full-width int32
        # default hint: all-inactive formula with the opcode's default
        self.hints = [None, None, None, None]
        self.dp = np.zeros(NDP, dtype=np.int32)
        self._dflts = dflts


class _Builder:
    """Accumulates schedule steps; default row is a passthrough.

    Width is rounded up to a multiple of 128 so the Pallas step kernel
    can use a large position tile; the pad rows stay passthrough forever.

    ``one_pos`` (required for OP_MUL steps) is the state position holding
    the constant 1: a mul step's passthrough form is x[p]·x[one_pos].

    Each ``new_*_step`` call finalizes the previous step: hinted columns
    are verified against their emitted rows and compressed to 16 scalars;
    unhinted non-default columns go to the residual row bank. Memory
    during build is O(W) regardless of step count."""

    def __init__(self, W: int, one_pos: int | None = None):
        self._orig_w = W
        self.W = (W + 127) & ~127
        self.one_pos = one_pos
        self.bs_max = 0
        self._cur: _StepRef | None = None
        self._fin: list = []       # (op, lo, hi, colinfo[4], dp)
        self._bank_rows: list = []  # full-width rows, sliced at arrays()
        self._iota = np.arange(self.W, dtype=np.int32)

    # -- step constructors (return the 4 row views for compatibility) --

    def _begin(self, op: int, dflts) -> tuple:
        self._finalize()
        W = self.W
        rows = []
        for dk, dc in dflts:
            rows.append(self._iota.copy() if dk == 0
                        else np.full(W, dc, np.int32))
        self._cur = _StepRef(op, rows, dflts)
        return tuple(rows)

    def new_step(self, csrc: bool = False):
        """2-mul affine step. With ``csrc`` the coefficients come from
        the in-scan scratch (row 0 = passthrough one/zero constants)."""
        if csrc:
            return self._begin(OP_AFFINE_C,
                               ((1, 0), (0, 0), (1, 0), (0, 0)))
        return self._begin(OP_AFFINE, ((1, ONE), (0, 0), (1, ZERO), (0, 0)))

    def new_mul_step(self):
        """out[p] = x[g1[p]]·x[g2[p]]; defaults to x[p]·1."""
        assert self.one_pos is not None, "mul steps need one_pos"
        return self._begin(OP_MUL,
                           ((1, 0), (0, 0), (1, 0), (1, self.one_pos)))

    def new_aff1_step(self, self_read: bool = False, csrc: bool = False):
        """out[p] = x[g1[p]] + C·x[g2[p]] — the 1-mul step. With
        ``self_read`` the runtime reads x1 as the window slice itself
        and g1 is ignored. With ``csrc``, C comes from the in-scan
        scratch instead of the pool."""
        if csrc:
            op = OP_AFF1S_C if self_read else OP_AFF1_C
            return self._begin(op, ((1, 0), (0, 0), (1, 0), (0, 0)))
        op = OP_AFF1S if self_read else OP_AFF1
        return self._begin(op, ((1, 0), (0, 0), (1, ZERO), (0, 0)))

    def new_cmpsel_step(self):
        """comp = ∀p x[a[p]] == x[b[p]] (per batch lane);
        out[p] = comp ? x[g1[p]] : x[g2[p]]."""
        return self._begin(OP_CMPSEL, ((0, 0), (0, 0), (0, 0), (0, 0)))

    @property
    def zero_pos(self) -> int:
        """A state row that is zero forever: the last pad row (state
        widths are odd pre-padding, so at least one pad row exists).
        Lets pure-scale steps ride OP_AFF1: out = x[zero] + C·x[g2]."""
        assert self.W > self._orig_w, "no pad row available"
        return self.W - 1

    # -- hints ---------------------------------------------------------

    def hint(self, col: str, **kw):
        """Attach the closed-form index formula for ``col`` of the
        current step (see _P for parameters). The step's default
        (dk, dc) is filled in automatically unless overridden."""
        ci = COLS.index(col)
        dk, dc = self._cur._dflts[ci]
        kw.setdefault("dk", dk)
        kw.setdefault("dc", dc)
        self._cur.hints[ci] = _P(**kw)

    def dop(self, dop: int, shalf: int, hm: int, half: int, ms0: int,
            ms1: int, mp0: int, mp1: int, msi0: int, msi1: int):
        """Set the current step's D-engine micro-op (see DP_* slots)."""
        self._cur.dp[:] = (dop, shalf, hm, half, ms0, ms1, mp0, mp1,
                           msi0, msi1)

    def track_bs(self, bs: int):
        self.bs_max = max(self.bs_max, bs)

    # -- finalize / assemble -------------------------------------------

    def _finalize(self):
        cur = self._cur
        if cur is None:
            return
        self._cur = None
        W = self.W
        colinfo = []  # per column: ("p", params) | ("bank", bank_id)
        lo, hi = W, 0
        for ci in range(4):
            row = cur.rows[ci]
            hint = cur.hints[ci]
            dk, dc = cur._dflts[ci]
            if hint is not None:
                synth = _synth_np(hint, W)
                if not np.array_equal(synth, row):
                    bad = np.nonzero(synth != row)[0]
                    raise AssertionError(
                        f"schedule hint mismatch: op={cur.op} col="
                        f"{COLS[ci]} first bad p={bad[0]} "
                        f"(formula {synth[bad[0]]} != row {row[bad[0]]}; "
                        f"{bad.size} rows differ)")
                colinfo.append(("p", hint))
                span = int(hint[CP_SPAN])
                if span > 0:
                    lo = min(lo, int(hint[CP_OFF]))
                    hi = max(hi, int(hint[CP_OFF]) + span)
                continue
            base = (self._iota if dk == 0
                    else np.full(W, dc, np.int32))
            diff = np.nonzero(row != base)[0]
            if diff.size == 0:
                colinfo.append(("p", _P(dk=dk, dc=dc)))
                continue
            self._bank_rows.append(row)
            colinfo.append(("bank", len(self._bank_rows) - 1))
            lo = min(lo, int(diff[0]))
            hi = max(hi, int(diff[-1]) + 1)
        if hi <= lo:  # fully-passthrough step
            lo, hi = 0, 1
        self._fin.append((cur.op, lo, hi, colinfo, cur.dp))

    def arrays(self) -> Schedule:
        """Assemble the finalized steps into a Schedule. The window
        width A is the max active span over steps, padded to the 128-row
        position tile; residual bank rows are sliced to their step's
        window."""
        self._finalize()
        W = self.W
        steps = self._fin
        # starts are 128-aligned (every power-of-two position tile up to
        # 128 then divides both start and A), so A must absorb each
        # step's alignment slack: A >= hi - (lo & ~127) guarantees
        # [start, start + A) covers [lo, hi) for start = min(lo & ~127,
        # W - A) (W - A is itself 128-aligned since both are multiples)
        A = max(hi - (lo & ~127) for _, lo, hi, _, _ in steps)
        A = min(W, (A + 127) & ~127)
        ops = np.asarray([s[0] for s in steps], np.int32)
        starts = np.asarray(
            [min(lo & ~127, W - A) for _, lo, _, _, _ in steps], np.int32)
        for t, (_, lo, hi, _, _) in enumerate(steps):
            assert starts[t] <= lo and starts[t] + A >= hi, (t, lo, hi)
        colp = np.zeros((len(steps), 4, NCP), np.int32)
        rid = np.full((len(steps), 4), -1, np.int32)
        dp = np.stack([s[4] for s in steps])
        bank = []
        for t, (op, lo, hi, colinfo, _) in enumerate(steps):
            start = int(starts[t])
            for ci, (kind, val) in enumerate(colinfo):
                if kind == "p":
                    colp[t, ci] = val
                else:
                    row = self._bank_rows[val][start:start + A]
                    bank.append(np.ascontiguousarray(row))
                    rid[t, ci] = len(bank) - 1
        bank = (np.stack(bank) if bank
                else np.zeros((1, A), np.int32))
        xs = (ops, starts, colp, dp, rid, bank)
        return Schedule(W, A, self.bs_max, xs)




def _mesh(nb: int, bs: int):
    J, I = np.meshgrid(np.arange(nb), np.arange(bs), indexing="ij")
    return J.ravel(), I.ravel()


def _emit_extend(bld, off, k: int, moiety: int, dst, nblocks: int,
                 src=None):
    """Butterfly steps of EXTEND over tree size k on a block region.

    ``dst`` = (base, stride): the m/2-point inputs of block j live at
    positions base + j·stride + i, i < k/2 (stride ≥ k/2; EXIT uses
    stride-k gapped regions). ``src`` = (base, stride, iscale_log): the
    first down-level reads inputs from base + j·stride + (i << iscale),
    folding lane-to-lane copies into the butterfly (multi-block sources
    must share the destination stride; strided single-block sources like
    DEGREE's even-eval subsample use iscale). Blocks share coefficients.

    SCALED EMISSION (default): every level but the last is the 1-mul
    form out[p] = x[p] + C·x[p^half] with C computed by the in-scan
    running-diagonal engine (DOP_LEVEL0/LEVEL micro-ops on each step);
    the last recombine level applies the accumulated diagonal with a
    2-mul OP_AFFINE_C (DOP_FINAL), so the extend's outputs are exactly
    the reference's (fftree.rs:72-120) at ~55% of the multiply work.
    When the pool flags ``unscaled`` (some Lemma-3.2 diagonal is zero),
    every level runs as an exact 2-mul OP_AFFINE with coefficients
    gathered straight from the compact matrix planes.
    """
    bs = k // 2
    if bs == 1:
        return  # size-1 extend is the identity (fftree.rs:74-76)
    logm = _ilog2(bs)
    R0, dstr = dst
    span = (nblocks - 1) * dstr + bs
    act = dict(off=R0, span=span, km=dstr - 1, alo=0, ahi=bs)
    if src is not None:
        S0b, sstr, isl = src
        assert nblocks == 1 or (sstr == dstr and isl == 0), \
            "multi-block sources must share the destination stride"
    unscaled = off.get("unscaled", False)
    pdec = 0 if moiety == S0 else 1
    prec = 2 if moiety == S0 else 3
    levels = [(pdec, d, False) for d in range(logm)]
    levels += [(prec, d, d == 0) for d in reversed(range(logm))]
    bld.track_bs(bs)
    J, I = _mesh(nblocks, bs)
    P = R0 + J * dstr + I

    def hint_partner(col, half, from_src: bool):
        if not from_src:
            bld.hint(col, **act, c0=R0, xx=half, m3=-1)
        elif nblocks > 1 or (sstr == dstr and isl == 0):
            bld.hint(col, **act, c0=S0b, xx=half, m3=-1)
        else:  # strided single-block source: xor on u = t << isl
            bld.hint(col, **act, c0=S0b, s2=-isl, xx=half << isl, m3=-1)

    def hint_src_read(col):
        if nblocks > 1 or (sstr == dstr and isl == 0):
            bld.hint(col, **act, c0=S0b, m1=-1)
        else:
            bld.hint(col, **act, c0=S0b, s2=-isl, m2=-1)

    for li, (pi, d, fin) in enumerate(levels):
        half = bs >> (d + 1)
        bm = off[f"bm_{k}_{d}_{pi}"]
        hw = half  # plane width
        use_src = li == 0 and src is not None
        srcp = (S0b + J * sstr + (I << isl)) if use_src else None
        if unscaled:
            # exact 2-mul butterfly: a = diag, b = off-diag, selected by
            # the butterfly bit (the reference's matrix application)
            ar, g1, br, g2 = bld.new_step()
            ar[P] = np.where((I & half) != 0, bm + hw, bm) + (I & (half - 1))
            br[P] = (np.where((I & half) != 0, bm + 3 * hw, bm + 2 * hw)
                     + (I & (half - 1)))
            bld.hint("a", **act, sb=_ilog2(half), c0=bm, c1=bm + hw,
                     m1=half - 1, dk=1, dc=ONE)
            bld.hint("b", **act, sb=_ilog2(half), c0=bm + 2 * hw,
                     c1=bm + 3 * hw, m1=half - 1, dk=1, dc=ZERO)
            if use_src:
                g1[P] = srcp
                g2[P] = S0b + J * sstr + ((I ^ half) << isl)
                hint_src_read("g1")
                hint_partner("g2", half, True)
            else:
                g2[P] = R0 + J * dstr + (I ^ half)
                hint_partner("g2", half, False)
            continue
        if fin:  # unscale: out = (Ms·D)·x[p] + (Mp·D[perm])·x[p^half]
            ar, g1, br, g2 = bld.new_step(csrc=True)
            ar[P] = 1 + I
            br[P] = 1 + I
            g2[P] = R0 + J * dstr + (I ^ half)
            bld.hint("a", **act, c0=1, m1=dstr - 1)
            bld.hint("b", **act, c0=1, m1=dstr - 1)
            hint_partner("g2", half, False)
        elif use_src:
            ar, g1, br, g2 = bld.new_aff1_step(csrc=True)
            br[P] = 1 + I
            g1[P] = srcp
            g2[P] = S0b + J * sstr + ((I ^ half) << isl)
            bld.hint("b", **act, c0=1, m1=dstr - 1)
            hint_src_read("g1")
            hint_partner("g2", half, True)
        else:
            ar, g1, br, g2 = bld.new_aff1_step(self_read=True, csrc=True)
            br[P] = 1 + I
            g2[P] = R0 + J * dstr + (I ^ half)
            bld.hint("b", **act, c0=1, m1=dstr - 1)
            hint_partner("g2", half, False)
        bld.dop(DOP_FINAL if fin else (DOP_LEVEL0 if li == 0
                                       else DOP_LEVEL),
                shalf=_ilog2(half), hm=half - 1, half=half,
                ms0=bm, ms1=bm + hw, mp0=bm + 2 * hw, mp1=bm + 3 * hw,
                msi0=bm + 4 * hw, msi1=bm + 5 * hw)


def extend_schedule(tree, m: int, moiety: int, mextend: bool = False):
    """Standalone EXTEND/MEXTEND of an m-point input (tree size 2m).

    State width m+1 (const-one slot feeds MEXTEND's +Z table term,
    fftree.rs:128-135)."""
    off = tree.pool_offsets
    W = m + 1
    bld = _Builder(W)
    _emit_extend(bld, off, 2 * m, moiety, (0, m), 1)
    if mextend:
        zkey = "z0_s1" if moiety == S1 else "z1_s0"
        zoff = off[f"{zkey}_{2 * m}"]
        ar, g1, br, g2 = bld.new_aff1_step(self_read=True)
        idx = np.arange(m)
        br[idx] = zoff + idx
        g2[idx] = m  # const-one slot
        bld.hint("b", off=0, span=m, c0=zoff, m1=-1)
        bld.hint("g2", off=0, span=m, c0=m)
    return bld.arrays()


def enter_schedule(tree, n: int):
    """ENTER as a schedule (fftree.rs:143-167): per block size k, fold the
    lane copy into depth-0 butterflies on the scratch lane, then one
    combine step interleaving U + X^(k/2)·V."""
    off = tree.pool_offsets
    W = 2 * n + 1
    bld = _Builder(W)
    size = 2
    while size <= n:
        k, bs = size, size // 2
        # every block extends (u and v alike); scratch lane destination
        _emit_extend(bld, off, k, S1, (n, bs), n // bs, src=(0, bs, 0))
        # combine (fftree.rs:155-159): u + xnn·v is the 1-mul form
        xnn_off = off[f"xnn_s_{k}"]
        ar, g1, br, g2 = bld.new_aff1_step()
        Jc, Rc = _mesh(n // k, k)
        Ic = Rc // 2
        P = Jc * k + Rc
        # u1/v1 come from the scratch lane (lane0 when bs == 1: the
        # size-1 extend was the identity)
        nbase = 0 if bs == 1 else n
        base = np.where(Rc % 2 == 0, 0, nbase)
        g1[P] = base + Jc * k + Ic
        g2[P] = base + Jc * k + bs + Ic
        br[P] = xnn_off + Rc
        bld.hint("g1", off=0, span=n, sb=0, c0=0, c1=nbase,
                 m1=~(k - 1), s2=1, m2=(k - 1) >> 1)
        bld.hint("g2", off=0, span=n, sb=0, c0=bs, c1=nbase + bs,
                 m1=~(k - 1), s2=1, m2=(k - 1) >> 1)
        bld.hint("b", off=0, span=n, c0=xnn_off, m1=k - 1)
        size *= 2
    return bld.arrays()


def exit_schedule(tree, n: int):
    """EXIT as a schedule (fftree.rs:200-230): per level k (n down to 2),
    MOD by X^(k/2) = REDC ∘ (·c) ∘ REDC with the ·c and a₀⁻¹ stages fused
    into pool coefficients, then the u0/v0 split. Scratch lane regions:
    Sa = first half of each block, Sb = second half.
    """
    off = tree.pool_offsets
    W = 2 * n + 1
    bld = _Builder(W)
    k = n
    while k >= 2:
        bs = k // 2
        nb = n // k
        SA0, SB0 = n, n + bs  # stride-k block regions on the scratch lane
        a0inv = off[f"xnn_s_inv_{k}"]  # even entries via stride-2 index
        z0inv = off[f"z0_inv_s1_{k}"]
        negaz = off[f"neg_a1_z0inv_{k}"]
        c0a0 = off[f"c0_a0inv_{k}"]
        zc1 = off[f"zc1_{k}"]
        negxi = off[f"neg_xnninv_{k}"]
        J, I = _mesh(nb, bs)
        SA = SA0 + J * k + I
        SB = SB0 + J * k + I
        actA = dict(off=SA0, span=(nb - 1) * k + bs, km=k - 1, alo=0,
                    ahi=bs)
        actB = dict(off=SB0, span=(nb - 1) * k + bs, km=k - 1, alo=0,
                    ahi=bs)

        # -- REDC 1 (moiety S0, a = xnn) --
        # t0 = e0·a0inv → Sa (fftree.rs:238): pure scale = 1-mul step
        # reading the always-zero pad row as x1
        ar, g1, br, g2 = bld.new_aff1_step()
        g1[SA] = bld.zero_pos
        br[SA] = a0inv + 2 * I
        g2[SA] = J * k + 2 * I
        bld.hint("g1", **actA, c0=bld.zero_pos, dk=0)
        bld.hint("b", **actA, c0=a0inv, s2=-1, m2=2 * bs - 1)
        bld.hint("g2", **actA, m1=~(k - 1), s2=-1, m2=2 * bs - 1)
        # g1v = extend(t0, S1) on Sa
        _emit_extend(bld, off, k, S1, (SA0, k), nb)
        # h1 = z0inv·e1 + negaz·g1v → Sb  (fftree.rs:253-255)
        ar, g1, br, g2 = bld.new_step()
        ar[SB] = z0inv + I
        g1[SB] = J * k + 2 * I + 1
        br[SB] = negaz + I
        g2[SB] = SA
        bld.hint("a", **actB, c0=z0inv, m1=k - 1)
        bld.hint("g1", **actB, c0=1, m1=~(k - 1), s2=-1, m2=2 * bs - 1)
        bld.hint("b", **actB, c0=negaz, m1=k - 1)
        bld.hint("g2", **actB, c0=SA0, m1=-1)
        # h0 = extend(h1, S0): read Sb, work in Sa (h1 must survive)
        _emit_extend(bld, off, k, S0, (SA0, k), nb, src=(SB0, k, 0))
        h0b, h1b = (SA0, SB0) if bs > 1 else (SB0, SB0)

        # -- fuse ·c and REDC 2 (fftree.rs:277-281) --
        # t0' = (h0·c_even)·a0inv = c0a0·h0 → Sa (1-mul scale)
        ar, g1, br, g2 = bld.new_aff1_step()
        g1[SA] = bld.zero_pos
        br[SA] = c0a0 + I
        g2[SA] = h0b + J * k + I
        bld.hint("g1", **actA, c0=bld.zero_pos, dk=0)
        bld.hint("b", **actA, c0=c0a0, m1=k - 1)
        bld.hint("g2", **actA, c0=h0b, m1=-1)
        _emit_extend(bld, off, k, S1, (SA0, k), nb)
        # h1' = zc1·h1 + negaz·g1v' → Sb
        ar, g1, br, g2 = bld.new_step()
        ar[SB] = zc1 + I
        g1[SB] = h1b + J * k + I
        br[SB] = negaz + I
        g2[SB] = SA
        bld.hint("a", **actB, c0=zc1, m1=k - 1)
        bld.hint("g1", **actB, c0=h1b, m1=-1)
        bld.hint("b", **actB, c0=negaz, m1=k - 1)
        bld.hint("g2", **actB, c0=SA0, m1=-1)
        _emit_extend(bld, off, k, S0, (SA0, k), nb, src=(SB0, k, 0))
        U0b = SA0 if bs > 1 else SB0

        # -- split: b-half first (it reads e0 the a-half would clobber),
        # then a-half = u0 (fftree.rs:206-221; u0 = MOD's even = h0') --
        ar, g1, br, g2 = bld.new_step()
        PB = J * k + bs + I
        ar[PB] = a0inv + 2 * I
        g1[PB] = J * k + 2 * I
        br[PB] = negxi + 2 * I
        g2[PB] = U0b + J * k + I
        actPB = dict(off=bs, span=(nb - 1) * k + bs, km=k - 1, alo=0,
                     ahi=bs)
        bld.hint("a", **actPB, c0=a0inv, s2=-1, m2=2 * bs - 1)
        bld.hint("g1", **actPB, m1=~(k - 1), s2=-1, m2=2 * bs - 1)
        bld.hint("b", **actPB, c0=negxi, s2=-1, m2=2 * bs - 1)
        bld.hint("g2", **actPB, c0=U0b, m1=-1)
        ar, g1, br, g2 = bld.new_aff1_step()
        PA = J * k + I
        g1[PA] = U0b + J * k + I
        bld.hint("g1", off=0, span=(nb - 1) * k + bs, km=k - 1, alo=0,
                 ahi=bs, c0=U0b, m1=-1)
        k //= 2
    return bld.arrays()


def mod_schedule(tree, k: int, redc_only: bool = False, moiety: int = S0):
    """Standalone MOD (or single REDC) by a = X^(k/2) with the canonical
    c table (the fftree.rs:286-289 public entry specialized to the
    precomputed-modulus case). Output replaces the value lane with the
    interleaved (h0', h1') table. ``moiety=S1`` gives canonical REDC by
    Z₁ (fftree.rs:272-275); full MOD is S0-only (fftree.rs:278-280).
    """
    assert moiety == S0 or redc_only, "full MOD is S0-only"
    off = tree.pool_offsets
    n = k
    W = 2 * n + 1
    bld = _Builder(W)
    bs = k // 2
    SA0, SB0 = n, n + bs
    a0inv = off[f"xnn_s_inv_{k}"]
    z0inv = (off[f"z0_inv_s1_{k}"] if moiety == S0
             else off[f"z1_inv_s0_{k}"])
    negaz = (off[f"neg_a1_z0inv_{k}"] if moiety == S0
             else off[f"neg_a1_z1inv_{k}"])
    c0a0 = off[f"c0_a0inv_{k}"]
    zc1 = off[f"zc1_{k}"]
    other = S1 if moiety == S0 else S0

    I = np.arange(bs)
    SA, SB = SA0 + I, SB0 + I
    actA = dict(off=SA0, span=bs)
    actB = dict(off=SB0, span=bs)
    ar, g1, br, g2 = bld.new_aff1_step()
    g1[SA] = bld.zero_pos
    br[SA] = a0inv + 2 * I
    g2[SA] = 2 * I
    bld.hint("g1", **actA, c0=bld.zero_pos, dk=0)
    bld.hint("b", **actA, c0=a0inv, s2=-1, m2=-1)
    bld.hint("g2", **actA, s2=-1, m2=-1)
    _emit_extend(bld, off, k, other, (SA0, k), 1)
    ar, g1, br, g2 = bld.new_step()
    ar[SB] = z0inv + I
    g1[SB] = 2 * I + 1
    br[SB] = negaz + I
    g2[SB] = SA
    bld.hint("a", **actB, c0=z0inv, m1=-1)
    bld.hint("g1", **actB, c0=1, s2=-1, m2=-1)
    bld.hint("b", **actB, c0=negaz, m1=-1)
    bld.hint("g2", **actB, c0=SA0, m1=-1)
    _emit_extend(bld, off, k, moiety, (SA0, k), 1, src=(SB0, k, 0))
    h0b, h1b = (SA0, SB0) if bs > 1 else (SB0, SB0)
    if not redc_only:
        ar, g1, br, g2 = bld.new_aff1_step()
        g1[SA] = bld.zero_pos
        br[SA] = c0a0 + I
        g2[SA] = h0b + I
        bld.hint("g1", **actA, c0=bld.zero_pos, dk=0)
        bld.hint("b", **actA, c0=c0a0, m1=-1)
        bld.hint("g2", **actA, c0=h0b, m1=-1)
        _emit_extend(bld, off, k, S1, (SA0, k), 1)
        ar, g1, br, g2 = bld.new_step()
        ar[SB] = zc1 + I
        g1[SB] = h1b + I
        br[SB] = negaz + I
        g2[SB] = SA
        bld.hint("a", **actB, c0=zc1, m1=-1)
        bld.hint("g1", **actB, c0=h1b, m1=-1)
        bld.hint("b", **actB, c0=negaz, m1=-1)
        bld.hint("g2", **actB, c0=SA0, m1=-1)
        _emit_extend(bld, off, k, S0, (SA0, k), 1, src=(SB0, k, 0))
        h0b = SA0 if bs > 1 else SB0
        h1b = SB0
    # interleave result back onto the value lane (mul-free copy step)
    ar, g1, br, g2 = bld.new_aff1_step()
    g1[2 * I] = h0b + I
    g1[2 * I + 1] = h1b + I
    bld.hint("g1", off=0, span=k, sb=0, c0=h0b, c1=h1b, s2=1, m2=-1)
    return bld.arrays()


def degree_schedule(tree, n: int):
    """DEGREE as a schedule (fftree.rs:169-198).

    Per level k: extend the even evals onto S₁, compare against the odd
    evals (one OP_CMPSEL bool per batch lane), and select either the
    low path (keep e₀) or the high path t₀ = extend((e₁−g₁)·z₀⁻¹, S₀),
    accumulating k/2 on the high path. The accumulator rides the state
    as a field element; the wrapper decodes it to int32.

    State: V [0,n) evals · acc at n · acc+k/2 at n+1 · one at n+2 ·
    SA [n+3, n+3+n/2) extend scratch · SB t₁/t₀ scratch. Every step is
    laid out to keep its active span ≤ n/2+1: the accumulator update is
    its own one-row step; the branch select is TWO cmpsel steps (V rows,
    then acc) whose compare indices live on rows just below acc — so the
    whole schedule windows to ~n/2 instead of ~2n.
    """
    off = tree.pool_offsets
    acc, acc_s = n, n + 1
    one_pos = n + 2
    sa = n + 3
    sb = sa + n // 2
    bld = _Builder(sb + n // 2, one_pos=one_pos)
    k = n
    while k >= 2:
        bs = k // 2
        I = np.arange(bs)
        SA, SB = sa + I, sb + I
        # acc_s = acc + k/2 (one-row 1-mul step)
        ar, g1, br, g2 = bld.new_aff1_step()
        g1[acc_s] = acc
        br[acc_s] = off[f"half_const_{k}"]
        g2[acc_s] = one_pos
        bld.hint("g1", off=acc_s, span=1, c0=acc, dk=0)
        bld.hint("b", off=acc_s, span=1, c0=off[f"half_const_{k}"])
        bld.hint("g2", off=acc_s, span=1, c0=one_pos, dk=0)
        if bs == 1:
            ar, g1, br, g2 = bld.new_aff1_step()  # identity extend = copy
            g1[SA] = 2 * I
            bld.hint("g1", off=sa, span=1, c0=0)
        else:
            _emit_extend(bld, off, k, S1, (sa, bs), 1, src=(0, 1, 1))
        # t1 = z0inv·e1 − z0inv·g1 → SB
        ar, g1, br, g2 = bld.new_step()
        ar[SB] = off[f"z0_inv_s1_{k}"] + I
        g1[SB] = 2 * I + 1
        br[SB] = off[f"neg_z0_inv_s1_{k}"] + I
        g2[SB] = SA
        bld.hint("a", off=sb, span=bs, c0=off[f"z0_inv_s1_{k}"], m1=-1)
        bld.hint("g1", off=sb, span=bs, c0=1, s2=-1, m2=-1)
        bld.hint("b", off=sb, span=bs, c0=off[f"neg_z0_inv_s1_{k}"],
                 m1=-1)
        bld.hint("g2", off=sb, span=bs, c0=sa, m1=-1)
        if bs > 1:
            _emit_extend(bld, off, k, S0, (sb, bs), 1, src=(sb, bs, 0))
        # low path iff extend(e₀) == e₁. cmpsel 1: acc row FIRST (the
        # V-select below overwrites the odd evals the compare reads) —
        # the compare pairs sit on rows just below acc
        ar, g1, br, g2 = bld.new_cmpsel_step()
        rows = acc - bs + I
        ar[rows] = SA
        br[rows] = 2 * I + 1
        g1[acc] = acc
        g2[acc] = acc_s
        bld.hint("a", off=acc - bs, span=bs, c0=sa, m1=-1)
        bld.hint("b", off=acc - bs, span=bs, c0=1, s2=-1, m2=-1)
        bld.hint("g1", off=acc, span=1, c0=acc, dk=0)
        bld.hint("g2", off=acc, span=1, c0=acc_s, dk=0)
        # cmpsel 2: V rows — compare pairs sit on the SAME rows being
        # written (a/b are compare indices, g1/g2 the select)
        ar, g1, br, g2 = bld.new_cmpsel_step()
        ar[I] = SA
        br[I] = 2 * I + 1
        g1[I] = 2 * I
        g2[I] = SB
        bld.hint("a", off=0, span=bs, c0=sa, m1=-1)
        bld.hint("b", off=0, span=bs, c0=1, s2=-1, m2=-1)
        bld.hint("g1", off=0, span=bs, s2=-1, m2=-1)
        bld.hint("g2", off=0, span=bs, c0=sb, m1=-1)
        k //= 2
    # expose acc at row 0 for from_state (mul-free copy step)
    ar, g1, br, g2 = bld.new_aff1_step()
    g1[0] = acc
    bld.hint("g1", off=0, span=1, c0=acc)
    return bld.arrays()


def vanish_schedule(tree, v: int):
    """VANISH of v arbitrary points over the size-2v (sub)tree as a
    schedule (fftree.rs:291-316): base values [α−l₀, α−l₁] via the
    negated 2-leaf domain, then per level one OP_MUL pairwise merge and
    a batched MEXTEND.

    Values live MOIETY-PLANAR: two v-row planes (S0 values, S1 values)
    that ping-pong with the two v-row scratch planes each level — a
    merged group's S0 plane IS the product plane and its S1 plane IS
    the mextend output, so there are no interleave steps and every
    step's active span is exactly v. The final domain-ordered interleave
    is a post-scan output permutation (run_schedule's out_perm).

    Returns the schedule with out_perm set.
    """
    off = tree.pool_offsets
    one_pos = 4 * v
    bld = _Builder(4 * v + 1, one_pos=one_pos)
    I = np.arange(v)
    # base planes (input points arrive at rows [0, v)): S1 plane first —
    # the S0 plane overwrites the inputs in place
    ar, g1, br, g2 = bld.new_aff1_step()
    g1[v + I] = I
    br[v + I] = off["neg_leaf2"] + 1
    g2[v + I] = one_pos
    bld.hint("g1", off=v, span=v, m1=-1)
    bld.hint("b", off=v, span=v, c0=off["neg_leaf2"] + 1)
    bld.hint("g2", off=v, span=v, c0=one_pos)
    ar, g1, br, g2 = bld.new_aff1_step(self_read=True)
    br[I] = off["neg_leaf2"] + 0
    g2[I] = one_pos
    bld.hint("b", off=0, span=v, c0=off["neg_leaf2"])
    bld.hint("g2", off=0, span=v, c0=one_pos)
    base = 0  # current planes at [base, base+2v); scratch at the other
    cur = 2
    while cur < 2 * v:
        ng = 2 * v // cur // 2  # merged groups this level
        scratch = 2 * v - base
        mc = cur // 2  # per-moiety size of a child group
        J, T = _mesh(ng, cur)
        SA = scratch + J * cur + T
        SB = scratch + v + J * cur + T
        # child value at domain position t: even → S0 plane, odd → S1;
        # q_s0[g, t] = left(t) · right(t) (state×state)
        ar, g1, br, g2 = bld.new_mul_step()
        g1[SA] = base + np.where(T % 2 == 0, 0, v) + 2 * J * mc + T // 2
        g2[SA] = (base + np.where(T % 2 == 0, 0, v) + (2 * J + 1) * mc
                  + T // 2)
        bld.hint("g1", off=scratch, span=ng * cur, sb=0, c0=base,
                 c1=base + v, m1=~(cur - 1), s2=1, m2=mc - 1)
        bld.hint("g2", off=scratch, span=ng * cur, sb=0, c0=base + mc,
                 c1=base + v + mc, m1=~(cur - 1), s2=1, m2=mc - 1)
        # mextend q onto S1 of the size-2·cur tree → the new S1 plane
        _emit_extend(bld, off, 2 * cur, S1, (scratch + v, cur), ng,
                     src=(scratch, cur, 0))
        ar, g1, br, g2 = bld.new_aff1_step(self_read=True)
        br[SB] = off[f"z0_s1_{2 * cur}"] + T
        g2[SB] = one_pos
        bld.hint("b", off=scratch + v, span=ng * cur,
                 c0=off[f"z0_s1_{2 * cur}"], m1=cur - 1)
        bld.hint("g2", off=scratch + v, span=ng * cur, c0=one_pos)
        base = scratch
        cur *= 2
    perm = np.empty(2 * v, dtype=np.int32)
    perm[0::2] = base + np.arange(v)
    perm[1::2] = base + v + np.arange(v)
    return bld.arrays()._replace(out_perm=perm)


def general_mod_schedule(tree, m: int, moiety: int = S0,
                         redc_only: bool = False):
    """REDC (and MOD) with a RUNTIME modulus table, fully scheduled
    (fftree.rs:232-289): the caller packs [evals ‖ a] (REDC) or
    [evals ‖ a ‖ c] (MOD) along the position axis. a₀⁻¹ is computed by
    a scheduled Fermat chain (square-and-multiply over p−2, OP_MUL
    steps) — the reference burns a batch_inversion per call here
    (fftree.rs:236); we burn ~2·log p scan steps and stay inside the
    single compiled interpreter.

    State: V [0,m) evals/result · A [m,2m) · C [2m,3m) (MOD only) ·
    AI a₀⁻¹ · SA · SB (each m/2) · one.
    """
    off = tree.pool_offsets
    spec = tree.spec
    bs = m // 2
    base = 2 * m if redc_only else 3 * m
    ai, sa, sb = base, base + bs, base + 2 * bs
    one_pos = base + 3 * bs
    bld = _Builder(one_pos + 1, one_pos=one_pos)
    I = np.arange(bs)
    AI, SA, SB = ai + I, sa + I, sb + I
    A0, A1 = m + 2 * I, m + 2 * I + 1
    actAI = dict(off=ai, span=bs)
    actSA = dict(off=sa, span=bs)
    actSB = dict(off=sb, span=bs)

    # --- scheduled Fermat: AI = a₀^(p−2) ---
    ar, g1, br, g2 = bld.new_aff1_step()
    g1[AI] = A0  # acc = base (top exponent bit); mul-free copy
    bld.hint("g1", **actAI, c0=m, s2=-1, m2=-1)
    ebits = bin(spec.p - 2)[2:]
    for bit in ebits[1:]:
        ar, g1, br, g2 = bld.new_mul_step()
        g1[AI] = AI
        g2[AI] = AI  # square
        bld.hint("g1", **actAI, c0=ai, m1=-1)
        bld.hint("g2", **actAI, c0=ai, m1=-1)
        if bit == "1":
            ar, g1, br, g2 = bld.new_mul_step()
            g1[AI] = AI
            g2[AI] = A0  # multiply by base
            bld.hint("g1", **actAI, c0=ai, m1=-1)
            bld.hint("g2", **actAI, c0=m, s2=-1, m2=-1)

    other = S1 if moiety == S0 else S0
    zinv = (off[f"z0_inv_s1_{m}"] if moiety == S0
            else off[f"z1_inv_s0_{m}"])
    neg_zinv = (off[f"neg_z0_inv_s1_{m}"] if moiety == S0
                else off[f"neg_z1_inv_s0_{m}"])

    def redc_pass(e0, e1):
        """SA ← h0, SB ← h1; e0/e1 = (row values, hint params) pairs."""
        e0_rows, e0_p = e0
        e1_rows, e1_p = e1
        # t0 = e0·a0inv → SA
        ar, g1, br, g2 = bld.new_mul_step()
        g1[SA] = e0_rows
        g2[SA] = AI
        bld.hint("g1", **actSA, **e0_p)
        bld.hint("g2", **actSA, c0=ai, m1=-1)
        # g1v = extend(t0, other) in place
        if bs > 1:
            _emit_extend(bld, off, m, other, (sa, bs), 1)
        # g1v·a1 in place
        ar, g1, br, g2 = bld.new_mul_step()
        g1[SA] = SA
        g2[SA] = A1
        bld.hint("g1", **actSA, c0=sa, m1=-1)
        bld.hint("g2", **actSA, c0=m + 1, s2=-1, m2=-1)
        # h1 = zinv·e1 + neg_zinv·(g1v·a1) → SB
        ar, g1, br, g2 = bld.new_step()
        ar[SB] = zinv + I
        g1[SB] = e1_rows
        br[SB] = neg_zinv + I
        g2[SB] = SA
        bld.hint("a", **actSB, c0=zinv, m1=-1)
        bld.hint("g1", **actSB, **e1_p)
        bld.hint("b", **actSB, c0=neg_zinv, m1=-1)
        bld.hint("g2", **actSB, c0=sa, m1=-1)
        # h0 = extend(h1, moiety) → SA
        if bs > 1:
            _emit_extend(bld, off, m, moiety, (sa, bs), 1,
                         src=(sb, bs, 0))
        else:
            ar, g1, br, g2 = bld.new_step()
            g1[SA] = SB
            bld.hint("g1", **actSA, c0=sb, m1=-1)

    redc_pass((2 * I, dict(s2=-1, m2=-1)),
              (2 * I + 1, dict(c0=1, s2=-1, m2=-1)))
    if not redc_only:
        # scale by c (hc0 = h0·c_even, hc1 = h1·c_odd): SA and SB are
        # adjacent, so one mul step with a parity-like select on the
        # bs-bit covers both halves
        ar, g1, br, g2 = bld.new_mul_step()
        g1[SA] = SA
        g2[SA] = 2 * m + 2 * I
        g1[SB] = SB
        g2[SB] = 2 * m + 2 * I + 1
        bld.hint("g1", off=sa, span=2 * bs, c0=sa, m1=-1)
        bld.hint("g2", off=sa, span=2 * bs, sb=_ilog2(bs),
                 c0=2 * m, c1=2 * m - 2 * bs + 1, s2=-1, m2=-1)
        redc_pass((SA, dict(c0=sa, m1=-1)), (SB, dict(c0=sb, m1=-1)))
    # interleave (h0, h1) onto V (mul-free copy step)
    ar, g1, br, g2 = bld.new_aff1_step()
    g1[2 * I] = SA
    g1[2 * I + 1] = SB
    bld.hint("g1", off=0, span=m, sb=0, c0=sa, c1=sb, s2=1, m2=-1)
    return bld.arrays()


# --------------------------------------------------------------- runtime
#
# State layout (W, L, B): BATCH last, so every limb plane of a window is
# contiguous along the batch and each per-limb load or store of a step
# moves whole batch rows. The step math below is the device.py pipeline
# re-indexed to limb-axis = -2, with the conv done by shift-accumulate
# (no (L, L) outer-product materialization) and both products of the
# affine step summed before a single fold/normalize chain.

_MASKc = jnp.uint32(0xFFFF)


def _normalize_cols(c):
    """Carry-normalize along axis -2 (cols < 2^32 → canonical, width+1)."""
    g = c >> 16
    lo = c & _MASKc
    zc = jnp.zeros_like(g[..., :1, :])
    t1 = jnp.concatenate([lo, zc], -2) + jnp.concatenate([zc, g], -2)
    g2 = (t1 >> 16).astype(bool)
    p2 = (t1 & _MASKc) == _MASKc

    def combine(lhs, rhs):
        gl, pl = lhs
        gr, pr = rhs
        return gr | (pr & gl), pr & pl

    G, _ = jax.lax.associative_scan(combine, (g2, p2), axis=-2)
    carry = jnp.concatenate(
        [jnp.zeros_like(G[..., :1, :]), G[..., :-1, :]], -2
    ).astype(jnp.uint32)
    return (t1 + carry) & _MASKc


def _fold_cols(spec: FieldSpec, c):
    """Fold columns ≥ L (axis -2) via the pseudo-Mersenne terms."""
    L = spec.num_limbs
    w = c.shape[-2]
    lo = c[..., :L, :]
    hi = c[..., L:, :]
    hw = w - L
    out_w = max(L, max(off for off, _ in spec.fold_terms) + hw)

    def place(x, off):
        pre = jnp.zeros((*x.shape[:-2], off, x.shape[-1]), jnp.uint32)
        post = jnp.zeros(
            (*x.shape[:-2], out_w - off - x.shape[-2], x.shape[-1]),
            jnp.uint32,
        )
        return jnp.concatenate([pre, x, post], -2)

    out = place(lo, 0)
    for off, digit in spec.fold_terms:
        out = out + place(hi * jnp.uint32(digit), off)
    return out


def _conv_cols(spec: FieldSpec, a, x):
    """Shift-accumulate product columns: a (W, L, 1) × x (W, L, B) →
    (W, 2L, B), every column < 2L·2^16."""
    L = spec.num_limbs
    c = jnp.zeros((*x.shape[:-2], 2 * L, x.shape[-1]), jnp.uint32)
    for i in range(L):
        prod = a[..., i : i + 1, :] * x
        c = c.at[..., i : i + L, :].add(prod & _MASKc)
        c = c.at[..., i + 1 : i + L + 1, :].add(prod >> 16)
    return c


def _mont_reduce_cols(spec: FieldSpec, c):
    """Word-serial Montgomery reduction (CIOS) in the (W, cols, B)
    layout: product columns (< 2^22, width ≥ L+1) → canonical value·R⁻¹.

    For fold-unfriendly primes the schedule keeps every resident value in
    Montgomery form (value·R), so each affine/mul step needs exactly ONE
    of these reductions — the reference's arkworks backend works the same
    way (Fp256<MontBackend>, lib.rs:37). L unrolled iterations of
    whole-tensor ops; the redundant-column invariant (< 2^22 plus one
    sub-2^17 addend per iteration) keeps everything exact in uint32."""
    L = spec.num_limbs
    n_prime = jnp.uint32(spec.n_prime)
    p_limbs = spec.to_limbs(spec.p)
    w = c.shape[-2]
    if w < 2 * L + 1:
        c = jnp.concatenate(
            [c, jnp.zeros((*c.shape[:-2], 2 * L + 1 - w, c.shape[-1]),
                          jnp.uint32)], -2)
    cols = [c[..., i, :] for i in range(c.shape[-2])]
    for _ in range(L):
        m = (cols[0] * n_prime) & _MASKc
        for i in range(L):
            prod = m * jnp.uint32(p_limbs[i])
            cols[i] = cols[i] + (prod & _MASKc)
            cols[i + 1] = cols[i + 1] + (prod >> 16)
        carry = cols[0] >> 16  # low 16 bits are exactly zero now
        cols = cols[1:]
        cols[0] = cols[0] + carry
    # CIOS bound: the input is below R·p (one product of canonical values,
    # two summed, or any value < R times R² mod p), so the result is below
    # T/R + p < 3p, and below 2p when 2p < R; L+1 columns suffice (the
    # normalize spill column is provably zero)
    x = _normalize_cols(jnp.stack(cols[: L + 1], axis=-2))[..., : L + 1, :]
    # canonicalize (CMPSEL equality needs canonical values): conditional
    # subtracts of 2p (when 2p ≥ R) and p
    W1 = L + 1
    slack = 16 * L - spec.p.bit_length()
    for j in ([0] if slack else [1, 0]):
        comp = jnp.asarray(
            [((1 << (16 * W1)) - (spec.p << j)) >> (16 * i) & 0xFFFF
             for i in range(W1)],
            dtype=jnp.uint32,
        )[:, None]
        y = _normalize_cols(x + comp)
        need = y[..., W1, :] > 0
        x = jnp.where(need[..., None, :], y[..., :W1, :], x)
    return x[..., :L, :]


def _to_mont_cols(spec: FieldSpec, x):
    """Canonical (.., L, B) → Montgomery form (value·R) via one
    conv-with-R² + reduction."""
    r2 = jnp.asarray(spec.to_limbs(spec.r2_mod_p), jnp.uint32)
    return _mont_reduce_cols(spec, _conv_cols(spec, r2[None, :, None], x))


def _from_mont_cols(spec: FieldSpec, x):
    """Montgomery form → canonical: reduce once more (·R⁻¹)."""
    return _mont_reduce_cols(spec, x)


def _muladd2_cols(spec: FieldSpec, A, x1, B, x2):
    """Fused A·x1 + B·x2 in the (W, L, B) layout. For fold-unfriendly
    primes all operands are in Montgomery form and the sum of products
    takes a single CIOS reduction (A·R · x·R · R⁻¹ = (Ax)·R)."""
    if spec.num_limbs == 1 and spec.p == fd.M31_P:
        # m31: plain elementwise fast path
        return fd._m31_add(fd._m31_mul(A, x1), fd._m31_mul(B, x2))
    c = _conv_cols(spec, A, x1) + _conv_cols(spec, B, x2)
    if spec.fold_terms is None:
        return _mont_reduce_cols(spec, c)
    return _reduce_cols(spec, c)


def _reduce_cols(spec: FieldSpec, c):
    """Product columns (W, 2L, B) → canonical field value (W, L, B):
    fold, normalize, then the conditional-subtract chain."""
    L = spec.num_limbs
    c = _normalize_cols(_fold_cols(spec, c))
    c = _normalize_cols(_fold_cols(spec, c))
    slack = 16 * L - spec.p.bit_length()
    js = [0] if slack == 0 else list(range(slack + 1, -1, -1))
    x = c[..., : L + 1, :]
    W1 = L + 1
    for j in js:
        comp = jnp.asarray(
            [((1 << (16 * W1)) - (spec.p << j)) >> (16 * i) & 0xFFFF
             for i in range(W1)],
            dtype=jnp.uint32,
        )[:, None]
        y = _normalize_cols(x + comp)
        need = y[..., W1, :] > 0
        x = jnp.where(need[..., None, :], y[..., :W1, :], x)
    return x[..., :L, :]


def _add_canon(spec: FieldSpec, a, b):
    """Canonical (W, L, B) + (W, L, B) mod p: one conditional subtract."""
    if spec.num_limbs == 1 and spec.p == fd.M31_P:
        return fd._m31_add(a, b)
    L = spec.num_limbs
    W1 = L + 1
    x = _normalize_cols(a + b)[..., :W1, :]
    comp = jnp.asarray(
        [((1 << (16 * W1)) - spec.p) >> (16 * i) & 0xFFFF
         for i in range(W1)], dtype=jnp.uint32)[:, None]
    y = _normalize_cols(x + comp)
    need = y[..., W1, :] > 0
    return jnp.where(need[..., None, :], y[..., :W1, :], x)[..., :L, :]


def _muladd1_cols(spec: FieldSpec, C, x1, x2):
    """Fused x1 + C·x2 in the (W, L, B) layout (OP_AFF1/OP_AFF1S)."""
    if spec.num_limbs == 1 and spec.p == fd.M31_P:
        return fd._m31_add(x1, fd._m31_mul(C, x2))
    c = _conv_cols(spec, C, x2)
    if spec.fold_terms is None:
        # Montgomery residents: reduce the product, then one canonical add
        return _add_canon(spec, _mont_reduce_cols(spec, c), x1)
    # inject x1 into the product columns pre-reduction (its contribution
    # is strictly smaller than a second product, so muladd2's bounds hold)
    L = spec.num_limbs
    pad = jnp.zeros((*x1.shape[:-2], c.shape[-2] - L, x1.shape[-1]),
                    jnp.uint32)
    return _reduce_cols(spec, c + jnp.concatenate([x1, pad], axis=-2))


def _mulss(spec: FieldSpec, x1, x2):
    """State×state field product in the (W, L, B) layout (OP_MUL)."""
    if spec.num_limbs == 1 and spec.p == fd.M31_P:
        return fd._m31_mul(x1, x2)
    c = _conv_cols(spec, x1, x2)  # broadcasting handles a = (W, L, B)
    if spec.fold_terms is None:  # Montgomery residents: one reduction
        return _mont_reduce_cols(spec, c)
    return _reduce_cols(spec, c)


class StepRoute(NamedTuple):
    """How run_schedule executes a schedule on one backend.

    ``kernel``: affine steps run the in-place Pallas step kernels
    (ops/pallas_step.py) instead of the XLA step math. ``split``: steps
    run as run-split pieces, one static opcode per jitted scan, instead of
    the legacy scan whose body switches over all eight opcodes."""

    kernel: bool = False
    split: bool = False


def step_route(backend: str | None = None) -> StepRoute:
    """The one backend decision of the step executor.

    The GPU runs run-split pieces with the step kernels: the XLA step math
    does not fit the card at the flagship batch, and the legacy switch
    with the kernels in all its branches compiles for minutes (PERF.md).
    Every other backend (the CPU test platform) runs the legacy switch
    interpreter on the XLA step math: run-split's ~6-10 distinct programs
    per (algorithm, size) trip XLA:CPU's executable.serialize() segfault
    in cache-writing suite processes (see tests/conftest.py)."""
    if (backend or jax.default_backend()) == "gpu":
        return StepRoute(kernel=True, split=True)
    return StepRoute()


# the most steps one segment call runs. A segment's step range is a
# runtime argument, so the cap changes no compiled program; it only cuts
# the longest schedules (EXIT at n=2^16 has 1056 steps) into a few calls
SEGMENT_STEPS = 512


def run_schedule(spec: FieldSpec, pool, sched: Schedule, batch,
                 one_pos: int, m_out: int,
                 route: StepRoute = StepRoute(),
                 batch_chunk: int | None = None, mesh=None):
    """Execute a schedule: state packing, the step scans, unpacking.

    ``batch``: (B, m, L) input; ``sched``: a :class:`Schedule`;
    ``pool``: (P, L); ``route``: see :func:`step_route`. Each step
    synthesizes its four index rows from the 16-scalar column formulas
    (residual bank rows where flagged), gathers its window's inputs from
    anywhere in the state, computes only the A-row window, and writes it
    back — the rest of the state rides the scan carry untouched.
    Butterfly coefficients are computed by the running-diagonal engine
    carried through the scan (see module docstring). With
    ``route.kernel`` the fused step kernel replaces the XLA muladd
    pipeline for affine steps and writes the window in place; gathers
    stay in XLA either way.

    ``batch_chunk``: process the batch in chunks of that many lanes; the
    device peak scales with the per-chunk state.

    Schedules execute as a CHAIN of separately-jitted segments with the
    state (and the D/invD diagonals) staying on device between them.

    ``mesh``: a 1-D device mesh to shard the batch over (ShardedFFTree
    passes its own). Every segment then runs under shard_map over the
    mesh axis, called eagerly or under an outer jit alike: each device
    steps its own lanes, and no step needs another device's data.
    """
    x = _pack_state(spec, batch, sched.W, one_pos)
    if mesh is not None:
        x = jax.device_put(x, NamedSharding(
            mesh, PartitionSpec(None, None, mesh.axis_names[0])))
    xs = sched.xs
    nsteps = int(xs[0].shape[0])
    # Each piece is a step range [lo, hi) passed at run time to one
    # compiled loop, so a schedule shape compiles once (legacy) or once
    # per opcode (run-split), whatever its length. Run-split groups steps
    # into runs of IDENTICAL opcode (host-visible in the schedule data),
    # with the opcode static so the step body is that single branch — no
    # 8-way lax.switch, whose operands XLA lays out for every branch at
    # once. Pieces are SHARED across schedules of the same shape (ENTER
    # and EXIT reuse each other's programs).
    legacy = not route.split
    host_ops = np.asarray(xs[0])
    pieces = []
    lo = 0
    while lo < nsteps:
        hi = lo + 1
        while (hi < nsteps and hi - lo < SEGMENT_STEPS
               and (legacy or host_ops[hi] == host_ops[lo])):
            hi += 1
        pieces.append((lo, hi, None if legacy else int(host_ops[lo])))
        lo = hi
    # fold-unfriendly primes keep the pool Montgomery-resident: convert
    # ONCE per call, outside the segment bodies (jit caches compiled
    # programs, not values)
    if spec.num_limbs > 1 and spec.fold_terms is None:
        pool = _pool_to_mont(spec, pool)
    L = spec.num_limbs
    D0 = jnp.zeros((max(sched.bs_max, 1), L), jnp.uint32)

    def run_pieces(x, chunk):
        """Chain the pieces over one resident state. Split mode donates
        the state (and diagonals) into every piece — the in-place step
        kernels then write the caller's buffer directly instead of a
        defensive copy per piece call (the piece count is ~10× the
        legacy segment count, so per-call copies would dominate).
        D/iD must be DISTINCT fresh buffers per chain: both are donated,
        and a shared or reused buffer would be donated twice."""
        if legacy and mesh is None:
            D = iD = D0
        else:
            D = jnp.zeros_like(D0) + 0
            iD = jnp.zeros_like(D0) + 0
        for lo, hi, op_idx in pieces:
            args = (spec, pool, xs, np.int32(lo), np.int32(hi), x, D, iD,
                    route.kernel, chunk, op_idx)
            if mesh is not None:
                x, D, iD = _run_segment_sharded(*args, mesh)
            elif legacy:
                x, D, iD = _run_segment(*args)
            else:
                x, D, iD = _run_segment_donated(*args)
        return x

    B = x.shape[-1]
    if (not legacy and batch_chunk is not None and batch_chunk < B
            and B % batch_chunk == 0):
        # split mode chunks at the TOP: each batch chunk runs the whole
        # piece chain on its own (W, L, Bc) state. The legacy path's
        # per-segment lax.map re-lays the full state out twice per
        # segment — fine for a handful of segments, ruinous for ~10×
        # as many pieces.
        outs = [run_pieces(x[..., c0:c0 + batch_chunk], None)
                for c0 in range(0, B, batch_chunk)]
        x = jnp.concatenate(outs, axis=-1)
    else:
        x = run_pieces(x, batch_chunk)
    return _unpack_state(
        spec, x, m_out,
        None if sched.out_perm is None else jnp.asarray(sched.out_perm))


@partial(jax.jit, static_argnums=(0, 2, 3))
def _pack_state(spec: FieldSpec, batch, w: int, one_pos: int):
    x = to_state(batch, w, one_pos)
    # fold-unfriendly primes (e.g. the 2-adic STARK prime of the
    # comparison bench): keep the pool and the whole resident state in
    # MONTGOMERY form (value·R) so every step needs exactly one CIOS
    # reduction — the same representation the reference's arkworks
    # backend uses (Fp256<MontBackend>, lib.rs:37). Conversion costs one
    # mul per element at entry/exit vs O(log² n) muls inside.
    if spec.num_limbs > 1 and spec.fold_terms is None:
        x = _to_mont_cols(spec, x)
    return x


@partial(jax.jit, static_argnums=(0, 2))
def _unpack_state(spec: FieldSpec, state, m_out: int, out_perm=None):
    if out_perm is None:
        out = state[:m_out]
    else:
        out = jnp.take(state, out_perm, axis=0)
    if spec.num_limbs > 1 and spec.fold_terms is None:
        out = _from_mont_cols(spec, out)
    return jnp.transpose(out, (2, 0, 1))


@partial(jax.jit, static_argnums=(0,))
def _pool_to_mont(spec: FieldSpec, pool):
    """(P, L) canonical pool → Montgomery form (run once per call chain)."""
    return _to_mont_cols(spec, pool[:, :, None])[..., 0]


def _synth_jnp(cp, p):
    """In-scan mirror of _synth_np: synthesize one column's (A,) index
    row from its 16 formula scalars. ~10 int32 vector ops — noise next
    to the field math."""
    t = p - cp[CP_OFF]
    s2 = cp[CP_S2]
    u = jnp.where(s2 >= 0, t >> jnp.maximum(s2, 0),
                  t << jnp.maximum(-s2, 0))
    inb = t & cp[CP_KM]
    act = ((t >= 0) & (t < cp[CP_SPAN])
           & (inb >= cp[CP_ALO]) & (inb < cp[CP_AHI]))
    sel = jnp.where(((t >> cp[CP_SB]) & 1) == 1, cp[CP_C1], cp[CP_C0])
    v = (sel + (t & cp[CP_M1]) + (u & cp[CP_M2])
         + (((u + cp[CP_DD]) ^ cp[CP_XX]) & cp[CP_M3]))
    dflt = jnp.where(cp[CP_DK] == 0, p, cp[CP_DC])
    return jnp.where(act, v, dflt)


def _mul_rows(spec: FieldSpec, a, b):
    """(N, L) × (N, L) field product (the D-engine's batch-free muls)."""
    return _mulss(spec, a[:, :, None], b[:, :, None])[..., 0]


def _run_segment_impl(spec: FieldSpec, pool, sched_xs, lo, hi, x, D, iD,
                      kernel: bool, batch_chunk: int | None,
                      op_idx: int | None = None):
    """Steps [lo, hi) of a schedule (see run_schedule); ``lo``/``hi`` are
    runtime scalars, so one compiled program serves every range. For
    fold-unfriendly primes the pool arrives already Montgomery-converted.
    Returns (state, D, invD) so the running diagonals survive segment cuts
    inside an extend.

    ``op_idx``: the segment's single opcode as a STATIC value — the step
    body compiles to that one branch (the run-split path). None keeps
    the 8-way lax.switch (legacy single-program interpreter).

    Jitted twice below: ``_run_segment`` (legacy chain — the state may
    be reused by the caller) and ``_run_segment_donated`` (run-split
    chain — state and diagonals are dead after each piece, so donating
    them lets the in-place kernels write the caller's buffer)."""
    from ecfft_tpu.ops import pallas_step as ps

    use_kernel = kernel and ps.kernel_supports(spec)
    ops_a, starts, colp, dp, rid = sched_xs[:5]
    bank = sched_xs[5]
    A = bank.shape[1]
    P = pool.shape[0]
    bsx = D.shape[0]
    one_row = pool[1:2]
    zero_row = pool[0:1]

    def body(carry, inp):
        state, D, iD = carry
        op_t, start, cps, dps, rids = inp
        q = jnp.arange(A, dtype=jnp.int32)
        p = start + q

        def col(ci):
            v = _synth_jnp(cps[ci], p)
            r = rids[ci]
            brow = jnp.take(bank, jnp.maximum(r, 0), axis=0)
            return jnp.where(r >= 0, brow, v)

        a_i, g1, b_i, g2 = col(0), col(1), col(2), col(3)
        x2 = jnp.take(state, jnp.clip(g2, 0, state.shape[0] - 1), axis=0)

        # ---- running-diagonal coefficient engine (batch-free) ----
        r = jnp.arange(bsx, dtype=jnp.int32)
        bitv = ((r >> dps[DP_SHALF]) & 1) == 1
        io = r & dps[DP_HM]

        def plane(b0, b1):
            idx = jnp.clip(jnp.where(bitv, b1, b0) + io, 0, P - 1)
            return jnp.take(pool, idx, axis=0)

        Ms = plane(dps[DP_MS0], dps[DP_MS1])
        Mp = plane(dps[DP_MP0], dps[DP_MP1])
        Msi = plane(dps[DP_MSI0], dps[DP_MSI1])
        perm = jnp.clip(r ^ dps[DP_HALF], 0, bsx - 1)
        Dp = jnp.take(D, perm, axis=0)
        dop = dps[DP_DOP]
        is0 = dop == DOP_LEVEL0
        isl = dop == DOP_LEVEL
        isf = dop == DOP_FINAL
        # the five independent products as ONE batched multiply, then the
        # dependent one: the compiled step holds two copies of the field
        # multiply instead of six, which is most of its compile time
        ratio, DpiD, MpDp, CA, MsiiD = jnp.split(_mul_rows(
            spec, jnp.concatenate([Mp, Dp, Mp, Ms, Msi]),
            jnp.concatenate([Msi, iD, Dp, D, iD])), 5)
        CB = jnp.where(is0, ratio, _mul_rows(spec, ratio, DpiD))
        CB = jnp.where(isf, MpDp, CB)
        D = jnp.where(is0, Ms, jnp.where(isl, CA, D))
        iD = jnp.where(is0, Msi, jnp.where(isl, MsiiD, iD))
        # scratch row 0 = the passthrough constants (one for A, zero
        # for B/C); emitters index coefficients at 1 + r
        CAx = jnp.concatenate([one_row, CA], axis=0)
        CBx = jnp.concatenate([zero_row, CB], axis=0)

        def take_c(tab, idx):
            return jnp.take(tab, jnp.clip(idx, 0, bsx), axis=0)

        def pool_row(idx):
            return jnp.take(pool, jnp.clip(idx, 0, P - 1), axis=0)

        def gx1(_g1=g1):
            return jnp.take(state, jnp.clip(_g1, 0, state.shape[0] - 1),
                            axis=0)

        def ret(out):
            """Write the computed window back (the non-in-place ops)."""
            return jax.lax.dynamic_update_slice(state, out, (start, 0, 0))

        if use_kernel:
            # the in-place step kernels write the output straight into
            # the state buffer at the window start, and the self-read
            # (OP_AFF1S*) variants read x1 from the state window itself:
            # no slice and no update-slice traversal of the window
            def affine(_):
                return ps.pallas_aff2g_ip(spec, pool_row(a_i),
                                          pool_row(b_i), state, gx1(), x2,
                                          start)

            def affine_c(_):
                return ps.pallas_aff2g_ip(spec, take_c(CAx, a_i),
                                          take_c(CBx, b_i), state, gx1(),
                                          x2, start)

            def aff1(_):
                return ps.pallas_aff1g_ip(spec, pool_row(b_i), state,
                                          gx1(), x2, start)

            def aff1_c(_):
                return ps.pallas_aff1g_ip(spec, take_c(CBx, b_i), state,
                                          gx1(), x2, start)

            def aff1s(_):
                return ps.pallas_aff1s_ip(spec, pool_row(b_i), state, x2,
                                          start)

            def aff1s_c(_):
                return ps.pallas_aff1s_ip(spec, take_c(CBx, b_i), state,
                                          x2, start)
        else:
            def slx1():
                return jax.lax.dynamic_slice(
                    state, (start, 0, 0), (A,) + state.shape[1:])

            def affine(_):
                return ret(_muladd2_cols(spec, pool_row(a_i)[:, :, None],
                                         gx1(), pool_row(b_i)[:, :, None],
                                         x2))

            def affine_c(_):
                return ret(_muladd2_cols(
                    spec, take_c(CAx, a_i)[:, :, None], gx1(),
                    take_c(CBx, b_i)[:, :, None], x2))

            def aff1(_):
                return ret(_muladd1_cols(spec, pool_row(b_i)[:, :, None],
                                         gx1(), x2))

            def aff1_c(_):
                return ret(_muladd1_cols(
                    spec, take_c(CBx, b_i)[:, :, None], gx1(), x2))

            def aff1s(_):
                return ret(_muladd1_cols(spec, pool_row(b_i)[:, :, None],
                                         slx1(), x2))

            def aff1s_c(_):
                return ret(_muladd1_cols(
                    spec, take_c(CBx, b_i)[:, :, None], slx1(), x2))

        def mul(_):
            return ret(_mulss(spec, gx1(), x2))

        def cmpsel(_):
            c1 = jnp.take(state, jnp.clip(a_i, 0, state.shape[0] - 1),
                          axis=0)
            c2 = jnp.take(state, jnp.clip(b_i, 0, state.shape[0] - 1),
                          axis=0)
            comp = jnp.all(c1 == c2, axis=(0, 1))  # (B,)
            return ret(jnp.where(comp[None, None, :], gx1(), x2))

        branches = [affine, mul, cmpsel, aff1, aff1s, aff1s_c, aff1_c,
                    affine_c]
        if op_idx is None:
            state = jax.lax.switch(op_t, branches, None)
        else:
            state = branches[op_idx](None)
        return (state, D, iD), None

    def run_one(args):
        def step(i, carry):
            return body(carry, tuple(
                a[i] for a in (ops_a, starts, colp, dp, rid)))[0]

        return jax.lax.fori_loop(lo, hi, step, args)

    B = x.shape[-1]
    if batch_chunk is not None and batch_chunk < B and B % batch_chunk == 0:
        xc = x.reshape(*x.shape[:-1], B // batch_chunk, batch_chunk)
        xc = jnp.moveaxis(xc, -2, 0)  # (chunks, W, L, Bc)
        out, Dn, iDn = jax.lax.map(
            lambda c: run_one((c, D, iD)), xc)
        out = jnp.moveaxis(out, 0, -2).reshape(*x.shape)
        return out, Dn[0], iDn[0]
    return run_one((x, D, iD))


_run_segment = jax.jit(_run_segment_impl, static_argnums=(0, 8, 9, 10))
_run_segment_donated = jax.jit(_run_segment_impl,
                               static_argnums=(0, 8, 9, 10),
                               donate_argnums=(5, 6, 7))


@partial(jax.jit, static_argnums=(0, 8, 9, 10, 11),
         donate_argnums=(5, 6, 7))
def _run_segment_sharded(spec, pool, sched_xs, lo, hi, x, D, iD, kernel,
                         batch_chunk, op_idx, mesh):
    """One segment under shard_map over the batch axis: every step is
    batch-parallel, so each device runs it on its own lanes and no
    collective is needed. The diagonals are batch-free and come out the
    same on every device."""
    def body(pool, sched_xs, lo, hi, x, D, iD):
        return _run_segment_impl(spec, pool, sched_xs, lo, hi, x, D, iD,
                                 kernel, batch_chunk, op_idx)

    lanes = PartitionSpec(None, None, mesh.axis_names[0])
    rep = PartitionSpec()
    return jax.shard_map(body, mesh=mesh,
                         in_specs=(rep, rep, rep, rep, lanes, rep, rep),
                         out_specs=(lanes, rep, rep),
                         check_vma=False)(pool, sched_xs, lo, hi, x, D, iD)


def to_state(batch_arr, W: int, one_pos: int):
    """(B, m, L) batch → (W, L, B) state with a constant 1 at one_pos
    (skipped when the schedule has no tail slots, e.g. the NTT).

    ``batch_arr`` may be a tuple of parts concatenated along the position
    axis (general-modulus REDC/MOD pack [evals ‖ a ‖ c]); unbatched
    (m, L) parts broadcast against the first part's batch dims.
    """
    if isinstance(batch_arr, (tuple, list)):
        lead = batch_arr[0].shape[:-2]
        batch_arr = jnp.concatenate(
            [batch_arr[0]]
            + [jnp.broadcast_to(p, lead + p.shape[-2:])
               for p in batch_arr[1:]],
            axis=-2,
        )
    B, m, L = batch_arr.shape
    x = jnp.transpose(batch_arr, (1, 2, 0))  # (m, L, B)
    if W == m:
        return x
    pad = jnp.zeros((W - m, L, B), jnp.uint32)
    pad = pad.at[one_pos - m, 0, :].set(1)
    return jnp.concatenate([x, pad], axis=0)


def from_state(state, m: int):
    """(W, L, B) state → (B, m, L) values from the value lane."""
    return jnp.transpose(state[:m], (2, 0, 1))


