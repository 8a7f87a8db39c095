"""The device FFTree: struct-of-arrays precomputation + public API.

Re-architecture of the reference's FFTree (src/fftree.rs:24-70,
318-496) for an accelerator:

- **No subtree pointer chain.** The reference keeps a Box'd chain of
  recursively derived subtrees (fftree.rs:29,465-482). Here the "chain"
  is a flat dict ``tables[m]`` of per-size device arrays — a pytree of
  uint32 limb tensors that jit/pjit map over directly. A size-N tree
  serves every power-of-two size ≤ N (the reference's
  ``subtree_with_size``, fftree.rs:489-496) by plain dict lookup.
- **Construction bootstrap runs ON DEVICE.** The reference builds tables
  bottom-up using its own partially-built algorithms (fftree.rs:381-460).
  We keep exactly that dependency order — matrices → z0_s1 (subtree
  tables + EXTEND) → z1_s0 (VANISH, which needs z0_s1) → z0z0/z1z1
  (subtree MOD + EXTEND) — but each step is a batched device computation,
  so tree generation is itself O(n log³ n) of vectorized field ops rather
  than a single-core pointer walk. Only the O(n) elliptic-curve leaf walk
  (lib.rs:72-79) stays on host with exact ints.

Per-size tables (tree size m, serving EXTEND of m/2-point inputs):
  leaves (m, L) · xnn_s = ⟨X^(m/2) ≀ S⟩ (m, L) · xnn_s_inv ·
  z0_s1 = ⟨Z₀ ≀ S₁⟩ (m/2, L) · z1_s0 · z0_inv_s1 · z1_inv_s0 ·
  z0z0_rem_xnn_s = ⟨Z₀² mod X^(m/2) ≀ S⟩ (m, L) · z1z1_rem_xnn_s ·
  mats[d] = (dec_S0, dec_S1, rec_S0, rec_S1) per extend depth d —
  the moiety-selected Lemma-3.2 decomposition matrices
  (fftree.rs:338-363) with the d/2−1 exponent of THIS size.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from ecfft_tpu.errors import SizeError, TreeConstructionError
from ecfft_tpu.fields import device as fd
from ecfft_tpu.fields.registry import FieldSpec, build_domain, get_spec
from ecfft_tpu.ops import core as ops
from ecfft_tpu.ops.core import S0, S1

__all__ = ["FFTree", "S0", "S1", "build_fftree"]

# bump on ANY pool/schedule layout change — stale cache files from an
# older layout must never load (their offsets would silently misindex)
_POOL_FORMAT = 6


def _ilog2(n: int) -> int:
    return n.bit_length() - 1


def _horner(spec: FieldSpec, coeffs: list, x):
    """Evaluate a (short, host-known) polynomial at device points."""
    acc = jnp.broadcast_to(fd.encode(spec, coeffs[-1]), x.shape)
    for c in reversed(coeffs[:-1]):
        acc = fd.add(spec, fd.mul(spec, acc, x), fd.encode(spec, c))
    return acc


def _interleave(a, b):
    x = jnp.stack([a, b], axis=-2)
    return x.reshape(*a.shape[:-2], a.shape[-2] * 2, a.shape[-1])


@partial(jax.jit, static_argnums=(0, 1))
def _build_mats(spec: FieldSpec, den_coeffs: tuple, layer_pts):
    """Decompose/recombine matrices for one layer of one tree size.

    Lemma 3.2 of ECFFT-I (fftree.rs:345-362): with v the denominator of
    the layer's rational map and (s0, s1) a matched point pair,
    v0 = v(s0)^(d/2−1), R = [[v0, s0·v0], [v1, s1·v1]], D = R⁻¹.
    Returns ((d, 2, 2, L) recombine, (d, 2, 2, L) decompose).
    """
    d = layer_pts.shape[0] // 2
    sa = layer_pts[:d]
    sb = layer_pts[d:]
    e = d // 2 - 1
    va = fd.pow_int(spec, _horner(spec, list(den_coeffs), sa), e)
    vb = fd.pow_int(spec, _horner(spec, list(den_coeffs), sb), e)
    r00, r01 = va, fd.mul(spec, sa, va)
    r10, r11 = vb, fd.mul(spec, sb, vb)
    rec = jnp.stack(
        [jnp.stack([r00, r01], axis=-2), jnp.stack([r10, r11], axis=-2)], axis=-3
    )  # (d, 2, 2, L)
    det = fd.sub(spec, fd.mul(spec, r00, r11), fd.mul(spec, r01, r10))
    di = fd.inv(spec, det)
    d00 = fd.mul(spec, r11, di)
    d01 = fd.neg(spec, fd.mul(spec, r01, di))
    d10 = fd.neg(spec, fd.mul(spec, r10, di))
    d11 = fd.mul(spec, r00, di)
    dec = jnp.stack(
        [jnp.stack([d00, d01], axis=-2), jnp.stack([d10, d11], axis=-2)], axis=-3
    )
    return rec, dec


def _tile_extend(spec: FieldSpec, mats, tree_size: int) -> dict:
    """Pre-scatter the Lemma-3.2 matrices into per-position butterfly
    coefficient tables for the compile-flat EXTEND (see ops.core.extend).

    For flat position p at depth d (butterfly bit b, half = 2^b):
      bit clear: out[p] = M[i',0,0]·x[p] + M[i',0,1]·x[p^half]  (row 0)
      bit set:   out[p] = M[i',1,1]·x[p] + M[i',1,0]·x[p^half]  (row 1)
    with i' = p & (half−1) the shared matrix index. Returns
    {"shifts": (logm,), S0: (dec, rec), S1: (dec, rec)} with coeff arrays
    (logm, m, 2, L). Pure numpy — the tables are constants, and eager
    device ops here would pay a dispatch per op.
    """
    m = tree_size // 2
    L = spec.num_limbs
    logm = _ilog2(m)
    out = {"shifts": np.asarray([m >> (d + 1) for d in range(logm)],
                                dtype=np.int32)}
    mats_np = [tuple(np.asarray(x) for x in quad) for quad in mats]
    for moiety in (S0, S1):
        mkey = "s0" if moiety == S0 else "s1"
        if logm == 0:
            z = np.zeros((0, 1, 2, L), dtype=np.uint32)
            out[mkey] = (z, z)
            continue
        dec_list, rec_list = [], []
        for d in range(logm):
            half = m >> (d + 1)
            iota = np.arange(m)
            bitv = ((iota & half) != 0)[:, None]
            ipr = iota & (half - 1)
            dec = mats_np[d][0 if moiety == S0 else 1]
            rec = mats_np[d][2 if moiety == S0 else 3]
            for src, acc in ((dec, dec_list), (rec, rec_list)):
                sel = np.take(src, ipr, axis=0)  # (m, 2, 2, L)
                c_self = np.where(bitv, sel[:, 1, 1, :], sel[:, 0, 0, :])
                c_part = np.where(bitv, sel[:, 1, 0, :], sel[:, 0, 1, :])
                acc.append(np.stack([c_self, c_part], axis=1))
        out[mkey] = (np.stack(dec_list), np.stack(rec_list))
    return out


def finalize_tables(spec: FieldSpec, tables: dict) -> dict:
    """Kept for API compatibility; pre-scattered extend tables are now
    derived LAZILY (FFTree._ext) so precomputation stays O(n) like the
    reference (README.md:24) — the schedule machine reads the compact
    Lemma-3.2 matrices directly."""
    return tables


@partial(jax.jit, static_argnums=(0, 2))
def _xnn_step(spec: FieldSpec, s, half: int):
    xnn = fd.pow_int(spec, s, half)
    return xnn, fd.inv(spec, xnn)


@partial(jax.jit, static_argnums=(0,))
def _z_step(spec: FieldSpec, ext, s, st, vt_prev, leaves2):
    """One size's z-table bootstrap, fully on device (fftree.rs:384-460).

    ``st`` = the half-size tables, ``vt_prev`` = {size: {mats, z0_s1}} for
    all smaller sizes (what VANISH consumes). One jit trace per tree size
    keeps construction free of eager-dispatch overhead.
    """
    m = s.shape[0]
    zeros_half = jnp.zeros_like(st["z0_s1"])
    st_z0_s0 = _interleave(zeros_half, st["z0_s1"])
    st_z1_s0 = _interleave(st["z1_s0"], zeros_half)
    st_z0_s1 = ops.extend(spec, ext, st_z0_s0, S1)
    st_z1_s1 = ops.extend(spec, ext, st_z1_s0, S1)
    z0_s1 = fd.mul(spec, st_z0_s1, st_z1_s1)

    vt = dict(vt_prev)
    vt[m] = {"ext": ext, "z0_s1": z0_s1}
    z1_s = ops.vanish(spec, vt, leaves2, s[1::2])
    z1_s0 = z1_s[0::2]

    z0_inv_s1 = fd.inv(spec, z0_s1)
    z1_inv_s0 = fd.inv(spec, z1_s0)

    xnn_s, xnn_s_inv = _xnn_step(spec, s, m // 2)
    xnnnn_s, xnnnn_s_inv = _xnn_step(spec, s, m // 4)
    sq_s0 = fd.mul(spec, st["z0z0_rem_xnn_s"], st["z1z1_rem_xnn_s"])
    rem_s0 = ops.modular_reduce(
        spec,
        st["ext"],
        st["z0_inv_s1"],
        sq_s0,
        st["xnn_s"][1::2],
        st["xnn_s_inv"][0::2],
        st["z0z0_rem_xnn_s"],
    )
    rem_s1 = ops.extend(spec, ext, rem_s0, S1)
    z0z0_rem_xnnnn_s = _interleave(rem_s0, rem_s1)
    z0_s = _interleave(jnp.zeros_like(z0_s1), z0_s1)
    z0_rem_xnn_sq_s = fd.square(spec, fd.sub(spec, z0_s, xnn_s))
    hi = fd.mul(
        spec, fd.sub(spec, z0_rem_xnn_sq_s, z0z0_rem_xnnnn_s), xnnnn_s_inv
    )
    hi_rem = ops.modular_reduce(
        spec,
        ext,
        z0_inv_s1,
        hi,
        xnnnn_s[1::2],
        xnnnn_s_inv[0::2],
        z0z0_rem_xnnnn_s,
    )
    z0z0_rem_xnn_s = fd.add(
        spec, z0z0_rem_xnnnn_s, fd.mul(spec, xnnnn_s, hi_rem)
    )
    z1_s = _interleave(z1_s0, jnp.zeros_like(z1_s0))
    z1z1 = fd.square(spec, fd.sub(spec, z1_s, xnn_s))
    z1z1_rem_xnn_s = ops.modular_reduce(
        spec,
        ext,
        z0_inv_s1,
        z1z1,
        xnn_s[1::2],
        xnn_s_inv[0::2],
        z0z0_rem_xnn_s,
    )
    return {
        "xnn_s": xnn_s,
        "xnn_s_inv": xnn_s_inv,
        "z0_s1": z0_s1,
        "z1_s0": z1_s0,
        "z0_inv_s1": z0_inv_s1,
        "z1_inv_s0": z1_inv_s0,
        "z0z0_rem_xnn_s": z0z0_rem_xnn_s,
        "z1z1_rem_xnn_s": z1z1_rem_xnn_s,
    }


def _free_bytes(device) -> int | None:
    """Bytes the device can still allocate (``bytes_limit`` less
    ``bytes_in_use``), or None where it reports no memory statistics —
    the CPU has no limit to respect."""
    stats = device.memory_stats()
    if not stats or "bytes_limit" not in stats:
        return None
    return int(stats["bytes_limit"]) - int(stats.get("bytes_in_use", 0))


def batch_chunk_for(W: int, L: int, B: int, free: int) -> int | None:
    """Lanes per chunk for a (W, L, B) state within ``free`` device bytes.

    A step's peak holds four dense (W, L, lanes) u32 buffers: the state,
    two gather temps and the step output. A chunked run also holds up to
    three full-batch states: the packed input, the finished chunks and
    their concatenation. Returns None when the whole batch fits, else the
    largest divisor of B whose chunks fit; raises SizeError when not even
    one lane does."""
    lane = 4 * W * L * 4
    if B * lane <= free:
        return None
    room = free - 3 * W * L * 4 * B
    for c in range(B - 1, 0, -1):
        if B % c == 0 and c * lane <= room:
            return c
    raise SizeError(
        f"a (W={W}, L={L}, B={B}) schedule state needs {lane / 1e9:.3f} "
        f"GB per batch lane at its peak (state, two gathers, step output)"
        f" plus {3 * W * L * 4 * B / 1e9:.2f} GB of full-batch states; "
        f"the device has {free / 1e9:.2f} GB free. Use a smaller n or "
        f"batch, or shard the batch over more devices.")


def _batch_chunk(W: int, L: int, flat) -> int | None:
    """Preflight + chunking for one schedule run on ``flat`` (B, m, L),
    against the devices the batch lives on (numpy input: the default
    device; none under an outer jit, which places the batch itself). A
    batch sharded over several devices is checked per device and never
    chunked."""
    if isinstance(flat, jax.core.Tracer):
        return None
    devs = (flat.devices() if isinstance(flat, jax.Array)
            else {jax.devices()[0]})
    free = [_free_bytes(d) for d in devs]
    if None in free:
        return None
    lanes = -(-flat.shape[0] // len(devs))
    chunk = batch_chunk_for(W, L, lanes, min(free))
    if chunk is not None and len(devs) > 1:
        raise SizeError(
            f"{lanes} lanes per device of a (W={W}, L={L}) schedule state "
            f"do not fit one device; shard the batch over more devices")
    return chunk


class FFTree:
    """Precomputed ECFFT evaluation-domain tables for one field and size.

    Public surface mirrors the reference FFTree (fftree.rs:123-316) with
    batch-first semantics: every method accepts inputs of shape
    (..., n, L-limbs-encoded) — use :meth:`encode`/:meth:`decode` to move
    between python ints and device form — and dispatches on the trailing
    size like the reference's ``subtree_with_size`` (fftree.rs:489-496).
    """

    # the 1-D device mesh the batch is sharded over; set on the copy a
    # ShardedFFTree runs, None on one device
    mesh = None

    def __init__(self, spec: FieldSpec, n: int, tables: dict,
                 f_layers: list | None = None, maps: list | None = None):
        self.spec = spec
        self.n = n
        self.tables = tables
        # host-int domain layers + rational maps, kept for serialization
        self.f_layers = f_layers
        self.maps = maps

    # ------------------------------------------------------------ build

    @classmethod
    def build(cls, field: str | FieldSpec, n: int) -> "FFTree | None":
        """F::build_fftree(n) (lib.rs:14-16, 40-84, 199-214): None when n
        exceeds the field's curve two-adicity."""
        spec = get_spec(field)
        dom = build_domain(spec, n)
        if dom is None:
            return None
        leaves, maps = dom
        # host: fill internal domain layers (fftree.rs:56-67), exact ints,
        # checking the 2-to-1 property map(s_i) == map(s_{i+half}) per node
        # (the reference's debug_assert, fftree.rs:63-66)
        f_layers = [leaves]
        for li, rmap in enumerate(maps):
            prev = f_layers[-1]
            half = len(prev) // 2
            nxt = [rmap(x) for x in prev[:half]]
            mirror = [rmap(x) for x in prev[half:]]
            if nxt != mirror:
                raise TreeConstructionError(
                    f"rational map {li} is not 2-to-1 on its layer "
                    "(fftree.rs:65)"
                )
            f_layers.append(nxt)
        return cls.from_domain_layers(spec, f_layers, maps)

    @classmethod
    def from_domain_layers(cls, spec, f_layers, maps) -> "FFTree":
        """Device bootstrap in the reference's exact dependency order
        (fftree.rs:318-463), iterating sizes bottom-up instead of
        recursing top-down."""
        n = len(f_layers[0])
        enc_layers = [fd.encode(spec, layer) for layer in f_layers]
        tables: dict[int, dict] = {}
        exts: dict[int, dict] = {}  # construction-transient (O(n log n))
        for m in [1 << i for i in range(1, _ilog2(n) + 1)]:
            stride = n // m
            t: dict = {}
            s = enc_layers[0][::stride]
            t["leaves"] = s

            # extend matrices for this size (layers with d ≥ 2 only —
            # the 2-wide layer is identity and never consulted)
            mats = []
            for li in range(_ilog2(m) - 1):
                layer_pts = enc_layers[li][::stride]
                rec, dec = _build_mats(
                    spec, tuple(maps[li].denominator), layer_pts
                )
                # moiety selection: dec skip 1/0, rec skip 0/1 for S0/S1
                # (fftree.rs:87-91,108-112)
                mats.append((dec[1::2], dec[0::2], rec[0::2], rec[1::2]))
            t["mats"] = mats
            # pre-scattered tables feed only the construction bootstrap's
            # flat-scan ops; the persistent FFTree keeps the COMPACT
            # matrices (O(n) space total, matching README.md:24)
            ext = _tile_extend(spec, mats, m)
            exts[m] = ext

            if m == 2:
                # base cases (fftree.rs:399-403,454-458)
                t["xnn_s"], t["xnn_s_inv"] = _xnn_step(spec, s, 1)
                t["z0_s1"] = fd.sub(spec, s[1:2], s[0:1])
                t["z1_s0"] = fd.sub(spec, s[0:1], s[1:2])
                t["z0_inv_s1"] = fd.inv(spec, t["z0_s1"])
                t["z1_inv_s0"] = fd.inv(spec, t["z1_s0"])
                sq = fd.square(spec, s)
                t["z0z0_rem_xnn_s"] = jnp.broadcast_to(sq[0:1], sq.shape)
                t["z1z1_rem_xnn_s"] = jnp.broadcast_to(sq[1:2], sq.shape)
            else:
                vt_prev = {
                    k: {"ext": exts[k], "z0_s1": tables[k]["z0_s1"]}
                    for k in tables
                }
                st = {"ext": exts[m // 2]}
                st.update(
                    (kk, tables[m // 2][kk])
                    for kk in ("z0_s1", "z1_s0", "z0_inv_s1", "xnn_s",
                               "xnn_s_inv", "z0z0_rem_xnn_s",
                               "z1z1_rem_xnn_s")
                )
                t.update(
                    _z_step(spec, ext, s, st, vt_prev, tables[2]["leaves"])
                )

            tables[m] = t
        tree = cls(spec, n, tables, f_layers=f_layers, maps=list(maps))
        tree._ext_cache = exts  # reuse for the *_unscheduled variants
        return tree

    # ------------------------------------------------------------ helpers

    def encode(self, values):
        return fd.encode(self.spec, values)

    def decode(self, arr):
        return fd.decode(self.spec, arr)

    def eval_domain(self, size: int | None = None) -> np.ndarray:
        """Leaf domain of the size-``size`` (sub)tree, as python ints
        (fftree.rs:502-504)."""
        size = size or self.n
        return fd.decode(self.spec, self.tables[size]["leaves"])

    def _size_check(self, m: int):
        if m & (m - 1):
            raise SizeError("input size must be a power of two")
        if m > self.n:
            raise SizeError("FFTree is too small")

    def _ext(self, m: int) -> dict:
        """Pre-scattered flat-scan EXTEND coefficient tables for tree
        size ``m``, derived lazily from the compact Lemma-3.2 matrices
        and cached. Only the ``*_unscheduled`` cross-validation variants
        and the construction bootstrap consume these; the public
        (schedule-machine) path gathers the compact matrices directly,
        keeping persistent precomputation O(n) (README.md:24)."""
        cache = getattr(self, "_ext_cache", None)
        if cache is None:
            cache = self._ext_cache = {}
        if m not in cache:
            cache[m] = _tile_extend(self.spec, self.tables[m]["mats"], m)
        return cache[m]

    def _subtables(self, key: str, up_to: int) -> dict:
        return {
            k: {kk: (self._ext(k) if kk == "ext" else self.tables[k][kk])
                for kk in key.split()}
            for k in self.tables
            if k <= up_to
        }

    # ------------------------------------------------- schedule machinery

    def _cache_digest(self) -> str:
        """Short content digest of the tree identity for cache filenames:
        hashes the full leaf domain (which determines every table), so a
        subtree, a different curve, or a different coset never collides
        with a fresh tree of the same (field, n)."""
        import hashlib

        h = hashlib.sha256()
        h.update(self.spec.p.to_bytes((self.spec.p.bit_length() + 7) // 8,
                                      "little"))
        h.update(np.asarray(self.tables[self.n]["leaves"]).tobytes())
        return h.hexdigest()[:12]

    @property
    def pool_offsets(self) -> dict:
        self._ensure_pool()
        return self._pool_off

    def _ensure_pool(self):
        if not hasattr(self, "_pool"):
            from ecfft_tpu.ops import schedule as sch

            self._pool, self._pool_off = sch.build_pool(self)
            self._scheds: dict = {}

    def _schedule(self, key, builder):
        self._ensure_pool()
        if key not in self._scheds:
            s = builder()
            self._scheds[key] = s._replace(
                xs=tuple(jnp.asarray(a) for a in s.xs)
            )
        return self._scheds[key]

    def prepare(self, sizes: tuple | None = None, cache_dir: str | None = None):
        """Build the coefficient pool and the ENTER/EXIT schedules ahead
        of time (ideally while tables still live on the CPU, then move
        them with :meth:`place_on`).

        ``cache_dir``: persist the pool to
        ``<dir>/.pool_<field>_<n>_<fmt>_<digest>.npz`` and reuse it on
        later runs — the pool is a pure function of the tree's TABLES
        (not just (field, n): a subtree yields different tables than a
        fresh size-n tree), so the filename embeds a format version and
        a content digest of the leaf domain; a layout change or a
        different tree can never silently load a stale file."""
        import json
        import os

        from ecfft_tpu.ops import schedule as sch

        tag = f"{_POOL_FORMAT}_{self._cache_digest()}"
        if cache_dir is not None and not hasattr(self, "_pool"):
            path = os.path.join(
                cache_dir, f".pool_{self.spec.name}_{self.n}_{tag}.npz")
            if os.path.exists(path):
                with np.load(path, allow_pickle=False) as z:
                    self._pool = jnp.asarray(z["pool"])
                    self._pool_off = json.loads(str(z["offsets"]))
                    self._scheds = {}
            else:
                self._ensure_pool()
                np.savez(path, pool=np.asarray(self._pool),
                         offsets=json.dumps(self._pool_off))
        self._ensure_pool()
        for n in sizes or (self.n,):
            for alg, builder in (
                ("enter", lambda: sch.enter_schedule(self, n)),
                ("exit", lambda: sch.exit_schedule(self, n)),
            ):
                key = (alg, n)
                if key in self._scheds:
                    continue
                spath = (None if cache_dir is None else os.path.join(
                    cache_dir,
                    f".sched_{self.spec.name}_{alg}_{n}_{tag}.npz"))
                if spath is not None and os.path.exists(spath):
                    # schedules are pure index/param data derived from
                    # (tree, n, algorithm); they persist like the pool
                    # (the parametric emitters make them KB-scale)
                    with np.load(spath, allow_pickle=False) as z:
                        xs = tuple(jnp.asarray(z[f"xs{i}"])
                                   for i in range(6))
                        op = (z["out_perm"] if "out_perm" in z.files
                              else None)
                        self._scheds[key] = sch.Schedule(
                            int(z["W"]), int(z["A"]), int(z["bs_max"]),
                            xs, op)
                    continue
                s = self._schedule(key, builder)
                if spath is not None:
                    arrs = {f"xs{i}": np.asarray(a)
                            for i, a in enumerate(s.xs)}
                    if s.out_perm is not None:
                        arrs["out_perm"] = np.asarray(s.out_perm)
                    np.savez(spath, W=s.W, A=s.A, bs_max=s.bs_max,
                             **arrs)
        return self

    def place_on(self, device):
        """Move tables, pool and schedules to ``device``."""
        self.tables = jax.device_put(self.tables, device)
        if hasattr(self, "_pool"):
            self._pool = jax.device_put(self._pool, device)
            self._scheds = {
                k: v._replace(xs=jax.device_put(v.xs, device))
                for k, v in self._scheds.items()
            }
        return self

    def _run_sched(self, sched, batch, m_out: int, one_pos: int,
                   extras: tuple = ()):
        """Run a schedule on a (..., m, L) batch; returns (..., m_out, L).
        ``extras`` are unbatched (m, L) tables packed after the batch
        along the position axis (inside the jitted computation)."""
        from ecfft_tpu.ops import schedule as sch

        lead = batch.shape[:-2]
        flat = batch.reshape((-1,) + batch.shape[-2:])
        payload = (flat, *extras) if extras else flat
        chunk = _batch_chunk(sched.W, self.spec.num_limbs, flat)
        res = sch.run_schedule(self.spec, self._pool, sched, payload,
                               one_pos, m_out, sch.step_route(), chunk,
                               self.mesh)
        return res.reshape(lead + res.shape[-2:])

    # ---------------------------------------------------------- algorithms
    # The public transforms run on the schedule machine (ops/schedule.py):
    # ONE compiled scan interprets per-size schedule tensors, so any
    # (algorithm, size) costs a single compile. The *_unscheduled
    # variants below keep the direct multi-scan formulation for
    # cross-validation and for construction (which predates the pool).

    def extend(self, evals, moiety: int = S1):
        """⟨P ≀ moiety⟩ from ⟨P ≀ other moiety⟩, deg P < m
        (fftree.rs:123-126)."""
        from ecfft_tpu.ops import schedule as sch

        m = evals.shape[-2]
        self._size_check(m * 2)
        s = self._schedule(("extend", m, moiety),
                           lambda: sch.extend_schedule(self, m, moiety))
        return self._run_sched(s, evals, m, m)

    def mextend(self, evals, moiety: int = S1):
        """EXTEND for monic polys of degree exactly m (fftree.rs:138-141)."""
        from ecfft_tpu.ops import schedule as sch

        m = evals.shape[-2]
        self._size_check(m * 2)
        s = self._schedule(
            ("mextend", m, moiety),
            lambda: sch.extend_schedule(self, m, moiety, mextend=True),
        )
        return self._run_sched(s, evals, m, m)

    def enter(self, coeffs):
        """Coefficients → evaluations (fftree.rs:164-167)."""
        from ecfft_tpu.ops import schedule as sch

        n = coeffs.shape[-2]
        self._size_check(n)
        s = self._schedule(("enter", n), lambda: sch.enter_schedule(self, n))
        return self._run_sched(s, coeffs, n, 2 * n)

    def exit(self, evals):
        """Evaluations → coefficients (fftree.rs:227-230)."""
        from ecfft_tpu.ops import schedule as sch

        n = evals.shape[-2]
        self._size_check(n)
        s = self._schedule(("exit", n), lambda: sch.exit_schedule(self, n))
        return self._run_sched(s, evals, n, 2 * n)

    def extend_unscheduled(self, evals, moiety: int = S1):
        m = evals.shape[-2]
        self._size_check(m * 2)
        return _extend_jit(self.spec, self._ext(m * 2), evals, moiety)

    def mextend_unscheduled(self, evals, moiety: int = S1):
        m = evals.shape[-2]
        self._size_check(m * 2)
        t = self.tables[m * 2]
        z = t["z0_s1"] if moiety == S1 else t["z1_s0"]
        return _mextend_jit(self.spec, self._ext(m * 2), z, evals, moiety)

    def enter_unscheduled(self, coeffs):
        n = coeffs.shape[-2]
        self._size_check(n)
        ext = {k: self._ext(k) for k in self.tables if k <= n}
        xnn = {k: self.tables[k]["xnn_s"] for k in self.tables if k <= n}
        return _enter_jit(self.spec, ext, xnn, coeffs)

    def exit_unscheduled(self, evals):
        n = evals.shape[-2]
        self._size_check(n)
        t = self._subtables(
            "ext xnn_s xnn_s_inv z0_inv_s1 z0z0_rem_xnn_s", n
        )
        return _exit_jit(self.spec, t, evals)

    def degree(self, evals):
        """Degree of the interpolant, batched int32 (fftree.rs:195-198).

        Runs single-scan on the schedule machine (OP_CMPSEL implements
        the reference's data-dependent branch per batch lane); the
        accumulator rides the state as a field element and is decoded
        host-side."""
        from ecfft_tpu.ops import schedule as sch

        n = evals.shape[-2]
        self._size_check(n)
        if n == 1:
            return np.zeros(evals.shape[:-2], dtype=np.int32)
        s = self._schedule(("degree", n),
                           lambda: sch.degree_schedule(self, n))
        out = np.asarray(self._run_sched(s, evals, 1, n + 2))
        acc = out[..., 0, :].astype(np.int64)
        val = np.zeros(acc.shape[:-1], dtype=np.int64)
        for li in range(min(acc.shape[-1], 2)):
            val |= acc[..., li] << (self.spec.limb_bits * li)
        return val.astype(np.int32)

    def degree_unscheduled(self, evals):
        n = evals.shape[-2]
        self._size_check(n)
        t = self._subtables("ext z0_inv_s1", n)
        return _degree_jit(self.spec, t, evals)

    def redc_z0(self, evals, a=None):
        """⟨P·Z₀⁻¹ mod a ≀ S⟩ (fftree.rs:264-267).

        With ``a=None`` (the canonical modulus a = X^(m/2), i.e. the
        tree's own ``xnn_s`` table — the reference's bench pattern,
        benches/fftree.rs:52-57) this runs single-scan on the schedule
        machine. With an explicit ``a`` table it takes the general path,
        Fermat-inverting a's even entries on device.
        """
        if a is None:
            m = evals.shape[-2]
            self._size_check(m)
            from ecfft_tpu.ops import schedule as sch

            s = self._schedule(
                ("redc", m),
                lambda: sch.mod_schedule(self, m, redc_only=True),
            )
            return self._run_sched(s, evals, m, 2 * m)
        return self._redc(evals, a, S0)

    def redc_z1(self, evals, a=None):
        """⟨P·Z₁⁻¹ mod a ≀ S⟩ (fftree.rs:272-275).

        With ``a=None`` (the canonical modulus a = X^(m/2)) this runs
        single-scan on the schedule machine, mirroring :meth:`redc_z0`;
        an explicit ``a`` table takes the general path."""
        if a is None:
            m = evals.shape[-2]
            self._size_check(m)
            from ecfft_tpu.ops import schedule as sch

            s = self._schedule(
                ("redc1", m),
                lambda: sch.mod_schedule(self, m, redc_only=True,
                                         moiety=S1),
            )
            return self._run_sched(s, evals, m, 2 * m)
        return self._redc(evals, a, S1)

    def _redc(self, evals, a, moiety):
        """General-modulus REDC on the schedule machine: [evals ‖ a]
        packs along the position axis; a₀⁻¹ comes from a scheduled
        Fermat chain (see ops.schedule.general_mod_schedule)."""
        from ecfft_tpu.ops import schedule as sch

        m = evals.shape[-2]
        self._size_check(m)
        s = self._schedule(
            ("gredc", m, moiety),
            lambda: sch.general_mod_schedule(self, m, moiety,
                                             redc_only=True),
        )
        one_pos = 2 * m + 3 * (m // 2)
        return self._run_sched(s, evals, m, one_pos, extras=(a,))

    def _redc_unscheduled(self, evals, a, moiety):
        m = evals.shape[-2]
        self._size_check(m)
        t = self.tables[m]
        z_inv = t["z0_inv_s1"] if moiety == S0 else t["z1_inv_s0"]
        return _redc_jit(self.spec, self._ext(m), z_inv, evals, a, moiety)

    def modular_reduce(self, evals, a=None, c=None):
        """MOD: remainder of P by ``a`` given c = ⟨Z₀² mod a ≀ S⟩
        (fftree.rs:286-289).

        With ``a=None``/``c=None`` this is the canonical form — modulus
        a = X^(m/2) with the precomputed c = z0z0_rem_xnn_s (the
        reference's bench pattern) — and runs single-scan on the schedule
        machine. Passing explicit ``a`` AND ``c`` takes the general path.
        """
        from ecfft_tpu.ops import schedule as sch

        m = evals.shape[-2]
        self._size_check(m)
        if a is None and c is None:
            s = self._schedule(("mod", m), lambda: sch.mod_schedule(self, m))
            return self._run_sched(s, evals, m, 2 * m)
        if a is None or c is None:
            raise TypeError(
                "modular_reduce needs both a and c (or neither for the "
                "canonical X^(m/2) form)"
            )
        s = self._schedule(
            ("gmod", m),
            lambda: sch.general_mod_schedule(self, m, S0, redc_only=False),
        )
        one_pos = 3 * m + 3 * (m // 2)
        return self._run_sched(s, evals, m, one_pos, extras=(a, c))

    def modular_reduce_unscheduled(self, evals, a, c):
        m = evals.shape[-2]
        self._size_check(m)
        t = self.tables[m]
        return _mod_jit(self.spec, self._ext(m), t["z0_inv_s1"], evals, a, c)

    def vanish(self, points):
        """⟨Z ≀ S⟩ for Z(x) = Π (x − aᵢ), single-scan on the schedule
        machine (fftree.rs:313-316; pairwise merges are OP_MUL steps)."""
        from ecfft_tpu.ops import schedule as sch

        v = points.shape[-2]
        self._size_check(v * 2)
        s = self._schedule(("vanish", v),
                           lambda: sch.vanish_schedule(self, v))
        return self._run_sched(s, points, 2 * v, 4 * v)

    def vanish_unscheduled(self, points):
        v = points.shape[-2]
        self._size_check(v * 2)
        t = self._subtables("ext z0_s1", v * 2)
        return _vanish_jit(self.spec, t, self.tables[2]["leaves"], points)


# ---------------------------------------------------------------- jit wraps

_extend_jit = jax.jit(ops.extend, static_argnums=(0, 3))
_mextend_jit = jax.jit(ops.mextend, static_argnums=(0, 4))
_enter_jit = jax.jit(ops.enter, static_argnums=(0,))
_exit_jit = jax.jit(ops.exit_, static_argnums=(0,))
_degree_jit = jax.jit(ops.degree, static_argnums=(0,))
_vanish_jit = jax.jit(ops.vanish, static_argnums=(0,))


@partial(jax.jit, static_argnums=(0, 5))
def _redc_jit(spec, ext, z_inv, evals, a, moiety):
    a0_inv = fd.inv(spec, a[0::2])
    return ops.redc(spec, ext, z_inv, evals, a[1::2], a0_inv, moiety)


@partial(jax.jit, static_argnums=(0,))
def _mod_jit(spec, ext, z0_inv_s1, evals, a, c):
    a0_inv = fd.inv(spec, a[0::2])
    return ops.modular_reduce(spec, ext, z0_inv_s1, evals, a[1::2], a0_inv, c)


def build_fftree(field: str, n: int) -> FFTree | None:
    """Module-level convenience mirroring ``FftreeField::build_fftree``
    (lib.rs:14-16)."""
    return FFTree.build(field, n)
