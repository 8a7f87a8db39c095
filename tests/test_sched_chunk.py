"""Batch-chunked schedule execution must be bit-identical to the
monolithic run (the chunked path bounds the device peak — state + two
gathers + the step output are each (W, L, lanes) — so a batch larger than
one device's memory still runs), and the preflight that picks the chunk
reads the device's own limit."""

import jax
import numpy as np
import pytest

import ecfft_tpu as ec
from ecfft_tpu import fftree as ft
from ecfft_tpu.errors import SizeError
from ecfft_tpu.native import build_fftree_native
from ecfft_tpu.ops import schedule as sch

CPU = sch.StepRoute()


def test_chunked_matches_unchunked():
    tree = build_fftree_native("m31", 64)
    tree.prepare((64,))
    rng = np.random.RandomState(3)
    coeffs = rng.randint(
        0, ec.FIELDS["m31"].p, size=(8, 64, 1)
    ).astype(np.uint32)
    s = tree._scheds[("enter", 64)]
    full = np.asarray(
        sch.run_schedule(tree.spec, tree._pool, s, coeffs, 128, 64,
                         CPU, None)
    )
    for chunk in (1, 2, 4):
        part = np.asarray(
            sch.run_schedule(tree.spec, tree._pool, s, coeffs, 128, 64,
                             CPU, chunk)
        )
        assert np.array_equal(full, part), f"chunk={chunk} diverged"


def test_multi_segment_secp_montgomery_matches(monkeypatch):
    """Segmentation × Montgomery/CIOS interaction: secp256k1's 16-limb
    path converts the pool to Montgomery form once per run_schedule call
    and carries the D/invD diagonals across segment boundaries — force a
    tiny segment cap so EXIT at n=256 splits into many segments and
    assert the result is bit-identical to the single-segment run."""
    n = 256
    tree = build_fftree_native("secp256k1", n)
    tree.prepare((n,))
    rng = np.random.RandomState(7)
    vals = [[int(v) for v in row]
            for row in rng.randint(0, 1 << 62, size=(2, n))]
    evals = tree.encode(vals)
    s = tree._scheds[("exit", n)]
    full = np.asarray(
        sch.run_schedule(tree.spec, tree._pool, s, evals, n, n, CPU, None))
    # 8 steps per segment => ~nsteps/8 segments
    monkeypatch.setattr(sch, "SEGMENT_STEPS", 8)
    split = np.asarray(
        sch.run_schedule(tree.spec, tree._pool, s, evals, n, n, CPU, None))
    assert np.array_equal(full, split)


def test_multi_segment_exit_matches_oracle():
    """EXIT at m31 n=4096 crosses the 512-step segment cap
    (sch.SEGMENT_STEPS), so run_schedule executes it as a chain of
    separately-jitted segments — the segmented result must equal the
    host oracle exactly."""
    from ecfft_tpu.host.fftree import build_host_fftree

    n = 4096
    tree = build_fftree_native("m31", n)
    tree.prepare((n,))
    assert tree._scheds[("exit", n)].xs[0].shape[0] > sch.SEGMENT_STEPS, (
        "test no longer crosses the segment boundary; grow n")
    ht = build_host_fftree("m31", n)
    rng = np.random.RandomState(5)
    coeffs = [[int(v) for v in row]
              for row in rng.randint(0, ec.FIELDS["m31"].p, size=(2, n))]
    evals = [ht.enter(c) for c in coeffs]
    got = [[int(v) for v in row]
           for row in tree.decode(tree.exit(tree.encode(evals)))]
    assert got == coeffs


def _lane_bytes(W, L):
    return 4 * W * L * 4


def test_oversized_state_preflight(monkeypatch):
    """The preflight (fftree.py::_batch_chunk): a state whose single
    batch lane does not fit the device's free memory raises a typed
    SizeError BEFORE any compile or execute. The free-bytes reader is
    the only thing faked; with room to spare the same call runs."""
    n = 64
    tree = build_fftree_native("secp256k1", n)
    tree.prepare((n,))
    enc = tree.encode([[1] * n])
    W = tree._scheds[("enter", n)].W
    monkeypatch.setattr(ft, "_free_bytes",
                        lambda dev: _lane_bytes(W, 16) - 1)
    with pytest.raises(SizeError, match="per batch lane"):
        tree.enter(enc)
    monkeypatch.setattr(ft, "_free_bytes", lambda dev: 10 ** 12)
    out = tree.enter(enc)
    assert out.shape == (1, n, 16)


def test_preflight_chunks_batch_not_multiple_of_128(monkeypatch):
    """B=12 with room for the full-batch states plus two lanes of step
    peak: the preflight picks chunks of 2 (the old lane rule only chunked
    multiples of 128), and the chunked ENTER is bit-exact."""
    n, B = 64, 12
    tree = build_fftree_native("m31", n)
    tree.prepare((n,))
    rng = np.random.RandomState(11)
    coeffs = rng.randint(0, ec.FIELDS["m31"].p,
                         size=(B, n, 1)).astype(np.uint32)
    want = np.asarray(tree.enter(coeffs))
    W = tree._scheds[("enter", n)].W
    free = 3 * W * 1 * 4 * B + 2 * _lane_bytes(W, 1)
    seen = []
    real = sch.run_schedule

    def spy(*args):
        seen.append(args[7])  # batch_chunk
        return real(*args)

    monkeypatch.setattr(ft, "_free_bytes", lambda dev: free)
    monkeypatch.setattr(sch, "run_schedule", spy)
    got = np.asarray(tree.enter(coeffs))
    assert seen == [2]
    assert np.array_equal(got, want)


@pytest.mark.parametrize("B, free_q, want", [
    (256, 1024, None),     # the whole batch fits
    (256, 1020, 32),       # 252 quarters left after the states: 63 lanes
    (12, 48, None),        # exact fit
    (12, 44, 2),           # ragged B: the largest divisor that fits
    (7, 25, 1),            # prime B: one lane per chunk
    (7, 24, SizeError),    # not even one lane
])
def test_batch_chunk_for(B, free_q, want):
    """The pure chunk picker, with free memory counted in quarters of a
    step-peak lane (one full-batch state lane is a quarter)."""
    W, L = 256, 16
    free = free_q * (_lane_bytes(W, L) // 4)
    if want is SizeError:
        with pytest.raises(SizeError):
            ft.batch_chunk_for(W, L, B, free)
    else:
        assert ft.batch_chunk_for(W, L, B, free) == want


def test_sharded_batch_is_not_chunked(monkeypatch):
    """A batch sharded over several devices is checked per device; when it
    does not fit, the preflight says so instead of chunking."""
    from ecfft_tpu.parallel.sharding import make_mesh, shard_batch

    n, B = 64, 32
    W = 256
    mesh = make_mesh(jax.devices()[:4])
    arr = shard_batch(mesh, np.zeros((B, n, 1), np.uint32))
    monkeypatch.setattr(ft, "_free_bytes", lambda dev: 10 ** 12)
    assert ft._batch_chunk(W, 1, arr) is None
    # 8 lanes per device; room for the states and one lane would chunk
    # an unsharded batch
    monkeypatch.setattr(ft, "_free_bytes",
                        lambda dev: 3 * W * 4 * 8 + _lane_bytes(W, 1))
    with pytest.raises(SizeError, match="per device"):
        ft._batch_chunk(W, 1, arr)


def test_cpu_reports_no_limit():
    """The CPU test platform reports no memory statistics: no preflight,
    no chunking."""
    assert ft._free_bytes(jax.devices()[0]) is None
    assert ft._batch_chunk(256, 16, np.zeros((4, 64, 16), np.uint32)) is None


def _run(tree, key, arr, one_pos, m_out, route):
    return np.asarray(sch.run_schedule(tree.spec, tree._pool,
                                       tree._scheds[key], arr, one_pos,
                                       m_out, route))


def test_run_split_matches_legacy_switch():
    """The per-op-run segmentation (static-branch pieces, power-of-two
    canonicalized lengths) must produce the same bits as the legacy
    single-program switch interpreter, for schedules that exercise every
    op family (enter + exit + degree); each route is passed explicitly."""
    n = 256
    tree = build_fftree_native("m31", n)
    tree.prepare((n,))
    rng = np.random.RandomState(7)
    coeffs = [[int(v) for v in row]
              for row in rng.randint(0, ec.FIELDS["m31"].p, size=(3, n))]
    enc = tree.encode(coeffs)
    ev = tree.enter(enc)
    tree.degree(ev)  # builds the degree schedule
    outs = {}
    for split in (True, False):
        route = sch.StepRoute(split=split)
        e = _run(tree, ("enter", n), enc, 2 * n, n, route)
        outs[split] = (e,
                       _run(tree, ("exit", n), e, 2 * n, n, route),
                       _run(tree, ("degree", n), e, n + 2, 1, route))
    for new, old in zip(outs[True], outs[False]):
        assert np.array_equal(new, old)
    assert np.array_equal(outs[True][1], np.asarray(enc))


def test_step_route_decision(monkeypatch):
    """One backend decision: the GPU runs run-split pieces with the step
    kernels; the CPU keeps the legacy switch on the XLA step math; the
    default reads jax.default_backend()."""
    assert sch.step_route("cpu") == sch.StepRoute(kernel=False, split=False)
    assert sch.step_route("gpu") == sch.StepRoute(kernel=True, split=True)
    assert sch.step_route() == sch.step_route("cpu")
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert sch.step_route() == sch.step_route("gpu")
