"""Profiling & timing utilities (SURVEY.md §5 "tracing/profiling").

The reference's observability is criterion benches + wall-clock prints
(benches/*, examples/interp_eval.rs:13-31). Here:

- :func:`trace`: context manager around ``jax.profiler.trace`` producing
  TensorBoard-loadable device traces, and :func:`device_times`, which
  reduces one to device seconds per kernel and the device's idle share,
- :func:`time_op`: block-until-ready wall timing with warmup,
- ``python -m ecfft_tpu.bench_suite``: the criterion-parity benchmark CLI
  (see ecfft_tpu/bench_suite.py).
"""

from __future__ import annotations

import contextlib
import glob
import os
import time

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a device profile: ``with trace("/tmp/prof"): run()``."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def _block(x):
    return jax.tree_util.tree_map(
        lambda a: a.block_until_ready() if hasattr(a, "block_until_ready") else a,
        x,
    )


def time_op(fn, *args, reps: int = 3, warmup: int = 1):
    """(best_seconds, result): times ``fn(*args)`` with device sync."""
    result = None
    for _ in range(warmup):
        result = _block(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        result = _block(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best, result


def device_times(log_dir: str) -> dict:
    """Reduce the newest trace under ``log_dir`` to device time.

    Returns {"kernels": {name: seconds}, "busy_s", "window_s", "idle"}:
    kernel seconds summed over the GPU planes' stream lines, busy = the
    union of those kernel intervals, window = first kernel start to last
    kernel end, idle = 1 − busy/window."""
    import jax

    paths = sorted(glob.glob(os.path.join(
        log_dir, "plugins", "profile", "*", "*.xplane.pb")))
    data = jax.profiler.ProfileData.from_file(paths[-1])
    kernels: dict = {}
    spans = []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                kernels[ev.name] = (kernels.get(ev.name, 0.0)
                                    + ev.duration_ns * 1e-9)
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    busy = 0.0
    end = None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    window = (max(b for _, b in spans) - min(a for a, _ in spans)
              if spans else 0.0)
    return {"kernels": kernels, "busy_s": busy * 1e-9,
            "window_s": window * 1e-9,
            "idle": 1.0 - busy / window if window else None}
