"""Profiling and timing utilities.

The reference has zero instrumentation (SURVEY.md §5 — the only output is
``std::cout`` in main.cpp). Here:

- ``timed``: best wall-clock seconds of a call, each run ended with
  ``jax.block_until_ready`` so the clock covers the device work and not
  only its dispatch;
- ``trace`` / ``annotate``: ``jax.profiler`` device traces and named
  regions inside them.
"""

from __future__ import annotations

import contextlib
import time

import jax


def timed(fn, *args, reps: int = 5, warmup: int = 1):
    """Min wall-clock seconds of ``fn(*args)``, synchronised with
    ``block_until_ready``."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


@contextlib.contextmanager
def trace(log_dir: str):
    """``jax.profiler`` trace around a code region (view with XProf)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def annotate(name: str):
    """Named region inside a profiler trace."""
    with jax.profiler.TraceAnnotation(name):
        yield
