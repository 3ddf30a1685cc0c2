"""Structured tracing/profiling hooks.

The reference's observability is wall-clock timers + phase-tagged stderr
logs (spasm_wtime, spasm_util.c:27-32; log sites like
spasm_echelonize.c:484,533).  This package keeps those logs (the
`spasm_tpu` logger) and adds the structured layer the reference lacks
(SURVEY.md §5.1): every engine phase is wrapped in a
`jax.profiler.TraceAnnotation` so device traces captured with
`jax.profiler.trace` (or the `--profile DIR` CLI flag) attribute compiled
kernels to engine phases in TensorBoard/Perfetto.

All hooks are zero-cost when no trace is being captured.
"""
from __future__ import annotations

import contextlib
import logging
import time
from typing import Iterator, Optional

log = logging.getLogger("spasm_tpu")

_trace_dir: Optional[str] = None


@contextlib.contextmanager
def phase(name: str, **attrs) -> Iterator[None]:
    """Annotate a host-side engine phase on the device timeline.

    Also records the phase wall-clock at DEBUG level so `-v -v` CLI runs
    get a structured phase breakdown without capturing a device trace.
    """
    import jax.profiler
    t0 = time.time()
    with jax.profiler.TraceAnnotation(f"spasm/{name}", **attrs):
        yield
    log.debug("[trace] %s: %.3fs", name, time.time() - t0)


def annotate(name: str):
    """Decorator form of `phase` for hot free functions."""
    def deco(fn):
        import functools

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with phase(name):
                return fn(*a, **kw)
        return wrapper
    return deco


def start_trace(trace_dir: str) -> None:
    """Begin capturing a device trace (TensorBoard/Perfetto format)."""
    global _trace_dir
    import jax.profiler
    jax.profiler.start_trace(trace_dir)
    _trace_dir = trace_dir
    log.info("[trace] capturing device trace to %s", trace_dir)


def stop_trace() -> None:
    global _trace_dir
    if _trace_dir is None:
        return
    import jax.profiler
    jax.profiler.stop_trace()
    log.info("[trace] device trace written to %s", _trace_dir)
    _trace_dir = None


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str]) -> Iterator[None]:
    """Capture a device trace for the duration when trace_dir is set."""
    if trace_dir is None:
        yield
        return
    start_trace(trace_dir)
    try:
        yield
    finally:
        stop_trace()


def gpu_name_power() -> str:
    """`name, power.limit` of the first NVIDIA card as nvidia-smi reports
    them ("" without one).  A child process reads them, so the caller's
    JAX backend stays untouched; every device number is reported beside
    them, since a card set below its power limit runs slower."""
    import subprocess
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    lines = r.stdout.strip().splitlines()
    return lines[0].strip() if r.returncode == 0 and lines else ""
