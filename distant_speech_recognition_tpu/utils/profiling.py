"""Per-stage timing and device tracing.

The reference's only observability is printf progress (SURVEY §5.1:
"%0.2f sec. processed", test_online_beamforming.py:207, plus #ifdef debug
dumps).  This package makes profiling first-class:

- :class:`StageTimer` — wall-clock timing per named stage with proper
  ``block_until_ready`` synchronization (async dispatch makes naive timing
  measure only the enqueue) and simple stats/report.
- :func:`device_trace` — context manager around ``jax.profiler`` emitting a
  TensorBoard-loadable XPlane trace of the enclosed device work.
- :func:`timed` — decorator variant of StageTimer for jitted callables.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import jax

__all__ = ["StageTimer", "device_trace", "timed"]


def _sync(x):
    """Wait for the device work feeding ``x`` (any pytree of arrays)."""
    return jax.block_until_ready(x)


class StageTimer:
    """Accumulates wall time per stage.

    >>> timer = StageTimer()
    >>> with timer("analysis"):
    ...     X = analysis(x, h, p)       # doctest: +SKIP
    >>> timer.report()                  # doctest: +SKIP
    """

    def __init__(self):
        self.times = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            # Async dispatch: enqueue a trivial op and block on it so the
            # stage is charged for its own device work (same in-order
            # stream), not for whatever gets awaited later.  For exact
            # attribution of a single callable prefer ``timed``.
            _sync(jax.numpy.zeros(()))
            self.times[stage].append(time.perf_counter() - t0)

    def add(self, stage: str, seconds: float) -> None:
        self.times[stage].append(seconds)

    def stats(self) -> dict:
        out = {}
        for k, v in self.times.items():
            out[k] = {
                "calls": len(v),
                "total_s": sum(v),
                "mean_s": sum(v) / len(v),
                "min_s": min(v),
                "max_s": max(v),
            }
        return out

    def report(self) -> str:
        rows = sorted(self.stats().items(), key=lambda kv: -kv[1]["total_s"])
        lines = [f"{'stage':<24} {'calls':>6} {'total':>10} {'mean':>10}"]
        for k, s in rows:
            lines.append(
                f"{k:<24} {s['calls']:>6} {s['total_s']:>9.4f}s {s['mean_s']:>9.4f}s"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a device trace of the enclosed block with jax.profiler.

    View with TensorBoard (profile plugin) or xprof.  No-ops gracefully if
    the active backend cannot trace.
    """
    started = False
    try:
        jax.profiler.start_trace(logdir)
        started = True
    except Exception:
        pass
    try:
        yield
    finally:
        if started:
            try:
                jax.profiler.stop_trace()
            except Exception:
                pass


def timed(timer: StageTimer, stage: str):
    """Decorator: time each call of ``fn`` (device-synchronized)."""

    def deco(fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            out = jax.tree.map(_sync, out)
            timer.add(stage, time.perf_counter() - t0)
            return out

        return wrapper

    return deco
