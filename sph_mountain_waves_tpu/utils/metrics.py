"""First-class performance instrumentation.

The reference has no structured profiling (``@time`` around main loops,
SURVEY §5). Here particle-steps/sec is a first-class metric: wrap a frame
loop in a ``StepTimer`` and read throughput/series; ``trace`` context wraps
``jax.profiler`` for device traces.
"""
from __future__ import annotations

import contextlib
import time

import jax
import numpy as np

__all__ = ["StepTimer", "trace"]


class StepTimer:
    """Accumulates (steps, particles, wall) per frame; reports
    particle-steps/sec. Call ``sync_example`` with any device array from the
    frame's result to force completion before timestamping."""

    def __init__(self):
        self.frames: list[tuple[int, int, float]] = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, n_steps: int, n_particles: int, sync_array=None):
        if sync_array is not None:
            float(jax.numpy.sum(sync_array[..., :1]))  # device->host barrier
        dt = time.perf_counter() - self._t0
        self.frames.append((n_steps, n_particles, dt))
        return dt

    @property
    def particle_steps_per_sec(self) -> float:
        work = sum(s * n for s, n, _ in self.frames)
        wall = sum(t for _, _, t in self.frames)
        return work / wall if wall else 0.0

    @property
    def series(self) -> np.ndarray:
        return np.asarray([[s, n, t] for s, n, t in self.frames])


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace of the enclosed block (view with TensorBoard)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
