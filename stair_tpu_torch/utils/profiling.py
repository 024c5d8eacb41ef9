"""Profiling for the trainer: a ``torch.profiler`` trace, step timing and
garbage-collection pauses (the port's counterpart of
``stair_tpu/utils/profiling.py``).

  * :func:`trace` — ``torch.profiler`` over a window of steps, written as a
    Chrome trace (``trace.json``) into a directory; it records the card's
    kernels where CUDA is available;
  * :class:`StepTimer` — step wall times with mean and percentile summaries;
  * :class:`GCTimer` — CPython garbage-collection pauses via
    ``gc.callbacks``.

``async_fetch`` has no counterpart: the trainer fetches a report window's
metrics in one transfer.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed steps with ``torch.profiler`` (CPU, and CUDA
    where available) and write ``<log_dir>/trace.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class GCTimer:
    """Accumulate CPython garbage-collection pause time via gc.callbacks.

    Host stalls in a training loop are invisible to device profilers;
    gen-2 collections over a large live heap (datasets, packed batches) are
    a classic periodic-stall suspect, so the trainer reports the pause
    total per metrics window (``perf/gc_ms``)."""

    def __init__(self):
        import gc

        self.total = 0.0
        self.collections = 0
        self._t0 = None
        self._registered = True
        gc.callbacks.append(self._cb)

    def close(self):
        """Deregister from gc.callbacks, so that repeated trainer runs in
        one process do not accumulate callbacks."""
        import gc

        if self._registered:
            try:
                gc.callbacks.remove(self._cb)
            except ValueError:
                pass
            self._registered = False

    def __del__(self):
        self.close()

    def _cb(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.total += time.perf_counter() - self._t0
            self.collections += 1
            self._t0 = None

    def take(self) -> tuple[float, int]:
        """Return (seconds, collections) since the last take()."""
        out = (self.total, self.collections)
        self.total, self.collections = 0.0, 0
        return out


class StepTimer:
    """Track step wall times; report mean/p50/p99."""

    def __init__(self, window: int = 200):
        self.window = window
        self.times: list[float] = []
        self._last = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
            if len(self.times) > self.window:
                del self.times[0]
        self._last = now

    def summary(self) -> dict:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {
            "steps_per_sec": 1.0 / float(arr.mean()),
            "step_ms_p50": float(np.percentile(arr, 50) * 1e3),
            "step_ms_p99": float(np.percentile(arr, 99) * 1e3),
        }
