"""General utilities (the reference's src/utils.py surface, minus the
metric and logging pieces that live in training/metrics.py).

Counterpart of ``midi_emotion_tpu/utils/__init__.py``: ``split_list`` and
``StepTimer`` copied unchanged, ``profiler_trace`` a ``torch.profiler``
scope where the JAX package's is a ``jax.profiler`` one. (The JAX
package's ``honor_jax_platforms_env`` has no counterpart: the port picks
its device with ``--device``.)
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import List, Optional, Sequence


def split_list(alist: Sequence, n_parts: int) -> List[Sequence]:
    """Even list partition (utils.py:8-13)."""
    if n_parts == 0:
        n_parts = 1
    length = len(alist)
    return [
        alist[i * length // n_parts : (i + 1) * length // n_parts]
        for i in range(n_parts)
    ]


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """A ``torch.profiler`` trace of the scope (CPU, and CUDA where the
    card is there), written to ``log_dir/trace.json`` for Perfetto or
    chrome://tracing; yields the profiler. No-op when log_dir is None."""
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Per-step wall-clock accounting for the training log line
    (ms/batch, train.py:384-387)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.time()
        self._steps = 0

    def tick(self):
        self._steps += 1

    @property
    def ms_per_step(self) -> float:
        if self._steps == 0:
            return float("nan")
        return (time.time() - self._t0) * 1000 / self._steps
