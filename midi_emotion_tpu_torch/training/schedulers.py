"""Learning-rate control.

The reference drives torch schedulers from the host loop
(train.py:129-139, 327-333, 432-434): a linear warmup overrides the
scheduler for the first ``warmup_step`` steps, then one of
{constant, cosine, cyclic, dev_perf(ReduceLROnPlateau)} takes over.
We keep the same host-side control -- the LR enters the jitted train step
as a scalar argument, so LR changes never retrace.

Two latent reference bugs are fixed rather than reproduced: train.py:129
tests ``scheduler == '--'`` so the 'cosine' choice never matched, and
'dev_perf'/'cosine' referenced argparse fields (patience, eta_min) that
config.py never defines. Here 'cosine' works and both knobs exist with
torch's defaults.

A copy of ``midi_emotion_tpu/training/schedulers.py``, unchanged but for this note:
the torch port keeps its own copies and imports nothing of the JAX
package.
"""

from __future__ import annotations

import math
from typing import Optional


class LRController:
    def __init__(
        self,
        scheduler: str,
        lr: float,
        warmup_step: int = 0,
        max_step: int = 1_000_000_000,
        eta_min: float = 0.0,
        lr_min: float = 5e-6,
        lr_max: float = 5e-3,
        decay_rate: float = 0.5,
        patience: int = 10,
        cyclic_step_size: int = 2000,
    ):
        assert scheduler in ("constant", "cosine", "cyclic", "dev_perf", "inv_sqrt")
        self.scheduler = scheduler
        self.base_lr = lr if scheduler != "cyclic" else lr_min  # config.py:145-146
        self.warmup_step = warmup_step
        self.max_step = max_step
        self.eta_min = eta_min
        self.lr_min = lr_min
        self.lr_max = lr_max
        self.decay_rate = decay_rate
        self.patience = patience
        self.cyclic_step_size = cyclic_step_size
        # dev_perf (ReduceLROnPlateau) state
        self._plateau_best: Optional[float] = None
        self._plateau_bad = 0
        self._plateau_scale = 1.0

    def lr_at(self, step: int) -> float:
        # linear warmup overrides everything (train.py:327-331)
        if self.scheduler != "constant" and self.warmup_step > 0 and step <= self.warmup_step:
            return self.base_lr * step / self.warmup_step
        if self.scheduler == "constant":
            return self.base_lr
        if self.scheduler == "cosine":
            t = min(max(step, 0), self.max_step)
            return self.eta_min + 0.5 * (self.base_lr - self.eta_min) * (
                1 + math.cos(math.pi * t / self.max_step)
            )
        if self.scheduler == "inv_sqrt":
            return self.base_lr / math.sqrt(max(step, 1))
        if self.scheduler == "cyclic":
            # torch CyclicLR triangular mode
            cycle = math.floor(1 + step / (2 * self.cyclic_step_size))
            x = abs(step / self.cyclic_step_size - 2 * cycle + 1)
            return self.lr_min + (self.lr_max - self.lr_min) * max(0.0, 1 - x)
        if self.scheduler == "dev_perf":
            return max(self.base_lr * self._plateau_scale, self.lr_min)
        raise AssertionError(self.scheduler)

    def on_eval(self, val_loss: float) -> None:
        """ReduceLROnPlateau step (train.py:432-434)."""
        if self.scheduler != "dev_perf":
            return
        if self._plateau_best is None or val_loss < self._plateau_best - 1e-8:
            self._plateau_best = val_loss
            self._plateau_bad = 0
        else:
            self._plateau_bad += 1
            if self._plateau_bad > self.patience:
                self._plateau_scale *= self.decay_rate
                self._plateau_bad = 0
