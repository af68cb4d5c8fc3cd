"""Checkpointing in the reference's work-dir layout.

Counterpart of ``midi_emotion_tpu/training/checkpoint.py``. The JAX
package's native layout needs msgpack, which the card's machine lacks, so
the port writes the reference's layout (train.py:114,180,397-407), which
``convert.load_model_dir`` and the JAX package's own ``load_model_dir``
both read:

    model_config.pt   -- ModelConfig.to_reference_dict()
    model.pt          -- the model's state_dict (f32 masters when training)
    mappings.pt       -- the vocabulary maps
    optimizer.pt      -- torch.optim.Adam's state_dict
    stats.json        -- {step, hour, epoch, sample} (resume counters)
    performance.csv   -- metric log (written by the Runner)

(no scaler.pt: bf16 needs no loss scaling.)
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, Optional

import torch

from ..convert import save_reference_dir
from ..models.config import ModelConfig
from ..vocab import Vocab

STATS_KEYS = ("step", "hour", "epoch", "sample")


def save_checkpoint(
    work_dir: str,
    model: torch.nn.Module,
    cfg: ModelConfig,
    vocab: Vocab,
    optimizer: Optional[torch.optim.Optimizer] = None,
    stats: Optional[Dict] = None,
) -> None:
    save_reference_dir(work_dir, cfg, model.state_dict(), vocab)
    if optimizer is not None:
        torch.save(optimizer.state_dict(), os.path.join(work_dir, "optimizer.pt"))
    if stats is not None:
        with open(os.path.join(work_dir, "stats.json"), "w") as f:
            json.dump({k: stats.get(k, 0) for k in STATS_KEYS}, f)


def load_opt_state(work_dir: str, optimizer: torch.optim.Optimizer) -> bool:
    """Restore ``optimizer`` from ``optimizer.pt`` in place. Returns False
    when the file is missing or does not fit, and the optimizer starts
    afresh, as the reference does (train.py:186-193)."""
    fp = os.path.join(work_dir, "optimizer.pt")
    if not os.path.exists(fp):
        return False
    try:
        optimizer.load_state_dict(torch.load(fp, map_location="cpu", weights_only=False))
    except (OSError, pickle.UnpicklingError, KeyError, ValueError, RuntimeError):
        return False
    return True


def load_stats(work_dir: str) -> Dict:
    fp = os.path.join(work_dir, "stats.json")
    if os.path.exists(fp):
        try:
            with open(fp) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            pass
    return {k: 0 for k in STATS_KEYS}
