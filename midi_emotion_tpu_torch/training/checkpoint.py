"""Checkpointing, in either work-dir layout.

Counterpart of ``midi_emotion_tpu/training/checkpoint.py``. A work dir
holds one of two layouts, never both:

* the reference's (train.py:114,180,397-407), which the port writes in a
  fresh dir, and which ``convert.load_model_dir`` and the JAX package's
  own ``load_model_dir`` both read:

      model_config.pt   -- ModelConfig.to_reference_dict()
      model.pt          -- the model's state_dict (f32 masters when training)
      mappings.pt       -- the vocabulary maps
      optimizer.pt      -- torch.optim.Adam's state_dict

* the JAX package's native layout (``convert/native.py``):
  model_config.json, vocab.json, model.msgpack and optimizer.msgpack (the
  optax state, which the JAX package's ``load_opt_state`` resumes).

Both add ``stats.json`` ({step, hour, epoch, sample}, the resume counters)
and the Runner's ``performance.csv``. ``save_checkpoint`` writes the
layout the dir already holds; ``load_opt_state`` reads ``optimizer.pt``
or, where there is none, ``optimizer.msgpack``. (No scaler.pt: bf16 needs
no loss scaling.)
"""

from __future__ import annotations

import json
import os
import pickle
import struct
import time
from typing import Dict, Optional, Tuple

import torch

from ..convert import flax_msgpack, native, save_reference_dir
from ..models.config import ModelConfig
from ..vocab import Vocab

STATS_KEYS = ("step", "hour", "epoch", "sample")
REFERENCE_FILES = ("model_config.pt", "model.pt", "mappings.pt", "optimizer.pt")


def _write_stats(work_dir: str, stats: Dict) -> None:
    with open(os.path.join(work_dir, "stats.json"), "w") as f:
        json.dump({k: stats.get(k, 0) for k in STATS_KEYS}, f)


def save_native_dir(
    work_dir: str,
    model: torch.nn.Module,
    cfg: ModelConfig,
    vocab: Vocab,
    optimizer: Optional[torch.optim.Optimizer] = None,
    stats: Optional[Dict] = None,
    clip: float = 1.0,
) -> Dict[str, Tuple[int, float]]:
    """Write ``work_dir`` in the JAX package's native layout: the model,
    and the optimizer as the optax state of ``make_optimizer(clip)``
    (``clip`` is the run's ``--clip``), which the JAX package's
    ``load_model_dir`` and ``load_opt_state`` read. Refuses a dir that
    holds the reference layout. Returns {msgpack file: (bytes, seconds to
    write)}."""
    held = [f for f in REFERENCE_FILES if os.path.exists(os.path.join(work_dir, f))]
    if held:
        raise ValueError(f"{work_dir} holds the reference layout ({', '.join(held)}); write the "
                         "native layout into another dir")
    written = {}
    t0 = time.perf_counter()
    n = native.write_native_model(work_dir, cfg, model.state_dict(), vocab)
    written[native.MODEL_FILE] = (n, time.perf_counter() - t0)
    if optimizer is not None:
        t0 = time.perf_counter()
        n = flax_msgpack.write(os.path.join(work_dir, native.OPT_FILE),
                               native.opt_state_from_adam(optimizer, model, clip))
        written[native.OPT_FILE] = (n, time.perf_counter() - t0)
    if stats is not None:
        _write_stats(work_dir, stats)
    return written


def save_checkpoint(
    work_dir: str,
    model: torch.nn.Module,
    cfg: ModelConfig,
    vocab: Vocab,
    optimizer: Optional[torch.optim.Optimizer] = None,
    stats: Optional[Dict] = None,
    clip: float = 1.0,
) -> None:
    """The layout ``work_dir`` already holds: native where it holds
    model_config.json, the reference's otherwise (a fresh dir). ``clip``
    matters only to the native layout's optimizer state."""
    if native.is_native_dir(work_dir):
        save_native_dir(work_dir, model, cfg, vocab, optimizer, stats, clip)
        return
    save_reference_dir(work_dir, cfg, model.state_dict(), vocab)
    if optimizer is not None:
        torch.save(optimizer.state_dict(), os.path.join(work_dir, "optimizer.pt"))
    if stats is not None:
        _write_stats(work_dir, stats)


def load_opt_state(work_dir: str, optimizer: torch.optim.Optimizer,
                   model: torch.nn.Module) -> bool:
    """Restore ``optimizer`` (Adam over ``model``'s parameters) in place
    from ``optimizer.pt`` or, where there is none, from the optax state in
    ``optimizer.msgpack``. Returns False when neither file is there or the
    state does not fit, and the optimizer starts afresh, as the reference
    does (train.py:186-193) and the JAX package (checkpoint.py:66-76)."""
    fp = os.path.join(work_dir, "optimizer.pt")
    if os.path.exists(fp):
        try:
            optimizer.load_state_dict(torch.load(fp, map_location="cpu", weights_only=False))
        except (OSError, pickle.UnpicklingError, KeyError, ValueError, RuntimeError):
            return False
        return True
    fp = os.path.join(work_dir, native.OPT_FILE)
    if not os.path.exists(fp):
        return False
    try:
        tree = flax_msgpack.read(fp)
    except (OSError, ValueError, IndexError, struct.error):  # a truncated or foreign file
        return False
    return native.load_adam_state(tree, optimizer, model)


def load_stats(work_dir: str) -> Dict:
    fp = os.path.join(work_dir, "stats.json")
    if os.path.exists(fp):
        try:
            with open(fp) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            pass
    return {k: 0 for k in STATS_KEYS}
