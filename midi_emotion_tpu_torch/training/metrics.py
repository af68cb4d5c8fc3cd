"""Metrics, CSV logging, and the experiment logger, in torch.

Counterpart of ``midi_emotion_tpu/training/metrics.py`` (the reference's
``utils.py``): top-k accuracy with pad masking (:15-80), ``CsvWriter``
(:82-109) and the file + stdout logger (:118-140).
"""

from __future__ import annotations

import csv
import functools
import os
import shutil
from typing import Dict, Optional, Sequence

import torch


def topk_accuracy(
    logits: torch.Tensor,
    target: torch.Tensor,
    topk: Sequence[int] = (1, 5),
    ignore_index: int = 0,
) -> Dict[str, torch.Tensor]:
    """Top-k accuracy over non-pad targets, plus the valid-element count
    for weighted aggregation."""
    counts = topk_counts(logits, target, topk, ignore_index)
    n_valid = counts["n_valid"]
    out = {f"top{k}": counts[f"top{k}"] / n_valid.clamp(min=1) for k in topk}
    out["n_valid"] = n_valid
    return out


def topk_counts(
    logits: torch.Tensor,
    target: torch.Tensor,
    topk: Sequence[int] = (1, 5),
    ignore_index: int = 0,
) -> Dict[str, torch.Tensor]:
    """The number of non-pad targets within the top k, for each k, and the
    number of non-pad targets ("n_valid"): the sums a mesh adds up over its
    ranks before it divides."""
    logits = logits.reshape(-1, logits.shape[-1])
    target = target.reshape(-1)
    valid = target != ignore_index
    _, pred = torch.topk(logits.float(), max(topk), dim=-1, sorted=True)
    correct = (pred == target[:, None]) & valid[:, None]
    out = {f"top{k}": correct[:, :k].sum() for k in topk}
    out["n_valid"] = valid.sum()
    return out


class CsvWriter:
    """performance.csv writer with resume-copy semantics
    (utils.py:82-109)."""

    def __init__(
        self,
        out_path: str,
        fieldnames: Sequence[str],
        in_path: Optional[str] = None,
        debug: bool = False,
    ):
        self.out_path = out_path
        self.fieldnames = list(fieldnames)
        self.debug = debug
        if not debug:
            if in_path is None or not os.path.exists(in_path):
                self._write_header()
            else:
                try:
                    shutil.copy(in_path, out_path)
                except OSError:
                    self._write_header()

    def _write_header(self) -> None:
        with open(self.out_path, "w") as f:
            csv.DictWriter(f, fieldnames=self.fieldnames).writeheader()

    def update(self, row: Dict) -> None:
        if not self.debug:
            with open(self.out_path, "a") as f:
                csv.DictWriter(f, fieldnames=self.fieldnames).writerow(row)


def logging_fn(s: str, log_path: Optional[str], print_=True, log_=True):
    if print_:
        print(s)
    if log_ and log_path:
        with open(log_path, "a+") as f:
            f.write(s + "\n")


def create_exp_dir(dir_path: str, debug: bool = False):
    """Experiment dir + logger factory (utils.py:129-140)."""
    if debug:
        print("Debug Mode : no experiment dir created")
        return functools.partial(logging_fn, log_path=None, log_=False)
    os.makedirs(dir_path, exist_ok=True)
    print(f"Experiment dir : {dir_path}")
    return functools.partial(logging_fn, log_path=os.path.join(dir_path, "log.txt"))
