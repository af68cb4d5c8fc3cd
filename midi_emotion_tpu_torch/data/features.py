"""Emotion-feature preprocessing, without pandas.

Counterpart of ``midi_emotion_tpu/data/features.py``, whose arithmetic it
copies; only the CSV ingestion differs. The JAX package reads the CSV with
pandas, which the card's machine lacks, so this module reads it with the
``csv`` module and keeps pandas' parsing of what it reads: empty and
``NaN``-like fields are NaN, ``True``/``False`` strings are bools
(``_read_features``).

Record-for-record reimplementation of the semantics of
the reference's ``src/data/preprocess_features.py`` (pinned by
tests/test_loader.py::test_feature_parity_with_reference) on plain numpy
arrays: CSV -> per-song records with valence/arousal labels min-max scaled
to [-1, 1] (or quantile-binned into discrete emotion token symbols), IQR
outlier removal, and the deterministic 5% test split of the matched subset
sorted by file.

Two reference quirks are reproduced deliberately:
 * the split boundary row belongs to BOTH train and test (the reference's
   inclusive ``.loc`` slicing, preprocess_features.py:77-78);
 * the top quantile edge is nudged by 1e-6 so the max value lands in the
   last real bin (preprocess_features.py:55).
"""

from __future__ import annotations

import csv
from typing import List, Optional, Tuple

import numpy as np


# pandas.read_csv's default NA strings: these fields read as NaN
_NA_STRINGS = frozenset((
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null",
))


def _to_float(s: str) -> float:
    s = s.strip()
    return float("nan") if s in _NA_STRINGS else float(s)


def _to_bool(s: str) -> bool:
    """pandas' reading of the is_matched column taken ``to_numpy(bool)``:
    True/False strings as bools, numbers by their truth, and NaN (an empty
    field) as True."""
    s = s.strip()
    if s.lower() in ("true", "false"):
        return s.lower() == "true"
    return bool(_to_float(s))


def _read_features(feature_file: str) -> dict:
    """The columns ``preprocess_features`` uses, as numpy arrays: file
    (object), valence, note_density_per_instrument and n_instruments
    (float64, NaN for an NA field) and is_matched (bool)."""
    with open(feature_file, newline="") as f:
        rows = list(csv.DictReader(f))
    cols = {"file": np.array([r["file"] for r in rows], object)}
    for name in ("valence", "note_density_per_instrument", "n_instruments"):
        cols[name] = np.array([_to_float(r[name] or "") for r in rows], np.float64)
    cols["is_matched"] = np.array([_to_bool(r["is_matched"] or "") for r in rows], bool)
    return cols


def _binned(x: np.ndarray, prefix: str, n_bins: int) -> np.ndarray:
    """Quantile-bin a scaled feature into '<V-2>'..'<V2>'-style symbols
    (NaN -> None)."""
    if n_bins % 2 == 0:
        ids = list(range(-n_bins // 2, 0)) + list(range(1, n_bins // 2 + 1))
    else:
        ids = list(range(-(n_bins - 1) // 2, (n_bins - 1) // 2 + 1))
    names = np.array([f"<{prefix}{b}>" for b in ids] + [None], object)
    edges = np.nanquantile(x, np.linspace(0.0, 1.0, n_bins + 1))
    edges[-1] += 1e-6
    # NaN searchsorts past every edge -> index n_bins -> the None bucket
    return names[np.digitize(x, edges) - 1]


def preprocess_features(
    feature_file: str,
    n_bins: Optional[int] = None,
    min_n_instruments: int = 3,
    test_ratio: float = 0.05,
    outlier_range: float = 1.5,
    conditional: bool = True,
    use_labeled_only: bool = True,
) -> Tuple[List[dict], List[dict]]:
    """Returns (train_records, test_records), each a list of dicts with
    keys "file" and (if conditional) "valence"/"arousal"."""
    raw = _read_features(feature_file)
    files = raw["file"]
    valence = raw["valence"]
    arousal = raw["note_density_per_instrument"]
    matched = raw["is_matched"]

    with np.errstate(invalid="ignore"):
        # row filters: enough instruments, nonzero valence (NaN labels kept)
        keep = (raw["n_instruments"] >= min_n_instruments) & (
            valence != 0
        )
        files, valence, arousal, matched = (
            a[keep] for a in (files, valence, arousal, matched)
        )

        # IQR outlier removal, both features judged on the same base rows
        def inlier(x: np.ndarray) -> np.ndarray:
            q1, q3 = np.nanquantile(x, 0.25), np.nanquantile(x, 0.75)
            margin = outlier_range * (q3 - q1)
            return ~((x < q1 - margin) | (x > q3 + margin))  # NaN stays

        keep = inlier(valence) & inlier(arousal)
        files, valence, arousal, matched = (
            a[keep] for a in (files, valence, arousal, matched)
        )

    def rescale(x: np.ndarray) -> np.ndarray:
        lo, hi = np.nanmin(x), np.nanmax(x)
        return (x - lo) / (hi - lo) * 2 - 1

    valence, arousal = rescale(valence), rescale(arousal)

    if n_bins is not None:
        valence = _binned(valence, "V", n_bins)
        arousal = _binned(arousal, "A", n_bins)

    def labeled(idx: np.ndarray) -> np.ndarray:
        """Rows whose BOTH labels are present."""
        if n_bins is not None:
            ok = (valence[idx] != None) & (arousal[idx] != None)  # noqa: E711
        else:
            ok = ~(np.isnan(valence[idx]) | np.isnan(arousal[idx]))
        return idx[ok]

    # deterministic split: matched subset sorted by file; the boundary row
    # appears in both splits (reference parity, see module docstring)
    m_idx = np.flatnonzero(matched)
    m_idx = m_idx[np.argsort(files[m_idx], kind="stable")]
    n_test = round(len(m_idx) * test_ratio)
    test_idx = m_idx[len(m_idx) - n_test :]
    train_idx = m_idx[: len(m_idx) - n_test + 1]
    if not use_labeled_only:
        u_idx = np.flatnonzero(~matched)
        train_idx = np.concatenate([train_idx, u_idx])
        train_idx = train_idx[np.argsort(files[train_idx], kind="stable")]

    test_idx = labeled(test_idx)
    if use_labeled_only:
        train_idx = labeled(train_idx)

    def records(idx: np.ndarray) -> List[dict]:
        out = []
        for i in idx:
            rec = {"file": files[i]}
            if conditional:
                for key, col in (("valence", valence), ("arousal", arousal)):
                    v = col[i]
                    if n_bins is None:
                        v = None if np.isnan(v) else float(v)
                    rec[key] = v
                out.append(rec)
            else:
                out.append(rec)
        return out

    return records(train_idx), records(test_idx)
