"""Frozen, versioned vocabulary specification for the MIDI event token stream.

Re-derivation of the reference vocabulary (the reference's ``src/data/
data_processing.py:183-222`` ``get_maps``) as an immutable spec with
closed-form, vectorized id<->event arithmetic instead of Python dicts.

Layout (base vocabulary, exactly 1007 ids):

    id 0                   : "<PAD>"
    id 1                   : "<START>"
    ids 2 .. 881           : note events -- for each instrument in
                             [DRUMS, GUITAR, BASS, PIANO, STRINGS], for each
                             on/off in [OFF, ON], for each pitch in
                             [min_pitch .. max_pitch] (88 pitches)
    ids 882 .. 1006        : ("TIMESHIFT", v) for v in
                             [step, 2*step, ..., max_timeshift] (125 values)
    ids 1007 ..            : runtime extra tokens (sorted discrete emotion
                             tokens such as "<V-2>", and/or "<CLS>"), appended
                             by the data loaders exactly as the reference does
                             (``loader.py:54-75``).

Event table (11 events):

    0 OFF_DRUMS   1 ON_DRUMS    2 OFF_GUITAR  3 ON_GUITAR  4 OFF_BASS
    5 ON_BASS     6 OFF_PIANO   7 ON_PIANO    8 OFF_STRINGS 9 ON_STRINGS
    10 TIMESHIFT

The closed forms used throughout the framework:

    token_id(event e < 10, pitch p) = 2 + e * n_pitches + (p - min_pitch)
    token_id(TIMESHIFT, v)          = 2 + 10 * n_pitches + v // step - 1

A copy of ``midi_emotion_tpu/vocab.py``, unchanged but for this note and
the reference's paths, given from its repository root:
the torch port keeps its own copies and imports nothing of the JAX
package.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

INSTRUMENTS = ("DRUMS", "GUITAR", "BASS", "PIANO", "STRINGS")
ON_OFFS = ("OFF", "ON")
PAD = "<PAD>"
START = "<START>"
CLS = "<CLS>"
TIMESHIFT = "TIMESHIFT"


@dataclasses.dataclass(frozen=True)
class Vocab:
    """Immutable vocabulary spec.

    ``extra_tokens`` mirrors the reference loaders' runtime vocabulary
    extension: sorted discrete-emotion tokens and/or "<CLS>".
    """

    min_pitch: int = 21
    max_pitch: int = 108
    max_timeshift: int = 1000  # milliseconds
    timeshift_step: int = 8  # milliseconds
    extra_tokens: tuple = ()

    # ---- derived sizes -------------------------------------------------
    @property
    def n_pitches(self) -> int:
        return self.max_pitch - self.min_pitch + 1

    @property
    def n_note_events(self) -> int:
        return len(INSTRUMENTS) * len(ON_OFFS)  # 10

    @property
    def n_timeshift(self) -> int:
        return self.max_timeshift // self.timeshift_step  # 125

    @property
    def timeshift_event(self) -> int:
        return self.n_note_events  # 10

    @property
    def note_base(self) -> int:
        return 2  # after <PAD>, <START>

    @property
    def timeshift_base(self) -> int:
        return self.note_base + self.n_note_events * self.n_pitches  # 882

    @property
    def base_size(self) -> int:
        return self.timeshift_base + self.n_timeshift  # 1007

    def __len__(self) -> int:
        return self.base_size + len(self.extra_tokens)

    # ---- special ids ---------------------------------------------------
    @property
    def pad_id(self) -> int:
        return 0

    @property
    def start_id(self) -> int:
        return 1

    def extra_id(self, token: str) -> int:
        return self.base_size + self.extra_tokens.index(token)

    @property
    def special_ids(self) -> np.ndarray:
        """Ids of all special ("<...>") tokens: pad, start, and extras."""
        return np.concatenate(
            [
                np.array([self.pad_id, self.start_id], dtype=np.int32),
                np.arange(
                    self.base_size, self.base_size + len(self.extra_tokens), dtype=np.int32
                ),
            ]
        )

    def special_mask(self) -> np.ndarray:
        """Boolean [vocab] mask that is True at special-token ids."""
        mask = np.zeros(len(self), dtype=bool)
        mask[self.special_ids] = True
        return mask

    # ---- event table ---------------------------------------------------
    @property
    def event_syms(self) -> list:
        syms = []
        for ins in INSTRUMENTS:
            for on_off in ON_OFFS:
                syms.append(f"{on_off}_{ins}")
        syms.append(TIMESHIFT)
        return syms

    @property
    def transposable_event_ids(self) -> np.ndarray:
        """Event ids whose pitch may be transposed (everything but drums)."""
        ids = []
        for i, ins in enumerate(INSTRUMENTS):
            if ins != "DRUMS":
                ids.extend([2 * i, 2 * i + 1])
        return np.array(sorted(ids), dtype=np.int32)

    # ---- vectorized id <-> (event, value) ------------------------------
    def encode_tuples(self, events: np.ndarray, values: np.ndarray) -> np.ndarray:
        """Vectorized (event_idx, value) -> token id.

        Notes use value = MIDI pitch; TIMESHIFT uses value = milliseconds
        (must already be quantized to ``timeshift_step``).
        """
        events = np.asarray(events, dtype=np.int64)
        values = np.asarray(values, dtype=np.int64)
        note_ids = self.note_base + events * self.n_pitches + (values - self.min_pitch)
        ts_ids = self.timeshift_base + values // self.timeshift_step - 1
        return np.where(events == self.timeshift_event, ts_ids, note_ids).astype(np.int32)

    def decode_ids(self, ids: np.ndarray):
        """Vectorized token id -> (event_idx, value).

        Special tokens decode to event -1, value = id.
        """
        ids = np.asarray(ids, dtype=np.int64)
        is_note = (ids >= self.note_base) & (ids < self.timeshift_base)
        is_ts = (ids >= self.timeshift_base) & (ids < self.base_size)
        rel = ids - self.note_base
        ev = np.where(is_note, rel // self.n_pitches, -1)
        ev = np.where(is_ts, self.timeshift_event, ev)
        val = np.where(is_note, self.min_pitch + rel % self.n_pitches, ids)
        val = np.where(
            is_ts, (ids - self.timeshift_base + 1) * self.timeshift_step, val
        )
        return ev.astype(np.int32), val.astype(np.int32)

    def is_timeshift(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids)
        return (ids >= self.timeshift_base) & (ids < self.base_size)

    # ---- transposition -------------------------------------------------
    def transpose_tuples(
        self, events: np.ndarray, values: np.ndarray, n: int
    ) -> np.ndarray:
        """Vectorized equivalent of the reference ``transpose``
        (data_processing.py:225-232): shift pitch of non-drum note events
        by ``n`` when the result stays within [min_pitch, max_pitch]."""
        transposable = np.isin(events, self.transposable_event_ids)
        shifted = values + n
        ok = transposable & (shifted >= self.min_pitch) & (shifted <= self.max_pitch)
        return np.where(ok, shifted, values)

    def transpose_ids(self, ids: np.ndarray, n: int) -> np.ndarray:
        """Transpose directly on token ids."""
        ev, val = self.decode_ids(ids)
        new_val = self.transpose_tuples(ev, val, n)
        changed = new_val != val
        return np.where(changed, self.encode_tuples(ev, new_val), ids).astype(ids.dtype)

    # ---- dict-style maps (reference-compatible surface) -----------------
    def get_maps(self) -> dict:
        """Reference-compatible maps dict (data_processing.py:183-222):
        tuple2idx/idx2tuple with (event_idx, value) int-tuple keys,
        event2idx/idx2event, transposable_event_inds."""
        event_syms = self.event_syms
        event2idx = {sym: idx for idx, sym in enumerate(event_syms)}
        idx2event = {idx: sym for idx, sym in enumerate(event_syms)}

        token_entries = [PAD, START]
        for i, ins in enumerate(INSTRUMENTS):
            for j, on_off in enumerate(ON_OFFS):
                ev = 2 * i + j
                for pitch in range(self.min_pitch, self.max_pitch + 1):
                    token_entries.append((ev, pitch))
        for ts in range(
            self.timeshift_step,
            self.max_timeshift + self.timeshift_step,
            self.timeshift_step,
        ):
            token_entries.append((self.timeshift_event, ts))
        token_entries.extend(self.extra_tokens)

        tuple2idx = {sym: idx for idx, sym in enumerate(token_entries)}
        idx2tuple = {idx: sym for idx, sym in enumerate(token_entries)}
        return {
            "event2idx": event2idx,
            "idx2event": idx2event,
            "tuple2idx": tuple2idx,
            "idx2tuple": idx2tuple,
            "transposable_event_inds": self.transposable_event_ids.tolist(),
        }

    def with_extra_tokens(self, extra: Sequence[str]) -> "Vocab":
        return dataclasses.replace(self, extra_tokens=tuple(extra))

    # ---- (de)serialization ----------------------------------------------
    def to_dict(self) -> dict:
        return {
            "min_pitch": self.min_pitch,
            "max_pitch": self.max_pitch,
            "max_timeshift": self.max_timeshift,
            "timeshift_step": self.timeshift_step,
            "extra_tokens": list(self.extra_tokens),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Vocab":
        return cls(
            min_pitch=d["min_pitch"],
            max_pitch=d["max_pitch"],
            max_timeshift=d["max_timeshift"],
            timeshift_step=d["timeshift_step"],
            extra_tokens=tuple(d["extra_tokens"]),
        )

    @classmethod
    def from_maps(cls, maps: dict) -> "Vocab":
        """Reconstruct a Vocab from a reference-style maps dict (e.g. one
        loaded from a PyTorch ``mappings.pt``)."""
        idx2tuple = maps["idx2tuple"]
        n = len(idx2tuple)
        extras = []
        for idx in range(n):
            sym = idx2tuple[idx]
            if isinstance(sym, str) and idx >= 2:
                extras.append(sym)
        vocab = cls(extra_tokens=tuple(extras))
        # sanity: the base layout must line up
        assert vocab.base_size + len(extras) == n, (vocab.base_size, len(extras), n)
        return vocab


def emotion_bin_tokens(n_bins: int = 5) -> list:
    """Discrete emotion token symbols in the reference's sorted order
    (loader.py:59-65 sorts them; generate.py:320-328 derives bin ids)."""
    if n_bins % 2 == 0:
        bin_ids = list(range(-n_bins // 2, 0)) + list(range(1, n_bins // 2 + 1))
    else:
        bin_ids = list(range(-(n_bins - 1) // 2, (n_bins - 1) // 2 + 1))
    tokens = []
    for axis in ("V", "A"):
        for b in bin_ids:
            tokens.append(f"<{axis}{b}>")
    return sorted(tokens)


DEFAULT_VOCAB = Vocab()
