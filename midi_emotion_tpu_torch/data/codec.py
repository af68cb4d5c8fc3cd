"""MIDI <-> token codec.

Forward path (notes -> bar-segmented token arrays) reproduces the semantics
of the reference encoder (the reference's ``src/data/data_processing.py``):

 * ``notes_to_timed_events``    <- ``mid_to_timed_tuples`` (:58-102)
 * ``timed_events_to_tuples``   <- ``timed_tuples_to_tuples`` (:104-131),
   vectorized with numpy instead of a per-event Python loop
 * ``notes_to_bars``            <- ``mid_to_bars`` (:140-176)

Reverse path (token ids -> notes / strings) mirrors
``data_processing_reverse.py``:

 * ``ids_to_tracks``            <- ``tuples_to_mid`` (:12-53)
 * ``ids_to_strings``           <- ``tuples_to_str`` (:61-69)

Tokens are represented in two interchangeable forms:
 * "tuple arrays": int16 [N, 2] of (event_idx, value) rows -- the on-disk
   shard format, binary-compatible in content with the reference's
   per-song ``.pt`` bar arrays;
 * flat int32 token-id arrays (see ``vocab.Vocab``) -- the model-facing form.

A copy of ``midi_emotion_tpu/data/codec.py``, unchanged but for this note and
the reference's paths, given from its repository root:
the torch port keeps its own copies and imports nothing of the JAX
package.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..vocab import INSTRUMENTS, TIMESHIFT, Vocab
from .midi_io import Note, Track

# sorting priorities (data_processing.py:59-64) -- note this differs from the
# vocabulary's instrument order
_ON_OFF_PRIORITY = {"ON": 0, "OFF": 1}
_INS_PRIORITY = {"DRUMS": 0, "BASS": 1, "GUITAR": 2, "PIANO": 3, "STRINGS": 4}

# reverse-path fixed program/velocity tables (data_processing_reverse.py:14-22)
INSTRUMENT_TO_PROGRAM = {
    "DRUMS": (0, True),
    "PIANO": (0, False),
    "GUITAR": (24, False),
    "BASS": (32, False),
    "STRINGS": (48, False),
}
VELOCITIES = {"BASS": 127, "DRUMS": 120, "GUITAR": 95, "PIANO": 110, "STRINGS": 85}

_EVENT_IDX = {}
for _i, _ins in enumerate(INSTRUMENTS):
    for _j, _onoff in enumerate(("OFF", "ON")):
        _EVENT_IDX[f"{_onoff}_{_ins}"] = 2 * _i + _j
_TIMESHIFT_EVENT = 10


def notes_to_timed_events(
    notes: Sequence[Note], min_pitch: int = 21, max_pitch: int = 108
) -> List[Tuple[float, Tuple[int, int]]]:
    """Notes -> time-sorted (time, (event_idx, pitch)) list.

    Reproduces mid_to_timed_tuples (data_processing.py:58-102): notes are
    sorted by (start, pitch, duration, velocity, instrument); each in-range
    note emits an ON and an OFF event; events then sort by
    (time, on/off priority, instrument priority, (event_idx, pitch)).
    """
    if not notes:
        raise RuntimeError("No notes found.")
    notes = sorted(
        notes, key=lambda n: (n.start, n.pitch, n.duration, n.velocity, n.instrument)
    )
    events = []
    for note in notes:
        if min_pitch <= note.pitch <= max_pitch:
            ins = note.instrument.upper()
            start = round(note.start, 6)
            end = round(note.end, 6)
            events.append(
                (
                    start,
                    _ON_OFF_PRIORITY["ON"],
                    _INS_PRIORITY[ins],
                    (_EVENT_IDX[f"ON_{ins}"], note.pitch),
                )
            )
            events.append(
                (
                    end,
                    _ON_OFF_PRIORITY["OFF"],
                    _INS_PRIORITY[ins],
                    (_EVENT_IDX[f"OFF_{ins}"], note.pitch),
                )
            )
    events.sort()
    return [(e[0], e[-1]) for e in events]


def timed_events_to_tuples(
    times_sec: np.ndarray,
    events: np.ndarray,
    values: np.ndarray,
    is_special: np.ndarray,
    max_timeshift: int = 1000,
    timeshift_step: int = 8,
) -> np.ndarray:
    """Vectorized delta-time tokenization (data_processing.py:104-131).

    Inputs are parallel arrays over events in time order; ``is_special``
    marks sentinel rows (e.g. bar boundaries) that contribute timeshifts but
    no token of their own. Returns int16 [N, 2] of (event_idx, value).

    Semantics reproduced exactly: times are rounded to integer milliseconds;
    gaps longer than ``max_timeshift`` are split into full-length shifts
    plus a remainder; the remainder is quantized with round-half-to-even to
    ``timeshift_step`` and never rounded down to zero.
    """
    times_ms = np.rint(np.asarray(times_sec, dtype=np.float64) * 1000).astype(np.int64)
    events = np.asarray(events, dtype=np.int64)
    values = np.asarray(values, dtype=np.int64)
    is_special = np.asarray(is_special, dtype=bool)

    prev = np.concatenate([times_ms[:1], times_ms[:-1]])
    delta = times_ms - prev  # >= 0 for time-sorted input; first is 0

    n_full = delta // max_timeshift
    rem = delta % max_timeshift
    # round-half-to-even to the step grid, clamped away from zero
    rem_q = (timeshift_step * np.round(rem / timeshift_step)).astype(np.int64)
    rem_q = np.where((rem > 0) & (rem_q == 0), timeshift_step, rem_q)
    has_rem = rem > 0

    n_out = n_full + has_rem.astype(np.int64) + (~is_special).astype(np.int64)
    total = int(n_out.sum())
    out = np.empty((total, 2), dtype=np.int16)

    # segment start offsets for each source event
    starts = np.concatenate([[0], np.cumsum(n_out)[:-1]])

    # full max-length timeshifts: positions starts[i] .. starts[i]+n_full[i]-1
    full_rows = np.repeat(starts, n_full) + _ranges(n_full)
    out[full_rows, 0] = _TIMESHIFT_EVENT
    out[full_rows, 1] = max_timeshift

    # remainder timeshifts
    rem_rows = (starts + n_full)[has_rem]
    out[rem_rows, 0] = _TIMESHIFT_EVENT
    out[rem_rows, 1] = rem_q[has_rem]

    # the events themselves
    ev_rows = (starts + n_full + has_rem)[~is_special]
    out[ev_rows, 0] = events[~is_special]
    out[ev_rows, 1] = values[~is_special]
    return out


def _ranges(counts: np.ndarray) -> np.ndarray:
    """[0..c0-1, 0..c1-1, ...] for an int array of counts."""
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    idx = np.arange(total, dtype=np.int64)
    reset = np.repeat(np.cumsum(counts) - counts, counts)
    return idx - reset


def notes_to_bars(
    notes: Sequence[Note],
    downbeats: np.ndarray,
    max_timeshift: int = 1000,
    timeshift_step: int = 8,
    min_pitch: int = 21,
    max_pitch: int = 108,
    impl: str = "auto",
) -> Optional[List[np.ndarray]]:
    """Segment a song into per-bar token arrays (mid_to_bars,
    data_processing.py:140-176).

    Each bar restarts its time cursor at the bar start; a trailing
    timeshift to the bar end is emitted; bars whose event list (including
    the two boundary sentinels) has <= 2 entries are dropped. Returns None
    on any failure, like the reference's bare ``except``.

    impl: "auto" uses the C++ core (ops/native.py) when it built, "python"
    forces the numpy path, "native" requires the C++ core. Both are
    bit-identical (tests/test_native.py).
    """
    if impl in ("auto", "native"):
        from ..ops import native

        if native.available():
            try:
                timed = notes_to_timed_events(notes, min_pitch, max_pitch)
                times = np.array([t for t, _ in timed], np.float64)
                evs = np.array([s[0] for _, s in timed], np.int16)
                vals = np.array([s[1] for _, s in timed], np.int16)
                return native.tokenize_bars(
                    times, evs, vals, downbeats, max_timeshift, timeshift_step
                )
            except Exception:
                return None
        if impl == "native":
            raise RuntimeError("native tokenizer unavailable (g++ build failed)")
    try:
        bar_times = [round(float(b), 6) for b in downbeats]
        bar_times.append(bar_times[-1] + (bar_times[-1] - bar_times[-2]))
        bar_times.append(bar_times[-1] + (bar_times[-1] - bar_times[-2]))

        timed = notes_to_timed_events(notes, min_pitch, max_pitch)
        i_bar = -1
        i_note = 0
        bars: List[np.ndarray] = []
        cur: List[Tuple[float, object]] = []
        cur_bar_end = -float("inf")
        while i_note < len(timed):
            time, sym = timed[i_note]
            if time < cur_bar_end:
                cur.append((time, sym))
                i_note += 1
            else:
                cur.append((cur_bar_end, "<BAR_END>"))
                if len(cur) > 2:
                    bars.append(_bar_to_array(cur, max_timeshift, timeshift_step))
                i_bar += 1
                cur_bar_start = bar_times[i_bar]
                cur_bar_end = bar_times[i_bar + 1]
                cur = [(cur_bar_start, "<BAR_START>")]
    except Exception:
        bars = None
    return bars


def _bar_to_array(
    timed: List[Tuple[float, object]], max_timeshift: int, timeshift_step: int
) -> np.ndarray:
    times = np.array([t for t, _ in timed], dtype=np.float64)
    is_special = np.array([isinstance(s, str) for _, s in timed], dtype=bool)
    events = np.array(
        [0 if isinstance(s, str) else s[0] for _, s in timed], dtype=np.int64
    )
    values = np.array(
        [0 if isinstance(s, str) else s[1] for _, s in timed], dtype=np.int64
    )
    return timed_events_to_tuples(
        times, events, values, is_special, max_timeshift, timeshift_step
    )


# ---------------------------------------------------------------------------
# Reverse path
# ---------------------------------------------------------------------------


def tuples_to_tracks(tuples: np.ndarray, vocab: Vocab, verbose: bool = False) -> List[Track]:
    """(event, value) rows -> instrument tracks (tuples_to_mid,
    data_processing_reverse.py:12-53). ON opens a note per (instrument,
    pitch); OFF closes the open one if any; an ON on an already-open key
    replaces its start time without emitting a note."""
    idx2event = {i: s for i, s in enumerate(vocab.event_syms)}
    tracks = {
        key: Track(name=key.lower(), program=val[0], is_drum=val[1])
        for key, val in INSTRUMENT_TO_PROGRAM.items()
    }
    active = {}
    time_cursor = 0.0
    for ev, val in tuples:
        event = idx2event[int(ev)]
        if event == TIMESHIFT:
            time_cursor += float(val) / 1000.0
        else:
            on_off, instrument = event.split("_")
            pitch = int(val)
            if on_off == "ON":
                active[(instrument, pitch)] = time_cursor
            elif (instrument, pitch) in active:
                start = active.pop((instrument, pitch))
                tracks[instrument].notes.append(
                    Note(VELOCITIES[instrument], pitch, start, time_cursor, instrument)
                )
            elif verbose:
                print(f"Ignoring {event} {pitch}: no previous ON event")
    return list(tracks.values())


def ids_to_tracks(ids: np.ndarray, vocab: Vocab) -> List[Track]:
    """Token ids -> tracks, skipping special tokens
    (ind_tensor_to_mid, data_processing_reverse.py:71-75)."""
    ids = np.asarray(ids)
    ev, val = vocab.decode_ids(ids)
    keep = ev >= 0
    return tuples_to_tracks(np.stack([ev[keep], val[keep]], axis=1), vocab)


def ids_to_strings(ids: np.ndarray, vocab: Vocab) -> List[str]:
    """Token ids -> string symbols (ind_tensor_to_str,
    data_processing_reverse.py:77-81): "EVENT_value" or the special symbol."""
    maps = vocab.get_maps()
    out = []
    for i in np.asarray(ids).tolist():
        sym = maps["idx2tuple"][int(i)]
        if isinstance(sym, str):
            out.append(sym)
        else:
            out.append(maps["idx2event"][sym[0]] + "_" + str(sym[1]))
    return out


def tuples_to_strings(tuples: np.ndarray, vocab: Vocab) -> List[str]:
    """(event, value) rows -> string symbols (tuples_to_str,
    data_processing_reverse.py:61-69)."""
    idx2event = {i: s for i, s in enumerate(vocab.event_syms)}
    return [idx2event[int(e)] + "_" + str(int(v)) for e, v in tuples]


def get_n_instruments(symbols: Sequence[str]) -> int:
    """Number of distinct instruments in a symbol list
    (utils.py:143-148: counts unique middle fields of 3-part symbols)."""
    parts = [s.split("_") for s in symbols]
    return len({p[1] for p in parts if len(p) == 3})


def n_instruments_from_ids(ids: np.ndarray, vocab: Vocab) -> int:
    """Vectorized equivalent of get_n_instruments over token ids."""
    ids = np.asarray(ids)
    ev, _ = vocab.decode_ids(ids)
    note_ev = ev[(ev >= 0) & (ev < vocab.timeshift_event)]
    return len(np.unique(note_ev // 2))


def tuples_to_ids(tuples: np.ndarray, vocab: Vocab) -> np.ndarray:
    """(event, value) int rows -> token ids (tensor_to_ind_tensor,
    data_processing.py:244-247), vectorized."""
    tuples = np.asarray(tuples)
    return vocab.encode_tuples(tuples[:, 0], tuples[:, 1])
