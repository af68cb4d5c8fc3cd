"""Self-contained MIDI and pianoroll I/O.

The reference relies on ``pretty_midi`` and ``pypianoroll`` for file I/O
(the reference's ``src/data/data_processing.py:9-17``,
``data_processing_reverse.py:12-53``). Neither library is available here, so
this module implements the minimum needed surface from scratch:

 * a Standard MIDI File (SMF) writer used by the token->MIDI decoder,
 * a SMF reader (sufficient for round-trip tests and offline feature
   extraction),
 * a parser for pypianoroll ``.npz`` multitrack files (the LPD-5 dataset
   format), converting them to in-memory note lists with the same semantics
   as ``pypianoroll.load(fp).to_pretty_midi()``: constant tempo taken from
   the first tempo entry, note boundaries at velocity run starts/ends,
 * downbeat computation matching ``PrettyMIDI.get_downbeats()`` for the
   constant-tempo, 4/4 output of that conversion (a bar every four beats).

A copy of ``midi_emotion_tpu/data/midi_io.py``, unchanged but for this note and
the reference's paths, given from its repository root:
the torch port keeps its own copies and imports nothing of the JAX
package.
"""

from __future__ import annotations

import dataclasses
import io
import json
import struct
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class Note:
    velocity: int
    pitch: int
    start: float  # seconds
    end: float  # seconds
    instrument: str = ""

    @property
    def duration(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class Track:
    name: str
    program: int
    is_drum: bool
    notes: List[Note] = dataclasses.field(default_factory=list)


# ---------------------------------------------------------------------------
# SMF writing
# ---------------------------------------------------------------------------


def _var_len(value: int) -> bytes:
    """MIDI variable-length quantity."""
    buf = [value & 0x7F]
    value >>= 7
    while value:
        buf.append((value & 0x7F) | 0x80)
        value >>= 7
    return bytes(reversed(buf))


def write_midi(
    tracks: Sequence[Track],
    path: str,
    tempo_bpm: float = 120.0,
    resolution: int = 220,
) -> None:
    """Write a format-1 SMF. Channel 9 is reserved for drums."""
    data = io.BytesIO()
    n_tracks = len(tracks) + 1  # + tempo track
    data.write(b"MThd" + struct.pack(">IHHH", 6, 1, n_tracks, resolution))

    # Tempo track
    tempo_us = int(round(60_000_000 / tempo_bpm))
    ev = b"\x00\xff\x51\x03" + struct.pack(">I", tempo_us)[1:]
    ev += b"\x00\xff\x2f\x00"  # end of track
    data.write(b"MTrk" + struct.pack(">I", len(ev)) + ev)

    ticks_per_sec = resolution * tempo_bpm / 60.0
    next_channel = 0
    for track in tracks:
        if track.is_drum:
            channel = 9
        else:
            if next_channel == 9:
                next_channel += 1
            channel = next_channel
            next_channel = (next_channel + 1) % 16

        events = []  # (tick, order, message bytes)
        name_bytes = track.name.encode("ascii", "replace")
        events.append((0, 0, b"\xff\x03" + _var_len(len(name_bytes)) + name_bytes))
        events.append((0, 1, bytes([0xC0 | channel, track.program & 0x7F])))
        for note in track.notes:
            on_tick = int(round(note.start * ticks_per_sec))
            off_tick = max(on_tick + 1, int(round(note.end * ticks_per_sec)))
            vel = min(127, max(1, int(note.velocity)))
            events.append((on_tick, 3, bytes([0x90 | channel, note.pitch & 0x7F, vel])))
            events.append((off_tick, 2, bytes([0x80 | channel, note.pitch & 0x7F, 64])))
        events.sort(key=lambda e: (e[0], e[1]))

        body = io.BytesIO()
        prev_tick = 0
        for tick, _, msg in events:
            body.write(_var_len(tick - prev_tick))
            body.write(msg)
            prev_tick = tick
        body.write(b"\x00\xff\x2f\x00")
        payload = body.getvalue()
        data.write(b"MTrk" + struct.pack(">I", len(payload)) + payload)

    with open(path, "wb") as f:
        f.write(data.getvalue())


# ---------------------------------------------------------------------------
# SMF reading
# ---------------------------------------------------------------------------


def _read_var_len(buf: bytes, pos: int):
    value = 0
    while True:
        b = buf[pos]
        pos += 1
        value = (value << 7) | (b & 0x7F)
        if not (b & 0x80):
            return value, pos


def read_midi(path: str) -> List[Track]:
    """Minimal SMF reader with tempo-map-aware tick->second conversion."""
    with open(path, "rb") as f:
        raw = f.read()
    assert raw[:4] == b"MThd", "not a MIDI file"
    _, fmt, n_tracks, division = struct.unpack(">IHHH", raw[4:14])
    assert division & 0x8000 == 0, "SMPTE timecodes unsupported"
    pos = 14

    # pass 1: collect raw events per track + global tempo map
    tempo_changes = [(0, 500000)]  # (tick, us_per_quarter)
    track_events = []  # list of list[(tick, status, d1, d2)]
    track_names: List[str] = []
    track_programs: List[Dict[int, int]] = []

    for _ in range(n_tracks):
        assert raw[pos : pos + 4] == b"MTrk"
        (length,) = struct.unpack(">I", raw[pos + 4 : pos + 8])
        body = raw[pos + 8 : pos + 8 + length]
        pos += 8 + length

        tick = 0
        p = 0
        running = 0
        events = []
        name = ""
        programs: Dict[int, int] = {}
        while p < len(body):
            delta, p = _read_var_len(body, p)
            tick += delta
            status = body[p]
            if status == 0xFF:  # meta
                meta_type = body[p + 1]
                mlen, p2 = _read_var_len(body, p + 2)
                payload = body[p2 : p2 + mlen]
                if meta_type == 0x51:
                    tempo_changes.append((tick, int.from_bytes(payload, "big")))
                elif meta_type == 0x03 and not name:
                    name = payload.decode("latin1")
                p = p2 + mlen
            elif status in (0xF0, 0xF7):  # sysex
                mlen, p2 = _read_var_len(body, p + 1)
                p = p2 + mlen
            else:
                if status & 0x80:
                    running = status
                    p += 1
                else:
                    status = running
                kind = status & 0xF0
                if kind in (0x80, 0x90, 0xA0, 0xB0, 0xE0):
                    d1, d2 = body[p], body[p + 1]
                    p += 2
                    events.append((tick, status, d1, d2))
                elif kind in (0xC0, 0xD0):
                    d1 = body[p]
                    p += 1
                    if kind == 0xC0:
                        programs[status & 0x0F] = d1
                    events.append((tick, status, d1, 0))
        track_events.append(events)
        track_names.append(name)
        track_programs.append(programs)

    # tick -> seconds with tempo map
    tempo_changes.sort()
    tempo_ticks = np.array([t for t, _ in tempo_changes], dtype=np.float64)
    tempo_us = np.array([u for _, u in tempo_changes], dtype=np.float64)
    seg_seconds = np.zeros(len(tempo_ticks))
    for i in range(1, len(tempo_ticks)):
        seg_seconds[i] = seg_seconds[i - 1] + (
            (tempo_ticks[i] - tempo_ticks[i - 1]) * tempo_us[i - 1] / 1e6 / division
        )

    def tick_to_sec(tick: int) -> float:
        i = int(np.searchsorted(tempo_ticks, tick, side="right")) - 1
        return float(
            seg_seconds[i] + (tick - tempo_ticks[i]) * tempo_us[i] / 1e6 / division
        )

    tracks: List[Track] = []
    for ti, events in enumerate(track_events):
        if not events:
            continue
        active: Dict[tuple, tuple] = {}
        per_channel_notes: Dict[int, List[Note]] = {}
        for tick, status, d1, d2 in events:
            kind = status & 0xF0
            channel = status & 0x0F
            if kind == 0x90 and d2 > 0:
                active[(channel, d1)] = (tick, d2)
            elif kind == 0x80 or (kind == 0x90 and d2 == 0):
                key = (channel, d1)
                if key in active:
                    on_tick, vel = active.pop(key)
                    per_channel_notes.setdefault(channel, []).append(
                        Note(vel, d1, tick_to_sec(on_tick), tick_to_sec(tick))
                    )
        for channel, notes in per_channel_notes.items():
            notes.sort(key=lambda n: (n.start, n.pitch))
            tracks.append(
                Track(
                    name=track_names[ti],
                    program=track_programs[ti].get(channel, 0),
                    is_drum=(channel == 9),
                    notes=notes,
                )
            )
    return tracks


# ---------------------------------------------------------------------------
# pypianoroll .npz parsing (LPD dataset format)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Pianoroll:
    tracks: List[Track]
    tempo: float  # constant tempo (first entry, matching to_pretty_midi)
    beat_resolution: int
    n_timesteps: int

    @property
    def seconds_per_step(self) -> float:
        return 60.0 / (self.tempo * self.beat_resolution)

    def downbeat_times(self, beats_per_bar: int = 4) -> np.ndarray:
        """Bar-start times, matching ``PrettyMIDI.get_downbeats()`` on the
        constant-tempo 4/4 conversion (data_processing.py:148)."""
        end = self.n_timesteps * self.seconds_per_step
        bar = beats_per_bar * 60.0 / self.tempo
        n = int(np.floor(end / bar)) + 1
        return np.arange(n) * bar


def _roll_to_notes(roll: np.ndarray, seconds_per_step: float, name: str) -> List[Note]:
    """Velocity pianoroll [T, 128] -> notes at run boundaries."""
    notes: List[Note] = []
    padded = np.zeros((roll.shape[0] + 2, roll.shape[1]), dtype=roll.dtype)
    padded[1:-1] = roll
    on = padded > 0
    change = on[1:] != on[:-1]
    for pitch in range(roll.shape[1]):
        idx = np.flatnonzero(change[:, pitch])
        # idx alternates start, end (in original timestep coordinates)
        for s, e in zip(idx[0::2], idx[1::2]):
            notes.append(
                Note(
                    velocity=int(roll[s, pitch]),
                    pitch=pitch,
                    start=s * seconds_per_step,
                    end=e * seconds_per_step,
                    instrument=name,
                )
            )
    notes.sort(key=lambda n: (n.start, n.pitch))
    return notes


def load_pianoroll_npz(path: str) -> Pianoroll:
    """Parse a pypianoroll multitrack ``.npz`` (dense or CSC-sparse tracks)."""
    with np.load(path, allow_pickle=False) as npz:
        keys = set(npz.files)
        if "info.json" in keys:
            info = json.loads(bytes(npz["info.json"]).decode("utf-8"))
        else:
            info = {}
        beat_resolution = int(
            info.get("beat_resolution", info.get("resolution", 24))
        )
        tempo_arr = np.atleast_1d(npz["tempo"]) if "tempo" in keys else np.array([120.0])
        tempo = float(tempo_arr.flat[0])

        tracks: List[Track] = []
        n_timesteps = 0
        i = 0
        seconds_per_step = 60.0 / (tempo * beat_resolution)
        while True:
            tinfo = info.get(str(i), {})
            roll = None
            if f"pianoroll_{i}" in keys:
                roll = np.asarray(npz[f"pianoroll_{i}"])
            elif f"pianoroll_{i}_csc_data" in keys:
                from scipy.sparse import csc_matrix  # scipy ships with jax stack

                shape = npz[f"pianoroll_{i}_csc_shape"]
                roll = csc_matrix(
                    (
                        npz[f"pianoroll_{i}_csc_data"],
                        npz[f"pianoroll_{i}_csc_indices"],
                        npz[f"pianoroll_{i}_csc_indptr"],
                    ),
                    shape=tuple(shape),
                ).toarray()
            else:
                break
            name = tinfo.get("name", f"track_{i}")
            n_timesteps = max(n_timesteps, roll.shape[0])
            tracks.append(
                Track(
                    name=name,
                    program=int(tinfo.get("program", 0)),
                    is_drum=bool(tinfo.get("is_drum", False)),
                    notes=_roll_to_notes(roll, seconds_per_step, name),
                )
            )
            i += 1

    return Pianoroll(
        tracks=tracks,
        tempo=tempo,
        beat_resolution=beat_resolution,
        n_timesteps=n_timesteps,
    )


def save_pianoroll_npz(
    path: str,
    rolls: Dict[str, np.ndarray],
    tempo: float = 120.0,
    beat_resolution: int = 24,
    programs: Optional[Dict[str, int]] = None,
) -> None:
    """Write a dense pypianoroll-style npz (used by tests/fixtures)."""
    programs = programs or {}
    info: Dict[str, object] = {"beat_resolution": beat_resolution}
    arrays: Dict[str, np.ndarray] = {}
    n_steps = 0
    for i, (name, roll) in enumerate(rolls.items()):
        info[str(i)] = {
            "name": name,
            "program": programs.get(name, 0),
            "is_drum": name.upper() == "DRUMS",
        }
        arrays[f"pianoroll_{i}"] = roll.astype(np.uint8)
        n_steps = max(n_steps, roll.shape[0])
    arrays["tempo"] = np.full(n_steps, tempo)
    arrays["info.json"] = np.frombuffer(
        json.dumps(info).encode("utf-8"), dtype=np.uint8
    )
    np.savez_compressed(path, **arrays)
