"""Dataset-label construction (Lakh-MIDI x Spotify emotion labels).

Re-derivation of the reference's 9-stage offline pipeline
(the reference's ``src/create_dataset/run.py``) as pure, testable
functions plus a resumable stage runner (see ``create_dataset/run.py`` at
the repo root for the CLI). Stages:

  1. MSD track_id -> metadata, via the MSD summary h5 (h5py; the reference
     vendors the GPL pytables accessor library instead, hdf5_getters.py)
  2. Echonest song json -> Spotify IDs
  3. Spotify feature fetch -- NETWORK; this environment has zero egress, so
     the fetcher is injectable: pass any callable with the spotipy client
     surface (or a pre-fetched CSV) and the rest of the pipeline is pure
  4. match-score reversal (track->file becomes file->track)
  5. best-match filtering
  6. pianoroll-content SHA1 dedup
  7. low-level MIDI features (note density, tempo, instrument count)
  8. merge
  9. summarize to full_dataset_features_summarized.csv

String matching/normalization reproduce create_dataset/utils.py:145-193.

A copy of ``midi_emotion_tpu/data/dataset_builder.py`` (the torch port
keeps its own copies and imports nothing of the JAX package), unchanged
but for this note, a word of the summary above, the reference's paths,
given from its repository root, and ``write_summary_csv``, which writes
with the ``csv`` module where the JAX copy uses pandas: pandas is not a
dependency of the port. Stage 3 stays a client the caller injects;
nothing here opens a connection.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import midi_io

# ---------------------------------------------------------------------------
# 1. MSD summary metadata
# ---------------------------------------------------------------------------


def msd_trackid_to_metadata(msd_summary_path: str, track_ids) -> Dict[str, dict]:
    """Scan the Million Song Dataset summary file for the given track ids
    (run.py:71-89). Uses the h5py MSD accessors (data/msd_hdf5.py, the
    clean-room replacement for the reference's vendored pytables getter
    library) -- the scan reads the track_id column in bulk rather than
    calling get_track_id() per row, which is ~100x faster over a summary
    file with 10^6 songs."""
    from . import msd_hdf5

    wanted = set(track_ids)
    out: Dict[str, dict] = {}
    with msd_hdf5.open_h5_file_read(msd_summary_path) as h5:
        meta = h5["/metadata/songs"]
        analysis = h5["/analysis/songs"]
        tids = analysis["track_id"][:]
        for i, tid in enumerate(tids):
            tid = tid.decode("utf-8")
            if tid in wanted:
                row = meta[i]
                out[tid] = {
                    "song_id": row["song_id"].decode("utf-8"),
                    "title": row["title"].decode("utf-8"),
                    "artist": row["artist_name"].decode("utf-8"),
                    "release": row["release"].decode("utf-8"),
                }
    return dict(sorted(out.items()))


# ---------------------------------------------------------------------------
# 2. Echonest -> Spotify IDs (pure json parsing, utils.py:198-210)
# ---------------------------------------------------------------------------


def get_spotify_ids(json_path: str) -> List[str]:
    with open(json_path) as f:
        data = json.load(f)["response"]["songs"]
    if not data:
        return []
    ids = []
    for track in data[0]["tracks"]:
        if track.get("catalog") == "spotify" and "foreign_id" in track:
            ids.append(track["foreign_id"].split(":")[-1])
    return ids


# ---------------------------------------------------------------------------
# string matching (utils.py:145-193)
# ---------------------------------------------------------------------------


def fix_string(s: str) -> str:
    if s != "":
        s = s.lower()
        s = s.replace("'s", "")
        s = s.replace("_", " ")
        s = re.sub(r"[\(\[].*?[\)\]]", "", s)
        if s and s[-1] == " ":
            s = s[:-1]
    return s


def strip_artist(s: str) -> str:
    s = s.lower().replace("the ", "")
    for key in [" - ", "/", " ft", "feat", "featuring", " and ", " with ",
                "_", " vs", "&", ";", "+"]:
        loc = s.find(key)
        if loc != -1:
            s = s[:loc]
    return s


def matching_strings_flexible(a: str, b: str) -> float:
    """Positional prefix-agreement score (utils.py:145-159)."""
    if a == "" or b == "":
        return 0.0
    a = fix_string(a).replace("'", "")
    b = fix_string(b).replace("'", "")
    min_len = min(len(a), len(b))
    if min_len == 0:
        return 0.0
    return sum(1 for i in range(min_len) if a[i] == b[i]) / min_len


def pick_best_by_album(tracks: Sequence[Optional[dict]], album: str) -> Optional[dict]:
    """Best Spotify track by album-name match score (run.py:157-170)."""
    best_score, best_ind = 0.0, 0
    for i, track in enumerate(tracks):
        if track is not None:
            score = matching_strings_flexible(
                album, track.get("album", {}).get("name", "")
            )
            if score > best_score:
                best_score, best_ind = score, i
    return tracks[best_ind]


# ---------------------------------------------------------------------------
# 4/5. match-score reversal + best match (run.py:213-261)
# ---------------------------------------------------------------------------


def reverse_match_scores(match_scores: Dict[str, Dict[str, float]]) -> Dict[str, Dict[str, float]]:
    reversed_: Dict[str, Dict[str, float]] = {}
    for track_id, matching in match_scores.items():
        for file_, score in matching.items():
            reversed_.setdefault(file_, {})[track_id] = score
    for k in reversed_:
        reversed_[k] = dict(
            sorted(reversed_[k].items(), reverse=True, key=lambda x: x[-1])
        )
    return dict(sorted(reversed_.items(), key=lambda x: x[0]))


def best_match_scores(match_scores_reversed: Dict[str, Dict[str, float]]) -> Dict[str, Tuple[str, float]]:
    return {
        file_: list(match.items())[0]
        for file_, match in match_scores_reversed.items()
    }


# ---------------------------------------------------------------------------
# 6. content-hash dedup (utils.py:42-62, run.py:263-320)
# ---------------------------------------------------------------------------


def pianoroll_content_hash(path: str) -> str:
    """SHA1 of the concatenated per-track pianorolls, tracks sorted by
    name; 'empty_pianoroll' sentinel for empty/corrupt files."""
    try:
        if path.endswith(".mid"):
            tracks = midi_io.read_midi(path)
            rolls = [_track_to_roll(t) for t in tracks if t.notes]
        else:
            pr = midi_io.load_pianoroll_npz(path)
            tracks = sorted(pr.tracks, key=lambda t: t.name)
            rolls = [
                _notes_to_roll(t.notes, pr.seconds_per_step, pr.n_timesteps)
                for t in tracks
                if t.notes
            ]
        if not rolls:
            return "empty_pianoroll"
        rolls = np.concatenate(rolls, axis=-1)
    except Exception:
        return "empty_pianoroll"
    return hashlib.sha1(np.ascontiguousarray(rolls)).hexdigest()


def _notes_to_roll(notes, seconds_per_step, n_steps):
    roll = np.zeros((n_steps, 128), np.uint8)
    for n in notes:
        s = int(round(n.start / seconds_per_step))
        e = max(s + 1, int(round(n.end / seconds_per_step)))
        roll[s : min(e, n_steps), n.pitch] = n.velocity
    return roll


def _track_to_roll(track, fs: int = 100):
    end = max(n.end for n in track.notes)
    n_steps = int(end * fs) + 1
    roll = np.zeros((n_steps, 128), np.uint8)
    for n in track.notes:
        roll[int(n.start * fs) : max(int(n.start * fs) + 1, int(n.end * fs)), n.pitch] = n.velocity
    return roll


def unique_files(
    file_to_hash: Dict[str, str],
    best_matches: Dict[str, Tuple[str, float]],
) -> List[str]:
    """Keep one file per content hash, preferring the highest match score
    (run.py:293-316)."""
    hash_to_files: Dict[str, List[Tuple[str, float]]] = {}
    for file_, h in file_to_hash.items():
        score = best_matches.get(file_, (None, 0))[1]
        hash_to_files.setdefault(h, []).append((file_, score))
    out = []
    for h, group in hash_to_files.items():
        if h != "empty_pianoroll":
            group = sorted(group, key=lambda x: x[1], reverse=True)
            out.append(group[0][0])
    return out


# ---------------------------------------------------------------------------
# 7. low-level MIDI features (utils.py:64-79)
# ---------------------------------------------------------------------------


def midi_features_from_pianoroll(path: str) -> dict:
    pr = midi_io.load_pianoroll_npz(path)
    notes = [n for t in pr.tracks for n in t.notes]
    duration = max((n.end for n in notes), default=0.0)
    n_notes = len(notes)
    n_instruments = sum(1 for t in pr.tracks if t.notes)
    return {
        "note_density": n_notes / duration if duration > 0 else float("nan"),
        "tempo": pr.tempo,
        "n_instruments": n_instruments,
        "duration": duration,
    }


# ---------------------------------------------------------------------------
# 9. summarize (run.py:437-476)
# ---------------------------------------------------------------------------


def summarize(
    merged: Dict[str, dict],
) -> List[dict]:
    """{"file": {"midi_features", "matched_features"}} -> csv rows with
    note_density_per_instrument and NaN-ed zero valence."""
    rows = []
    for midi_file, features in merged.items():
        mf = features["midi_features"]
        n_instruments = mf["n_instruments"]
        nd_per_ins = (
            mf["note_density"] / n_instruments if n_instruments else float("nan")
        )
        matched = features.get("matched_features") or {}
        if matched == {}:
            is_matched = False
            valence = float("nan")
        else:
            is_matched = True
            saf = matched.get("spotify_audio_features")
            if saf is None or saf == "":
                valence = float("nan")
            elif saf["valence"] == 0.0:
                # an unusual number of 0.0 valences are upstream errors
                valence = float("nan")
            else:
                valence = saf["valence"]
        rows.append(
            {
                "file": midi_file,
                "is_matched": is_matched,
                "n_instruments": n_instruments,
                "note_density_per_instrument": nd_per_ins,
                "valence": valence,
            }
        )
    return rows


def _csv_field(value) -> str:
    """A field as ``pandas.DataFrame.to_csv`` writes it: NaN and None
    empty, floats by repr, the rest by str."""
    if value is None or (isinstance(value, float) and value != value):
        return ""
    return repr(value) if isinstance(value, float) else str(value)


def write_summary_csv(rows: List[dict], path: str) -> None:
    """The summary rows as the JAX copy's ``pd.DataFrame(rows).to_csv(path,
    index=False)`` writes them: the columns in the order they first appear,
    one line a row, a missing field empty."""
    import csv as csv_mod

    columns: List[str] = []
    for row in rows:
        columns += [k for k in row if k not in columns]
    with open(path, "w", newline="") as f:
        writer = csv_mod.writer(f, lineterminator="\n")
        writer.writerow(columns)
        for row in rows:
            writer.writerow([_csv_field(row.get(k)) for k in columns])


# ---------------------------------------------------------------------------
# 3. Spotify fetch (injectable network boundary)
# ---------------------------------------------------------------------------


class SpotifyUnavailable(RuntimeError):
    pass


def make_spotipy_client(client_id: str, client_secret: str):
    """Real client, when spotipy + network exist (utils.py:17-20)."""
    try:
        import spotipy
        from spotipy.oauth2 import SpotifyClientCredentials
    except ImportError as e:
        raise SpotifyUnavailable(
            "spotipy is not installed in this environment; pass a prefetched "
            "features CSV (--spotify_csv) or inject a client"
        ) from e
    return spotipy.Spotify(
        client_credentials_manager=SpotifyClientCredentials(
            client_id=client_id, client_secret=client_secret
        )
    )


def fetch_spotify_features(
    trackid_to_songid: Dict[str, dict],
    songid_to_spotify: Dict[str, List[str]],
    client,
    incomplete_csv_path: str,
) -> Dict[str, dict]:
    """Stage-3 fetch loop with resumable incomplete CSV (run.py:114-205).
    ``client`` provides .tracks/.audio_features/.search (spotipy surface);
    tests inject a fake."""
    import csv as csv_mod

    fieldnames = [
        "track_id", "song_id", "title", "artist", "release", "spotify_id",
        "spotify_title", "spotify_artist", "spotify_album",
        "spotify_audio_features",
    ]
    processed = set()
    if os.path.exists(incomplete_csv_path):
        with open(incomplete_csv_path) as f:
            for row in csv_mod.DictReader(f):
                processed.add(row["track_id"])
    write_header = not processed

    def try_multiple(fn, *a, **kw):  # utils.py:81-100
        for _ in range(30):
            try:
                return fn(*a, **kw)
            except Exception as e:
                if e.args and e.args[0] == 404:
                    return None
        return None

    with open(incomplete_csv_path, "a") as f_out:
        writer = csv_mod.DictWriter(f_out, fieldnames=fieldnames)
        if write_header:
            writer.writeheader()
        for track_id, data in trackid_to_songid.items():
            if track_id in processed:
                continue
            data = dict(data)
            data["track_id"] = track_id
            ids = songid_to_spotify.get(data["song_id"], [])
            best = None
            if ids:
                res = try_multiple(client.tracks, ids[:50])
                tracks = res["tracks"] if res else None
                if tracks is None:
                    best = None
                elif len(tracks) > 1:
                    best = pick_best_by_album(tracks, data["release"])
                else:
                    best = tracks[0]
            if best is not None:
                spotify_id = best["uri"].split(":")[-1]
                feats = try_multiple(client.audio_features, [spotify_id])
                data["spotify_id"] = spotify_id
                data["spotify_title"] = best["name"]
                data["spotify_artist"] = ", ".join(
                    a["name"] for a in best["artists"]
                )
                data["spotify_album"] = best["album"]["name"]
                data["spotify_audio_features"] = feats[0] if feats else None
            else:
                for key in ("id", "title", "artist", "album", "audio_features"):
                    data["spotify_" + key] = None
            writer.writerow(data)

    out: Dict[str, dict] = {}
    with open(incomplete_csv_path) as f:
        for row in csv_mod.DictReader(f):
            saf = row["spotify_audio_features"]
            row["spotify_audio_features"] = (
                json.loads(saf.replace("'", '"').replace("None", "null"))
                if saf not in ("", "None")
                else None
            )
            tid = row.pop("track_id")
            out[tid] = row
    return out
