"""Offline pianoroll -> token-shard preprocessing.

The batch job over the LPD corpus (reference
``src/data/preprocess_pianorolls.py``): maps every pianoroll through the
tokenizer with a process pool and writes one shard per song plus the global
vocabulary. Differences from the reference: shards are framework-neutral
``.npz`` (see loader.save_song_shard) instead of torch ``.pt``, the vocab is
``vocab.json`` instead of ``maps.pt``, and the tokenizer core is the
vectorized numpy codec (optionally the C++ extension, ops/native).

A copy of ``midi_emotion_tpu/data/preprocess.py``, unchanged but for
this note and a word of the summary above. Its relative imports reach the
port's own ``vocab``, ``codec``, ``midi_io`` and
``loader.save_song_shard``: the torch port keeps its own copies and
imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Optional, Tuple

from ..vocab import DEFAULT_VOCAB
from . import codec, midi_io
from .loader import save_song_shard


def process_song(task: Tuple[str, str, str]) -> Optional[str]:
    """(input path, file id, out dir) -> shard path or None on failure.

    Mirrors preprocess_pianorolls.process (:27-40): read pianoroll ->
    bars; drop songs that fail or produce no bars.
    """
    path, file_id, out_dir = task
    try:
        if path.endswith(".npz"):
            pr = midi_io.load_pianoroll_npz(path)
            notes = [n for t in pr.tracks for n in t.notes]
            downbeats = pr.downbeat_times()
        else:  # .mid
            tracks = midi_io.read_midi(path)
            for t in tracks:
                for n in t.notes:
                    n.instrument = t.name.upper() or "PIANO"
            notes = [n for t in tracks for n in t.notes]
            if not notes:
                return None
            end = max(n.end for n in notes)
            import numpy as np

            downbeats = np.arange(0.0, end + 2.0, 2.0)
        bars = codec.notes_to_bars(notes, downbeats)
    except Exception:
        return None
    if not bars:
        return None
    out_path = os.path.join(out_dir, file_id + ".npz")
    save_song_shard(out_path, file_id, bars)
    return out_path


def main(argv=None):
    ap = argparse.ArgumentParser(description="Tokenize a pianoroll corpus")
    ap.add_argument("--input_dir", required=True,
                    help="directory of pypianoroll .npz (or .mid) files")
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--unique_files", default=None,
                    help="optional JSON list of {path|file} entries "
                    "(preprocess_pianorolls.py:53-56)")
    ap.add_argument("--n_workers", type=int, default=16)
    args = ap.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)

    if args.unique_files:
        with open(args.unique_files) as f:
            entries = json.load(f)
        paths = []
        for e in entries:
            p = e["path"] if isinstance(e, dict) else e
            paths.append(p if os.path.isabs(p) else os.path.join(args.input_dir, p))
    else:
        paths = sorted(
            os.path.join(args.input_dir, f)
            for f in os.listdir(args.input_dir)
            if f.endswith((".npz", ".mid"))
        )

    tasks = [
        (p, os.path.splitext(os.path.basename(p))[0], args.out_dir) for p in paths
    ]
    if args.n_workers > 1:
        with ProcessPoolExecutor(max_workers=args.n_workers) as ex:
            results = list(ex.map(process_song, tasks))
    else:
        results = [process_song(t) for t in tasks]

    ok = sum(1 for r in results if r)
    print(f"tokenized {ok}/{len(tasks)} songs -> {args.out_dir}")

    with open(os.path.join(os.path.dirname(args.out_dir.rstrip("/")) or ".",
                           "vocab.json"), "w") as f:
        json.dump(DEFAULT_VOCAB.to_dict(), f)


if __name__ == "__main__":
    main()
