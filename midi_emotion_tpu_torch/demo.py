"""One-command end-to-end demo over a synthetic corpus.

    python -m midi_emotion_tpu_torch.demo [--out DIR] [--steps N] [--device cuda|cpu]

Counterpart of ``midi_emotion_tpu/demo.py``, through the port's modules
and CLIs on the card (``--device cpu`` for the CPU): fabricate a
pianoroll corpus -> tokenize it into training shards (data/preprocess) ->
compute per-song features and emotion labels -> train a small conditional
model (cli/train_cli) -> generate emotion-conditioned MIDI from the
checkpoint (cli/generate_cli) -> train a small emotion-regression model ->
regression-evaluate the generated songs (the reference's
train.py --regression_dir flow). No downloads.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time

import numpy as np


def _say(msg: str) -> None:
    print(f"\n=== {msg} ===", flush=True)


def fabricate_corpus(corpus_dir: str, n_songs: int, seed: int = 0) -> None:
    from .data import midi_io

    os.makedirs(corpus_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    names = ["PIANO", "GUITAR", "BASS", "STRINGS"]
    for i in range(n_songs):
        rolls = {}
        for name in names:
            roll = np.zeros((96 * 16, 128), np.uint8)
            for _ in range(180):
                t = rng.randint(0, roll.shape[0] - 12)
                pitch = rng.randint(30, 100)
                roll[t : t + rng.randint(4, 12), pitch] = rng.randint(40, 120)
            rolls[name] = roll
        midi_io.save_pianoroll_npz(
            os.path.join(corpus_dir, f"song{i:03d}.npz"), rolls
        )


def fabricate_features(corpus_dir: str, csv_path: str, seed: int = 0) -> None:
    """Real audio-side features are MSD/Spotify joins (data/dataset_builder);
    the demo computes the MIDI-side features for real and draws valence."""
    from .data import dataset_builder as db

    rng = np.random.RandomState(seed + 1)
    rows = ["file,valence,note_density_per_instrument,n_instruments,is_matched"]
    for p in sorted(glob.glob(os.path.join(corpus_dir, "*.npz"))):
        f = db.midi_features_from_pianoroll(p)
        name = os.path.splitext(os.path.basename(p))[0]
        nd = f["note_density"] / max(1, f["n_instruments"])
        rows.append(
            f"{name},{rng.uniform(-0.9, 0.9):.4f},{nd:.4f},"
            f"{f['n_instruments']},True"
        )
    with open(csv_path, "w") as fh:
        fh.write("\n".join(rows) + "\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="demo_output")
    ap.add_argument("--n_songs", type=int, default=24)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--gen_len", type=int, default=160)
    ap.add_argument("--n_workers", type=int, default=2,
                    help="tokenizer processes (1: in this process)")
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cpu)")
    args = ap.parse_args(argv)

    t0 = time.time()
    out = os.path.abspath(args.out)
    corpus = os.path.join(out, "pianorolls")
    shards = os.path.join(out, "shards")
    csv_path = os.path.join(out, "features.csv")
    os.makedirs(out, exist_ok=True)
    device = ["--device", args.device]

    _say(f"1/6 fabricating {args.n_songs}-song pianoroll corpus")
    fabricate_corpus(corpus, args.n_songs)

    _say("2/6 tokenizing corpus into training shards")
    from .data.preprocess import main as preprocess_main

    preprocess_main(
        ["--input_dir", corpus, "--out_dir", shards, "--n_workers", str(args.n_workers)]
    )

    _say("3/6 computing per-song features")
    fabricate_features(corpus, csv_path)

    model_flags = [
        "--n_layer", "2", "--n_head", "4", "--d_model", "64",
        "--d_inner", "128", "--d_condition", "16", "--tgt_len", "128",
        "--batch_size", "4", "--dtype", "f32",
    ]
    common = [
        "--data_folder", shards, "--feature_file", csv_path,
        "--lr", "1e-3", "--log_step", "20",
        "--eval_step", str(args.steps), "--max_eval_step", "4",
        "--gen_step", "1000000000", "--num_workers", "0", "--seed", "1",
    ] + device

    _say(f"4/6 training a conditional model for {args.steps} steps")
    from .cli.train_cli import main as train_main

    train_main(
        ["--conditioning", "continuous_concat", "--max_step", str(args.steps),
         "--work_dir", os.path.join(out, "train")] + model_flags + common
    )
    model_dir = sorted(glob.glob(os.path.join(out, "train", "*")))[-1]

    _say("5/6 generating emotion-conditioned MIDI from the checkpoint")
    from .cli.generate_cli import main as generate_main

    generate_main(
        ["--model_dir", model_dir, "--conditioning", "continuous_concat",
         "--valence", "0.8", "-0.8", "--arousal", "0.8", "-0.8",
         "--gen_len", str(args.gen_len), "--max_input_len", "128",
         "--min_n_instruments", "1", "--dtype", "f32", "--seed", "3"] + device
    )
    gen_dir = os.path.join(model_dir, "generations", "inference")
    mids = glob.glob(os.path.join(gen_dir, "*.mid"))
    assert mids, f"no MIDI produced in {gen_dir}"

    _say("6/6 regression model + emotion evaluation of the generations")
    train_main(
        ["--conditioning", "none", "--regression",
         "--max_step", str(args.steps),
         "--work_dir", os.path.join(out, "regression")] + model_flags + common
    )
    reg_dir = sorted(glob.glob(os.path.join(out, "regression", "*")))[-1]
    train_main(
        ["--conditioning", "none", "--regression_dir", gen_dir,
         "--restart_dir", os.path.basename(reg_dir), "--max_eval_step", "-1",
         "--work_dir", os.path.join(out, "regression"),
         "--batch_size", "4", "--tgt_len", "128", "--dtype", "f32",
         "--num_workers", "0",
         "--data_folder", shards, "--feature_file", csv_path] + device
    )

    _say(
        f"demo complete in {time.time() - t0:.0f}s -- "
        f"{len(mids)} MIDI file(s) in {gen_dir}"
    )
    summary = {
        "seconds": round(time.time() - t0, 1),
        "midi_files": sorted(os.path.basename(m) for m in mids),
        "model_dir": model_dir,
        "regression_dir": reg_dir,
    }
    with open(os.path.join(out, "demo_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
