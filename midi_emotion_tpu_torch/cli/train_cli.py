"""Training CLI of the torch port.

The flags and post-parse derivations of ``midi_emotion_tpu/cli/
train_cli.py`` (and so of the reference's ``config.py:5-156``), plus
``--device`` (default ``cuda``):

    python -m midi_emotion_tpu_torch.cli.train_cli --data_folder <shards> \
        --feature_file <csv> --work_dir <dir> --device cuda

``--attn_impl`` takes ``auto`` (the flash kernels on a CUDA device, the
plain closed form on the CPU), ``kernel`` or ``plain``; ``ring`` and the
``--mesh_*`` and ``--remat dots|full`` flags are parsed and raise
NotImplementedError in the Runner until their ROADMAP items land.
"""

from __future__ import annotations

import argparse
import os
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Generates emotion-based symbolic music")
    p.add_argument(
        "--conditioning", type=str, default="continuous_concat",
        choices=["none", "discrete_token", "continuous_token", "continuous_concat"],
    )
    p.add_argument("--data_folder", type=str, default="data_files/lpd_5/lpd_5_full_transposable")
    p.add_argument("--feature_file", type=str,
                   default="data_files/features/pianoroll/full_dataset_features_summarized.csv")
    p.add_argument("--full_dataset", action="store_true")
    p.add_argument("--n_layer", type=int, default=20)
    p.add_argument("--n_head", type=int, default=16)
    p.add_argument("--d_model", type=int, default=768)
    p.add_argument("--d_condition", type=int, default=192)
    p.add_argument("--d_inner", type=int, default=768 * 4)
    p.add_argument("--tgt_len", type=int, default=1216)
    p.add_argument("--max_gen_input_len", type=int, default=-1)
    p.add_argument("--gen_len", type=int, default=2048)
    p.add_argument("--temp_note", type=float, default=1.2)
    p.add_argument("--temp_rest", type=float, default=1.2)
    p.add_argument("--n_bars", type=int, default=-1)
    p.add_argument("--no_pad", action="store_true")
    p.add_argument("--eval_tgt_len", type=int, default=-1)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--overwrite_dropout", action="store_true")
    p.add_argument("--lr", type=float, default=2e-5)
    p.add_argument("--overwrite_lr", action="store_true")
    p.add_argument("--arousal_feature", default="note_density", type=str,
                   choices=["tempo", "note_density"])
    p.add_argument("--scheduler", default="constant", type=str,
                   choices=["cosine", "inv_sqrt", "dev_perf", "constant", "cyclic"])
    p.add_argument("--lr_min", type=float, default=5e-6)
    p.add_argument("--lr_max", type=float, default=5e-3)
    p.add_argument("--warmup_step", type=int, default=0)
    p.add_argument("--decay_rate", type=float, default=0.5)
    p.add_argument("--patience", type=int, default=10)
    p.add_argument("--clip", type=float, default=1.0)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--accumulate_step", type=int, default=1)
    p.add_argument("--seed", type=int, default=-1)
    p.add_argument("--log_step", type=int, default=1000)
    p.add_argument("--eval_step", type=int, default=8000)
    p.add_argument("--max_eval_step", type=int, default=1000)
    p.add_argument("--gen_step", type=int, default=8000)
    p.add_argument("--work_dir", default="output", type=str)
    p.add_argument("--restart_dir", type=str, default=None)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--max_step", type=int, default=1000000000)
    p.add_argument("--overfit", action="store_true")
    p.add_argument("--find_lr", action="store_true")
    p.add_argument("--num_workers", default=8, type=int)
    p.add_argument("--bar_start_prob", type=float, default=0.5)
    p.add_argument("--n_samples", type=int, default=-1)
    p.add_argument("--n_emotion_bins", type=int, default=5)
    p.add_argument("--max_transpose", type=int, default=3)
    p.add_argument("--reset_scaler", action="store_true")  # no-op (bf16 needs no scaler)
    p.add_argument("--no_amp", action="store_true")  # maps to --dtype f32
    p.add_argument("--exhaustive_eval", action="store_true")
    p.add_argument("--regression", action="store_true")
    p.add_argument("--always_use_discrete_condition", action="store_true")
    p.add_argument("--regression_dir", type=str, default=None)
    # the JAX package's extras; a mesh is not ported yet (see the Runner)
    p.add_argument("--mesh_data", type=int, default=None,
                   help="data-parallel mesh size (only 1 is ported)")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="tensor-parallel mesh size")
    p.add_argument("--mesh_seq", type=int, default=1,
                   help="sequence-parallel mesh size (ring attention; "
                        "use with --attn_impl ring for T beyond one chip)")
    p.add_argument("--dtype", type=str, default="bf16", choices=["bf16", "f32"])
    p.add_argument("--attn_impl", type=str, default="auto",
                   choices=["auto", "kernel", "plain", "ring"],
                   help="'auto' = the flash kernels on CUDA, the plain closed form "
                        "on CPU; 'ring' is not ported yet")
    # the reference hard-codes 2048 (build_model.py:22); here the E and
    # positional tables are sized by this flag
    p.add_argument("--max_seq", type=int, default=2048)
    # activation recomputation: not ported; the flash kernels keep the
    # attention O(T) in memory, so "auto" = "none" trains the flagship
    p.add_argument("--remat", type=str, default="auto",
                   choices=["auto", "none", "dots", "full"])
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of training steps here")
    p.add_argument("--profile_start", type=int, default=5)
    p.add_argument("--profile_steps", type=int, default=5)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (cuda, cuda:1, cpu)")
    return p


def postprocess_args(args) -> argparse.Namespace:
    """config.py:117-156 derivations."""
    if args.regression_dir is not None:
        args.regression = True
    if args.conditioning != "continuous_concat":
        args.d_condition = -1
    assert not (args.exhaustive_eval and args.max_eval_step > 0), (
        "exhaustive eval iterates the whole test set; unset --max_eval_step"
    )
    if args.full_dataset:
        assert args.conditioning in ("discrete_token", "none") and not args.regression, \
            "LPD-full has NaN features"
    if args.regression:
        args.n_layer = 8
        print("Using 8 layers for regression")
    if args.find_lr:
        args.debug = True
    if args.eval_tgt_len < 0:
        args.eval_tgt_len = args.tgt_len
    if args.scheduler == "cyclic":
        args.lr = args.lr_min
    if args.no_amp:
        args.dtype = "f32"
    if args.restart_dir:
        args.restart_dir = os.path.join(args.work_dir, args.restart_dir)
    if args.debug:
        args.work_dir = os.path.join(args.work_dir, "DEBUG_" + time.strftime("%Y%m%d-%H%M%S"))
    else:
        args.work_dir = os.path.join(args.work_dir, time.strftime("%Y%m%d-%H%M%S"))
    return args


def parse_args(argv=None):
    args = build_parser().parse_args(argv)
    return postprocess_args(args)


def main(argv=None):
    args = parse_args(argv)
    import numpy as np

    if args.seed > 0:
        np.random.seed(args.seed)

    from ..training.train import Runner

    runner = Runner(args)
    runner.run()
    return runner


if __name__ == "__main__":
    main()
