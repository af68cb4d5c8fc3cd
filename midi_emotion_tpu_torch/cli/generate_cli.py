"""Generation CLI of the torch port.

Flag-compatible with ``midi_emotion_tpu/cli/generate_cli.py`` (and so with
the reference's generate.py), plus ``--device``:

    python -m midi_emotion_tpu_torch.cli.generate_cli --model_dir <dir> \
        --conditioning continuous_concat --valence 0.8 --arousal 0.8

``--model_dir`` is a reference work dir (model_config.pt, model.pt,
mappings.pt); relative dirs that do not exist resolve against
``--output_dir``. Files go to ``<model_dir>/generations/inference``.
``--attn_impl auto`` runs the flash kernel on a CUDA device and the plain
closed form on the CPU; the stacked KV caches (``--kv_dtype int8|bf16``)
are not ported yet.
"""

from __future__ import annotations

import argparse
import copy
import os

import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Generate emotion-conditioned MIDI (torch)")
    p.add_argument("--model_dir", type=str, required=True)
    p.add_argument("--output_dir", type=str, default="output")
    p.add_argument("--num_runs", type=int, default=1)
    p.add_argument("--gen_len", type=int, default=4096)
    p.add_argument("--max_input_len", type=int, default=1216)
    p.add_argument("--temp", type=float, nargs="+", default=[1.2, 1.2])
    p.add_argument("--topk", type=int, default=-1)
    p.add_argument("--topp", type=float, default=0.7)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--conditioning",
        type=str,
        required=True,
        choices=["none", "discrete_token", "continuous_token", "continuous_concat"],
    )
    p.add_argument("--penalty_coeff", type=float, default=0.5)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--short_filename", action="store_true")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--min_n_instruments", type=int, default=1)
    p.add_argument("--valence", type=float, default=[None], nargs="+")
    p.add_argument("--arousal", type=float, default=[None], nargs="+")
    p.add_argument("--batch_gen_dir", type=str, default="")
    p.add_argument("--n_emotion_bins", type=int, default=5)
    p.add_argument(
        "--slide_hop", type=int, default=None,
        help="KV-cache refresh hop for generations longer than the window "
        "(1 = reference-exact per-token slide; default window//8)",
    )
    p.add_argument("--dtype", type=str, default="bf16", choices=["bf16", "f32"])
    p.add_argument("--no_amp", action="store_true", help="alias for --dtype f32")
    p.add_argument(
        "--attn_impl", type=str, default="auto", choices=["auto", "kernel", "plain"],
        help="prefill attention: 'auto' = the flash kernel on CUDA, the plain "
        "closed form on CPU",
    )
    p.add_argument(
        "--kv_dtype", type=str, default="native", choices=["native"],
        help="decode KV cache: only the native per-layer cache is ported",
    )
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cuda, cuda:1, cpu)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.no_amp:
        args.dtype = "f32"
    if len(args.valence) != len(args.arousal):
        raise SystemExit("Lengths of valence and arousal must be equal")
    if (args.conditioning == "none") != (args.valence == [None] or args.arousal == [None]):
        raise SystemExit("If conditioning is used, specify valence and arousal; if not, don't")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: CUDA is not available")

    from ..convert import load_model_dir
    from ..generation.generate import continuous_to_discrete_symbols, generate

    model_dir = args.model_dir
    if not os.path.isdir(model_dir):
        model_dir = os.path.join(args.output_dir, args.model_dir)
    if not os.path.isdir(model_dir):
        raise SystemExit(f"model dir not found: {args.model_dir}")

    out_dir = os.path.join(model_dir, "generations", "inference")
    if args.batch_gen_dir:
        out_dir = os.path.join(out_dir, "_" + args.batch_gen_dir)

    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    _, model, vocab = load_model_dir(model_dir, dtype=dtype, device=device,
                                     attn_impl=args.attn_impl)

    conditions = None
    if args.valence != [None]:
        if len(args.valence) == 1:
            conditions = [[args.valence[0], args.arousal[0]]] * args.batch_size
        else:
            conditions = [[v, a] for v, a in zip(args.valence, args.arousal)]

    primers = [["<START>"]]
    discrete_conditions = None
    continuous_conditions = conditions
    if args.conditioning == "discrete_token":
        discrete_conditions = continuous_to_discrete_symbols(conditions, args.n_emotion_bins)
        continuous_conditions = None
    elif args.conditioning == "none":
        primers = [["<START>"] for _ in range(args.batch_size)]

    for _ in range(args.num_runs):
        primers_run = copy.deepcopy(primers)
        discrete_run = copy.deepcopy(discrete_conditions)
        continuous_run = copy.deepcopy(continuous_conditions)
        while not (primers_run == [] or discrete_run == [] or continuous_run == []):
            primers_run, discrete_run, continuous_run = generate(
                model,
                vocab,
                out_dir,
                args.conditioning,
                discrete_conditions=discrete_run,
                continuous_conditions=continuous_run,
                penalty_coeff=args.penalty_coeff,
                max_input_len=args.max_input_len,
                gen_len=args.gen_len,
                temperatures=args.temp,
                top_k=args.topk,
                top_p=args.topp,
                min_n_instruments=args.min_n_instruments,
                primers=primers_run,
                seed=args.seed,
                short_filename=args.short_filename,
                debug=args.debug,
                verbose=not args.quiet,
                slide_hop=args.slide_hop,
                kv_dtype=args.kv_dtype,
            )


if __name__ == "__main__":
    main()
