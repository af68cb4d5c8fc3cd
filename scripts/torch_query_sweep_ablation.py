#!/usr/bin/env python3
"""What the register budget of kernels 6 and 8's Hopper form costs, on one card.

    python3 scripts/torch_query_sweep_ablation.py      # from the repository root

Kernels 6 and 8 in bf16 (``wg::flash_bwd_q_wg_tc_kernel`` in
``midi_emotion_tpu_torch/csrc/flash_rel_attn_bwd_q.cu``) run two blocks an
SM up to d_head 48, which caps a thread at 128 registers. There phase A's
band product runs in two m64n48 halves (``HALF_BAND``), so S, dP and half
the band (56 accumulators) sit beside dQ or the dE carry; from 64 on, one
block an SM, it runs whole. Two blocks share a (b, h), each with its own
f32 dE partial (60 MB at B 8, H 16). This script builds variants of that
source (``torch_wide_fwd_ablation.build_variants``), each the source with
some of its ``BWD_Q_*`` switches defined ahead of it, and prints their
registers and spills:

  * ``as_built``: no switch: two blocks an SM to d_head 48 with the band
    in halves, one an SM with the band whole from 64;
  * ``whole_band``: the band in one m64n96 product (80 accumulators) at
    every d_head;
  * ``half_band``: the band in halves at every d_head;
  * ``one_block``: one block an SM (255 registers), the band whole, two
    query-tile slots;
  * ``split1``: one block a (b, h) (30 MB of partials, inside the 50 MB
    L2; 128 blocks at B 8, H 16, one an SM);
  * ``split1_one_block``: ``split1`` built for one block an SM, as
    ``one_block``;
  * ``no_partial_reads``: ``as_built`` without reading back the dE
    partial's rows (each pair's rows written over the last: wrong dE);
  * ``no_partial_rmw``: without reading or writing them (wrong dE);

then holds each right variant to the twins (``chip_smoke.check_bwd_kernel``,
bf16, 2e-2 of each output's scale, T 200 with a pad tail and a fully
masked row, at d_head 16, 32 and 48, and 64, 96 and 128 for the band's
three forms, causal and not), prints the wrong ones' worst dE error over
its scale, and times kernels 6 (``bwd_dq_de_dist``) and 8
(``bwd_de_dqrel``), each wrapper's whole call, at B 8, H 16, T 1216,
bf16, causal, a pad tail, at d_head 48 and 32, and 64, 96 and 128 for the
band's three forms. Times are CUPTI device ms (``chip_smoke.device_ms``),
two rounds over the variants. Prints one JSON object, with the card's
name and power limit. Writes nothing outside ``build/ablation/``.
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from torch_wide_fwd_ablation import build_variants, card_name, use_variant  # noqa: E402

KERNELS = ("flash_rel_attn_bwd_dq_de_dist", "flash_rel_attn_bwd_de_dqrel")
# name -> the switches defined ahead of the source
VARIANTS = {
    "as_built": {},
    "whole_band": {"BWD_Q_HALF_BAND": 0},
    "half_band": {"BWD_Q_HALF_BAND": 1},
    "one_block": {"BWD_Q_ONE_BLOCK": 1},
    "split1": {"BWD_Q_SPLIT": 1},
    "split1_one_block": {"BWD_Q_SPLIT": 1, "BWD_Q_ONE_BLOCK": 1},
    "no_partial_reads": {"BWD_Q_DE_PARTIAL": 1},
    "no_partial_rmw": {"BWD_Q_DE_PARTIAL": 0},
}
BAND_FORMS = ("as_built", "whole_band", "half_band")  # also checked and timed from 64 on


def variants(text):
    for switch in {k for v in VARIANTS.values() for k in v}:
        if f"#ifndef {switch}\n" not in text:
            sys.exit(f"torch_query_sweep_ablation: the source no longer has the switch {switch}")
    return {name: "".join(f"#define {k} {v}\n" for k, v in defs.items()) + text
            for name, defs in VARIANTS.items()}


def dhs(name, narrow):
    return narrow + ((64, 96, 128) if name in BAND_FORMS else ())


def main():
    import torch

    import chip_smoke as cs
    from midi_emotion_tpu_torch.kernels import build
    from midi_emotion_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        sys.exit("torch_query_sweep_ablation: needs a CUDA card")
    card = card_name()
    print(card, flush=True)
    src_dir = build.CSRC_DIR
    build.build_all(("flash_rel_attn_fwd",))  # lse for the backward's inputs
    dirs = build_variants(variants((src_dir / "flash_rel_attn_bwd_q.cu").read_text()),
                          "flash_bwd_q_wg_tc_kernel", source="flash_rel_attn_bwd_q")
    bf16 = torch.bfloat16
    out = {"card": card}
    for name, d in dirs.items():
        use_variant(d)
        for kernel in KERNELS:
            if name.startswith("no_"):  # wrong dE by design: its error, for the record
                wrapper = getattr(fa, cs.BWD_KERNELS[kernel][0])
                args = cs._bwd_args(torch, 2, 4, 200, 48, bf16, True)
                got, want = wrapper(*args)[1], getattr(fa, wrapper.__name__ + "_plain")(*args)[1]
                err, scale = cs._rel_err(got, want)
                print(f"{name} {kernel}: max|dE err| {err:.3e} over its scale {scale:.3e}")
                continue
            for dh in dhs(name, (16, 32, 48)):
                for causal in (True, False):
                    cs.check_bwd_kernel(torch, kernel, 2, 4, 200, dh, bf16, causal, 2e-2)
    for rnd in range(2):
        for name, d in dirs.items():
            use_variant(d)
            for kernel in KERNELS:
                wrapper = getattr(fa, cs.BWD_KERNELS[kernel][0])
                for dh in dhs(name, (48, 32)):
                    args = cs._bwd_args(torch, cs.TRAIN_B, 16, cs.TRAIN_T, dh, bf16, True)
                    ms = cs.device_ms(torch, lambda: wrapper(*args), per_call=2)
                    out.setdefault(f"{name}_{kernel}_dh{dh}", []).append(ms)
                    print(f"round {rnd} {name} {kernel} dh {dh}: {ms:.4f} ms", flush=True)
                    del args
            torch.cuda.empty_cache()
    use_variant(src_dir)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
