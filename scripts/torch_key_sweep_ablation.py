#!/usr/bin/env python3
"""What the choices of kernel 7's Hopper form cost, on one card.

    python3 scripts/torch_key_sweep_ablation.py      # from the repository root

Kernel 7 in bf16 (``wg::flash_bwd_kv_wg_tc_kernel`` in
``midi_emotion_tpu_torch/csrc/flash_rel_attn_bwd_kv.cu``, the key-major
sweep of ``MIDI_EMOTION_BWD=split``) is kernel 4's design without its
distance half. Its phase B has three products, dV += P^T dO, dK += dS'^T Q
and dQ += dS' K, on two warpgroups; a block sweeps groups of G key tiles
(two up to d_head 48), a query tile's dQ in registers while it meets the
group; one or two blocks a (b, h). This script builds variants of that
source (``torch_wide_fwd_ablation.build_variants``), each the source with
some of its ``BWD_KV_*`` switches defined ahead of it, and prints their
registers, spills and whether ptxas serialized their wgmma:

  * ``as_built``: no switch: dQ on warpgroup 0 (beside dV), G = 2 up to
    d_head 48, the dQ partial rows read under phase B's products up to
    d_head 48 and after them past it;
  * ``ahead0``: the partial rows read after the products at every d_head;
  * ``ahead64``: read under the products up to d_head 64;
  * ``dq_wg1``: dQ on warpgroup 1 (beside dK);
  * ``g1``: groups of one key tile at every d_head (each dQ partial row
    read and written once a key tile);

then holds each variant to the twin as ``chip_smoke.check_bwd_kernel``
does (bf16, 2e-2 of each output's scale, T 200 with a pad tail and a fully
masked row, at d_head 16, 32, 48, 64 and 96, causal and not) on one and two
blocks a (b, h), and times kernel 7 (``bwd_dkdv_dq``, the wrapper's whole
call: the kernel and its dQ reduction) in bf16, causal, a pad tail, T 1216,
on one block a (b, h) (``split1``) and two (``split2``): at B 8, H 16 (the
flagship, where ``bwd_split`` takes one) and B 8, H 3 (24 blocks a split,
where it takes two), at the d_head ``TIMED`` names for each variant. Times are CUPTI device ms
(``chip_smoke.device_ms``), two rounds over the variants. Prints one JSON
object, with the card's name and power limit. Writes nothing outside
``build/ablation/``.
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from torch_wide_fwd_ablation import build_variants, card_name, use_variant  # noqa: E402

# name -> the switches defined ahead of the source
VARIANTS = {
    "as_built": {},
    "ahead0": {"BWD_KV_AHEAD": 0},
    "ahead64": {"BWD_KV_AHEAD": 64},
    "dq_wg1": {"BWD_KV_DQ_WG": 1},
    "g1": {"BWD_KV_G": 1},
}
# H of the timed calls at B 8: the flagship's 16, and 3 (B * H 24)
SHAPES = (16, 3)
# the d_head each variant is timed at, at H 16 and at H 3
TIMED = {"as_built": ((48, 32, 64, 96), (48, 32)), "ahead0": ((48, 32), (48, 32)),
         "ahead64": ((64,), ()), "dq_wg1": ((48, 32), (48, 32)), "g1": ((48, 32), (48, 32))}


def check(torch, cs, fa, split, dh, causal):
    """Kernel 7 on ``split`` blocks a (b, h) against its twin, as
    ``chip_smoke.check_bwd_kernel`` holds it: 2e-2 of each output's scale,
    a zero dQ on the fully masked row."""
    args = cs._bwd_args(torch, 2, 4, 200, dh, torch.bfloat16, causal)
    got = fa.bwd_dkdv_dq(*args, split=split)
    for grad, a, b in zip(("dK", "dV", "dQ_qk"), got, fa.bwd_dkdv_dq_plain(*args)):
        err, scale = cs._rel_err(a, b)
        if not (torch.isfinite(a).all() and err <= 2e-2 * (1 + scale)):
            sys.exit(f"torch_key_sweep_ablation: split {split} dh {dh} causal {causal}: "
                     f"{grad} off its twin by {err:.3e}")
    if causal and not got[2][1, :, 0].eq(0).all():
        sys.exit("torch_key_sweep_ablation: the fully masked row has a nonzero dQ")


def variants(text):
    for switch in {k for v in VARIANTS.values() for k in v}:
        if f"#ifndef {switch}\n" not in text:
            sys.exit(f"torch_key_sweep_ablation: the source no longer has the switch {switch}")
    return {name: "".join(f"#define {k} {v}\n" for k, v in defs.items()) + text
            for name, defs in VARIANTS.items()}


def main():
    import torch

    import chip_smoke as cs
    from midi_emotion_tpu_torch.kernels import build
    from midi_emotion_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        sys.exit("torch_key_sweep_ablation: needs a CUDA card")
    card = card_name()
    print(card, flush=True)
    src_dir = build.CSRC_DIR
    build.build_all(("flash_rel_attn_fwd",))  # lse for the backward's inputs
    dirs = build_variants(variants((src_dir / "flash_rel_attn_bwd_kv.cu").read_text()),
                          "flash_bwd_kv_wg_tc_kernel", source="flash_rel_attn_bwd_kv")
    bf16 = torch.bfloat16
    out = {"card": card}
    for name, d in dirs.items():
        use_variant(d)
        forms = cs.ptxas_forms(build.library_path("flash_rel_attn_bwd_kv"), "flash_bwd_kv_wg")
        out[f"{name}_ptxas"] = forms
        for label, form in forms.items():
            print(f"{name}: {label}: {form}")
        for split in (1, 2):
            for dh in (16, 32, 48, 64, 96):
                for causal in (True, False):
                    check(torch, cs, fa, split, dh, causal)
        print(f"{name}: kernel 7 matches its twin on one and two blocks a (b, h)")
    for rnd in range(2):
        for name, d in dirs.items():
            use_variant(d)
            for H, dhs in zip(SHAPES, TIMED[name]):
                for dh in dhs:
                    args = cs._bwd_args(torch, cs.TRAIN_B, H, cs.TRAIN_T, dh, bf16, True)
                    for split in (1, 2):
                        ms = cs.device_ms(torch, lambda: fa.bwd_dkdv_dq(*args, split=split),
                                          per_call=2)
                        out.setdefault(f"{name}_H{H}_split{split}_dh{dh}", []).append(ms)
                        print(f"round {rnd} {name} B {cs.TRAIN_B} H {H} split {split} dh {dh}: "
                              f"{ms:.4f} ms", flush=True)
                    del args
            torch.cuda.empty_cache()
    use_variant(src_dir)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
