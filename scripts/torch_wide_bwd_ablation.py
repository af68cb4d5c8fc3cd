#!/usr/bin/env python3
"""What the parts of kernel 4's wide cluster backward cost, on one card.

    python3 scripts/torch_wide_bwd_ablation.py      # from the repository root

Kernel 4's bf16 backward past d_head 256 (``cl::wide_bwd_tc_cluster_kernel``
in ``midi_emotion_tpu_torch/csrc/flash_rel_attn_wide.cu``) runs one
thread-block cluster per (b, h) and split of its key tiles, a CTA per 128
columns; per tile pair the CTAs sum their partial S and dP through
distributed shared memory, and each adds its dQ and dE columns to its
split's f32 partials in device memory. This script builds variants of that
source (``torch_wide_fwd_ablation.build_variants``) and times kernel 4's
whole call (``flash_rel_attention_bwd``: dsum, the cluster kernel, the two
reductions) at the flagship's width (B 8, T 1216, bf16, causal, a pad tail)
with 2 heads of 384 and 1 of 768:

  * ``as_built``: the source as it is (all-pull below ``SCATTER_PARTS``
    parts, reduce-scatter and all-gather from there on);
  * ``all_pull``: every rank reads every rank's partials;
  * ``scatter``: the reduce-scatter and all-gather at every width;
  * ``no_remote_reads``: ``all_pull`` with every read from the CTA's own
    partials (wrong gradients; the signals and waits kept);
  * ``no_exchange``: neither signals nor remote reads;
  * ``no_partial_reads``: ``as_built`` without reading back the dQ and dE
    partial rows (each pair's rows written over the last: wrong gradients).

The wrong variants' worst error over the twin's gradient scale is printed
beside their time. Times are CUPTI device ms (``chip_smoke.device_ms``),
two rounds over the variants. Prints one JSON object, with the card's name
and power limit. Writes nothing outside ``build/ablation/``.
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from torch_wide_fwd_ablation import build_variants, card_name, use_variant  # noqa: E402

PULL = """      if (np < SCATTER_PARTS) {
        for (int r = 0; r < np; ++r) {
          const uint32_t at = peer(xs, r);
"""
SIGNALS = (
    "        if (lane < np) arrive_peer(peer(smem_u32(&xfull[wq]), lane));\n",
    "      wait_cluster(&xfull[wq], p & 1);\n",
    "      if (lane < np) arrive_peer(peer(smem_u32(&xfree[wq]), lane));\n",
)
FREE_WAIT = "if (p > 0) wait_cluster(&xfree[wq], (p - 1) & 1);"
PARTIAL_READS = (
    "          part_rows_in(work, dqa, q0, 1, T_len, D, c0, wq, false);\n",
    "        if (!first_kt) part_rows_in(work, dea, q0 - k0, -1, T_len, D, c0, wq, true);\n",
    "          if (!first_kt) part_rows_in(work, dea, q0 + BQ - k0, -1, T_len, D, c0, wq, true);\n",
)
SCATTER = "constexpr int SCATTER_PARTS = 5;"


def variants(text):
    for piece in (PULL, SCATTER, *SIGNALS, *PARTIAL_READS):
        if text.count(piece) != 1:
            sys.exit(f"torch_wide_bwd_ablation: the source no longer holds {piece!r}")
    if text.count(FREE_WAIT) != 2:
        sys.exit(f"torch_wide_bwd_ablation: the source no longer holds {FREE_WAIT!r} twice")
    all_pull = text.replace(SCATTER, "constexpr int SCATTER_PARTS = 99;")
    own = all_pull.replace(PULL, PULL.replace("peer(xs, r)", "peer(xs, rank)"))
    silent = own.replace(FREE_WAIT, "")
    for piece in SIGNALS:
        silent = silent.replace(piece, "")
    no_reads = text
    no_reads = no_reads.replace(PARTIAL_READS[0], "          for (int x = 0; x < R; ++x) work[x] = 0.f;\n")
    for piece in PARTIAL_READS[1:]:
        no_reads = no_reads.replace(piece, "")
    return {"as_built": text, "all_pull": all_pull,
            "scatter": text.replace(SCATTER, "constexpr int SCATTER_PARTS = 2;"),
            "no_remote_reads": own, "no_exchange": silent, "no_partial_reads": no_reads}


def main():
    import torch

    import chip_smoke as cs
    from midi_emotion_tpu_torch.kernels import build
    from midi_emotion_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        sys.exit("torch_wide_bwd_ablation: needs a CUDA card")
    card = card_name()
    print(card, flush=True)
    src_dir = build.CSRC_DIR
    dirs = build_variants(variants((src_dir / "flash_rel_attn_wide.cu").read_text()),
                          "wide_bwd_tc_cluster_kernel")
    build.build_all(("flash_rel_attn_bwd",))  # dsum, from the source as it is
    bf16 = torch.bfloat16
    out = {"card": card}
    for rnd in range(2):
        for name, d in dirs.items():
            use_variant(d)
            for H, dh in ((2, 384), (1, 768)):
                q, k, v, e, pad = cs._flash_inputs(torch, cs.TRAIN_B, H, cs.TRAIN_T, dh, bf16)
                o, lse = fa.flash_rel_attention(q, k, v, e, True, pad)
                g = torch.Generator(device="cuda").manual_seed(cs.SEED + 1)
                do = (torch.randn(o.shape, generator=g, device="cuda")
                      * (~pad)[:, None, :, None]).to(bf16)
                call = lambda: fa.flash_rel_attention_bwd(q, k, v, e, True, pad, o, lse, do)  # noqa: E731
                row = out.setdefault(name, {})
                if rnd == 0:
                    got = call()
                    want = fa.flash_rel_attention_bwd_plain(q, k, v, e, True, pad, o, lse, do)
                    row[f"rel_err_dh{dh}"] = max(
                        (a.float() - b.float()).abs().max().item()
                        / (1 + b.float().abs().max().item()) for a, b in zip(got, want))
                    del got, want
                row[f"ms_dh{dh}_round{rnd}"] = cs.device_ms(torch, call, iters=10)
                del q, k, v, e, pad, o, lse, do
                torch.cuda.empty_cache()
    use_variant(src_dir)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
