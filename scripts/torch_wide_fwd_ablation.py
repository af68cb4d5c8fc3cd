#!/usr/bin/env python3
"""What the cluster exchange of kernel 1's wide forward costs, on one card.

    python3 scripts/torch_wide_fwd_ablation.py      # from the repository root

Kernel 1's bf16 forward past d_head 256 (``cl::wide_fwd_tc_cluster_kernel``
in ``midi_emotion_tpu_torch/csrc/flash_rel_attn_wide.cu``) runs one
thread-block cluster per query tile, a CTA per 128 columns, and sums the
CTAs' partial scores through distributed shared memory. This script builds
variants of that source, each into its own directory under
``build/ablation/``, and times each at the flagship's width (B 8, T 1216,
bf16, causal, a pad tail) with 2 heads of 384, 1 of 768 and 1 of 1024:

  * ``as_built``: the source as it is (all-pull below ``SCATTER_PARTS``
    parts, reduce-scatter and all-gather from there on);
  * ``all_pull``: every rank reads every other rank's whole partial;
  * ``scatter``: the reduce-scatter and all-gather at every width;
  * ``signals_only``: ``all_pull`` without its remote reads (each CTA uses
    its own partial: wrong outputs, the signals and waits kept);
  * ``no_exchange``: neither signals nor remote reads.

The last two give wrong outputs by design; their max |O - twin| is printed
beside their time. Times are CUPTI device ms (``chip_smoke.device_ms``),
two rounds over the variants. Prints one JSON object, with the card's name
and power limit. Writes nothing outside ``build/ablation/``.
"""

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PULL = """          } else {
            const uint32_t at = peer(xmine, r);
#pragma unroll
            for (int n = 0; n < BK / 8; ++n) v[n] = ld_peer(at + n * NCW * 32 * 16);
          }
"""
OWN = """          } else {
#pragma unroll
            for (int n = 0; n < BK / 8; ++n)
              v[n] = make_float4(sacc[4 * n], sacc[4 * n + 1], sacc[4 * n + 2], sacc[4 * n + 3]);
          }
"""
SIGNAL = """      if (lane < np) arrive_peer(peer(smem_u32(xw), lane));
      wait_cluster(xw, (kt >> 1) & 1);
"""
SCATTER = "constexpr int SCATTER_PARTS = 5;"


def variants(text):
    for piece in (PULL, SIGNAL, SCATTER):
        if text.count(piece) != 1:
            sys.exit(f"torch_wide_fwd_ablation: the source no longer holds {piece!r}")
    all_pull = text.replace(SCATTER, "constexpr int SCATTER_PARTS = 99;")
    return {"as_built": text, "all_pull": all_pull,
            "scatter": text.replace(SCATTER, "constexpr int SCATTER_PARTS = 2;"),
            "signals_only": all_pull.replace(PULL, OWN),
            "no_exchange": all_pull.replace(PULL, OWN).replace(SIGNAL, "")}


def card_name():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def build_variants(texts, kernel, source="flash_rel_attn_wide"):
    """Each variant's csrc/<source>.cu (``texts``: name -> source) built
    into build/ablation/<name>/, one nvcc each, all at once (the other
    sources copied beside it load the libraries built from them as they
    are); prints the registers and spills of ``kernel``. Returns name ->
    directory."""
    import chip_smoke as cs
    from midi_emotion_tpu_torch.kernels import build

    src_dir = build.CSRC_DIR
    dirs, started = {}, []
    for name, src in texts.items():
        d = build.PACKAGE_DIR.parent / "build" / "ablation" / name
        d.mkdir(parents=True, exist_ok=True)
        for other in (*src_dir.glob("*.cuh"), *src_dir.glob("*.cu")):  # the same hashes
            shutil.copy(other, d)
        (d / f"{source}.cu").write_text(src)
        dirs[name] = d
        build.CSRC_DIR = d
        started.append((name, *build._start_build(source)))
    for name, proc, tmp in started:
        build.CSRC_DIR = dirs[name]
        build._finish_build(source, proc, tmp)
        for kern, regs, spilled in cs.ptxas_report(build.library_path(source))[0]:
            if kernel in kern:
                print(f"{name}: {kern}: {regs} registers, {spilled} bytes spilled")
    build.CSRC_DIR = src_dir
    return dirs


def use_variant(d):
    """Load the kernels of build directory ``d`` at the wrappers' next launch."""
    from midi_emotion_tpu_torch.kernels import build
    from midi_emotion_tpu_torch.ops import flash_attention as fa

    build.CSRC_DIR = d
    build.cuda_library.cache_clear()
    fa._function.cache_clear()


def main():
    import torch

    import chip_smoke as cs
    from midi_emotion_tpu_torch.kernels import build
    from midi_emotion_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        sys.exit("torch_wide_fwd_ablation: needs a CUDA card")
    card = card_name()
    print(card, flush=True)
    src_dir = build.CSRC_DIR
    dirs = build_variants(variants((src_dir / "flash_rel_attn_wide.cu").read_text()),
                          "wide_fwd_tc_cluster_kernel")
    bf16 = torch.bfloat16
    out = {"card": card}
    for rnd in range(2):
        for name, d in dirs.items():
            use_variant(d)
            for H, dh in ((2, 384), (1, 768), (1, 1024)):
                q, k, v, e, pad = cs._flash_inputs(torch, cs.TRAIN_B, H, cs.TRAIN_T, dh, bf16)
                o, _ = fa.flash_rel_attention(q, k, v, e, True, pad)
                ro, _ = fa.flash_rel_attention_plain(q, k, v, e, True, pad)
                row = out.setdefault(name, {})
                row[f"max_abs_err_dh{dh}"] = (o.float() - ro.float()).abs().max().item()
                row[f"ms_dh{dh}_round{rnd}"] = cs.device_ms(
                    torch, lambda: fa.flash_rel_attention(q, k, v, e, True, pad))
                del q, k, v, e, pad, o, ro
            torch.cuda.empty_cache()
    build.CSRC_DIR = src_dir
    print(json.dumps(out))


if __name__ == "__main__":
    main()
