#!/usr/bin/env python3
"""What bounds kernel 1's two-warpgroup form at d_head 192 and 256, on one card.

    python3 scripts/torch_parts_fwd_ablation.py      # from the repository root

Kernel 1's bf16 forward at d_head 192 and 256 (``tc::flash_fwd_tc_parts_kernel``
in ``midi_emotion_tpu_torch/csrc/flash_rel_attn_fwd.cu``) runs one block a
query tile whose two warpgroups each own half the columns, copy their
half of every tile by TMA and sum their partial scores in the block's
shared memory. This script builds variants of that source, each into its
own directory under ``build/ablation/``, and times each at the flagship's
width (T 1216, bf16, causal, a pad tail) with 3 heads of 256 at B 4 and 8
and 4 of 192 at B 8:

  * ``as_built``: the source as it is;
  * ``no_partner_read``: each warpgroup uses its own partial score alone
    (the partials still written, both barriers kept);
  * ``no_reload``: the first K, E and V stages copied once and never
    refilled, so no tile after them waits on a copy (the products read
    stale tiles).

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

SOURCE = "flash_rel_attn_fwd"
KERNEL = "flash_fwd_tc_parts_kernel"
READ = """      sacc[4 * n] += u.x;
      sacc[4 * n + 1] += u.y;
      sacc[4 * n + 2] += u.z;
      sacc[4 * n + 3] += u.w;
"""
# (piece, its no_reload replacement)
RELOAD = (("    mbar_wait(&kfull[s], (kt / NS) & 1);\n",
           "    if (kt < NS) mbar_wait(&kfull[s], 0);\n"),
          ("    mbar_wait(&vfull[sv], (kt / NV) & 1);\n",
           "    if (kt < NV) mbar_wait(&vfull[sv], 0);\n"),
          ("      if (copier) copy_k(kt + NS);\n", ""),
          ("      if (copier) copy_v(kt + NV);\n", ""))


def variants(text):
    for piece in (READ, *(p for p, _ in RELOAD)):
        if text.count(piece) != 1:
            sys.exit(f"torch_parts_fwd_ablation: the source no longer holds {piece!r}")
    no_reload = text
    for piece, new in RELOAD:
        no_reload = no_reload.replace(piece, new)
    return {"as_built": text, "no_partner_read": text.replace(READ, ""), "no_reload": no_reload}


def card_name():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def build_variants(texts):
    """Each variant's source (``texts``: name -> text) built into
    build/ablation/<name>/, one nvcc each, all at once (the other sources
    copied beside it, so their libraries keep their hashed names); prints
    the registers and spills of the kernel. Returns name -> directory."""
    import chip_smoke as cs
    from midi_emotion_tpu_torch.kernels import build

    src_dir = build.CSRC_DIR
    dirs, started = {}, []
    for name, src in texts.items():
        d = build.PACKAGE_DIR.parent / "build" / "ablation" / name
        d.mkdir(parents=True, exist_ok=True)
        for other in (*src_dir.glob("*.cuh"), *src_dir.glob("*.cu")):
            shutil.copy(other, d)
        (d / f"{SOURCE}.cu").write_text(src)
        dirs[name] = d
        build.CSRC_DIR = d
        started.append((name, *build._start_build(SOURCE)))
    for name, proc, tmp in started:
        build.CSRC_DIR = dirs[name]
        build._finish_build(SOURCE, proc, tmp)
        for kern, n in cs.ptxas_forms(build.library_path(SOURCE), KERNEL).items():
            print(f"{name}: {kern}: {n}")
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
        sys.exit("torch_parts_fwd_ablation: needs a CUDA card")
    card = card_name()
    print(card, flush=True)
    src_dir = build.CSRC_DIR
    dirs = build_variants(variants((src_dir / f"{SOURCE}.cu").read_text()))
    bf16 = torch.bfloat16
    out = {"card": card}
    for rnd in range(2):
        for name, d in dirs.items():
            use_variant(d)
            for B, H, dh in ((4, 3, 256), (cs.TRAIN_B, 3, 256), (cs.TRAIN_B, 4, 192)):
                q, k, v, e, pad = cs._flash_inputs(torch, B, H, cs.TRAIN_T, dh, bf16)
                o, _ = fa.flash_rel_attention(q, k, v, e, True, pad)
                ro, _ = fa.flash_rel_attention_plain(q, k, v, e, True, pad)
                row = out.setdefault(name, {})
                row[f"max_abs_err_dh{dh}_B{B}"] = (o.float() - ro.float()).abs().max().item()
                row[f"ms_dh{dh}_B{B}_round{rnd}"] = cs.device_ms(
                    torch, lambda: fa.flash_rel_attention(q, k, v, e, True, pad))
                del q, k, v, e, pad, o, ro
            torch.cuda.empty_cache()
    build.CSRC_DIR = src_dir
    print(json.dumps(out))


if __name__ == "__main__":
    main()
