#!/usr/bin/env python3
"""Check and time the port's flash attention kernels 1 and 4 on one card.

    python3 scripts/torch_flash_bench.py                 # this checkout
    python3 scripts/torch_flash_bench.py --roots A B B A --check --train --decode
    python3 scripts/torch_flash_bench.py --roots A B B A --wide
    python3 scripts/torch_flash_bench.py --roots A B B A --mid --train
    python3 scripts/torch_flash_bench.py --roots A B B A --decomp --train

Each root is a checkout of this repository (an unpacked ``git archive`` of
another commit, say). For each root in the order given, a fresh process
builds that root's ``csrc/flash_rel_attn_{fwd,bwd}.cu`` into its own
``build/kernels/`` and imports its ``midi_emotion_tpu_torch``. With
``--check`` it first holds kernels 1 and 4 against their plain twins with
``chip_smoke.py``'s checks and tolerances (this checkout's), at the shapes
those kernels are built for. It then times, as CUPTI device ms
(``chip_smoke.device_ms``), in bf16 at H 16, T 1216, d_head 48, causal,
with a pad tail:
  * kernel 1 (``flash_rel_attention``'s forward) at B 4 and B 8;
  * kernel 4 (``flash_rel_attention_bwd``, the merged backward) at B 8, the
    whole call and each of its launches apart (``chip_smoke.BWD_LAUNCHES``:
    ``dsum``, the main kernel, the dQ reduction and the dE reduction).
With ``--decode``, also the stacked-cache decode kernel 13 (``decode_attn_cached``,
staged, as ``chip_smoke.check_decode`` times it: layer 13 of L 20, B 64,
W 1408, length 1216, 4 stage rows, H 16, d_head 48), int8 and bf16.
With ``--wide``, also kernels 1, 4 and 13 past d_head 256 (their wide
forms), at the flagship's width with 2 heads of 384 and 1 of 768: kernel 1
(bf16, causal, a pad tail) at B 8, T 1216; kernel 4's whole call at the
same shape (``bwd_dh*``), beside SDPA's backward (``bwd_dh*_sdpa``, as
``chip_smoke.check_flash_bwd`` builds it); and kernel 13 staged at layer 13
of L 20, B 64, W 1408, length 1216, 4 stage rows, int8 and bf16 (the
shapes of ``chip_smoke.streamed_flagship_kernels``); each is first held to
its twin by ``chip_smoke.check_flash``, ``check_flash_bwd`` and
``check_decode`` at those shapes (kernel 13 at lengths 0 to 1400), and each
library's ptxas report (registers, spills) is printed.
With ``--mid``, also kernels 1 and 4 in bf16 at d_head 129-256, at the
flagship's width with 3 heads of 256 and 4 of 192 (T 1216, causal, a pad
tail): kernel 1 at B 4 and B 8 (``fwd_dh*_B*``) and kernel 4's whole call
at B 8 (``bwd_dh*``), each first held to its twin by
``chip_smoke.check_flash`` / ``check_flash_bwd`` and timed beside SDPA
(``*_sdpa``) and SDPA's backward; kernel 4's main launch apart
(``bwd_dh*_main``); the alternatives the route was chosen against, run on
each root's wide source and held to the twins: kernel 1 as the cluster
forward in two parts of 128 (``fwd_dh*_B*_cluster``; at 192 on heads
padded to 256) and, at 192, kernel 4's cluster on heads padded to 256
(``bwd_dh192_pad256``), both as the wrapper would run them (pad, launch,
cut); and the 20-layer ``--n_head 3`` train step at B 8 (``step3_*``, as
``--train`` measures the flagship's). Each library's ptxas report is
printed.
With ``--decomp``, also the other backward decompositions' kernels 5-9
(``MIDI_EMOTION_BWD=split|fused``; their library ``flash_rel_attn_bwd_q``'s
and ``_bwd_kv``'s ptxas reports are printed): each first held to its twin
by ``chip_smoke.check_bwd_kernel`` in bf16 at every d_head it is built for
and at 40 (padded), T 200, causal and not, a pad tail and a fully masked
row, at that check's tolerance (2e-2 of each output's scale); then each
wrapper's call timed alone (``k5``..``k9``: the kernel and its reduction)
and its main kernel apart (``k5_main``..``k9_main``) in bf16 at B 8, H 16,
T 1216, d_head 48, causal, with a pad tail; the inputs of the exp
floor: the 64 x 64 tile pairs a query-major kernel visits at that shape
(``tile_pairs``; each forms P of 4096 entries a pass), the visible (query,
key) pairs (``visible_pairs``, what the data needs), and the SFU's exp
rate (``exps_per_ms``: 16 results a clock an SM, the CUDA C++ Programming
Guide's throughput table for sm_90, times the card's SMs and its maximum
SM clock from ``nvidia-smi``); and, with ``--train``, the
flagship's train step under ``MIDI_EMOTION_BWD=split`` (``split_*``, with
kernels 7's and 8's ms a step), under ``fused`` with
``MIDI_EMOTION_DQDE=dist`` (``dist_*``, with kernels 6's and 9's) and with
``column`` (``column_*``, with kernels 5's and 9's), measured as the merged
step is.
With ``--train``, also the default (merged) train step of the flagship at
B 8, T 1216, bf16, dropout 0.1 (``chip_smoke.py``'s CLI arguments, on its
synthetic shards): after 2 warm-up steps, 3 steps under the profiler,
their device ms a step (every CUDA kernel's time summed), the wall ms a
step and the busy share, and kernels 1 and 4's ms a step.
Each process prints one JSON line; the calling process prints them all, then a
table by root, with the card's name and power limit. Roots are run in
turn, so putting a parent between two runs of a change (A B B A) shows the
card's drift; every root's kernels are built first, the roots in parallel.
Writes nothing outside each root's ``build/``.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def train_step(torch, cs, root, steps=3, extra=(), key="step", kernels=None):
    """The merged train step's device ms, wall ms and kernels 1 and 4's ms,
    a step, on the flagship (see the module docstring), or with ``extra``
    CLI arguments (``--n_head 3``), into keys starting with ``key``;
    ``kernels`` (label -> a substring of kernel names): those kernels' ms a
    step too."""
    import tempfile
    import time

    from torch.profiler import ProfilerActivity, profile

    from midi_emotion_tpu_torch.cli import train_cli

    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(root, "build")) as tmp:
        shards, features = cs.write_dataset(tmp)
        runner = train_cli.main([
            "--data_folder", shards, "--feature_file", features,
            "--conditioning", "continuous_concat", "--batch_size", str(cs.TRAIN_B),
            "--tgt_len", str(cs.TRAIN_T), "--dtype", "bf16", "--dropout", "0.1",
            "--num_workers", "0", "--log_step", "1000", "--eval_step", "1000",
            "--max_eval_step", "1", "--gen_step", "1000000", "--seed", "1", "--device", "cuda",
            "--work_dir", os.path.join(tmp, "run"), "--max_step", "1", *extra])
        it = runner.train_dataset.epochs(cs.TRAIN_B)
        batches = [runner._to_device(runner._microbatches(it)) for _ in range(2 + steps)]
        gen = torch.Generator().manual_seed(cs.SEED)
        for b in batches[:2]:
            float(runner._train_fn(b, 2e-5, gen)["loss"])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for b in batches[2:]:
                float(runner._train_fn(b, 2e-5, gen)["loss"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    per_step = lambda es: sum(e.self_device_time_total for e in es) / 1e3 / steps
    device = per_step(events)
    k4 = per_step([e for e in events if any(only in e.key for _, only in cs.BWD_LAUNCHES)])
    k1 = per_step([e for e in events if "flash_fwd_tc_" in e.key])
    out = {f"{key}_device_ms": device, f"{key}_wall_ms": wall * 1e3 / steps,
           f"{key}_busy": device / (wall * 1e3 / steps), f"{key}_k4_ms": k4, f"{key}_k1_ms": k1}
    for label, only in (kernels or {}).items():
        out[f"{key}_{label}_ms"] = per_step([e for e in events if only in e.key])
    return out


# kernels 5-9: chip_smoke's name -> (label, a substring of its main kernel's name)
DECOMP_KERNELS = {
    "flash_rel_attn_bwd_dq_de": ("k5", "flash_bwd_q_"),
    "flash_rel_attn_bwd_dq_de_dist": ("k6", "flash_bwd_q_"),
    "flash_rel_attn_bwd_dkdv_dq": ("k7", "flash_bwd_kv_"),
    "flash_rel_attn_bwd_de_dqrel": ("k8", "flash_bwd_q_"),
    "flash_rel_attn_bwd_dkdv": ("k9", "flash_bwd_kv_tc_kernel"),
}
# (label, MIDI_EMOTION_BWD, MIDI_EMOTION_DQDE, the kernels timed a step)
DECOMP_STEPS = (("split", "split", "column", {"k7": "flash_bwd_kv_", "k8": "flash_bwd_q_"}),
                ("dist", "fused", "dist", {"k6": "flash_bwd_q_", "k9": "flash_bwd_kv_"}),
                ("column", "fused", "column", {"k5": "flash_bwd_q_", "k9": "flash_bwd_kv_"}))


def decomp_ms(torch, cs):
    """Kernels 5-9 (see the module docstring): held to their twins, then
    CUPTI device ms of one call and of its main kernel."""
    from midi_emotion_tpu_torch.ops import flash_attention as fa

    bf16 = torch.bfloat16
    n_tiles = -(-cs.TRAIN_T // 64)
    out = {"tile_pairs": cs.TRAIN_B * 16 * n_tiles * (n_tiles + 1) // 2}
    pad = cs._flash_inputs(torch, cs.TRAIN_B, 1, cs.TRAIN_T, 16, bf16)[4]
    out["visible_pairs"] = cs.visible_pairs(torch, pad, 16, True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out["exps_per_ms"] = 16 * sms * float(smi.stdout.split()[0]) * 1e3  # MHz -> a ms
    for kernel, (label, only) in DECOMP_KERNELS.items():
        for dh in (*fa.DECOMPOSITION_DHS, 40):
            for causal in (True, False):
                cs.check_bwd_kernel(torch, kernel, 2, 4, 200, dh, bf16, causal, 2e-2)
        wrapper = getattr(fa, cs.BWD_KERNELS[kernel][0])
        args = cs._bwd_args(torch, cs.TRAIN_B, 16, cs.TRAIN_T, 48, bf16, True)
        out[label] = cs.device_ms(torch, lambda: wrapper(*args), per_call=2)
        out[f"{label}_main"] = cs.device_ms(torch, lambda: wrapper(*args), only=only)
        del args
        torch.cuda.empty_cache()
    return out


def decode_ms(torch, cs):
    """Kernel 13, staged, at the flagship's serving shape: CUPTI device ms
    of one call, int8 and bf16."""
    from midi_emotion_tpu_torch.ops import decode_attention as da

    out = {}
    L, B, W, H, dh, S = (cs.DECODE[k] for k in ("L", "B", "W", "H", "dh", "S"))
    for quant, mode in ((True, "int8"), (False, "bf16")):
        kv, sc, q, e, pend, row, _ = cs._decode_cache(torch, quant, cs.SEED + 5)
        length, p_cnt = 1216, 4
        e_rows = da.expand_e_rows(e, length + p_cnt + 1, W)
        e_pend = da.expand_e_rows(e, p_cnt + 1, S + 1)
        out[f"decode_{mode}"] = cs.device_ms(
            torch, lambda: da.decode_attn_cached(q, kv, sc, 13, e_rows, length, pend, e_pend,
                                                 p_cnt, row),
            iters=50, only="decode_attn_stacked")
        del kv, sc, pend
        torch.cuda.empty_cache()
    return out


def wide_ms(torch, cs):
    """Kernels 1, 4 and 13 past d_head 256 (see the module docstring):
    CUPTI device ms of one call, after the checks."""
    from midi_emotion_tpu_torch.ops import decode_attention as da
    from midi_emotion_tpu_torch.ops.flash_attention import flash_rel_attention

    bf16 = torch.bfloat16
    out = {}
    for H, dh in ((2, 384), (1, 768)):
        cs.check_flash(torch, cs.TRAIN_B, H, cs.TRAIN_T, dh, bf16, True, 2e-2, 1e-3, rel=True)
        q, k, v, e, pad = cs._flash_inputs(torch, cs.TRAIN_B, H, cs.TRAIN_T, dh, bf16)
        out[f"fwd_dh{dh}"] = cs.device_ms(torch, lambda: flash_rel_attention(q, k, v, e, True, pad))
        del q, k, v, e, pad
        torch.cuda.empty_cache()
        bwd = cs.check_flash_bwd(torch, cs.TRAIN_B, H, cs.TRAIN_T, dh, bf16, True, 2e-2, timed=True)
        out[f"bwd_dh{dh}"], out[f"bwd_dh{dh}_sdpa"] = bwd["ms"], bwd["library_ms"]
        shape = dict(L=20, B=64, W=1408, H=H, dh=dh, S=8)
        for quant, mode in ((True, "int8"), (False, "bf16")):
            torch.cuda.empty_cache()
            cs.check_decode(torch, quant, shape=shape, lengths=(0, 1, 129, 700, 1216, 1400))
            kv, sc, q, e, pend, row, _ = cs._decode_cache(torch, quant, cs.SEED + 5, shape)
            length, p_cnt, dh_k = 1216, 4, da.cache_dh(dh)
            e_rows = da.expand_e_rows(e, length + p_cnt + 1, shape["W"], dh_to=dh_k)
            e_pend = da.expand_e_rows(e, p_cnt + 1, shape["S"] + 1, dh_to=dh_k)
            # "decode": the kernel of either design (decode_attn_stacked_kernel,
            # or the per-head decode_wide_kernel of earlier checkouts)
            out[f"decode_{mode}_dh{dh}"] = cs.device_ms(
                torch, lambda: da.decode_attn_cached(q, kv, sc, 13, e_rows, length, pend, e_pend,
                                                     p_cnt, row),
                iters=50, only="decode")
            del kv, sc, pend
        torch.cuda.empty_cache()
    return out


def _padded_fwd(torch, fa, q, k, v, e, pad, dh_to=256):
    """Kernel 1 on the wide source's cluster forward at ``dh_to`` columns,
    as the wrapper would run it there: heads padded, c of the true d_head,
    O cut back."""
    import math

    B, H, T, dh = q.shape
    qp, kp, vp, ep = fa.pad_heads(dh_to, q, k, v, e)
    o = torch.empty_like(qp)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    fa._launch("flash_rel_attn_wide_fwd", qp.data_ptr(), kp.data_ptr(), vp.data_ptr(),
               ep.data_ptr(), pad.data_ptr(), o.data_ptr(), lse.data_ptr(), B, H, T, dh_to,
               e.shape[0], 1, 1, 1.0 / math.sqrt(dh), torch.cuda.current_stream().cuda_stream)
    return o[..., :dh].contiguous(), lse


def _padded_bwd(torch, fa, q, k, v, e, pad, o, lse, do, dh_to=256):
    """Kernel 4's whole call on the wide source's cluster backward at
    ``dh_to`` columns, as the wrapper would run it there (dsum, heads
    padded, c of the true d_head, gradients cut back)."""
    import math

    dh = q.shape[-1]
    dsum = fa._dsum(o, do)
    qp, kp, vp, ep, dop = fa.pad_heads(dh_to, q, k, v, e, do)
    outs = {n: torch.empty_like(t) for n, t in zip(("dq", "dk", "dv", "de"), (qp, kp, vp, ep))}
    fa._launch_wide_bwd(4, qp, kp, vp, ep, True, pad, lse, dsum, dop, outs, 1.0 / math.sqrt(dh))
    return [t[..., :dh].contiguous() for t in outs.values()]


def mid_ms(torch, cs):
    """Kernels 1 and 4 in bf16 at d_head 129-256 and the alternatives the
    route was chosen against (see the module docstring): CUPTI device ms
    of one call, after the checks."""
    from midi_emotion_tpu_torch.ops import flash_attention as fa

    bf16 = torch.bfloat16
    out = {}
    for H, dh in ((3, 256), (4, 192)):
        for B in (4, cs.TRAIN_B):
            k1 = cs.check_flash(torch, B, H, cs.TRAIN_T, dh, bf16, True, 2e-2, 1e-3, timed=True,
                                rel=True)
            out[f"fwd_dh{dh}_B{B}"], out[f"fwd_dh{dh}_B{B}_sdpa"] = k1["ms"], k1["library_ms"]
            q, k, v, e, pad = cs._flash_inputs(torch, B, H, cs.TRAIN_T, dh, bf16)
            o, lse = _padded_fwd(torch, fa, q, k, v, e, pad)
            ro, rlse = fa.flash_rel_attention_plain(q, k, v, e, True, pad)
            err = (o.float() - ro.float()).abs().max().item() / (1 + ro.float().abs().max().item())
            if not (err <= 2e-2 and (lse - rlse).abs().max().item() <= 1e-3):
                sys.exit(f"the cluster forward at dh {dh} (padded to 256) disagrees: {err}")
            out[f"fwd_dh{dh}_B{B}_cluster"] = cs.device_ms(
                torch, lambda: _padded_fwd(torch, fa, q, k, v, e, pad),
                only="wide_fwd_tc_cluster_kernel")
            del q, k, v, e, pad, o, lse, ro, rlse
            torch.cuda.empty_cache()
        k4 = cs.check_flash_bwd(torch, cs.TRAIN_B, H, cs.TRAIN_T, dh, bf16, True, 2e-2, timed=True,
                                launches=True)
        out[f"bwd_dh{dh}"], out[f"bwd_dh{dh}_sdpa"] = k4["ms"], k4["library_ms"]
        out[f"bwd_dh{dh}_main"] = k4["launch_ms"]["main"]
        torch.cuda.empty_cache()
        if dh == 192:
            q, k, v, e, pad = cs._flash_inputs(torch, cs.TRAIN_B, H, cs.TRAIN_T, dh, bf16)
            o, lse = fa.flash_rel_attention(q, k, v, e, True, pad)
            g = torch.Generator(device="cuda").manual_seed(cs.SEED + 1)
            do = (torch.randn(o.shape, generator=g, device="cuda")
                  * (~pad)[:, None, :, None]).to(bf16)
            got = _padded_bwd(torch, fa, q, k, v, e, pad, o, lse, do)
            want = fa.flash_rel_attention_bwd_plain(q, k, v, e, True, pad, o, lse, do)
            for a, b in zip(got, want):
                scale = b.float().abs().max().item()
                if not (a.float() - b.float()).abs().max().item() <= 2e-2 * (1 + scale):
                    sys.exit("kernel 4's cluster at dh 192 padded to 256 disagrees with its twin")
            out["bwd_dh192_pad256"] = cs.device_ms(
                torch, lambda: _padded_bwd(torch, fa, q, k, v, e, pad, o, lse, do), iters=5)
            del q, k, v, e, pad, o, lse, do, got, want
            torch.cuda.empty_cache()
    return out


def libraries(decode, wide, mid, decomp=False):
    return (("flash_rel_attn_fwd", "flash_rel_attn_bwd")
            + (("flash_rel_attn_bwd_kv", "flash_rel_attn_bwd_q") if decomp else ())
            + (("decode_attn_stacked",) if decode else ())
            + (("flash_rel_attn_wide", "decode_attn_wide") if wide else ())
            + (("flash_rel_attn_wide",) if mid and not wide else ()))


def worker(root, check, train, decode, wide, mid, decomp):
    import importlib.util

    sys.path.insert(0, root)  # the package comes from root
    import torch

    # this checkout's checks, whatever chip_smoke.py root holds
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from midi_emotion_tpu_torch.kernels.build import build_all, library_path
    from midi_emotion_tpu_torch.ops.flash_attention import (
        flash_rel_attention, flash_rel_attention_bwd)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_all(libraries(decode, wide, mid, decomp))
    for name in ("flash_rel_attn_fwd", "flash_rel_attn_bwd"):
        cs.print_ptxas(library_path(name), name)
        cs.print_sass_mma(library_path(name), name)
    if decomp:
        for name in ("flash_rel_attn_bwd_q", "flash_rel_attn_bwd_kv"):
            cs.print_ptxas(library_path(name), name)
    if wide or mid:
        for name in ("flash_rel_attn_wide",) + (("decode_attn_wide",) if wide else ()):
            cs.print_ptxas(library_path(name), name)
    bf16 = torch.bfloat16
    if check:
        for T in (1, 63, 64, 65, 333, 1216):
            cs.check_flash(torch, 2, 4, T, 48, bf16, True, 2e-2, 1e-3)
            cs.check_flash_bwd(torch, 2, 4, T, 48, bf16, True, 2e-2)
        cs.check_flash(torch, 2, 4, 200, 48, bf16, False, 2e-2, 1e-3)
        cs.check_flash_bwd(torch, 2, 4, 200, 48, bf16, False, 2e-2)
        for dh in (16, 32, 40, 64, 96, 128):
            cs.check_flash(torch, 2, 4, 333, dh, bf16, True, 2e-2, 1e-3)
            cs.check_flash_bwd(torch, 2, 4, 333, dh, bf16, True, 2e-2)
        cs.check_flash(torch, 4, 16, 1216, 48, bf16, True, 2e-2, 1e-3)
        cs.check_flash_bwd(torch, 8, 16, 1216, 48, bf16, True, 2e-2)
    out = {"root": root}
    for B in (4, 8):
        q, k, v, e, pad = cs._flash_inputs(torch, B, 16, 1216, 48, bf16)
        out[f"fwd_B{B}"] = cs.device_ms(torch, lambda: flash_rel_attention(q, k, v, e, True, pad))
    q, k, v, e, pad = cs._flash_inputs(torch, 8, 16, 1216, 48, bf16)
    o, lse = flash_rel_attention(q, k, v, e, True, pad)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 1)
    do = (torch.randn(o.shape, generator=g, device="cuda") * (~pad)[:, None, :, None]).to(bf16)
    call = lambda: flash_rel_attention_bwd(q, k, v, e, True, pad, o, lse, do)
    out["bwd_B8"] = cs.device_ms(torch, call, iters=10, per_call=4)
    for label, only in cs.BWD_LAUNCHES:
        out[f"bwd_B8_{label}"] = cs.device_ms(torch, call, iters=10, only=only)
    del q, k, v, e, pad, o, lse, do
    torch.cuda.empty_cache()
    if decode:
        out.update(decode_ms(torch, cs))
    if wide:
        out.update(wide_ms(torch, cs))
    if mid:
        out.update(mid_ms(torch, cs))
    if decomp:
        out.update(decomp_ms(torch, cs))
    if train:
        out.update(train_step(torch, cs, root))
    if train and decomp:
        for key, impl, dqde, kernels in DECOMP_STEPS:
            os.environ.update({"MIDI_EMOTION_BWD": impl, "MIDI_EMOTION_DQDE": dqde})
            out.update(train_step(torch, cs, root, key=key, kernels=kernels))
        os.environ.update({"MIDI_EMOTION_BWD": "merged", "MIDI_EMOTION_DQDE": "column"})
    if mid:
        out.update(train_step(torch, cs, root, extra=("--n_head", "3"), key="step3"))
    print("RESULT " + json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--roots", nargs="*", default=[HERE])
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--decode", action="store_true")
    ap.add_argument("--wide", action="store_true")
    ap.add_argument("--mid", action="store_true")
    ap.add_argument("--decomp", action="store_true")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args.worker, args.check, args.train, args.decode, args.wide, args.mid,
                      args.decomp)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "no card"
    print(card, flush=True)
    roots = [os.path.abspath(root) for root in args.roots]
    builds = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from midi_emotion_tpu_torch.kernels.build import build_all; "
         "build_all(tuple(sys.argv[2:]))", root,
         *libraries(args.decode, args.wide, args.mid, args.decomp)],
        cwd=root)
        for root in dict.fromkeys(roots)]
    if any(b.wait() for b in builds):
        sys.exit("torch_flash_bench: a build failed")
    rows = []
    for root in roots:
        cmd = [sys.executable, os.path.abspath(__file__), "--worker", root]
        flags = [f"--{f}" for f in ("check", "train", "decode", "wide", "mid", "decomp")
                 if getattr(args, f)]
        proc = subprocess.run(cmd + flags, cwd=root, capture_output=True, text=True, timeout=1800)
        print(proc.stdout[-20000:], proc.stderr[-4000:], sep="\n", flush=True)
        if proc.returncode != 0:
            sys.exit(f"torch_flash_bench: {root} failed ({proc.returncode})")
        rows += [json.loads(line[7:]) for line in proc.stdout.splitlines()
                 if line.startswith("RESULT ")]
    keys = [k for k in rows[0] if k != "root"]
    print(f"device ms (CUPTI) on {card}:")
    print("root | " + " | ".join(keys))
    for r in rows:
        print(f"{r['root']} | " + " | ".join(f"{r[k]:.4f}" for k in keys))


if __name__ == "__main__":
    main()
