#!/usr/bin/env python3
"""Smoke test of the torch port (midi_emotion_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, on a machine with a card

Phases, each fatal on failure:
  1. refuse to start without CUDA; print the card's name and power limit;
  2. build the hand-written kernels from the sources in this checkout
     (the CUDA flash attention forward, the merged backward, the key-major
     and query-major backward sweeps of the other decompositions, and the
     stacked-cache decode attention with nvcc into build/kernels/, one nvcc
     per source, started together; the Triton LayerNorm and dropout kernels
     at their first launch);
  3. compare each kernel with its plain PyTorch twin on the card, at the
     flagship shapes, in f32 and bf16 (the decode kernel in its four modes,
     int8 and bf16, unstaged and staged, at the serving shapes L 20, B 64,
     W 1408), and time both and, where one PyTorch call computes the same
     function, that call; every attention kernel also at the head shapes
     past the flagship's, at small sizes (d_head 96 and 128 in f32 and
     bf16, the flash kernels in bf16 at every d_head and at 40, which
     their wrappers pad to 48, and the decode kernel at D 1280, two head
     groups, and at d_head 40, laid out at 48; kernels 1 and 4 timed at
     d_head 128 beside 64; kernel 1 also at the train step's B 8, and
     kernel 4's call split into its launches: dsum, the main kernel, the
     dQ and the dE reductions); count the tensor-core instructions of
     kernels 1 and 4-9 and of their wide forms' bf16 sweeps in their SASS
     (cuobjdump), failing on one without any, on a bf16 kernel 1 or 4
     without a wgmma (HGMMA) instruction (kernel 1's two-warpgroup form at
     d_head 192 and 256 and kernel 4's cluster in parts of 96 and 128
     among them), on a bf16 kernel 6, 7 or 8 at d_head 16-128 without one,
     or on a missing kernel 9 or wide sweep; hold kernels 5-8 in bf16
     (their Hopper form, wgmma on TMA tiles; kernel 5 runs kernel 6's
     instantiation, and its outputs must be kernel 6's bit for bit)
     against their twins at every d_head they are built for and at 40,
     causal and not (kernel 7 on one and on two blocks a (b, h)), each
     call launching that form, and two calls bitwise equal; time kernel 9
     on its two grids (bitwise equal, within 2e-2 of
     kernel 7's dK and dV); hold each
     backward decomposition (split, fused/column, fused/dist) against the
     merged kernel, and time the whole split call beside SDPA's backward;
     past d_head 128: kernels 1 and 4 at 160, 192, 224 and 256 (160 and 224
     through the padding) in f32 and bf16 (in bf16 kernel 1 is one block a
     query tile whose two warpgroups each own half the columns and sum
     their partial scores in shared memory, tc::flash_fwd_tc_parts_kernel,
     and kernel 4 the wide source's cluster backward in two parts of 96 or
     128), kernel 13 at 192 and 256 in its four modes, the three timed at
     the flagship's width with 3 heads of 256 beside SDPA and the bound
     (kernel 1 at B 4 and 8, kernel 4's call at B 8, kernel 13 at L 20, B
     64, W 1408), kernels 1 and 4 also at 4 heads of 192, with the two
     forms' ptxas registers, spills and serialized-wgmma flag (the JSON
     rows' ``wide_heads``); past the built widths, on
     the wide kernels (csrc/flash_rel_attn_wide.cu, csrc/decode_attn_wide.cu;
     kernel 1's bf16 forward there is a cluster of CTAs per query tile,
     kernel 4's bf16 backward a cluster of CTAs per (b, h) and split of
     its key tiles, kernel 13 up to 1024 channels a head the stacked
     kernel's wide instantiations): kernels 1 and 4 at 320 (padded to
     384), 384 and 768, kernels 1 and 4 in bf16 at 1152 (a 9-CTA cluster;
     the SASS check fails on either cluster kernel without HGMMA), kernels
     5-9 at 192, 256
     and 384, kernel 13 at 320, 384, 768, 1024 and 1152, f32 and bf16 at
     small B; kernels 1, 4, 5-9 and 13 timed at the flagship's width with
     2 heads of 384 and 1 of 768 (the JSON rows' ``streamed_heads``: the
     flash kernels at B 8, T 1216, kernel 13 at L 20, B 64, W 1408) beside
     their twins, SDPA and the bound, with the ptxas registers and spills
     of kernel 1's cluster forward, kernel 4's cluster backward and kernel
     13's wide instantiations (``streamed_heads.ptxas``); and at the widths
     that were the limits (272
     on kernels 1, 4 and 13, 144 on 5-9 under split and fused) every
     wrapper launching its kernel while the plain twins and SDPA refuse to
     run;
     kernels 3 and 12 also at a ragged shape ([9729, 99]), and their row
     pass timed apart from the dgamma/dbeta reduction; then one small f32
     train step through the kernels against the same step on the CPU
     (twins);
  4. write a random-init flagship model (continuous_concat, 20 layers,
     d_model 768, 16 heads of 48, seeded torch.Generator) as a
     reference-format work dir and check its forward pass on the card
     (kernels) against the CPU (plain twins) on a small input;
  5. training: write a synthetic dataset with the port's save_song_shard
     and run the port's training CLI at the flagship width (B 8, T 1216,
     bf16, dropout 0.1): a few steps, a checkpoint, a resume; then a short
     --dropout 0 run at 4 layers (its LayerNorms run kernels 2 and 3); then
     a 2-step run under each other backward decomposition
     (MIDI_EMOTION_BWD=split, fused, fused with MIDI_EMOTION_DQDE=dist),
     whose first loss must equal the merged run's; time train tokens/sec
     over 5 steps after 2 warm-up steps under each decomposition in turn
     (merged first: the headline) and profile two;
 5b. native work dirs: write the trained work dir in the JAX package's
     native layout with save_native_dir (model.msgpack, optimizer.msgpack
     through the port's Flax msgpack codec, stats.json) and read every leaf
     back bitwise; load it and the reference dir on the card: bitwise the
     same logits; entry()'s flagship forward (B 4, T 1216, bf16); the
     generation CLI with --kv_dtype int8 on both dirs at one seed: the same
     ids; train_cli --restart_dir on both: the step counter continues from
     stats.json, the same first loss and Adam step; a 1-step 4-layer
     continuous_token run written as a native dir, the transfer CLI from
     the trained dir into it (the embedding slice as transfer_state_dict
     says), torch_export of it and a load of the export; a 2-step 4-layer
     dropout-0 run under MIDI_EMOTION_FLASH_BWD=xla (kernel 4 never
     launched): its first loss equal to the kernels' run (phase 5's
     dropout-0 run), its first-step attention gradients within 2e-2 of
     (1 + scale) of kernel 4's;
 5c. --remat none, dots and full: 2 flagship steps each (B 8, dropout 0.1)
     from one init and dropout generator, the same losses and grad norms,
     kernel 1 launched 40 times a step under dots and full (the recompute
     reruns it) against 20, kernel 4 20 times; peak memory and ms/step of
     each; then 2 ranks of this script (``--mesh-rank``), both on cuda:0
     under gloo, run 2 steps at --mesh_data 2, at --mesh_model 2 and at
     --mesh_seq 2 --attn_impl ring (global B 8) against the one-process
     run: losses, grad norms and step 1's gradients parameter by parameter
     (the model ranks then run the same 2 steps under each of two planted
     tensor-parallel faults, which the limits must see); then the
     ring's per-step function driven over 4 chunks of 304 in one process
     (B 2, H 16, T 1216) against kernel 1's output and kernel 4's
     gradients, in f32 and bf16;
 5d. the flagship's width with 3 heads of 256 (--n_head 3, 153 598 191
     parameters: each layer's E is max_seq x d_head): 2 CLI steps (B 8, T
     1216, bf16, dropout 0.1), then 2 warm-up and 5 timed (train
     tokens/sec, device ms a step); its work dir served by
     Sampler at B 64, window 1216, a 600-token prompt and 128 new tokens
     through the native, int8 and bf16 caches (sampled tokens/sec each); a
     4-layer --n_head 4 (d_head 192) model trained 3 steps and served from
     the int8 cache (these bf16 paths fail unless kernel 1's two-warpgroup
     form and, training, kernel 4's cluster launched); a 4-layer --n_head 3
     model trained 2 steps at B 2 in f32; past d_head 256: the flagship's width with 2 heads of 384
     (158 841 071 parameters), 20 layers, 2 CLI steps, then 2 warm-up and
     5 timed, served like the 3-head model from the native, int8 and bf16
     caches; a 4-layer --n_head 1 (d_head 768) model trained 3 steps and
     served from the int8 and bf16 caches; one train step under each of
     split, fused/column and fused/dist at 4 layers of --n_head 3 and of
     --n_head 1; a 4-layer --n_head 1 model trained 2 steps at B 2 in f32;
  6. serve a 2-layer d_head-40 model (d_model 640, random weights): its
     stacked int8 and bf16 decode steps against its native ones, then
     Sampler.generate through each stacked cache; serve the trained work
     dir: the stacked int8 and bf16 decode steps against the native ones
     (logits within the JAX package's bounds); then
     the port's generation CLI (bf16, batch 4, 1400 tokens, window 1216, so
     the window refreshes at T = 1216) with the native cache and with
     --kv_dtype int8, checking the MIDI files and the sampled ids; a short
     int8 run with MIDI_EMOTION_DECODE_STAGE=0 (the unstaged kernel mode);
     and generate() with a varying condition through generate_exact;
  7. time generation alone, at the smoke's shape and at the headline shape
     (batch 64, 1024 tokens, window 1216, top-p 0.7) with the native, int8
     and bf16 caches in turn, and profile 8 decode steps at B 64 (native
     and int8): device-busy share and the top kernels per step.
Each path (the dropout-0.1 training run with its resume, the dropout-0
run, the three decomposition runs, phase 5b's five, phase 5c's three remat
runs and each mesh rank's run, phase 5d's twelve training runs and nine
generation runs, the d_head-40 model's generation, each generation run)
runs with every
kernel launch counter set to 0 just before it and read just after; the
script fails if a kernel of that path was never launched, or if a
decomposition run or the MIDI_EMOTION_FLASH_BWD=xla run launched the
merged backward kernel; phase 5's split, fused/column and fused/dist runs
also fail unless kernels 5-8 launched their Hopper form, and those and
phase 5d's decomposition runs if one of them launched another form at
d_head up to 128.

The second-to-last line is a JSON object with each kernel's launches,
error, times and bound; the last line is {"ok": true, "device": {...}}.
"""

import contextlib
import csv
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = dict(vocab_size=1007, mode="continuous_concat", n_layer=20, n_head=16,
                d_model=768, d_inner=3072, d_condition=192, max_seq=2048, dropout=0.1)
SEED = 0
TRAIN_B, TRAIN_T = 8, 1216
# H100 SXM published peaks (NVIDIA's data sheet): HBM bytes/s;
# dense bf16 tensor-core FLOP/s; f32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(torch, fn, iters=20, warmup=3):
    """Mean device time of fn() in ms, by CUDA events around `iters` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters=20, warmup=3, only=None, per_call=1):
    """Mean device time of fn() in ms: the summed durations of the CUDA
    kernels it launched (those whose name holds ``only``, when given), by
    torch.profiler (CUPTI), over ``iters`` runs of at least ``per_call``
    kernels each. Unlike CUDA events around back-to-back launches, this
    leaves out the gaps in which the card waits for the host to launch the
    next kernel."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and (only is None or only in e.key)]
        # the card's profiler can drop kernel records under back-to-back
        # launches; every call launches at least per_call kernels, and each
        # kernel as often as every other call, so a window with fewer
        # records, or with a kernel's count not a multiple of the calls,
        # lost some: profile it again
        if (sum(e.count for e in events) >= iters * per_call
                and all(e.count % iters == 0 for e in events)):
            break
    else:
        print(f"device_ms: the profiler kept {sum(e.count for e in events)} kernel records "
              f"of {iters} calls of {per_call} in each of 3 windows; the time below undercounts")
    return sum(e.self_device_time_total for e in events) / 1e3 / iters


def bound(n_bytes, n_flops, flops_type):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the operations over the peak rate for their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_FLOPS[flops_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dtype_name(dtype):
    return str(dtype).replace("torch.", "").replace("float32", "f32").replace("bfloat16", "bf16")


def _rel_err(a, b):
    """max |a - b| and the reference's max |b|, in f32."""
    return (a.float() - b.float()).abs().max().item(), b.float().abs().max().item()


def _report(torch, out, timed, name, kernel_fn, plain_fn, library_fn=None, iters=20,
            kernel_only=None, per_call=1):
    """With ``timed``, time the kernel, its plain twin and, where there is
    one, the library call, into ``out``: device time (``device_ms``) for
    the JSON line, and CUDA-event time per call printed beside it. With
    ``kernel_only``, the kernel's device time counts only the kernels whose
    name holds it (not the wrapper's small torch ops around the launch);
    ``per_call``: the kernels a call of the kernel's wrapper launches."""
    if not timed:
        return out
    fns = {"ms": kernel_fn, "plain_ms": plain_fn, "library_ms": library_fn}
    n = {"ms": iters, "plain_ms": max(2, iters // 10), "library_ms": iters}
    events = {}
    for key, fn in fns.items():
        only, per = (kernel_only, per_call) if key == "ms" else (None, 1)
        out[key] = None if fn is None else device_ms(torch, fn, iters=n[key], only=only,
                                                     per_call=per)
        events[key] = None if fn is None else time_ms(torch, fn, iters=n[key])
    show = lambda key: "-" if out[key] is None else f"{out[key]:.4f} ({events[key]:.4f})"
    print(f"{name}: device ms (event ms per call): kernel {show('ms')}, plain "
          f"{show('plain_ms')}, library {show('library_ms')}; bound {out['bound_ms']:.4f} ms "
          f"({out['bound_by']})")
    return out


# ---------------------------------------------------------------------------
# phase 3: each kernel against its twin
# ---------------------------------------------------------------------------


def visible_pairs(torch, pad, H, causal):
    """(query row, key) pairs the masks leave visible, over every head."""
    live = (~pad).double()  # [B, T]
    T = pad.shape[1]
    if causal:  # key j is seen by rows j..T-1
        rows = T - torch.arange(T, device=pad.device, dtype=torch.float64)
        per_b = (live * rows).sum(-1)
    else:
        per_b = live.sum(-1) * T
    return int(per_b.sum().item()) * H


def _flash_inputs(torch, B, H, T, dh, dtype):
    g = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v = (torch.randn((B, H, T, dh), generator=g, device="cuda").to(dtype)
               for _ in range(3))
    e = torch.randn((FLAGSHIP["max_seq"], dh), generator=g, device="cuda").to(dtype)
    pad = torch.zeros((B, T), dtype=torch.bool, device="cuda")
    if B > 1:  # batch row 1: key 0 pad (row 0 sees no key) and a pad tail
        pad[1, 0] = True
        pad[1, T - T // 6:] = True
    return q, k, v, e, pad


def check_flash(torch, B, H, T, dh, dtype, causal, tol_o, tol_lse, timed=False, rel=False):
    """Kernel 1 against its twin: O within tol_o (times 1 + max |O| with
    ``rel``), lse within tol_lse, and the fully masked row's O = 0, lse =
    1e30; with ``timed``, its times beside SDPA's and the bound."""
    from midi_emotion_tpu_torch.ops.flash_attention import (
        flash_rel_attention, flash_rel_attention_plain)

    q, k, v, e, pad = _flash_inputs(torch, B, H, T, dh, dtype)
    o, lse = flash_rel_attention(q, k, v, e, causal, pad)
    torch.cuda.synchronize()
    ro, rlse = flash_rel_attention_plain(q, k, v, e, causal, pad)
    if not (torch.isfinite(o).all() and torch.isfinite(lse).all()):
        fail(f"flash {dtype} B={B} T={T}: non-finite output")
    err_o = (o.float() - ro.float()).abs().max().item()
    err_lse = (lse - rlse).abs().max().item()
    if rel:
        tol_o *= 1 + ro.float().abs().max().item()
    name = f"flash fwd {dtype_name(dtype)} B={B} H={H} T={T} dh={dh} causal={causal}"
    print(f"{name}: max|dO|={err_o:.3e} (tol {tol_o}) max|dlse|={err_lse:.3e} (tol {tol_lse})")
    if not (err_o <= tol_o and err_lse <= tol_lse):
        fail(f"{name}: kernel disagrees with its plain twin")
    if causal and B > 1 and not (o[1, :, 0].eq(0).all() and rlse[1, :, 0].eq(1e30).all()
                                 and lse[1, :, 0].eq(1e30).all()):
        fail(f"{name}: the fully masked row is not O = 0, lse = 1e30")
    el = q.element_size()
    n_bytes = 4 * q.numel() * el + e.numel() * el + pad.numel() + lse.numel() * 4
    out = {"max_abs_err": err_o}
    out["bound_ms"], out["bound_by"] = bound(
        n_bytes, visible_pairs(torch, pad, H, causal) * 6 * dh, dtype_name(dtype))
    library = None
    if timed:
        # F.scaled_dot_product_attention computing O as the kernel does: the
        # skewed relative logits, the causal and the pad masks folded into a
        # float mask built outside the timing (SDPA scales q.k by 1/sqrt(dh)
        # itself and adds the mask as it is)
        import torch.nn.functional as F

        from midi_emotion_tpu_torch.ops.attention import rel_position_bias
        from midi_emotion_tpu_torch.ops.flash_attention import _masked

        mask = (rel_position_bias(q.float(), e.float()) / dh ** 0.5).masked_fill(
            _masked(T, causal, pad, q.device), float("-inf")).to(dtype)

        def library():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

    return _report(torch, out, timed, name,
                   lambda: flash_rel_attention(q, k, v, e, causal, pad),
                   lambda: flash_rel_attention_plain(q, k, v, e, causal, pad), library)


# kernel 4's launches in one call of its wrapper: label -> a substring of
# the kernel's name (main: flash_bwd_tc_kernel up to d_head 128, the
# cluster's wide_bwd_tc_cluster_kernel past it)
BWD_LAUNCHES = (("dsum", "dsum"), ("main", "_bwd_tc_"),
                ("dq_reduce", "dq_reduce_kernel"), ("de_reduce", "de_reduce_kernel"))


def check_flash_bwd(torch, B, H, T, dh, dtype, causal, tol, timed=False, launches=False):
    """dQ, dK, dV, dE against the twin, with a fully masked row and a pad
    tail; each gradient within tol * (1 + its max |value|). With ``timed``
    and ``launches`` (bf16), also each of the call's launches apart
    (``BWD_LAUNCHES``), into ``launch_ms``."""
    from midi_emotion_tpu_torch.ops.flash_attention import (
        flash_rel_attention, flash_rel_attention_bwd, flash_rel_attention_bwd_plain)

    q, k, v, e, pad = _flash_inputs(torch, B, H, T, dh, dtype)
    o, lse = flash_rel_attention(q, k, v, e, causal, pad)
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    do = (torch.randn(o.shape, generator=g, device="cuda") * (~pad)[:, None, :, None]).to(dtype)
    got = flash_rel_attention_bwd(q, k, v, e, causal, pad, o, lse, do)
    torch.cuda.synchronize()
    want = flash_rel_attention_bwd_plain(q, k, v, e, causal, pad, o, lse, do)
    name = f"flash bwd {dtype_name(dtype)} B={B} H={H} T={T} dh={dh} causal={causal}"
    worst = 0.0
    for grad, a, b in zip(("dQ", "dK", "dV", "dE"), got, want):
        err, scale = _rel_err(a, b)
        print(f"{name}: max|{grad} err|={err:.3e} (tol {tol * (1 + scale):.3e})")
        if not (torch.isfinite(a).all() and err <= tol * (1 + scale)):
            fail(f"{name}: {grad} disagrees with its plain twin")
        worst = max(worst, err)
    if causal and not got[0][1, :, 0].eq(0).all():
        fail(f"{name}: the fully masked row has a nonzero dQ")
    el = q.element_size()
    n_bytes = (8 * q.numel() + 2 * e.numel()) * el + pad.numel() + lse.numel() * 4
    out = {"max_abs_err": worst}
    out["bound_ms"], out["bound_by"] = bound(
        n_bytes, visible_pairs(torch, pad, H, causal) * 16 * dh, dtype_name(dtype))
    library = None
    if timed:
        # F.scaled_dot_product_attention's backward with the relative, causal
        # and pad logits as a float mask that requires grad, its graph built
        # outside the timing: dQ, dK, dV, and dS' as the mask's grad (dE would
        # follow from dS' by a skewed reduction, not timed)
        import torch.nn.functional as F

        from midi_emotion_tpu_torch.ops.attention import rel_position_bias
        from midi_emotion_tpu_torch.ops.flash_attention import _masked

        mask = (rel_position_bias(q.float(), e.float()) / dh ** 0.5).masked_fill(
            _masked(T, causal, pad, q.device), float("-inf")).to(dtype).requires_grad_()
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out_l = F.scaled_dot_product_attention(*leaves, attn_mask=mask)

        def library():
            return torch.autograd.grad(out_l, (*leaves, mask), do, retain_graph=True)

    # the kernel's time: the whole wrapper call, its dsum, backward kernel
    # and reductions, every one of them the port's own
    call = lambda: flash_rel_attention_bwd(q, k, v, e, causal, pad, o, lse, do)
    out = _report(torch, out, timed, name, call,
                  lambda: flash_rel_attention_bwd_plain(q, k, v, e, causal, pad, o, lse, do),
                  library, iters=5)
    if timed and launches:
        out["launch_ms"] = {label: device_ms(torch, call, iters=10, only=only)
                            for label, only in BWD_LAUNCHES}
        print(f"{name}: device ms by launch " +
              ", ".join(f"{k} {v:.4f}" for k, v in out["launch_ms"].items()))
    return out


# the other backward decompositions' kernels: JSON name -> (its wrapper in
# ops/flash_attention.py, its outputs, operations / dh per visible (query,
# key) pair, and per visible pair at a distance i - j >= 0, which alone
# reaches the relative terms); an operation is a multiply or an add. The
# dist kernel does the column kernel's products: its dsd is the scattered
# dS', not a second S, dP and band by distance
BWD_KERNELS = {
    "flash_rel_attn_bwd_dq_de": ("bwd_dq_de", ("dQ", "dE"), 8, 4),
    "flash_rel_attn_bwd_dq_de_dist": ("bwd_dq_de_dist", ("dQ", "dE"), 8, 4),
    "flash_rel_attn_bwd_dkdv_dq": ("bwd_dkdv_dq", ("dK", "dV", "dQ_qk"), 12, 0),
    "flash_rel_attn_bwd_de_dqrel": ("bwd_de_dqrel", ("dQ_rel", "dE"), 0, 10),
    "flash_rel_attn_bwd_dkdv": ("bwd_dkdv", ("dK", "dV"), 10, 0),
}
# (MIDI_EMOTION_BWD, MIDI_EMOTION_DQDE) -> the kernels that decomposition launches
DECOMPOSITIONS = {
    ("split", "column"): ("flash_rel_attn_bwd_dkdv_dq", "flash_rel_attn_bwd_de_dqrel"),
    ("fused", "column"): ("flash_rel_attn_bwd_dq_de", "flash_rel_attn_bwd_dkdv"),
    ("fused", "dist"): ("flash_rel_attn_bwd_dq_de_dist", "flash_rel_attn_bwd_dkdv"),
}


@contextlib.contextmanager
def bwd_decomposition(impl, dqde):
    """MIDI_EMOTION_BWD and MIDI_EMOTION_DQDE set inside, restored after."""
    old = {k: os.environ.get(k) for k in ("MIDI_EMOTION_BWD", "MIDI_EMOTION_DQDE")}
    os.environ.update({"MIDI_EMOTION_BWD": impl, "MIDI_EMOTION_DQDE": dqde})
    try:
        yield
    finally:
        for k, val in old.items():
            if val is None:
                del os.environ[k]
            else:
                os.environ[k] = val


def _bwd_args(torch, B, H, T, dh, dtype, causal):
    """(q, k, v, e, causal, pad, lse, dsum, dO) for a backward kernel: the
    forward kernel's lse, a cotangent zero on pad rows."""
    from midi_emotion_tpu_torch.ops import flash_attention as fa

    q, k, v, e, pad = _flash_inputs(torch, B, H, T, dh, dtype)
    o, lse = fa.flash_rel_attention(q, k, v, e, causal, pad)
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    do = (torch.randn(o.shape, generator=g, device="cuda") * (~pad)[:, None, :, None]).to(dtype)
    dsum = (do.float() * o.float()).sum(-1)
    return q, k, v, e, causal, pad, lse, dsum, do


def check_bwd_kernel(torch, kernel, B, H, T, dh, dtype, causal, tol, timed=False, **kw):
    """One of the other decompositions' kernels against its twin, with a
    fully masked row and a pad tail; each output within tol * (1 + its max
    |value|), and a zero dQ on the masked row. ``kw`` goes to the kernel's
    wrapper (kernel 7's ``split``)."""
    from midi_emotion_tpu_torch.ops import flash_attention as fa

    wrapper_name, names, ops_pair, ops_dist = BWD_KERNELS[kernel]
    wrapper, twin = getattr(fa, wrapper_name), getattr(fa, wrapper_name + "_plain")
    args = _bwd_args(torch, B, H, T, dh, dtype, causal)
    q, k, v, e, _, pad, lse, _, _ = args
    got = wrapper(*args, **kw)
    torch.cuda.synchronize()
    want = twin(*args)
    name = (f"{kernel} {dtype_name(dtype)} B={B} H={H} T={T} dh={dh} causal={causal}"
            + "".join(f" {key}={val}" for key, val in kw.items()))
    worst = 0.0
    for grad, a, b in zip(names, got, want):
        err, scale = _rel_err(a, b)
        print(f"{name}: max|{grad} err|={err:.3e} (tol {tol * (1 + scale):.3e})")
        if not (a.dtype == b.dtype and torch.isfinite(a).all() and err <= tol * (1 + scale)):
            fail(f"{name}: {grad} disagrees with its plain twin")
        if causal and grad.startswith("dQ") and not a[1, :, 0].eq(0).all():
            fail(f"{name}: the fully masked row has a nonzero {grad}")
        worst = max(worst, err)
    el = q.element_size()
    n_out = sum(e.numel() if grad == "dE" else q.numel() for grad in names)
    n_bytes = (4 * q.numel() + e.numel() + n_out) * el + pad.numel() + 2 * lse.numel() * 4
    n_ops = (visible_pairs(torch, pad, H, causal) * ops_pair
             + visible_pairs(torch, pad, H, True) * ops_dist) * dh
    out = {"max_abs_err": worst}
    out["bound_ms"], out["bound_by"] = bound(n_bytes, n_ops, dtype_name(dtype))
    return _report(torch, out, timed, name, lambda: wrapper(*args, **kw), lambda: twin(*args),
                   iters=5)


def check_bwd_decompositions(torch, tol=2e-2):
    """Each decomposition's backward against the merged kernel at the
    flagship backward shape in bf16: dQ, dK, dV and dE within tol of each
    gradient's scale (every route sums in f32; split rounds its two dQ
    halves to bf16 before their f32 sum, as the JAX package does)."""
    from midi_emotion_tpu_torch.ops import flash_attention as fa

    q, k, v, e, pad = _flash_inputs(torch, TRAIN_B, 16, TRAIN_T, 48, torch.bfloat16)
    o, lse = fa.flash_rel_attention(q, k, v, e, True, pad)
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    do = (torch.randn(o.shape, generator=g, device="cuda") * (~pad)[:, None, :, None]).bfloat16()
    with bwd_decomposition("merged", "column"):
        want = fa.flash_rel_attention_bwd(q, k, v, e, True, pad, o, lse, do)
    for impl, dqde in DECOMPOSITIONS:
        with bwd_decomposition(impl, dqde):
            got = fa.flash_rel_attention_bwd(q, k, v, e, True, pad, o, lse, do)
        torch.cuda.synchronize()
        errs = []
        for grad, a, b in zip(("dQ", "dK", "dV", "dE"), got, want):
            err, scale = _rel_err(a, b)
            errs.append(f"{grad} {err:.3e} (tol {tol * (1 + scale):.3e})")
            if not (torch.isfinite(a).all() and err <= tol * (1 + scale)):
                fail(f"backward {impl}/{dqde} disagrees with the merged kernel on {grad}")
        print(f"backward MIDI_EMOTION_BWD={impl} DQDE={dqde} vs merged kernel, bf16 B={TRAIN_B} "
              f"H=16 T={TRAIN_T} dh=48: max err " + ", ".join(errs))


def check_query_sweep_kernels(torch, kernels):
    """Kernels 5, 6 and 8 (``QUERY_SWEEP_KERNELS``) or 7
    (``KEY_SWEEP_KERNELS``, on one and on two blocks a (b, h): its
    ``split``) in bf16, on their Hopper form (``form`` "wgmma"): against
    their twins at every d_head they are built for and at 40 (padded to
    48), causal and not, T 200 with a pad tail and a fully masked row, at
    the BWD_KERNELS checks' bf16 tolerance (2e-2 of each output's scale);
    each call launched that form; and two calls on the same inputs give
    bitwise-equal outputs (the dQ or dE partials summed in block order), at
    T 333 and at the flagship backward shape; kernel 7's dK and dV bitwise
    equal on its two splits (each key tile sums its query tiles in one
    order)."""
    from midi_emotion_tpu_torch.ops import flash_attention as fa

    for kernel in kernels:
        wrapper = getattr(fa, BWD_KERNELS[kernel][0])
        splits = ({"split": 1}, {"split": 2}) if kernel in KEY_SWEEP_KERNELS else ({},)
        for kw in splits:
            for dh in (*fa.DECOMPOSITION_DHS, 40):
                for causal in (True, False):
                    before = dict(wrapper.form_launches)
                    check_bwd_kernel(torch, kernel, 2, 4, 200, dh, torch.bfloat16, causal, 2e-2,
                                     **kw)
                    grew = {f: n - before[f] for f, n in wrapper.form_launches.items()
                            if n != before[f]}
                    if grew != {"wgmma": 1}:
                        fail(f"{kernel} bf16 dh={dh} causal={causal} {kw}: launched {grew}, not "
                             f"the wgmma form once")
        for shape in ((2, 4, 333, dh, causal) for dh in fa.DECOMPOSITION_DHS
                      for causal in (True, False)):
            args = _bwd_args(torch, *shape[:4], torch.bfloat16, shape[4])
            outs = []
            for kw in splits:
                first, second = wrapper(*args, **kw), wrapper(*args, **kw)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(first, second)):
                    fail(f"{kernel} bf16 B, H, T, dh, causal = {shape} {kw}: two calls differ")
                outs.append(first)
            if len(outs) == 2 and not all(torch.equal(a, b)
                                          for a, b in zip(outs[0][:2], outs[1][:2])):
                fail(f"{kernel} bf16 B, H, T, dh, causal = {shape}: dK, dV differ between splits")
        args = _bwd_args(torch, TRAIN_B, 16, TRAIN_T, 48, torch.bfloat16, True)
        first, second = wrapper(*args), wrapper(*args)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            fail(f"{kernel} bf16 at the flagship backward shape: two calls differ")
        print(f"{kernel}: bf16 wgmma form matches its twin at d_head "
              f"{fa.DECOMPOSITION_DHS} and 40, causal and not"
              + (", on one and two blocks a (b, h)" if len(splits) == 2 else "")
              + f"; two calls give bitwise-equal outputs at T 333 (every d_head) and "
              f"B={TRAIN_B} H=16 T={TRAIN_T} dh=48")
        del args, first, second
        torch.cuda.empty_cache()


def check_column_is_dist(torch):
    """Kernel 5 in bf16 runs kernel 6's instantiation (the two compute the
    same products on the same tiles on the card): their dQ and dE bitwise
    equal at every d_head and 40, causal and not, T 333, and at the
    flagship backward shape."""
    from midi_emotion_tpu_torch.ops import flash_attention as fa

    shapes = [(2, 4, 333, dh, causal) for dh in (*fa.DECOMPOSITION_DHS, 40)
              for causal in (True, False)] + [(TRAIN_B, 16, TRAIN_T, 48, True)]
    for shape in shapes:
        args = _bwd_args(torch, *shape[:4], torch.bfloat16, shape[4])
        column, dist = fa.bwd_dq_de(*args), fa.bwd_dq_de_dist(*args)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(column, dist)):
            fail(f"kernel 5 bf16 B, H, T, dh, causal = {shape}: dQ, dE not bitwise kernel 6's")
    print(f"kernel 5: bf16 dQ and dE bitwise kernel 6's at d_head {fa.DECOMPOSITION_DHS} and 40, "
          f"causal and not, and B={TRAIN_B} H=16 T={TRAIN_T} dh=48")


def _rows(torch, rows, D, dtype, n, seed=SEED):
    g = torch.Generator(device="cuda").manual_seed(seed)
    xs = [(torch.randn((rows, D), generator=g, device="cuda") * 3 + 1).to(dtype)
          for _ in range(n)]
    w = torch.randn((D,), generator=g, device="cuda")
    b = torch.randn((D,), generator=g, device="cuda")
    return xs, w, b


def check_layernorm(torch, rows, D, dtype, tol, timed=False):
    import torch.nn.functional as F

    from midi_emotion_tpu_torch.ops.layernorm import layernorm, layernorm_ref

    (x,), w, b = _rows(torch, rows, D, dtype, 1)
    y = layernorm(x, w, b)
    torch.cuda.synchronize()
    ref = layernorm_ref(x, w, b)
    if y.dtype != dtype or not torch.isfinite(y).all():
        fail(f"layernorm {dtype}: wrong dtype or non-finite output")
    err, scale = _rel_err(y, ref)
    name = f"ln fwd {dtype_name(dtype)} [{rows}, {D}]"
    print(f"{name}: max|dy|={err:.3e} (tol {tol * (1 + scale):.3e})")
    if not err <= tol * (1 + scale):
        fail(f"{name}: kernel disagrees with its plain twin")
    out = {"max_abs_err": err}
    out["bound_ms"], out["bound_by"] = bound(
        2 * x.numel() * x.element_size() + 2 * D * 4, 8 * x.numel(), "f32")
    w_lib, b_lib = w.to(dtype), b.to(dtype)  # F.layer_norm takes x's type
    return _report(torch, out, timed, name, lambda: layernorm(x, w, b),
                   lambda: layernorm_ref(x, w, b),
                   lambda: F.layer_norm(x, (D,), w_lib, b_lib, 1e-6), iters=100)


def check_layernorm_bwd(torch, rows, D, dtype, tol, timed=False):
    """dx within tol * (1 + max|dx|); dgamma, dbeta (f32 sums over the
    rows) within 1e-5 * (1 + their max)."""
    import torch.nn.functional as F

    from midi_emotion_tpu_torch.ops.layernorm import layernorm_bwd, layernorm_bwd_ref

    (x, dy), w, _ = _rows(torch, rows, D, dtype, 2, seed=SEED + 2)
    got = layernorm_bwd(x, dy, w)
    torch.cuda.synchronize()
    want = layernorm_bwd_ref(x, dy, w)
    name = f"ln bwd {dtype_name(dtype)} [{rows}, {D}]"
    worst = 0.0
    for grad, a, r, t in zip(("dx", "dgamma", "dbeta"), got, want, (tol, 1e-5, 1e-5)):
        err, scale = _rel_err(a, r)
        print(f"{name}: max|{grad} err|={err:.3e} (tol {t * (1 + scale):.3e})")
        if not err <= t * (1 + scale):
            fail(f"{name}: {grad} disagrees with its plain twin")
        worst = max(worst, err)
    out = {"max_abs_err": worst}
    out["bound_ms"], out["bound_by"] = bound(
        3 * x.numel() * x.element_size() + 3 * D * 4, 12 * x.numel(), "f32")
    xr = x.detach().clone().requires_grad_()
    wr = w.to(dtype).requires_grad_()
    br = torch.zeros_like(wr, requires_grad=True)

    def library():  # one F.layer_norm forward and its autograd backward
        torch.autograd.grad(F.layer_norm(xr, (D,), wr, br, 1e-6), (xr, wr, br), dy)

    return _report(torch, out, timed, name, lambda: layernorm_bwd(x, dy, w),
                   lambda: layernorm_bwd_ref(x, dy, w), library, iters=50, per_call=2)


def check_dropout(torch, rows, D, dtype, rate, timed=False):
    """Keep fraction within 6 binomial standard deviations of 1 - rate;
    the backward's mask is the forward's; a fixed seed reproduces, a new
    one differs; the twin given the recovered mask matches exactly."""
    import torch.nn.functional as F

    from midi_emotion_tpu_torch.ops import fused_dropout as fd

    name = f"dropout {dtype_name(dtype)} [{rows}, {D}] rate {rate}"
    ones = torch.ones((rows, D), dtype=dtype, device="cuda")
    keep = fd.fused_dropout(ones, 1234, rate) != 0
    frac = keep.float().mean().item()
    sd = (rate * (1 - rate) / keep.numel()) ** 0.5
    print(f"{name}: keep fraction {frac:.6f} (1 - rate = {1 - rate}, 6 sd = {6 * sd:.2e})")
    if abs(frac - (1 - rate)) > 6 * sd:
        fail(f"{name}: keep fraction off")
    if not torch.equal(fd.fused_dropout(ones, 1234, rate) != 0, keep):
        fail(f"{name}: a fixed seed does not reproduce its mask")
    if torch.equal(fd.fused_dropout(ones, 1235, rate) != 0, keep):
        fail(f"{name}: a new seed draws the same mask")
    (x,), _, _ = _rows(torch, rows, D, dtype, 1, seed=SEED + 3)
    xg = x.clone().requires_grad_()
    y = fd.fused_dropout(xg, 1234, rate)
    y.backward(torch.ones_like(y))
    if not torch.equal(xg.grad != 0, keep):
        fail(f"{name}: the backward's mask is not the forward's")
    err = (y.detach().float() - fd.dropout_plain(x, keep, rate).float()).abs().max().item()
    print(f"{name}: max|dy| against the twin with the recovered mask {err:.3e} (tol 0)")
    if err != 0:
        fail(f"{name}: kernel disagrees with its plain twin")
    out = {"max_abs_err": err}
    out["bound_ms"], out["bound_by"] = bound(2 * x.numel() * x.element_size(),
                                             2 * x.numel(), "f32")
    return _report(torch, out, timed, name, lambda: fd.fused_dropout(x, 1234, rate),
                   lambda: fd.dropout_plain(x, keep, rate),
                   lambda: F.dropout(x, rate, training=True), iters=100)


def check_dal(torch, rows, D, dtype, rate, tol, timed=False):
    """LN(res + dropout(sub)) and its backward against the twins given the
    mask recovered from the dropout kernel (same seed and shape, so the
    same Philox counters)."""
    from midi_emotion_tpu_torch.ops import fused_dropout as fd

    (sub, res, dy), w, b = _rows(torch, rows, D, dtype, 3, seed=SEED + 4)
    seed = 77
    keep = fd.fused_dropout(torch.ones_like(sub), seed, rate) != 0
    y = fd.dropout_add_layernorm(sub, res, w, b, seed, rate)
    torch.cuda.synchronize()
    err_y, scale = _rel_err(y, fd.dropout_add_layernorm_plain(sub, res, w, b, keep, rate))
    name = f"dal fwd {dtype_name(dtype)} [{rows}, {D}]"
    print(f"{name}: max|dy|={err_y:.3e} (tol {tol * (1 + scale):.3e})")
    if not err_y <= tol * (1 + scale):
        fail(f"{name}: kernel disagrees with its plain twin")
    fwd = {"max_abs_err": err_y}
    fwd["bound_ms"], fwd["bound_by"] = bound(
        3 * sub.numel() * sub.element_size() + 2 * D * 4, 10 * sub.numel(), "f32")
    _report(torch, fwd, timed, name, lambda: fd.dropout_add_layernorm(sub, res, w, b, seed, rate),
            lambda: fd.dropout_add_layernorm_plain(sub, res, w, b, keep, rate), iters=100)

    got = fd.dropout_add_layernorm_bwd(sub, res, dy, w, seed, rate)
    want = fd.dropout_add_layernorm_bwd_plain(sub, res, dy, w, keep, rate)
    name = f"dal bwd {dtype_name(dtype)} [{rows}, {D}]"
    worst = 0.0
    for grad, a, r, t in zip(("dsub", "dres", "dgamma", "dbeta"), got, want,
                             (tol, tol, 1e-5, 1e-5)):
        err, scale = _rel_err(a, r)
        print(f"{name}: max|{grad} err|={err:.3e} (tol {t * (1 + scale):.3e})")
        if not err <= t * (1 + scale):
            fail(f"{name}: {grad} disagrees with its plain twin")
        worst = max(worst, err)
    bwd = {"max_abs_err": worst}
    bwd["bound_ms"], bwd["bound_by"] = bound(
        5 * sub.numel() * sub.element_size() + 3 * D * 4, 14 * sub.numel(), "f32")
    _report(torch, bwd, timed, name,
            lambda: fd.dropout_add_layernorm_bwd(sub, res, dy, w, seed, rate),
            lambda: fd.dropout_add_layernorm_bwd_plain(sub, res, dy, w, keep, rate), iters=50,
            per_call=2)
    return fwd, bwd


def check_dropout_places(torch, card):
    """Kernels 10, 11 and 12 at a mesh rank's place in the flagship's global
    [8, 1216, 768] bf16 activation: a data rank's rows 4..7 and a seq rank's
    positions 608..1215. Each must give the global call's outputs at its
    elements, bit for bit, and is timed beside the same slice at the
    default place (the code path of one process)."""
    from midi_emotion_tpu_torch.ops import fused_dropout as fd

    rate, seed = 0.1, 77
    (sub, res, dy), w, b = _rows(torch, TRAIN_B * TRAIN_T, 768, torch.bfloat16, 3,
                                 seed=SEED + 5)
    sub, res, dy = (t.view(TRAIN_B, TRAIN_T, 768) for t in (sub, res, dy))
    y = fd.fused_dropout(sub, seed, rate)
    z = fd.dropout_add_layernorm(sub, res, w, b, seed, rate)
    ds, dr, _, _ = fd.dropout_add_layernorm_bwd(sub, res, dy, w, seed, rate)
    half = TRAIN_T // 2
    for label, at, place in (
            ("data rank 1 of 2", (slice(4, 8), slice(None)), (4, 0, TRAIN_T)),
            ("seq rank 1 of 2", (slice(None), slice(half, None)), (0, half, TRAIN_T))):
        ps, pr, pdy = (t[at].contiguous() for t in (sub, res, dy))
        calls = {
            "dropout": lambda pl: fd.fused_dropout(ps, seed, rate, place=pl),
            "dal_fwd": lambda pl: fd.dropout_add_layernorm(ps, pr, w, b, seed, rate, place=pl),
            "dal_bwd": lambda pl: fd.dropout_add_layernorm_bwd(ps, pr, pdy, w, seed, rate,
                                                                place=pl),
        }
        got = {k: fn(place) for k, fn in calls.items()}
        same = (torch.equal(got["dropout"], y[at]) and torch.equal(got["dal_fwd"], z[at])
                and torch.equal(got["dal_bwd"][0], ds[at])
                and torch.equal(got["dal_bwd"][1], dr[at]))
        times = {}
        for k, fn in calls.items():
            per_call = 2 if k == "dal_bwd" else 1  # its row pass and col_sum
            times[k] = tuple(device_ms(torch, lambda: fn(pl), iters=100, per_call=per_call)
                             for pl in (place, None))
        print(f"dropout kernels at place {place} ({label}, bf16 {list(ps.shape)}): the global "
              f"call's outputs at the slice {'bitwise' if same else 'NOT bitwise'}; ms at the "
              f"place / at the default place: "
              + ", ".join(f"{k} {a:.4f} / {d:.4f}" for k, (a, d) in times.items())
              + f" on {card}")
        if not same:
            fail(f"dropout kernels at place {place}: the slice differs from the global call's")
    del sub, res, dy, y, z, ds, dr
    torch.cuda.empty_cache()


def time_ln_bwd_passes(torch, rows, D, card):
    """ln_bwd's row pass apart from its dgamma/dbeta reduction (col_sum),
    kernel 12 (with dropout) and kernel 3, bf16 [rows, D]."""
    from midi_emotion_tpu_torch.ops import fused_dropout as fd
    from midi_emotion_tpu_torch.ops import layernorm_triton as lt

    (sub, res, dy), w, _ = _rows(torch, rows, D, torch.bfloat16, 3, seed=SEED + 4)
    ds, dr = torch.empty_like(sub), torch.empty_like(res)
    rate = 0.1
    for name, args in (("kernel 12", (res, sub, dy, w, dr, ds, 1e-6, 77, fd.keep_threshold(rate),
                                      1.0 / (1.0 - rate))),
                       ("kernel 3", (res, None, dy, w, dr, None, 1e-6))):
        part = lt.ln_bwd_launch(*args, reduce=False)
        row_ms = device_ms(torch, lambda: lt.ln_bwd_launch(*args, reduce=False), iters=100)
        sum_ms = device_ms(torch, lambda: lt.col_sum_launch(part), iters=100)
        print(f"ln_bwd {name} bf16 [{rows}, {D}]: row pass {row_ms:.4f} ms, dgamma/dbeta "
              f"reduction (col_sum over {part.shape[1]} partials) {sum_ms:.4f} ms on {card}")


def time_dkdv_grids(torch, card, tol=2e-2):
    """Kernel 9 (bf16, the flagship backward shape, causal, pad tail) on
    its two grids: one block per (b, h, key tile), the wrapper's default,
    and two blocks a (b, h) on alternate key tiles; dK and dV bitwise
    equal on the two, and within tol of each output's scale of kernel 7's
    (the same sums in the same order, on wgmma there, mma.sync here)."""
    from midi_emotion_tpu_torch.ops import flash_attention as fa

    q, k, v, e, pad = _flash_inputs(torch, TRAIN_B, 16, TRAIN_T, 48, torch.bfloat16)
    o, lse = fa.flash_rel_attention(q, k, v, e, True, pad)
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    do = (torch.randn(o.shape, generator=g, device="cuda") * (~pad)[:, None, :, None]).bfloat16()
    args = (q, k, v, e, True, pad, lse, (do.float() * o.float()).sum(-1), do)
    # each key tile sums the same products in the same order on either grid
    grids = [fa.bwd_dkdv(*args, split=split) for split in (None, 2)]
    if not all(torch.equal(a, b) for a, b in zip(*grids)):
        fail("kernel 9: dK, dV differ between its two grids")
    for grad, a, b in zip(("dK", "dV"), grids[0], fa.bwd_dkdv_dq(*args)[:2]):
        err, scale = _rel_err(a, b)
        if err > tol * (1 + scale):
            fail(f"kernel 9: {grad} off kernel 7's by {err:.3e} (tol {tol * (1 + scale):.3e})")
    times = {split: device_ms(torch, lambda: fa.bwd_dkdv(*args, split=split), iters=20)
             for split in (None, 2, None, 2)}  # each twice, in turns; the second kept
    print(f"kernel 9 grids, bf16 B={TRAIN_B} H=16 T={TRAIN_T} dh=48: one block per key tile "
          f"{times[None]:.4f} ms, two blocks a (b, h) {times[2]:.4f} ms, dK and dV bitwise "
          f"equal on both and within {tol} of kernel 7's, on {card}")


# the flagship's serving cache: W 1408 is w_max for window 1216 with the
# default hop (1216 // 8), rounded up to 128
DECODE = dict(L=20, B=64, W=1408, H=16, dh=48, S=8)


# the head shapes past the flagship's, at a small cache: d_head 96 and 128,
# a width above 1024 (two head groups of 5), and d_head 40, which the cache
# lays out at 48 columns a head
DECODE_SHAPES = (dict(L=2, B=4, W=256, H=8, dh=96, S=8), dict(L=2, B=4, W=256, H=8, dh=128, S=8),
                 dict(L=2, B=4, W=256, H=10, dh=128, S=8), dict(L=2, B=4, W=256, H=16, dh=40, S=8),
                 dict(L=2, B=4, W=256, H=4, dh=192, S=8), dict(L=2, B=4, W=256, H=3, dh=256, S=8))
# the flagship's serving cache at its width with 3 heads of 256 (--n_head 3)
DECODE_WIDE = dict(DECODE, H=3, dh=256)


def _decode_cache(torch, quant, seed, shape=DECODE):
    """A stacked cache of random rows at ``shape`` (quantized per layer for
    int8), q, E, a stage and the current row, on the card, laid out as the
    model lays them out (each head at cache_dh(dh) columns, zero past dh);
    and max |V| before quantization."""
    from midi_emotion_tpu_torch.ops import decode_attention as da

    L, B, W, H, dh, S = (shape[k] for k in ("L", "B", "W", "H", "dh", "S"))
    D, dh_k = H * dh, da.cache_dh(dh)
    g = torch.Generator(device="cuda").manual_seed(seed)
    kv = torch.empty((L, B, W, 2 * H * dh_k), dtype=torch.int8 if quant else torch.bfloat16,
                     device="cuda")
    sc = torch.empty((L, B, 2 * H, W), dtype=torch.bfloat16, device="cuda") if quant else None
    vmax = 0.0
    for i in range(L):
        rows = torch.randn((B, W, 2 * D), generator=g, device="cuda")
        vmax = max(vmax, rows[..., D:].abs().max().item())
        rows = da.pad_groups(rows, 2 * H, dh_k)
        if quant:
            kv[i], sc[i] = da.quantize_rows(rows, 2 * H)
        else:
            kv[i] = rows
    q = torch.randn((B, H, dh), generator=g, device="cuda")
    e = torch.randn((FLAGSHIP["max_seq"], dh), generator=g, device="cuda")
    pend = da.pad_groups(torch.randn((S, L, B, 2 * D), generator=g, device="cuda"), 2 * H,
                         dh_k).bfloat16()
    row = da.pad_groups(torch.randn((B, 2 * D), generator=g, device="cuda"), 2 * H,
                        dh_k).bfloat16()
    return kv, sc, q, e, pend, row, vmax


def check_decode(torch, quant, timed=False, shape=DECODE,
                 lengths=(0, 1, 127, 128, 129, 700, 1216, 1281, 1400)):
    """Kernel 13 against its twin at ``shape`` (by default the serving
    shapes, layer 13 of 20), unstaged at each length and staged (S 8) at
    each (length, p_cnt), p_cnt 8 being the clamp. Tolerances: the integer score sums are exact, but
    the f32 scores round apart by an ulp, and a flip of one P
    re-quantization unit moves a head's output by at most about
    max|V|/127 (int8); bf16 rounds p to bf16 in both, so the unstaged
    normalized acc is held to 1e-3 of max|V|; the staged bf16 output adds
    one bf16 ulp (2^-7 of its scale, both roundings); m and l to f32
    summation order (1e-5 relative); the written stage exactly."""
    from midi_emotion_tpu_torch.ops import decode_attention as da

    L, B, W, H, dh, S = (shape[k] for k in ("L", "B", "W", "H", "dh", "S"))
    D, dh_k = H * dh, da.cache_dh(dh)  # the cache's head width (dh_k = dh when built)
    layer = min(13, L - 1)  # a nonzero layer
    mode = "int8" if quant else "bf16"
    kv, sc, q, e, pend, row, vmax = _decode_cache(torch, quant, SEED + 5, shape)
    p_tol = vmax / 127 if quant else 0.0
    worst = {"unstaged": 0.0, "staged": 0.0, "m/l": 0.0}
    for length in lengths:
        e_rows = da.expand_e_rows(e, length + 1, W, dh_to=dh_k)
        acc, m, l = da.decode_attn_cached(q, kv, sc, layer, e_rows, length)
        torch.cuda.synchronize()
        racc, rm, rl = da.decode_attn_cached_plain(q, kv, sc, layer, e_rows, length)
        if length == 0:
            if not ((m == -1e30).all() and (l == 0).all() and (acc == 0).all()):
                fail(f"decode {mode}: length 0 is not the fully masked triple")
        else:
            err_ml = max(((m - rm).abs() / (1 + rm.abs())).max().item(),
                         ((l - rl).abs() / (1 + rl.abs())).max().item())
            err = (acc.view(B, H, dh) / l[..., None]
                   - racc.view(B, H, dh) / rl[..., None]).abs().max().item()
            tol = p_tol if quant else 1e-3 * vmax
            worst["unstaged"] = max(worst["unstaged"], err)
            worst["m/l"] = max(worst["m/l"], err_ml)
            if not (err <= tol and err_ml <= 1e-5 and torch.isfinite(acc).all()):
                fail(f"decode {mode} unstaged length {length}: err {err:.3e} (tol {tol:.3e}), "
                     f"m/l {err_ml:.3e} (tol 1e-5)")
        for p_cnt in (0, 3, 7, 8):
            e_rows = da.expand_e_rows(e, length + p_cnt + 1, W, dh_to=dh_k)
            e_pend = da.expand_e_rows(e, p_cnt + 1, S + 1, dh_to=dh_k)
            got_pend, want_pend = pend.clone(), pend.clone()
            out, _ = da.decode_attn_cached(q, kv, sc, layer, e_rows, length, got_pend, e_pend,
                                           p_cnt, row)
            torch.cuda.synchronize()
            ref, _ = da.decode_attn_cached_plain(q, kv, sc, layer, e_rows, length, want_pend,
                                                 e_pend, p_cnt, row)
            err = (out.float() - ref.float()).abs().max().item()
            tol = p_tol + 2 ** -7 * ref.float().abs().max().item()
            worst["staged"] = max(worst["staged"], err)
            if not (torch.equal(got_pend, want_pend) and err <= tol
                    and torch.isfinite(out).all()):
                fail(f"decode {mode} staged length {length} p_cnt {p_cnt}: err {err:.3e} "
                     f"(tol {tol:.3e}), stage equal {torch.equal(got_pend, want_pend)}")
    name = f"decode {mode} L={L} B={B} W={W} H={H} dh={dh}"
    print(f"{name}: lengths {lengths[0]}..{lengths[-1]}, p_cnt 0/3/7/8: max err unstaged "
          f"{worst['unstaged']:.3e}, staged {worst['staged']:.3e} (P unit max|V|/127 = "
          f"{vmax / 127:.3e}), m/l {worst['m/l']:.3e}; stage writes exact")
    if not timed:
        return None

    # timed: staged, length 1216 (the window), 4 rows in the stage
    length, p_cnt = 1216, 4
    e_rows = da.expand_e_rows(e, length + p_cnt + 1, W, dh_to=dh_k)
    e_pend = da.expand_e_rows(e, p_cnt + 1, S + 1, dh_to=dh_k)
    stage = pend.clone()
    item = 1 if quant else 2
    n_bytes = (B * length * 2 * D * item + (B * 2 * H * length * 2 if quant else 0)
               + length * dh * 2 + B * H * dh * (2 + (1 if quant else 0)) + (B * H * 4 if quant else 0)
               + B * p_cnt * 2 * D * 2 + (S + 1) * dh * 2 + 2 * B * 2 * D * 2 + B * D * 2)
    out = {"max_abs_err": max(worst["unstaged"], worst["staged"])}
    out["bound_ms"], out["bound_by"] = bound(n_bytes, B * H * (length + p_cnt + 1) * 6 * dh,
                                             "int8" if quant else "bf16")
    library = None
    if not quant:
        # F.scaled_dot_product_attention over the same live cache rows, the
        # relative bias passed as a float mask built outside the timing
        import torch.nn.functional as F

        qb = q.bfloat16()[:, :, None, :]
        kb = kv[layer, :, :length, :D].view(B, length, H, dh).transpose(1, 2)
        vb = kv[layer, :, :length, D:].view(B, length, H, dh).transpose(1, 2)
        mask = ((qb.float() @ e_rows[:length].float().T) / dh ** 0.5).bfloat16()

        def library():
            return F.scaled_dot_product_attention(qb, kb, vb, attn_mask=mask)

    res = _report(torch, out, timed, f"{name} staged length {length} p_cnt {p_cnt}",
                  lambda: da.decode_attn_cached(q, kv, sc, layer, e_rows, length, stage, e_pend,
                                                p_cnt, row),
                  lambda: da.decode_attn_cached_plain(q, kv, sc, layer, e_rows, length, stage,
                                                      e_pend, p_cnt, row),
                  library, iters=50,
                  kernel_only="decode_wide_kernel" if dh_k > 1024 else "decode_attn_stacked")
    if timed:
        print(f"{name}: bytes moved {n_bytes / 1e6:.1f} MB; kernel at "
              f"{n_bytes / (res['ms'] * 1e-3) / 1e12:.3f} TB/s")
    del kv, sc, pend, stage
    torch.cuda.empty_cache()
    return res


def check_train_step(torch):
    """One f32 train step (2 layers, B 2, T 256, dropout 0) through the
    kernels on the card against the same step on the CPU (plain twins):
    loss, grad norm and every clipped gradient."""
    from midi_emotion_tpu_torch.models.config import ModelConfig
    from midi_emotion_tpu_torch.models.model import MusicTransformer
    from midi_emotion_tpu_torch.training.train_step import make_optimizer, make_train_step

    cfg = ModelConfig(**{**FLAGSHIP, "n_layer": 2, "dropout": 0.0})
    gen = torch.Generator().manual_seed(SEED)
    tokens = torch.randint(2, 1007, (1, 2, 257), generator=gen)
    tokens[0, 1, -40:] = 0  # a pad tail
    batch = {"input": tokens[:, :, :-1], "target": tokens[:, :, 1:],
             "condition": torch.tensor([[[0.8, -0.5], [0.3, -0.9]]])}
    out = {}
    for dev in ("cpu", "cuda"):
        model = MusicTransformer(cfg, device=dev).init_weights(torch.Generator().manual_seed(1))
        m = make_train_step(model, make_optimizer(model), clip=1.0)(
            {k: v.to(dev) for k, v in batch.items()}, 2e-5)
        out[dev] = ({k: v.item() for k, v in m.items()},
                    {n: p.grad.cpu() for n, p in model.named_parameters()})
    (mc, gc), (mg, gg) = out["cpu"], out["cuda"]
    worst = max((gg[n] - gc[n]).abs().max().item() / (1 + gc[n].abs().max().item()) for n in gc)
    print(f"train step f32 2 layers B=2 T=256: loss card {mg['loss']:.6f} cpu {mc['loss']:.6f}; "
          f"grad norm card {mg['grad_norm']:.6f} cpu {mc['grad_norm']:.6f}; worst gradient "
          f"error {worst:.3e} of its scale (tol 1e-4)")
    if not (abs(mg["loss"] - mc["loss"]) <= 1e-5 * (1 + abs(mc["loss"]))
            and abs(mg["grad_norm"] - mc["grad_norm"]) <= 1e-4 * (1 + mc["grad_norm"])
            and worst <= 1e-4):
        fail("the train step through the kernels disagrees with the plain twins")


# ---------------------------------------------------------------------------
# phase 5: training through the CLI
# ---------------------------------------------------------------------------


def write_dataset(root, n_songs=24, n_bars=40, events_per_bar=80):
    """Shards written with the port's save_song_shard: every bar holds
    ``events_per_bar`` (event, value) rows over four instruments and
    timeshifts, so the loader's 19-bar window fills T 1216 without pad.
    Returns (shard folder, feature CSV path)."""
    from midi_emotion_tpu_torch.data.loader import save_song_shard

    rng = np.random.RandomState(SEED)
    folder = os.path.join(root, "shards")
    os.makedirs(folder, exist_ok=True)
    rows = ["file,valence,note_density_per_instrument,n_instruments,is_matched"]
    for i in range(n_songs):
        bars = []
        for _ in range(n_bars):
            ev = rng.randint(0, 4, size=events_per_bar) * 2 + rng.randint(0, 2, size=events_per_bar)
            val = rng.randint(21, 109, size=events_per_bar)
            ts = rng.randint(0, events_per_bar, size=events_per_bar // 4)
            ev[ts] = 10
            val[ts] = rng.choice(np.arange(8, 1008, 8), size=len(ts))
            bars.append(np.stack([ev, val], axis=1).astype(np.int16))
        fid = f"song{i:03d}"
        save_song_shard(os.path.join(folder, fid + ".npz"), fid, bars)
        rows.append(f"{fid},{rng.uniform(-0.9, 0.9):.4f},{3.0 + i * 0.1:.4f},4,True")
    path = os.path.join(root, "features.csv")
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")
    return folder, path


def train_losses(work_dir):
    with open(os.path.join(work_dir, "performance.csv")) as f:
        return [float(r["trn_loss"]) for r in csv.DictReader(f) if r["trn_loss"] not in ("", "nan")]


def timed_training(torch, runner, n_warmup=2, n_timed=5):
    """Train tokens/sec = B * T * steps / seconds over ``n_timed`` steps of
    the Runner's train step (loss read after each step, as the Runner
    does) after ``n_warmup``, on batches from its loader staged on the
    card beforehand; plus the launches per step and a profiled window."""
    it = runner.train_dataset.epochs(TRAIN_B)
    batches = [runner._to_device(runner._microbatches(it)) for _ in range(n_warmup + n_timed + 2)]
    gen = torch.Generator().manual_seed(SEED)
    lr = 2e-5
    losses = [float(runner._train_fn(b, lr, gen)["loss"]) for b in batches[:n_warmup]]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [float(runner._train_fn(b, lr, gen)["loss"])
               for b in batches[n_warmup:n_warmup + n_timed]]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    per_step = {k: v / n_timed for k, v in read_counts().items()}
    if not all(np.isfinite(losses)):
        fail(f"non-finite training losses {losses}")
    tps = TRAIN_B * TRAIN_T * n_timed / secs
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for b in batches[-2:]:
            float(runner._train_fn(b, lr, gen)["loss"])
        torch.cuda.synchronize()
        prof_secs = time.perf_counter() - t1
    # device-side events only: the CPU ops that launched them report the
    # same time again
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    device_us = sum(e.self_device_time_total for e in events)
    device_ms_step = device_us / 1e3 / 2
    print(f"train step profile (2 steps, {prof_secs * 1e3 / 2:.2f} ms/step wall under the "
          f"profiler): device busy {device_us / 1e3 / 2:.2f} ms/step "
          f"({100 * device_us / 1e6 / prof_secs:.1f}% of wall)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3 / 2:9.3f} ms/step "
              f"{100 * e.self_device_time_total / device_us:5.1f}%  x{e.count // 2:<5d} "
              f"{e.key[:90]}")
    ln = [e for e in events if e.key.startswith(("ln_bwd", "col_sum"))]
    print(f"  {sum(e.self_device_time_total for e in ln) / 1e3 / 2:9.3f} ms/step in the "
          f"LayerNorm backward (kernel 12 or 3: its row pass and col_sum, "
          f"x{sum(e.count for e in ln) // 2})")
    return tps, secs / n_timed, per_step, losses, device_ms_step


# ---------------------------------------------------------------------------
# launch counters
# ---------------------------------------------------------------------------

# name, route, source, the TPU kernel it replaces. In bf16 kernels 1 and
# 4-8 run on the tensor cores by wgmma, 9 by mma.sync; every f32 path on
# the CUDA cores
KERNELS = (
    ("flash_rel_attn_fwd", "cuda", "midi_emotion_tpu_torch/csrc/flash_rel_attn_fwd.cu",
     "midi_emotion_tpu/ops/pallas_attention.py:369"),
    ("ln_fwd", "triton", "midi_emotion_tpu_torch/ops/layernorm_triton.py",
     "midi_emotion_tpu/ops/layernorm.py:53"),
    ("ln_bwd", "triton", "midi_emotion_tpu_torch/ops/layernorm_triton.py",
     "midi_emotion_tpu/ops/layernorm.py:63"),
    ("flash_rel_attn_bwd", "cuda", "midi_emotion_tpu_torch/csrc/flash_rel_attn_bwd.cu",
     "midi_emotion_tpu/ops/pallas_attention.py:1417"),
    # kernel 5, bf16 on kernel 6's instantiation (wg::flash_bwd_q_wg_tc_kernel<DIST>)
    ("flash_rel_attn_bwd_dq_de", "cuda", "midi_emotion_tpu_torch/csrc/flash_rel_attn_bwd_q.cu",
     "midi_emotion_tpu/ops/pallas_attention.py:808"),
    # kernel 6, bf16 on wgmma and TMA (wg::flash_bwd_q_wg_tc_kernel<DIST>)
    ("flash_rel_attn_bwd_dq_de_dist", "cuda", "midi_emotion_tpu_torch/csrc/flash_rel_attn_bwd_q.cu",
     "midi_emotion_tpu/ops/pallas_attention.py:874"),
    # kernel 7, bf16 on wgmma and TMA (wg::flash_bwd_kv_wg_tc_kernel)
    ("flash_rel_attn_bwd_dkdv_dq", "cuda", "midi_emotion_tpu_torch/csrc/flash_rel_attn_bwd_kv.cu",
     "midi_emotion_tpu/ops/pallas_attention.py:1065"),
    # kernel 8, bf16 on wgmma and TMA (wg::flash_bwd_q_wg_tc_kernel<REL>)
    ("flash_rel_attn_bwd_de_dqrel", "cuda", "midi_emotion_tpu_torch/csrc/flash_rel_attn_bwd_q.cu",
     "midi_emotion_tpu/ops/pallas_attention.py:1127"),
    # kernel 9, bf16 on the tensor cores (tc::flash_bwd_kv_tc_kernel without dQ)
    ("flash_rel_attn_bwd_dkdv", "cuda", "midi_emotion_tpu_torch/csrc/flash_rel_attn_bwd_kv.cu",
     "midi_emotion_tpu/ops/pallas_attention.py:1213"),
    ("dropout", "triton", "midi_emotion_tpu_torch/ops/layernorm_triton.py",
     "midi_emotion_tpu/ops/fused_dropout.py:132"),
    ("dal_fwd", "triton", "midi_emotion_tpu_torch/ops/layernorm_triton.py",
     "midi_emotion_tpu/ops/fused_dropout.py:194"),
    ("dal_bwd", "triton", "midi_emotion_tpu_torch/ops/layernorm_triton.py",
     "midi_emotion_tpu/ops/fused_dropout.py:211"),
    ("decode_attn_stacked", "cuda", "midi_emotion_tpu_torch/csrc/decode_attn_stacked.cu",
     "midi_emotion_tpu/ops/decode_attention.py:73"),
)


def counters():
    """Kernel name -> the wrapper that counts its launches."""
    from midi_emotion_tpu_torch.ops import flash_attention as fa
    from midi_emotion_tpu_torch.ops import fused_dropout as fd
    from midi_emotion_tpu_torch.ops.decode_attention import decode_attn_cached
    from midi_emotion_tpu_torch.ops.layernorm import layernorm, layernorm_bwd

    return {"flash_rel_attn_fwd": fa.flash_rel_attention, "ln_fwd": layernorm,
            "ln_bwd": layernorm_bwd, "flash_rel_attn_bwd": fa.flash_rel_attention_bwd,
            **{name: getattr(fa, spec[0]) for name, spec in BWD_KERNELS.items()},
            "dropout": fd.fused_dropout, "dal_fwd": fd.dropout_add_layernorm,
            "dal_bwd": fd.dropout_add_layernorm_bwd, "decode_attn_stacked": decode_attn_cached}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0
        for form in getattr(fn, "form_launches", {}):  # kernels 1, 4 and 5-9, by form
            fn.form_launches[form] = 0


def read_counts():
    return {name: fn.launches for name, fn in counters().items()}


def read_forms():
    """Launches by ``form``: kernels 1, 4 and 5-9."""
    return {name: dict(fn.form_launches) for name, fn in counters().items()
            if hasattr(fn, "form_launches")}


# kernels 5-8 at d_head up to 128 in bf16 run their Hopper form alone:
# the query-major 5, 6 and 8 and the key-major 7; no (kernel, form) in
# OLD_WGMMA_FORMS may launch on a bf16 path
QUERY_SWEEP_KERNELS = ("flash_rel_attn_bwd_dq_de", "flash_rel_attn_bwd_dq_de_dist",
                       "flash_rel_attn_bwd_de_dqrel")
KEY_SWEEP_KERNELS = ("flash_rel_attn_bwd_dkdv_dq",)
WGMMA_KERNELS = QUERY_SWEEP_KERNELS + KEY_SWEEP_KERNELS
OLD_WGMMA_FORMS = tuple((k, form) for k in WGMMA_KERNELS for form in ("cuda_cores", "mma_sync"))


def run_path(name, required, fn, absent=(), forms=(), absent_forms=()):
    """Run one main path with every counter at 0 just before and read just
    after; fail if a kernel the path needs was not launched, if a kernel
    in ``absent`` was, if a (kernel, form) in ``forms`` (``form``'s
    forms) was never
    launched, or if one in ``absent_forms`` was."""
    reset_counts()
    result = fn()
    counts = read_counts()
    by_form = read_forms()
    print(f"path {name}: kernel launches {counts}; by form "
          f"{ {k: {f: n for f, n in v.items() if n} for k, v in by_form.items()} }")
    missing = [k for k in required if counts[k] <= 0]
    missing += [f"{k} ({form})" for k, form in forms if by_form[k][form] <= 0]
    if missing:
        fail(f"path {name}: kernels never launched: {missing}")
    stray = [k for k in absent if counts[k] != 0]
    stray += [f"{k} ({form})" for k, form in absent_forms if by_form[k][form] != 0]
    if stray:
        fail(f"path {name}: kernels that must not run were launched: {stray}")
    return counts, result


# ---------------------------------------------------------------------------
# phase 5b: native work dirs, transfer and export, MIDI_EMOTION_FLASH_BWD=xla
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def flash_bwd_xla():
    """MIDI_EMOTION_FLASH_BWD=xla inside, restored after."""
    old = os.environ.get("MIDI_EMOTION_FLASH_BWD")
    os.environ["MIDI_EMOTION_FLASH_BWD"] = "xla"
    try:
        yield
    finally:
        if old is None:
            del os.environ["MIDI_EMOTION_FLASH_BWD"]
        else:
            os.environ["MIDI_EMOTION_FLASH_BWD"] = old


def new_losses(work_dir, restart_dir):
    """The losses a restarted run logged itself: its performance.csv
    carries the restart dir's rows first."""
    return train_losses(work_dir)[len(train_losses(restart_dir)):]


def check_native_dir(torch, tmp, trained):
    """Write the trained work dir (reference layout, f32 masters and Adam
    state) as a native dir with save_native_dir, and read every leaf of
    both msgpack files back bitwise through the port's decoder. Returns
    (native dir, the trained state_dict on the host, stats)."""
    from midi_emotion_tpu_torch.convert import flax_msgpack, load_model_dir, native
    from midi_emotion_tpu_torch.convert import state_dict_from_jax_params
    from midi_emotion_tpu_torch.training import checkpoint as ckpt
    from midi_emotion_tpu_torch.training.train_step import make_optimizer

    cfg, model, vocab = load_model_dir(trained, torch.float32, "cuda", param_dtype=torch.float32)
    optimizer = make_optimizer(model)
    if not ckpt.load_opt_state(trained, optimizer, model):
        fail(f"{trained}: its optimizer.pt does not restore")
    stats = ckpt.load_stats(trained)
    nat = os.path.join(tmp, "native")
    written = ckpt.save_native_dir(nat, model, cfg, vocab, optimizer, stats, clip=1.0)
    shutil.copy(os.path.join(trained, "performance.csv"), nat)
    sd = {k: v.cpu() for k, v in model.state_dict().items()}
    files = {}
    for name, (n_bytes, secs) in written.items():
        t0 = time.perf_counter()
        files[name] = flax_msgpack.read(os.path.join(nat, name))
        read_secs = time.perf_counter() - t0
        print(f"native dir {name}: {n_bytes} bytes, written in {secs:.3f} s, read in "
              f"{read_secs:.3f} s")
    back = state_dict_from_jax_params(files[native.MODEL_FILE], cfg)
    bad = [k for k in sd if not torch.equal(back[k], sd[k])]
    adam = files[native.OPT_FILE]["1"]
    mu, nu = (state_dict_from_jax_params(adam[m], cfg) for m in ("mu", "nu"))
    steps = set()
    for k, p in model.named_parameters():
        state = optimizer.state[p]
        steps.add(int(state["step"]))
        if not (torch.equal(mu[k], state["exp_avg"].cpu())
                and torch.equal(nu[k], state["exp_avg_sq"].cpu())):
            bad.append(f"Adam moments of {k}")
    if bad or steps != {int(adam["count"])}:
        fail(f"native dir: leaves that do not read back bitwise: {bad[:5]} (steps {steps}, "
             f"count {int(adam['count'])})")
    print(f"native dir: {len(sd)} parameters and their Adam state (step {steps.pop()}) read "
          f"back bitwise; stats {stats}")
    del model, optimizer, files, back, mu, nu
    torch.cuda.empty_cache()
    return nat, sd, stats


def attention_grads(torch, runner, batch, xla):
    """The first step's gradients of every attention parameter (Wq, Wk,
    Wv, fc, E of each layer) at the run's initial weights (its seed) on
    ``batch``, with MIDI_EMOTION_FLASH_BWD=xla or with the kernels."""
    from midi_emotion_tpu_torch.models.model import MusicTransformer
    from midi_emotion_tpu_torch.training.train_step import make_loss_fn

    model = MusicTransformer(runner.cfg, dtype=torch.bfloat16, device="cuda",
                             param_dtype=torch.float32).init_weights(
        torch.Generator().manual_seed(runner.args.seed)).train()
    with flash_bwd_xla() if xla else contextlib.nullcontext():
        make_loss_fn(model)({k: v[0] for k, v in batch.items()}).backward()
        torch.cuda.synchronize()
    return {n: p.grad.float() for n, p in model.named_parameters() if ".rga." in n}


def native_phase(torch, tmp, trained, train_args, drop0):
    """Phase 5b, each part fatal. ``drop0``: phase 5's 4-layer dropout-0
    runner, the baseline of the MIDI_EMOTION_FLASH_BWD=xla run. Returns
    the counts of each path it ran."""
    from midi_emotion_tpu_torch.cli import generate_cli, train_cli
    from midi_emotion_tpu_torch.convert import load_model_dir, torch_export, transfer
    from midi_emotion_tpu_torch.entry import entry
    from midi_emotion_tpu_torch.training import checkpoint as ckpt
    from midi_emotion_tpu_torch.training.train_step import make_optimizer

    t_phase = time.perf_counter()
    nat, trained_sd, stats = check_native_dir(torch, tmp, trained)
    paths = []

    # the same weights through both layouts: bitwise the same logits
    def serve_logits():
        tokens = torch.randint(2, 1007, (2, 64), generator=torch.Generator().manual_seed(SEED))
        tokens[1, -8:] = 0
        cond = torch.tensor([[0.8, -0.5], [0.3, -0.9]])
        logits = {}
        for name, d in (("native", nat), ("reference", trained)):
            m = load_model_dir(d, torch.bfloat16, "cuda")[1]
            with torch.inference_mode():
                logits[name] = m(tokens.cuda(), cond.cuda()).float().cpu()
            del m
        fwd, args = entry()
        out = fwd(*args)
        torch.cuda.synchronize()
        return logits, out

    counts, (logits, ent) = run_path("native dir: logits beside the reference dir's, and entry()",
                                     ("flash_rel_attn_fwd", "ln_fwd"), serve_logits)
    paths.append(counts)
    print(f"native dir logits [2, 64] bf16: bitwise equal to the reference dir's: "
          f"{torch.equal(logits['native'], logits['reference'])}; entry(): "
          f"{tuple(ent.shape)} {ent.dtype}")
    if not torch.equal(logits["native"], logits["reference"]) \
            or not torch.isfinite(logits["native"]).all():
        fail("the native dir's logits differ from the reference dir's")
    if tuple(ent.shape) != (4, 1216, 1007) or not torch.isfinite(ent).all():
        fail("entry(): the flagship forward is not [4, 1216, 1007] and finite")
    del ent
    torch.cuda.empty_cache()

    # the generation CLI on the native dir, --kv_dtype int8: the ids sampled
    # from the reference dir at the same seed
    def generate(d, sub):
        generate_cli.main([
            "--model_dir", d, "--conditioning", "continuous_concat", "--dtype", "bf16",
            "--batch_size", "2", "--valence", "0.8", "-0.5", "--arousal", "0.8", "0.5",
            "--gen_len", "128", "--max_input_len", "1216", "--device", "cuda",
            "--kv_dtype", "int8", "--batch_gen_dir", sub, "--quiet", "--short_filename",
            "--seed", "7"])
        out = os.path.join(d, "generations", "inference", "_" + sub)
        return {f: np.load(os.path.join(out, f)) for f in sorted(os.listdir(out))
                if f.endswith(".npy")}

    counts, ids = run_path(
        "generation CLI (native dir, then reference dir, --kv_dtype int8)",
        ("flash_rel_attn_fwd", "ln_fwd", "decode_attn_stacked"),
        lambda: (generate(nat, "int8_native"), generate(trained, "int8_reference")))
    paths.append(counts)
    same = list(ids[0]) == list(ids[1]) and all(np.array_equal(ids[0][f], ids[1][f])
                                                for f in ids[0])
    print(f"generation CLI --kv_dtype int8: {len(ids[0])} songs from the native dir, ids equal "
          f"to the reference dir's at seed 7: {same}")
    if not ids[0] or not same:
        fail("the native dir samples other ids than the reference dir")

    # --restart_dir on the native dir against a restart from the reference
    # dir: the same weights and Adam state, so the same first loss
    restart_args = train_args + ["--max_step", str(stats["step"] + 2), "--log_step", "1"]

    def restarts():
        runs = {}
        for name, d in (("native", nat), ("reference", trained)):
            r = train_cli.main(restart_args + ["--work_dir", os.path.join(tmp, f"restart_{name}"),
                                               "--restart_dir", d])
            runs[name] = (r.train_step_num, {int(s["step"]) for s in r.optimizer.state.values()},
                          new_losses(r.args.work_dir, d))
            del r
            torch.cuda.empty_cache()
        return runs

    counts, runs = run_path(
        "train --restart_dir (native dir, then reference dir; flagship, dropout 0.1)",
        ("flash_rel_attn_fwd", "flash_rel_attn_bwd", "dropout", "dal_fwd", "dal_bwd"), restarts)
    paths.append(counts)
    (n_step, n_adam, n_loss), (r_step, r_adam, r_loss) = runs["native"], runs["reference"]
    print(f"restart from the native dir: steps {stats['step']} -> {n_step}, Adam steps {n_adam}, "
          f"losses {n_loss}; from the reference dir: {r_step}, {r_adam}, {r_loss}")
    if n_step != stats["step"] + 2 or len(n_loss) != 2 or not all(np.isfinite(n_loss)):
        fail("the restart from the native dir did not continue from its stats.json")
    if n_loss[0] != r_loss[0] or n_adam != r_adam:
        fail("the native restart's first loss or Adam step differs from the reference restart's")
    if abs(n_loss[1] - r_loss[1]) > 1e-3 * (1 + abs(r_loss[1])):
        fail("the native restart's second loss is off the reference restart's by more than 1e-3")

    # transfer into a fresh continuous_token native dir, then export it
    def transfer_and_export():
        tok = train_cli.main(train_args + [
            "--work_dir", os.path.join(tmp, "token"), "--conditioning", "continuous_token",
            "--n_layer", "4", "--max_step", "1", "--log_step", "1"])
        cfg, model, vocab = load_model_dir(tok.args.work_dir, torch.float32, "cuda",
                                           param_dtype=torch.float32)
        optimizer = make_optimizer(model)
        ckpt.load_opt_state(tok.args.work_dir, optimizer, model)
        token = os.path.join(tmp, "token_native")
        ckpt.save_native_dir(token, model, cfg, vocab, optimizer,
                             ckpt.load_stats(tok.args.work_dir))
        fresh = {k: v.cpu() for k, v in model.state_dict().items()}
        del tok, model, optimizer
        transfer.main(["--from_dir", trained, "--to_dir", token, "--device", "cuda"])
        torch_export.main(["--model_dir", token, "--out_dir", os.path.join(tmp, "token_export"),
                           "--device", "cuda"])
        return fresh, token

    counts, (fresh, token) = run_path(
        "train (continuous_token, 4 layers, 1 step), transfer, export",
        ("flash_rel_attn_fwd", "flash_rel_attn_bwd", "dropout", "dal_fwd", "dal_bwd"),
        transfer_and_export)
    paths.append(counts)
    want = transfer.transfer_state_dict(trained_sd, fresh)

    def host_state(d):
        return {k: v.cpu() for k, v in load_model_dir(d, torch.float32, "cuda")[1]
                .state_dict().items()}

    got, exported = host_state(token), host_state(os.path.join(tmp, "token_export"))
    emb, cols = got["embedding.weight"], trained_sd["embedding.weight"].shape[1]
    slice_ok = torch.equal(emb[:, :cols], trained_sd["embedding.weight"]) \
        and torch.equal(emb[:, cols:], fresh["embedding.weight"][:, cols:])
    print(f"transfer: the trained continuous_concat dir -> a 4-layer continuous_token dir: "
          f"embedding {tuple(trained_sd['embedding.weight'].shape)} -> {tuple(emb.shape)}, "
          f"slice [:, :{cols}] landed: {slice_ok}; export loads: {exported.keys() == got.keys()}")
    if got.keys() != want.keys() or not all(torch.equal(got[k], want[k]) for k in want) \
            or not slice_ok:
        fail("the transferred native dir does not hold transfer_state_dict's weights")
    if not all(torch.equal(exported[k], got[k]) for k in got):
        fail("the exported reference dir does not hold the native dir's weights")
    torch.cuda.empty_cache()

    # MIDI_EMOTION_FLASH_BWD=xla: kernels 1, 2 and 3, never kernel 4
    def xla_run():
        with flash_bwd_xla():
            r = train_cli.main(train_args + [
                "--work_dir", os.path.join(tmp, "drop0_xla"), "--dropout", "0", "--n_layer", "4",
                "--max_step", "2", "--log_step", "1"])
        batch = r._to_device(r._microbatches(r.train_dataset.epochs(TRAIN_B)))
        return r, batch, attention_grads(torch, r, batch, xla=True)

    counts, (xla_runner, batch, xla_grads) = run_path(
        "train (4 layers, dropout 0, MIDI_EMOTION_FLASH_BWD=xla)",
        ("flash_rel_attn_fwd", "ln_fwd", "ln_bwd"), xla_run, absent=("flash_rel_attn_bwd",))
    paths.append(counts)
    base = train_losses(drop0.args.work_dir)
    xla = train_losses(xla_runner.args.work_dir)
    print(f"train CLI, MIDI_EMOTION_FLASH_BWD=xla: losses {xla}, the kernels' run {base}")
    if len(xla) != 2 or xla[0] != base[0]:
        fail("MIDI_EMOTION_FLASH_BWD=xla: step 1's loss differs from the kernels' run")
    if abs(xla[1] - base[1]) > 1e-3 * (1 + abs(base[1])):
        fail("MIDI_EMOTION_FLASH_BWD=xla: step 2's loss is off the kernels' run by more than 1e-3")
    # the kernel 4 side is a comparison, outside any path's counts
    k4_grads = attention_grads(torch, drop0, batch, xla=False)
    worst, worst_name = 0.0, ""
    for name, g in k4_grads.items():
        err, scale = _rel_err(xla_grads[name], g)
        if not torch.isfinite(xla_grads[name]).all() or err > 2e-2 * (1 + scale):
            fail(f"MIDI_EMOTION_FLASH_BWD=xla: the gradient of {name} is off kernel 4's by "
                 f"{err:.3e} (tol {2e-2 * (1 + scale):.3e})")
        if err / (1 + scale) > worst:
            worst, worst_name = err / (1 + scale), name
    print(f"MIDI_EMOTION_FLASH_BWD=xla: first-step gradients of {len(k4_grads)} attention "
          f"parameters against kernel 4's: worst {worst:.3e} of (1 + scale), {worst_name} "
          f"(tol 2e-2, phase 3's bf16 tolerance for kernel 4 against its twin)")
    del xla_runner
    torch.cuda.empty_cache()
    print(f"phase 5b (native dirs, transfer, export, FLASH_BWD=xla): "
          f"{time.perf_counter() - t_phase:.1f} s")
    return paths


# ---------------------------------------------------------------------------
# phase 5c: --remat, data and tensor parallelism on the one card, the ring
# ---------------------------------------------------------------------------

# a mesh's 2 steps against one process's, relative: (first loss, step
# 1's grad norm and step 2's loss, step 2's grad norm, step 1's
# gradients). The mesh sums the batch (data) or each row-parallel
# product's halves (model) in another order, in bf16 products, and the
# seq ranks run the ring (plain f32 products of the bf16 q, k, v) where
# one process runs kernel 1, so nothing is bitwise. First loss: 1e-5 for
# data; 1e-4 for model, whose two halves of each row-parallel product are
# each rounded to bf16 before their sum, and for seq. Step 1's grad norm
# and step 2's loss: 1e-3. Step 2's grad norm: 5e-3 (1e-2 for seq), since
# step 1's Adam update moves each weight by about lr whatever its
# gradient's size, so the elements near 0 whose sign the rounding flips
# move apart, and step 2's gradients with them. Step 1's gradients, the
# worst parameter's |g - g_one| / |g_one|: E's are the noisiest (a small
# sum of bf16 products); 0.1 for data and 0.25 for model and seq, between
# the sound runs' readings on the H100 (1.4e-2 data, 7.2e-2 model) and a
# planted fault's (0.75 with E's gradient left unsummed over the model
# group, which moves the loss and grad norms by less than 1e-3).
MESH_TOLS = {"data": (1e-5, 1e-3, 5e-3, 0.1), "model": (1e-4, 1e-3, 5e-3, 0.25),
             "seq": (1e-4, 1e-3, 1e-2, 0.25)}
MESH_ARGS = {"data": ("--mesh_data", "2"), "model": ("--mesh_model", "2"),
             "seq": ("--mesh_seq", "2", "--attn_impl", "ring")}
# kernels each mesh path must launch (the ring launches no attention kernel)
MESH_KERNELS = {"data": ("flash_rel_attn_fwd", "flash_rel_attn_bwd", "dropout", "dal_fwd",
                         "dal_bwd"),
                "model": ("flash_rel_attn_fwd", "flash_rel_attn_bwd", "dropout", "dal_fwd",
                          "dal_bwd"),
                "seq": ("dropout", "dal_fwd", "dal_bwd")}


@contextlib.contextmanager
def planted_fault(fault):
    """One tensor-parallel fault planted in this process (a mesh rank's)
    inside, so that the card shows what the limits of MESH_TOLS read for a
    broken split: "E unsummed" drops the all-reduce of E's gradient over
    the model group (E enters each layer's attention through ``copy_to``,
    the only 2-D tensor that does); "norm unsummed" leaves the sharded
    gradients' squares out of the model group's sum in the global norm."""
    from midi_emotion_tpu_torch.parallel import mesh as mesh_lib
    from midi_emotion_tpu_torch.training import train_step

    module, name = {"E unsummed": (mesh_lib, "copy_to"),
                    "norm unsummed": (train_step, "global_norm")}[fault]
    orig = getattr(module, name)
    if fault == "E unsummed":
        setattr(module, name, lambda x, group: x if x.dim() == 2 else orig(x, group))
    else:
        setattr(module, name, lambda grads, sharded=None, mesh=None: orig(grads))
    try:
        yield
    finally:
        setattr(module, name, orig)


def runner_steps(torch, runner, n=2):
    """n train steps of the Runner's own step (its dropout generator, the
    run's LR) on the global batches of its loader, each rank taking its
    rows: ([(loss, grad norm)], [ms of each step, host clock to a
    synchronize], peak bytes allocated, step 1's whole gradients)."""
    it = runner.train_dataset.epochs(TRAIN_B)
    batches = [runner._microbatches(it) for _ in range(n)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps, ms, grads = [], [], None
    for b in batches:
        t0 = time.perf_counter()
        m = runner._train_fn(runner._to_device(b), runner.args.lr, runner._generator)
        steps.append((float(m["loss"]), float(m["grad_norm"])))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if grads is None:
            grads = whole_grads(runner.model)
    return steps, ms, torch.cuda.max_memory_allocated(), grads


def whole_grads(model):
    """Each parameter's gradient as the step left it (reduced over the
    mesh and clipped), whole (the model group gathers its shards), f32 on
    the CPU."""
    import torch

    from midi_emotion_tpu_torch.parallel import mesh as mesh_lib

    out = {}
    for name, p in model.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        if model.mesh is not None:
            g = mesh_lib.gather_whole(g, model.shard_dims[name], model.mesh)
        out[name] = g.detach().float().cpu()
    return out


def grad_error(grads, base):
    """The largest over parameters of |g - g_base| / |g_base| (Frobenius
    norms), and its parameter's name. The key projection's bias is left
    out: softmax ignores a score added to a whole row, so its gradient is
    0 but for rounding."""
    return max(((grads[n] - g).norm().item() / max(g.norm().item(), 1e-30), n)
               for n, g in base.items() if not n.endswith("Wk.bias"))


def new_runner(train_args, work_dir, *extra):
    """A Runner as train_cli builds it, writing nothing (--debug)."""
    from midi_emotion_tpu_torch.cli import train_cli
    from midi_emotion_tpu_torch.training.train import Runner

    return Runner(train_cli.parse_args(train_args + ["--work_dir", work_dir, "--debug",
                                                     *extra]))


def mesh_rank(kind, rank, port, spec, out):
    """One of the 2 ranks of phase 5c's mesh part, on cuda:0 under gloo:
    2 steps of the flagship at global B 8 on a mesh of 2 along ``kind``
    ("data", "model" or "seq", the ring), its kernel launches, and (rank 0)
    the whole parameters after them; then, for "model", the same 2 steps
    under each fault of ``planted_fault`` in turn, from a fresh Runner."""
    import torch
    import torch.distributed as dist

    rank = int(rank)
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
    from midi_emotion_tpu_torch.parallel.mesh import initialize_distributed

    initialize_distributed("gloo", timeout=300)
    with open(spec) as f:
        train_args, work_dir = json.load(f)
    runner = new_runner(train_args, work_dir, *MESH_ARGS[kind], "--device", "cuda:0")
    reset_counts()
    steps, ms, peak, grads = runner_steps(torch, runner)
    counts = read_counts()
    whole, _ = runner._whole()  # every rank gathers
    state = {n: p.detach().cpu() for n, p in whole.named_parameters()} if rank == 0 else None
    del runner, whole
    faults = {}
    for fault in (("E unsummed", "norm unsummed") if kind == "model" else ()):
        torch.cuda.empty_cache()
        with planted_fault(fault):
            runner = new_runner(train_args, work_dir + fault.replace(" ", "_"),
                                *MESH_ARGS[kind], "--device", "cuda:0")
            faults[fault] = runner_steps(torch, runner)[::3]
        del runner
    torch.save(dict(steps=steps, ms=ms, peak=peak, grads=grads if rank == 0 else None,
                    counts=counts, state=state, faults=faults if rank == 0 else {}),
               out)
    dist.destroy_process_group()


def run_mesh(tmp, kind, train_args, timeout=600):
    """Start this script's 2 ranks of ``kind`` on the card and wait; fail,
    with their logs, if one fails or the deadline passes (the others are
    killed). Returns each rank's results."""
    import socket

    import torch

    spec = os.path.join(tmp, f"mesh_{kind}.json")
    with open(spec, "w") as f:
        json.dump([train_args, os.path.join(tmp, f"mesh_{kind}")], f)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    procs, logs = [], []
    for r in range(2):
        logs.append(open(os.path.join(tmp, f"mesh_{kind}_{r}.log"), "w"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mesh-rank", kind, str(r), port, spec,
             os.path.join(tmp, f"mesh_{kind}_{r}.pt")], stdout=logs[-1], stderr=subprocess.STDOUT,
            cwd=REPO))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=60)
        for log in logs:
            log.close()
    if any(p.returncode != 0 for p in procs):
        for r in range(2):
            with open(os.path.join(tmp, f"mesh_{kind}_{r}.log")) as f:
                print(f"--- mesh {kind} rank {r} (rc {procs[r].returncode}) ---\n"
                      f"{f.read()[-4000:]}", file=sys.stderr)
        fail(f"the 2-rank {kind}-parallel run failed or timed out")
    return [torch.load(os.path.join(tmp, f"mesh_{kind}_{r}.pt"), weights_only=False)
            for r in range(2)]


def check_ring_on_card(torch):
    """The ring's per-step function driven over 4 chunks of 304 in one
    process on CUDA tensors (B 2, H 16, T 1216, d_head 48, causal, row 1's
    keys pad from 500 on: across the boundaries of chunks 1, 2 and 3)
    against kernel 1's output and kernel 4's gradients (q, k, v, E), with
    phase 3's tolerances for those kernels against their twins."""
    from midi_emotion_tpu_torch.ops.flash_attention import flash_rel_attention
    from midi_emotion_tpu_torch.parallel.ring_attention import ring_attention_one_process

    B, H, T, dh, n = 2, 16, TRAIN_T, 48, 4
    g = torch.Generator(device="cuda").manual_seed(SEED)
    pad = torch.zeros((B, T), dtype=torch.bool, device="cuda")
    pad[1, 500:] = True
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        q, k, v, w = (torch.randn((B, H, T, dh), generator=g, device="cuda") for _ in range(4))
        e = torch.randn((FLAGSHIP["max_seq"], dh), generator=g, device="cuda")
        q, k, v, e = (t.to(dtype) for t in (q, k, v, e))
        outs = []
        for fn in (lambda *a: ring_attention_one_process(*a, n, True, pad),
                   lambda *a: flash_rel_attention(*a, True, pad)[0]):
            leaves = [t.clone().requires_grad_() for t in (q, k, v, e)]
            o = fn(*leaves)
            (o.float() * w).sum().backward()
            outs.append([o.detach()] + [t.grad for t in leaves])
        torch.cuda.synchronize()
        for name, got, want in zip(("out", "dq", "dk", "dv", "dE"), *outs):
            err, scale = _rel_err(got, want)
            print(f"ring ({n} chunks of {T // n}, {dtype_name(dtype)}) {name} against kernel "
                  f"{1 if name == 'out' else 4}: max|diff| {err:.3e} (tol {tol:g} x (1 + "
                  f"{scale:.3g}))")
            if not torch.isfinite(got).all() or err > tol * (1 + scale):
                fail(f"the ring's {name} ({dtype_name(dtype)}) disagrees with kernel "
                     f"{1 if name == 'out' else 4}")
        del outs
        torch.cuda.empty_cache()
    print("the ring's rotation across ranks (torch.distributed.batch_isend_irecv) runs on the "
          "card in the --mesh_seq 2 run above, under gloo, which carries CUDA tensors through "
          "host copies; one card cannot host two NCCL ranks, so NCCL's send/recv is not run")


def parallel_phase(torch, tmp, train_args, card):
    """Phase 5c, each part fatal. Returns the counts of each path it ran."""
    t_phase = time.perf_counter()
    paths, runs = [], {}
    # --remat: 2 steps each from one init and dropout generator
    for remat in ("none", "dots", "full"):
        def two_steps():
            r = new_runner(train_args, os.path.join(tmp, f"remat_{remat}"), "--remat", remat)
            return r, runner_steps(torch, r)

        counts, (runner, res) = run_path(
            f"train (flagship, dropout 0.1, --remat {remat}, 2 steps)",
            ("flash_rel_attn_fwd", "flash_rel_attn_bwd", "dropout", "dal_fwd", "dal_bwd"),
            two_steps)
        paths.append(counts)
        runs[remat] = res
        steps, ms, peak, _ = res
        per_step = {k: counts[k] / 2 for k in ("flash_rel_attn_fwd", "flash_rel_attn_bwd")}
        print(f"--remat {remat}: (loss, grad norm) {steps}; step 1 {ms[0]:.1f} ms, step 2 "
              f"{ms[1]:.1f} ms; peak memory {peak / 2**30:.2f} GiB; kernel 1 "
              f"{per_step['flash_rel_attn_fwd']:g}, "
              f"kernel 4 {per_step['flash_rel_attn_bwd']:g} launches a step on {card}")
        want_fwd = 20 if remat == "none" else 40
        if per_step != {"flash_rel_attn_fwd": want_fwd, "flash_rel_attn_bwd": 20}:
            fail(f"--remat {remat}: kernel 1 must launch {want_fwd} times a step and kernel 4 "
                 f"20 times, got {per_step}")
        if remat == "none":
            reference = {n: p.detach().cpu() for n, p in runner.model.named_parameters()}
        del runner
        torch.cuda.empty_cache()
    base, base_grads = runs["none"][0], runs["none"][3]
    for remat in ("dots", "full"):
        steps, grads = runs[remat][0], runs[remat][3]
        worst = max(abs(a - b) / abs(b) for s, t in zip(steps, base) for a, b in zip(s, t))
        g_err, g_name = grad_error(grads, base_grads)
        print(f"--remat {remat} against none: losses and grad norms "
              f"{'bitwise equal' if steps == base else f'within {worst:.3e} relative'}, step 1's "
              f"gradients within {g_err:.3e} relative ({g_name}) (tol 1e-6 relative)")
        if max(worst, g_err) > 1e-6:
            fail(f"--remat {remat}: the steps differ from --remat none's")
    del runs

    # data, tensor and seq (ring) parallelism: 2 ranks on cuda:0 under gloo
    # against the one-process run above (--remat none, global B 8)
    def readings(steps, grads):
        """(first loss, step 1's grad norm and step 2's loss, step 2's grad
        norm, step 1's gradients) off one process's, relative."""
        e = [abs(steps[i][j] - base[i][j]) / abs(base[i][j])
             for i, j in ((0, 0), (0, 1), (1, 0), (1, 1))]
        g = grad_error(grads, base_grads) if grads is not None else (0.0, "")
        return (e[0], max(e[1], e[2]), e[3], g[0]), g[1]

    names = ("first loss", "step 1's grad norm or step 2's loss", "step 2's grad norm",
             "step 1's gradients")
    for kind in ("data", "model", "seq"):
        t1 = time.perf_counter()
        ranks = run_mesh(tmp, kind, train_args)
        tols = MESH_TOLS[kind]
        for r, res in enumerate(ranks):
            counts = res["counts"]
            paths.append(counts)
            print(f"path train (flagship, dropout 0.1, {' '.join(MESH_ARGS[kind])}, rank {r} of "
                  f"2 on cuda:0, gloo, 2 steps): kernel launches {counts}")
            missing = [k for k in MESH_KERNELS[kind] if counts[k] <= 0]
            if missing:
                fail(f"--mesh_{kind} 2 rank {r}: kernels never launched: {missing}")
            if kind == "seq" and (counts["flash_rel_attn_fwd"] or counts["flash_rel_attn_bwd"]):
                fail(f"--mesh_seq 2 rank {r}: the ring launched a flash kernel: {counts}")
            errs, g_name = readings(res["steps"], res["grads"])
            print(f"--mesh_{kind} 2 rank {r}: (loss, grad norm) {res['steps']}, one process "
                  f"{base}: off by " + ", ".join(f"{x:.3e}" for x in errs) + f" ({', '.join(names)}"
                  f"{'; worst ' + g_name if g_name else ''}) relative, tol {tols}; steps of "
                  f"{res['ms'][0]:.1f} and {res['ms'][1]:.1f} ms, peak memory "
                  f"{res['peak'] / 2**30:.2f} GiB, on {card}")
            if any(e > t for e, t in zip(errs, tols)):
                fail(f"--mesh_{kind} 2 rank {r}: the steps are off one process's")
            for fault, (steps, grads) in res["faults"].items():
                errs, g_name = readings(steps, grads)
                caught = [n for n, x, t in zip(names, errs, tols) if x > t]
                print(f"--mesh_{kind} 2 rank {r}, planted fault ({fault}): off by "
                      + ", ".join(f"{x:.3e}" for x in errs)
                      + f"{' (worst ' + g_name + ')' if g_name else ''}; over the limit: "
                      f"{', '.join(caught) or 'none'}")
                if not caught:
                    fail(f"--mesh_{kind} 2: the limits do not see the planted fault ({fault})")
        state = ranks[0]["state"]
        worst = max((state[n] - w).abs().max().item() for n, w in reference.items())
        print(f"--mesh_{kind} 2: largest parameter difference from one process after 2 steps "
              f"at train_cli's default lr 2e-5: {worst:.3e}; {time.perf_counter() - t1:.1f} s "
              f"with the ranks' start")
        del ranks, state
    check_ring_on_card(torch)
    print(f"phase 5c (remat, data and tensor parallelism, the ring): "
          f"{time.perf_counter() - t_phase:.1f} s")
    return paths


# ---------------------------------------------------------------------------
# d_head past 128 (phase 3's wide heads, phase 5d)
# ---------------------------------------------------------------------------

# kernels 1 and 4 are built for d_head 192 and 256 (two column halves, a
# block each); 160 and 224 reach them through the padding
WIDE_DHS = (160, 192, 224, 256)


# past d_head 256 kernels 1, 4 and 13, and past 128 kernels 5-9, run their
# wide forms (csrc/flash_rel_attn_wide.cu, csrc/decode_attn_wide.cu): 320
# through the padding (to 384)
STREAMED_DHS = (320, 384, 768)
DECOMPOSITION_WIDE_DHS = (192, 256, 384)
WIDE_SOURCES = {"flash_rel_attn_fwd": "flash_rel_attn_wide.cu",
                "flash_rel_attn_bwd": "flash_rel_attn_wide.cu",
                **{name: "flash_rel_attn_wide.cu" for name in BWD_KERNELS},
                "decode_attn_stacked": "decode_attn_wide.cu"}


@contextlib.contextmanager
def no_fallback(torch):
    """Every plain twin of ops/flash_attention.py and ops/decode_attention.py
    and F.scaled_dot_product_attention raise while inside: a wrapper that
    ran one instead of its kernel fails."""
    import torch.nn.functional as F

    from midi_emotion_tpu_torch.ops import decode_attention as da
    from midi_emotion_tpu_torch.ops import flash_attention as fa

    def refuse(name):
        def call(*args, **kwargs):
            raise AssertionError(f"{name} ran on the card")
        return call

    patched = [(mod, name) for mod in (fa, da) for name in dir(mod) if name.endswith("_plain")]
    patched.append((F, "scaled_dot_product_attention"))
    saved = [(mod, name, getattr(mod, name)) for mod, name in patched]
    for mod, name in patched:
        setattr(mod, name, refuse(name))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def check_no_fallback(torch):
    """At the widths that were the kernels' limits, each wrapper launches
    its kernel and nothing else: d_head 272 (padded to 384) on kernels 1,
    4 and 13, 144 (padded to 192) on kernels 5-9 under split, fused/column
    and fused/dist, bf16, with every plain twin and SDPA refusing to run
    (``no_fallback``); each counter grows by its launches, and the outputs
    match the twins at phase 3's bf16 tolerances."""
    from midi_emotion_tpu_torch.ops import decode_attention as da
    from midi_emotion_tpu_torch.ops import flash_attention as fa

    bf16 = torch.bfloat16
    q, k, v, e, pad = _flash_inputs(torch, 2, 2, 64, 272, bf16)
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    do = (torch.randn(q.shape, generator=g, device="cuda") * (~pad)[:, None, :, None]).to(bf16)
    kv, sc, q13, e13, _, _, vmax = _decode_cache(torch, True, SEED, dict(L=2, B=2, W=256, H=2,
                                                                         dh=272, S=8))
    e_rows = da.expand_e_rows(e13, 101, 256, dh_to=da.cache_dh(272))
    q2, k2, v2, e2, _ = _flash_inputs(torch, 2, 2, 64, 144, bf16)
    o2, lse2 = fa.flash_rel_attention(q2, k2, v2, e2, True, pad)
    do2 = (torch.randn(q2.shape, generator=g, device="cuda") * (~pad)[:, None, :, None]).to(bf16)
    torch.cuda.synchronize()
    reset_counts()
    with no_fallback(torch):
        o, lse = fa.flash_rel_attention(q, k, v, e, True, pad)
        grads = fa.flash_rel_attention_bwd(q, k, v, e, True, pad, o, lse, do)
        acc, m, l = da.decode_attn_cached(q13, kv, sc, 1, e_rows, 100)
        split = {}
        for impl, dqde in DECOMPOSITIONS:
            with bwd_decomposition(impl, dqde):
                split[impl, dqde] = fa.flash_rel_attention_bwd(q2, k2, v2, e2, True, pad, o2,
                                                               lse2, do2)
        torch.cuda.synchronize()
    counts = read_counts()
    want = {"flash_rel_attn_fwd": 1, "flash_rel_attn_bwd": 1, "decode_attn_stacked": 1,
            "flash_rel_attn_bwd_dkdv_dq": 1, "flash_rel_attn_bwd_de_dqrel": 1,
            "flash_rel_attn_bwd_dq_de": 1, "flash_rel_attn_bwd_dq_de_dist": 1,
            "flash_rel_attn_bwd_dkdv": 2}
    if any(counts[name] != n for name, n in want.items()):
        fail(f"the wide wrappers' launches {counts} are not {want}")
    ro, rlse = fa.flash_rel_attention_plain(q, k, v, e, True, pad)
    errs = [_rel_err(o, ro)[0] / (1 + ro.float().abs().max().item()),
            (lse - rlse).abs().max().item()]
    rgrads = fa.flash_rel_attention_bwd_plain(q, k, v, e, True, pad, o, lse, do)
    errs += [_rel_err(a, b)[0] / (1 + b.float().abs().max().item()) for a, b in zip(grads, rgrads)]
    r2 = fa.flash_rel_attention_bwd_plain(q2, k2, v2, e2, True, pad, o2, lse2, do2)
    for got in split.values():
        errs += [_rel_err(a, b)[0] / (1 + b.float().abs().max().item()) for a, b in zip(got, r2)]
    racc, _, rl = da.decode_attn_cached_plain(q13, kv, sc, 1, e_rows, 100)
    err13 = (acc.view(2, 2, 272) / l[..., None] - racc.view(2, 2, 272) / rl[..., None]).abs()
    if not (max(errs[:1] + errs[2:]) <= 2e-2 and errs[1] <= 1e-3
            and err13.max().item() <= vmax / 127):
        fail(f"a wide kernel disagrees with its twin past the old limits: {errs}, kernel 13 "
             f"{err13.max().item():.3e}")
    print(f"no fallback: kernels 1, 4 and 13 at d_head 272 and kernels 5-9 at 144 under split, "
          f"fused/column and fused/dist launched {counts} with every plain twin and SDPA "
          f"refusing to run; worst relative error {max(errs):.3e}, kernel 13 "
          f"{err13.max().item():.3e}")


def streamed_flagship_kernels(torch, card):
    """Kernels 1, 4, 5-9 and 13 timed past their built widths at the
    flagship's width with 2 heads of 384 and 1 of 768, beside their plain
    twins, SDPA where one call computes the same function and the bound:
    the flash kernels at the train step's B 8, T 1216, kernel 13 staged at
    L 20, B 64, W 1408. Returns {kernel: {"dh384": numbers, "dh768": ...}}."""
    bf16 = torch.bfloat16
    out = {}
    for H, dh in ((2, 384), (1, 768)):
        key, shape = f"dh{dh}", {"B": TRAIN_B, "H": H, "T": TRAIN_T, "dh": dh}
        row = {"flash_rel_attn_fwd": check_flash(torch, TRAIN_B, H, TRAIN_T, dh, bf16, True, 2e-2,
                                                 1e-3, timed=True, rel=True)}
        torch.cuda.empty_cache()
        row["flash_rel_attn_bwd"] = check_flash_bwd(torch, TRAIN_B, H, TRAIN_T, dh, bf16, True,
                                                    2e-2, timed=True)
        for kernel in BWD_KERNELS:
            torch.cuda.empty_cache()
            row[kernel] = check_bwd_kernel(torch, kernel, TRAIN_B, H, TRAIN_T, dh, bf16, True,
                                           2e-2, timed=True)
        for m in row.values():
            m["shape"] = shape
        torch.cuda.empty_cache()
        dshape = dict(L=20, B=64, W=1408, H=H, dh=dh, S=8)
        lengths = (0, 1, 129, 700, 1216, 1400)
        int8 = check_decode(torch, True, timed=True, shape=dshape, lengths=lengths)
        int8["bf16"] = check_decode(torch, False, timed=True, shape=dshape, lengths=lengths)
        int8["shape"] = {k: dshape[k] for k in ("L", "B", "W", "H", "dh")}
        row["decode_attn_stacked"] = int8
        torch.cuda.empty_cache()
        for name, m in row.items():
            out.setdefault(name, {})[key] = m
        print(f"streamed heads (d_model 768, {H} heads of {dh}), device ms on {card}: "
              + "; ".join(f"{name} {m['ms']:.4f} (plain {m['plain_ms']:.4f}, library "
                          f"{m['library_ms'] if m['library_ms'] is None else round(m['library_ms'], 4)}"
                          f", bound {m['bound_ms']:.4f})" for name, m in row.items()))
    # the redesigned wide forms' registers and spills: kernels 1 and 4's
    # cluster kernels and kernel 13's wide instantiations
    from midi_emotion_tpu_torch.kernels.build import library_path

    for name, lib, pick in (("flash_rel_attn_fwd", "flash_rel_attn_wide",
                             "wide_fwd_tc_cluster_kernel"),
                            ("flash_rel_attn_bwd", "flash_rel_attn_wide",
                             "wide_bwd_tc_cluster_kernel"),
                            ("decode_attn_stacked", "decode_attn_wide",
                             "decode_attn_stacked_kernel")):
        regs = {kern: {"registers": r, "spilled": sp}
                for kern, r, sp in ptxas_report(library_path(lib))[0] if pick in kern}
        for kern, n in regs.items():
            print(f"ptxas, wide form of {name}: {kern}: {n['registers']} registers, "
                  f"{n['spilled']} bytes spilled")
        out[name]["ptxas"] = regs
    return out


def wide_flagship_kernels(torch, card):
    """Kernels 1, 4 and 13 timed at the flagship's width with 3 heads of
    256 beside SDPA and the bound: kernel 1 at B 4 and 8, H 3, T 1216;
    kernel 4's whole call at B 8 (and its launches apart); kernel 13 staged
    at L 20, B 64, W 1408, int8 and bf16; kernels 1 and 4 the same at 4
    heads of 192 (the rows' ``dh192``); the ptxas registers, spills and
    serialized-wgmma flag of kernel 1's two-warpgroup form and kernel 4's
    cluster, which serve d_head 129-256 in bf16 (the rows' ``ptxas``).
    Returns {kernel: its numbers}."""
    bf16 = torch.bfloat16
    out = {"flash_rel_attn_fwd": check_flash(torch, 4, 3, TRAIN_T, 256, bf16, True, 2e-2, 1e-3,
                                             timed=True, rel=True)}
    b8 = check_flash(torch, TRAIN_B, 3, TRAIN_T, 256, bf16, True, 2e-2, 1e-3, timed=True,
                     rel=True)
    out["flash_rel_attn_fwd"]["train_shape"] = {"B": TRAIN_B, **b8}
    torch.cuda.empty_cache()
    out["flash_rel_attn_bwd"] = check_flash_bwd(torch, TRAIN_B, 3, TRAIN_T, 256, bf16, True, 2e-2,
                                                timed=True, launches=True)
    torch.cuda.empty_cache()
    k1_192 = check_flash(torch, 4, 4, TRAIN_T, 192, bf16, True, 2e-2, 1e-3, timed=True, rel=True)
    k1_192["train_shape"] = {"B": TRAIN_B, **check_flash(torch, TRAIN_B, 4, TRAIN_T, 192, bf16,
                                                         True, 2e-2, 1e-3, timed=True, rel=True)}
    torch.cuda.empty_cache()
    k4_192 = check_flash_bwd(torch, TRAIN_B, 4, TRAIN_T, 192, bf16, True, 2e-2, timed=True,
                             launches=True)
    torch.cuda.empty_cache()
    lengths = (0, 1, 129, 700, 1216, 1400)  # the other shapes hold the rest at d_head 256
    int8 = check_decode(torch, True, timed=True, shape=DECODE_WIDE, lengths=lengths)
    int8["bf16"] = check_decode(torch, False, timed=True, shape=DECODE_WIDE, lengths=lengths)
    out["decode_attn_stacked"] = int8
    for name, m in out.items():
        m["shape"] = {"H": 3, "dh": 256, **({"L": 20, "B": 64, "W": 1408} if "decode" in name
                                            else {"B": 4 if "fwd" in name else TRAIN_B,
                                                  "T": TRAIN_T})}
    k1, k4 = out["flash_rel_attn_fwd"], out["flash_rel_attn_bwd"]
    k1["dh192"] = {**k1_192, "shape": {"H": 4, "dh": 192, "B": 4, "T": TRAIN_T}}
    k4["dh192"] = {**k4_192, "shape": {"H": 4, "dh": 192, "B": TRAIN_B, "T": TRAIN_T}}
    from midi_emotion_tpu_torch.kernels.build import library_path

    for m, lib, pick in ((k1, "flash_rel_attn_fwd", "flash_fwd_tc_parts_kernel"),
                         (k4, "flash_rel_attn_wide", "wide_bwd_tc_cluster_kernel")):
        m["ptxas"] = ptxas_forms(library_path(lib), pick)
        for kern, n in m["ptxas"].items():
            print(f"ptxas, d_head 129-256 form: {kern}: {n['registers']} registers, "
                  f"{n['spilled']} bytes spilled, wgmma serialized: {n['wgmma_serialized']}")
    print(f"wide heads (d_model 768, 4 heads of 192), device ms on {card}: kernel 1 B 4 "
          f"{k1_192['ms']:.4f} (SDPA {k1_192['library_ms']:.4f}, bound {k1_192['bound_ms']:.4f}), "
          f"B 8 {k1_192['train_shape']['ms']:.4f} (SDPA "
          f"{k1_192['train_shape']['library_ms']:.4f}); kernel 4 call B 8 {k4_192['ms']:.4f} "
          f"(SDPA backward {k4_192['library_ms']:.4f}, bound {k4_192['bound_ms']:.4f})")
    print(f"wide heads (d_model 768, 3 heads of 256), device ms on {card}: kernel 1 B 4 "
          f"{k1['ms']:.4f} (SDPA {k1['library_ms']:.4f}, bound {k1['bound_ms']:.4f}), B 8 "
          f"{b8['ms']:.4f} (SDPA {b8['library_ms']:.4f}); kernel 4 call B 8 {k4['ms']:.4f} "
          f"(SDPA backward {k4['library_ms']:.4f}, bound {k4['bound_ms']:.4f}); kernel 13 int8 "
          f"{int8['ms']:.4f} "
          f"(bound {int8['bound_ms']:.4f}), bf16 {int8['bf16']['ms']:.4f} (SDPA "
          f"{int8['bf16']['library_ms']:.4f}, bound {int8['bf16']['bound_ms']:.4f})")
    torch.cuda.empty_cache()
    return out


def wide_heads_phase(torch, tmp, vocab, train_args, card):
    """Phase 5d, the flagship's width past d_head 128, each part fatal: the
    20-layer model at --n_head 3 (d_head 256) trained through the CLI (2
    steps, then 2 warm-up and 5 timed by timed_training: tokens/sec, device
    ms a step),
    served from its work dir at B 64, window 1216 (a 600-token prompt, 128
    sampled tokens) through the native, int8 and bf16 caches (sampled
    tokens/sec each); a 4-layer --n_head 4 (d_head 192) model trained 3
    steps and served from the int8 cache; a 4-layer --n_head 3 model
    trained 2 steps at B 2 in f32. The bf16 runs at 3 heads of 256 and 4 of
    192 fail unless kernel 1's two-warpgroup form and (training) kernel 4's
    cluster launched (``run_path``'s forms). Returns the launch counts of
    its paths."""
    from midi_emotion_tpu_torch.cli import train_cli
    from midi_emotion_tpu_torch.convert import load_model_dir
    from midi_emotion_tpu_torch.generation.sampler import Sampler
    from midi_emotion_tpu_torch.ops.sampling import SamplingParams

    t_phase = time.perf_counter()
    train_kernels = ("flash_rel_attn_fwd", "flash_rel_attn_bwd", "dropout", "dal_fwd", "dal_bwd")
    serve_kernels = ("flash_rel_attn_fwd", "ln_fwd")
    counts = []

    # bf16 at d_head 129-256: kernel 1's two-warpgroup form, kernel 4's cluster
    new_forms = (("flash_rel_attn_fwd", "parts"), ("flash_rel_attn_bwd", "cluster"))

    def train(label, work, extra, steps, forms=()):
        c, runner = run_path(f"train ({label})", train_kernels, lambda: train_cli.main(
            train_args + extra + ["--work_dir", os.path.join(tmp, work), "--max_step", str(steps),
                                  "--log_step", "1"]), forms=forms)
        losses = train_losses(runner.args.work_dir)
        print(f"train CLI ({label}): logged losses {losses}")
        if runner.train_step_num != steps or len(losses) != steps or not all(np.isfinite(losses)):
            fail(f"{label}: the run did not take its {steps} steps with finite losses")
        counts.append(c)
        return runner

    runner = train("d_model 768, 3 heads of 256", "wide", ["--n_head", "3"], 2, new_forms)
    mcfg = runner.model.config
    if mcfg.n_head != 3:
        fail(f"the wide run built {mcfg.n_head} heads")
    n_params = sum(p.numel() for p in runner.model.parameters())
    tps, secs, per_step, losses, dev_ms = timed_training(torch, runner)
    print(f"wide train ({mcfg.n_layer} layers, d_model {mcfg.d_model}, {mcfg.n_head} heads of "
          f"{mcfg.d_model // mcfg.n_head}, {n_params} parameters): "
          f"{tps:.1f} tokens/sec ({secs * 1e3:.2f} ms/step over 5 steps after 2 warm-up), "
          f"{dev_ms:.2f} device ms/step (profiled), losses {losses}, kernel launches per step "
          f"{per_step} on {card}")
    if per_step["flash_rel_attn_fwd"] <= 0 or per_step["flash_rel_attn_bwd"] <= 0:
        fail("the wide train steps did not launch kernels 1 and 4")
    work = runner.args.work_dir
    del runner
    torch.cuda.empty_cache()

    model = load_model_dir(work, torch.bfloat16, "cuda")[1]
    B, prompt, new = 64, 600, 128
    ids = np.flatnonzero(~vocab.special_mask())
    primer = np.random.RandomState(SEED).choice(ids, size=(B, prompt)).astype(np.int32)
    primer[:, 0] = vocab.start_id
    cond = np.tile(np.array([[0.8, -0.5]], np.float32), (B, 1))
    # gen_len counts the primer's last token: prompt + new ids come back
    sp = SamplingParams(gen_len=new + 1, max_input_len=1216, top_p=0.7, seed=1)
    rates = {}
    for kv_dtype in ("native", "int8", "bf16"):
        def serve():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            song = Sampler(model, vocab, sp, kv_dtype=kv_dtype).generate(
                primer, continuous_conditions=cond)
            torch.cuda.synchronize()
            return song, time.perf_counter() - t0

        c, (song, secs) = run_path(
            f"generation (3 heads of 256, {kv_dtype} cache, B {B})",
            serve_kernels + (() if kv_dtype == "native" else ("decode_attn_stacked",)), serve,
            forms=new_forms[:1])
        counts.append(c)
        if song.shape != (B, prompt + new) or vocab.special_mask()[song[:, prompt:]].any():
            fail(f"wide model, {kv_dtype} cache: bad sampled ids {song.shape}")
        rates[kv_dtype] = B * new / secs
        print(f"wide serve ({kv_dtype} cache): {rates[kv_dtype]:.1f} sampled tokens/sec (B {B}, "
              f"{prompt}-token prompt, {new} new, window 1216, bf16, {secs:.2f} s) on {card}")
    del model
    torch.cuda.empty_cache()

    runner = train("4 layers, 4 heads of 192", "wide_192", ["--n_head", "4", "--n_layer", "4"], 3,
                   new_forms)
    model = load_model_dir(runner.args.work_dir, torch.bfloat16, "cuda")[1]
    del runner
    sp4 = SamplingParams(gen_len=300, max_input_len=256, top_p=0.7, seed=2)

    def serve4():
        return Sampler(model, vocab, sp4, kv_dtype="int8").generate(
            np.full((4, 1), vocab.start_id, np.int32), continuous_conditions=cond[:4])

    c, song = run_path("generation (4 heads of 192, int8 cache)",
                       serve_kernels + ("decode_attn_stacked",), serve4, forms=new_forms[:1])
    counts.append(c)
    if song.shape != (4, 300) or vocab.special_mask()[song[:, 1:]].any():
        fail(f"d_head 192 model, int8 cache: bad sampled ids {song.shape}")
    print("d_head 192 model: sampled 4 x 300 valid ids through the int8 cache")
    del model
    torch.cuda.empty_cache()
    train("4 layers, 3 heads of 256, f32, B 2", "wide_f32", ["--n_head", "3", "--n_layer", "4",
                                                             "--dtype", "f32", "--batch_size", "2"],
          2, (("flash_rel_attn_fwd", "cuda_cores"), ("flash_rel_attn_bwd", "cuda_cores")))
    torch.cuda.empty_cache()
    print(f"phase 5d (d_head past 128): {time.perf_counter() - t_phase:.1f} s; wide train "
          f"tokens/sec {tps:.1f}, {dev_ms:.2f} device ms/step; sampled tokens/sec native "
          f"{rates['native']:.1f}, int8 {rates['int8']:.1f}, bf16 {rates['bf16']:.1f} on {card}")

    # past d_head 256, on the wide kernels: 2 heads of 384 at full depth
    t_phase = time.perf_counter()
    runner = train("d_model 768, 2 heads of 384", "wide384", ["--n_head", "2"], 2)
    n_params = sum(p.numel() for p in runner.model.parameters())
    if runner.model.config.n_head != 2 or n_params != 158841071:
        fail(f"the --n_head 2 run built {runner.model.config.n_head} heads, {n_params} parameters "
             f"(want 2 and 158841071)")
    tps384, secs384, per_step, losses, dev_ms384 = timed_training(torch, runner)
    print(f"wide train (20 layers, d_model 768, 2 heads of 384, {n_params} parameters): "
          f"{tps384:.1f} tokens/sec ({secs384 * 1e3:.2f} ms/step over 5 steps after 2 warm-up), "
          f"{dev_ms384:.2f} device ms/step (profiled), losses {losses}, kernel launches per step "
          f"{per_step} on {card}")
    if per_step["flash_rel_attn_fwd"] <= 0 or per_step["flash_rel_attn_bwd"] <= 0:
        fail("the d_head-384 train steps did not launch kernels 1 and 4")
    work = runner.args.work_dir
    del runner
    torch.cuda.empty_cache()
    model = load_model_dir(work, torch.bfloat16, "cuda")[1]
    rates384 = {}
    for kv_dtype in ("native", "int8", "bf16"):
        def serve384():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            song = Sampler(model, vocab, sp, kv_dtype=kv_dtype).generate(
                primer, continuous_conditions=cond)
            torch.cuda.synchronize()
            return song, time.perf_counter() - t0

        c, (song, secs) = run_path(
            f"generation (2 heads of 384, {kv_dtype} cache, B {B})",
            serve_kernels + (() if kv_dtype == "native" else ("decode_attn_stacked",)), serve384)
        counts.append(c)
        if song.shape != (B, prompt + new) or vocab.special_mask()[song[:, prompt:]].any():
            fail(f"d_head-384 model, {kv_dtype} cache: bad sampled ids {song.shape}")
        rates384[kv_dtype] = B * new / secs
        print(f"wide serve, 2 heads of 384 ({kv_dtype} cache): {rates384[kv_dtype]:.1f} sampled "
              f"tokens/sec (B {B}, {prompt}-token prompt, {new} new, window 1216, bf16, "
              f"{secs:.2f} s) on {card}")
    del model
    torch.cuda.empty_cache()

    # one head of 768, 4 layers: trained, then served from the int8 and bf16 caches
    runner = train("4 layers, 1 head of 768", "wide768", ["--n_head", "1", "--n_layer", "4"], 3)
    model = load_model_dir(runner.args.work_dir, torch.bfloat16, "cuda")[1]
    del runner
    for kv_dtype in ("int8", "bf16"):
        def serve768():
            return Sampler(model, vocab, sp4, kv_dtype=kv_dtype).generate(
                np.full((4, 1), vocab.start_id, np.int32), continuous_conditions=cond[:4])

        c, song = run_path(f"generation (1 head of 768, {kv_dtype} cache)",
                           serve_kernels + ("decode_attn_stacked",), serve768)
        counts.append(c)
        if song.shape != (4, 300) or vocab.special_mask()[song[:, 1:]].any():
            fail(f"d_head 768 model, {kv_dtype} cache: bad sampled ids {song.shape}")
    print("d_head 768 model: sampled 4 x 300 valid ids through the int8 and bf16 caches")
    del model
    torch.cuda.empty_cache()

    # kernels 5-9 on their wide form: a train step under each other
    # decomposition at 3 heads of 256 and 1 of 768 (4 layers)
    for heads in ("3", "1"):
        for impl, dqde in DECOMPOSITIONS:
            def run_decomposition():
                with bwd_decomposition(impl, dqde):
                    return train_cli.main(train_args + [
                        "--n_head", heads, "--n_layer", "4", "--max_step", "1", "--log_step", "1",
                        "--work_dir", os.path.join(tmp, f"wide_{heads}_{impl}_{dqde}")])
            c, runner = run_path(
                f"train (4 layers, --n_head {heads}, MIDI_EMOTION_BWD={impl} DQDE={dqde})",
                ("flash_rel_attn_fwd", *DECOMPOSITIONS[impl, dqde]), run_decomposition,
                absent=("flash_rel_attn_bwd",),
                forms=tuple((k, "streamed") for k in DECOMPOSITIONS[impl, dqde]),
                absent_forms=OLD_WGMMA_FORMS)
            counts.append(c)
            d_losses = train_losses(runner.args.work_dir)
            if runner.train_step_num != 1 or len(d_losses) != 1 or not np.isfinite(d_losses[0]):
                fail(f"--n_head {heads} {impl}/{dqde}: the step did not run to a finite loss")
            del runner
            torch.cuda.empty_cache()
        print(f"--n_head {heads} (d_head {768 // int(heads)}): one train step under each of "
              f"split, fused/column and fused/dist")
    train("4 layers, 1 head of 768, f32, B 2", "wide768_f32", ["--n_head", "1", "--n_layer", "4",
                                                               "--dtype", "f32", "--batch_size",
                                                               "2"], 2)
    torch.cuda.empty_cache()
    print(f"phase 5d past d_head 256: {time.perf_counter() - t_phase:.1f} s; 2 heads of 384: "
          f"train tokens/sec {tps384:.1f}, {dev_ms384:.2f} device ms/step; sampled tokens/sec "
          f"native {rates384['native']:.1f}, int8 {rates384['int8']:.1f}, bf16 "
          f"{rates384['bf16']:.1f} on {card}")
    return counts


# ---------------------------------------------------------------------------
# phase 7: timed generation
# ---------------------------------------------------------------------------


def timed_generation(torch, model, vocab, B, gen_len, max_input_len, kv_dtype="native"):
    from midi_emotion_tpu_torch.generation.sampler import Sampler
    from midi_emotion_tpu_torch.ops.sampling import SamplingParams

    sp = SamplingParams(gen_len=gen_len, max_input_len=max_input_len, top_p=0.7, seed=1)
    cond = np.tile(np.array([[0.8, 0.8]], np.float32), (B, 1))
    primer = np.full((B, 1), vocab.start_id, np.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    song = Sampler(model, vocab, sp, kv_dtype=kv_dtype).generate(primer,
                                                                 continuous_conditions=cond)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if song.shape != (B, gen_len) or vocab.special_mask()[song[:, 1:]].any():
        fail(f"timed generation B={B}: bad output {song.shape}")
    return B * (gen_len - 1) / secs, secs


def check_stacked_steps(torch, model, label="flagship bf16"):
    """A bf16 model on the card (the trained flagship, or the d_head-40
    model): prefill a 100-token prompt at window 1408, then 10
    teacher-forced steps through the staged stacked cache (S 8, so one
    flush) against the native cache's decode steps. The bounds are the JAX
    package's (tests/test_decode_attention.py): int8 within 5% of the
    native logits' scale, bf16 within 2%."""
    from midi_emotion_tpu_torch.ops.decode_attention import flush_pend

    B, T, W, S, n = 4, 100, DECODE["W"], DECODE["S"], 10
    cfg = model.config
    g = torch.Generator().manual_seed(SEED + 6)
    tokens = torch.randint(2, 1007, (B, T + n), generator=g).cuda()
    cond = torch.tensor([[0.8, 0.8], [-0.5, 0.5], [0.3, -0.3], [-0.9, -0.9]], device="cuda")
    with torch.inference_mode():
        ce = model.condition_embedding(cond)
        _, cache = model.prefill(tokens[:, :T], cond, W)
        native = []
        for i in range(n):
            logits, cache = model.decode_step(tokens[:, T + i], ce, cache)
            native.append(logits.float())
        del cache
        for quant, limit in ((True, 0.05), (False, 0.02)):
            _, cache = model.prefill_q(tokens[:, :T], cond, W, quant)
            kv, sc = cache["kv"], cache.get("sc")
            pend = torch.zeros((S, cfg.n_layer, B, kv.shape[-1]), dtype=torch.bfloat16,
                               device="cuda")
            f_len, p, worst = T, 0, 0.0
            for i in range(n):
                logits, pend = model.decode_step_staged(tokens[:, T + i], ce, kv, sc, pend,
                                                        f_len, p)
                p += 1
                if p == S:
                    flush_pend(kv, sc, pend, f_len, cfg.n_head)
                    f_len, p = f_len + S, 0
                ref = native[i]
                err = (logits.float() - ref).abs().max().item() / ref.abs().max().item()
                if not torch.isfinite(logits).all():
                    fail("stacked decode: non-finite logits")
                worst = max(worst, err)
            mode = "int8" if quant else "bf16"
            print(f"stacked {mode} decode steps vs native ({label}, B={B}, prompt {T}, "
                  f"{n} steps, one flush): worst error {worst:.3e} of the logits' scale "
                  f"(limit {limit})")
            if worst > limit:
                fail(f"stacked {mode} decode steps disagree with the native cache")
            del cache, kv, sc, pend
    torch.cuda.empty_cache()


# a d_head the decode kernel is not built for (d_model 640, 16 heads of 40,
# as a model of that width has): its stacked cache holds each head at 48
# columns. Two layers, random weights from the seed.
PADDED_HEADS = dict(FLAGSHIP, n_layer=2, d_model=640, d_inner=2560, d_condition=160, dropout=0.0)


def serve_padded_heads(torch, vocab):
    """The d_head-40 model (bf16) on the card: its stacked int8 and bf16
    decode steps against its native ones (check_stacked_steps), then
    Sampler.generate through each stacked cache (B 4, 300 tokens, window
    256, so it crosses flushes and refreshes): valid ids of the right shape.
    Returns the launch counts of the two generation runs (one path)."""
    from midi_emotion_tpu_torch.generation.sampler import Sampler
    from midi_emotion_tpu_torch.models.config import ModelConfig
    from midi_emotion_tpu_torch.models.model import MusicTransformer
    from midi_emotion_tpu_torch.ops.sampling import SamplingParams

    cfg = ModelConfig(**PADDED_HEADS)
    model = MusicTransformer(cfg, dtype=torch.bfloat16, device="cuda").init_weights(
        torch.Generator().manual_seed(SEED + 8))
    model.eval()
    check_stacked_steps(torch, model, f"d_model {cfg.d_model}, {cfg.n_head} heads of "
                                      f"{cfg.d_model // cfg.n_head}, bf16")
    B, gen_len = 4, 300
    sp = SamplingParams(gen_len=gen_len, max_input_len=256, top_p=0.7, seed=2)
    cond = np.tile(np.array([[0.8, -0.5]], np.float32), (B, 1))
    primer = np.full((B, 1), vocab.start_id, np.int32)

    def run():
        for kv_dtype in ("int8", "bf16"):
            song = Sampler(model, vocab, sp, kv_dtype=kv_dtype).generate(
                primer, continuous_conditions=cond)
            torch.cuda.synchronize()
            if song.shape != (B, gen_len) or vocab.special_mask()[song[:, 1:]].any():
                fail(f"d_head 40 model, {kv_dtype} cache: bad sampled ids {song.shape}")
            print(f"d_head 40 model, {kv_dtype} cache: sampled {B} x {gen_len} valid ids")

    counts, _ = run_path("generation (d_head 40 model, --kv_dtype int8 then bf16)",
                         ("flash_rel_attn_fwd", "ln_fwd", "decode_attn_stacked"), run)
    del model
    torch.cuda.empty_cache()
    return counts


def check_midis(vocab, out, n, gen_len):
    from midi_emotion_tpu_torch.data import midi_io

    mids = sorted(f for f in os.listdir(out) if f.endswith(".mid"))
    if len(mids) < n:
        fail(f"{out}: expected >= {n} MIDI files, found {mids}")
    special = vocab.special_mask()
    for f in mids:
        tracks = midi_io.read_midi(os.path.join(out, f))
        ids = np.load(os.path.join(out, "inds_" + f[:-4] + ".npy"))
        if ids.shape != (gen_len,) or special[ids[1:]].any() or ids.max() >= 1007:
            fail(f"{f}: bad sampled ids")
        print(f"{os.path.basename(out)}/{f}: {len(tracks)} tracks, "
              f"{sum(len(t.notes) for t in tracks)} notes")


def profile_decode(torch, model, vocab, kv_dtype, B=64, prompt_len=600, steps=8):
    """torch.profiler over ``steps`` decode steps of the Sampler's own chunk
    loop at B 64 (window 1408, a 600-token prompt, after a warm-up chunk):
    wall ms per step under the profiler, device-busy share and the top five
    kernels per step."""
    from torch.profiler import ProfilerActivity, profile

    from midi_emotion_tpu_torch.generation.sampler import Sampler
    from midi_emotion_tpu_torch.ops.sampling import SamplingParams

    sampler = Sampler(model, vocab, SamplingParams(gen_len=1024, max_input_len=1216, top_p=0.7),
                      kv_dtype=kv_dtype)
    g = torch.Generator().manual_seed(SEED + 7)
    prompt = torch.randint(2, 1007, (B, prompt_len), generator=g).numpy()
    cond = torch.full((B, 2), 0.5, device="cuda")
    u = torch.rand((2 * steps, B), generator=g).cuda()
    with torch.inference_mode():
        logits, cache, ce = sampler._prefill(prompt, cond, DECODE["W"])
        chunk = sampler._decode_chunk
        if sampler.stage_steps:
            cache, chunk = sampler._to_staged(cache, B), sampler._decode_chunk_staged
        key = torch.full((B,), vocab.start_id, dtype=torch.long, device="cuda")
        counts = torch.zeros((B,), dtype=torch.long, device="cuda")
        _, logits, cache, counts = chunk(steps, cache, logits, key, counts, u[:steps], ce, None)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            chunk(steps, cache, logits, key, counts, u[steps:], ce, None)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t1
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    device_us = sum(e.self_device_time_total for e in events)
    print(f"decode profile {kv_dtype} (B={B}, window {DECODE['W']}, prompt {prompt_len}, "
          f"{steps} steps): {secs * 1e3 / steps:.2f} ms/step wall under the profiler, device "
          f"busy {device_us / 1e3 / steps:.3f} ms/step ({100 * device_us / 1e6 / secs:.1f}% of "
          f"wall), {sum(e.count for e in events) / steps:.0f} kernels/step")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:5]:
        print(f"  {e.self_device_time_total / 1e3 / steps:9.3f} ms/step "
              f"{100 * e.self_device_time_total / device_us:5.1f}%  x{e.count // steps:<5d} "
              f"{e.key[:90]}")
    del cache
    torch.cuda.empty_cache()


def _kernel_label(mangled):
    """A readable name for a mangled kernel of this repository's sources."""
    m = re.search(r"(wide_bwd_tc_cluster_kernel)ILi(\d+)E", mangled)
    if m:  # templated on its part's width, not on d_head
        return f"{m.group(1)} <bf16, part={m.group(2)}>"
    m = re.search(r"(decode_attn_stacked_kernel)ILi(\d+)ELb([01])E", mangled)
    if m:
        kern, dh, quant = m.groups()
        return f"{kern} <dh={dh}, {'int8' if quant == '1' else 'bf16'}>"
    m = re.search(r"\d([a-z][a-z_]*_kernel)(?:I(13__nv_bfloat16|f)?(?:Li(\d+)E)?(?:L[bi](\d)E)?)?",
                  mangled)
    if m:
        kern, t, dh, mode = m.groups()
        modes = {"flash_rel_attn_bwd_kv_kernel": ("dK/dV", "dK/dV/dQ_qk"),
                 "flash_rel_attn_bwd_q_kernel": ("column", "dist", "rel"),
                 "flash_bwd_q_wg_tc_kernel": ("column", "dist", "rel")}
        extra = f", {modes[kern][int(mode)]}" if mode and kern in modes else ""
        # the tensor-core kernels take bf16 alone, the CUDA-core flash
        # kernels of kernels 1 and 4 f32 alone; the others name their type
        if t is None and dh is None:
            return kern  # not a template
        bf16 = t == "13__nv_bfloat16" or (t is None and "_tc_" in kern)
        return f"{kern} <{'bf16' if bf16 else 'f32'}{', dh=' + dh if dh else ''}{extra}>"
    return mangled


def ptxas_report(lib_path):
    """[(kernel label, registers, bytes spilled)] from the library's ptxas
    report (``-Xptxas -v``, kept beside it by kernels/build.py), and the
    report's text."""
    log = lib_path.with_name(lib_path.name + ".log")
    if not log.exists():
        return [], ""
    text = log.read_text()
    kinds = re.findall(r"Compiling entry function '(\S+)'", text)
    regs = re.findall(r"Used (\d+) registers", text)
    spills = re.findall(r"(\d+) bytes spill stores", text)
    return [(_kernel_label(k), int(r), int(sp)) for k, r, sp in zip(kinds, regs, spills)], text


def ptxas_forms(lib_path, pick):
    """{kernel label: registers, bytes spilled and whether ptxas reported
    its wgmma serialized} for the library's kernels whose label holds
    ``pick``, from the ptxas report: a "Performance Loss" line that names
    the kernel, or one inside its entry's part of the report."""
    log = lib_path.with_name(lib_path.name + ".log")
    text = log.read_text() if log.exists() else ""
    out = {}
    for part in text.split("Compiling entry function '")[1:]:
        mangled = part.split("'", 1)[0]
        label = _kernel_label(mangled)
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores", part)
        if pick not in label or regs is None:
            continue
        serialized = any("Performance Loss" in line and "wgmma" in line
                         and (mangled in line or "'" not in line)
                         for line in part.splitlines()) or any(
            "Performance Loss" in line and mangled in line for line in text.splitlines())
        out[label] = {"registers": int(regs.group(1)),
                      "spilled": int(spill.group(1)) if spill else 0,
                      "wgmma_serialized": serialized}
    return out


def print_ptxas(lib_path, label):
    kernels, text = ptxas_report(lib_path)
    for kern, r, sp in kernels:
        print(f"ptxas: {label} {kern}: {r} registers, {sp} bytes spilled")
    for line in text.splitlines():  # e.g. wgmma serialized by the compiler
        if "Performance Loss" in line:
            print(f"ptxas: {label}: {line.strip()[:300]}")


def print_sass_mma(lib_path, label):
    """Count each kernel's tensor-core instructions (HMMA for mma.sync,
    HGMMA for wgmma) in the library's SASS, by cuobjdump, and print them.
    Returns {kernel label: {"HMMA": count, "HGMMA": count}}."""
    cuda_bin = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin")
    tool = shutil.which("cuobjdump") or os.path.join(cuda_bin, "cuobjdump")
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                         timeout=300)
    if out.returncode != 0:
        fail(f"cuobjdump -sass {lib_path} failed: {out.stderr.strip()[-2000:]}")
    counts, kern = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            kern = _kernel_label(m.group(1))
            counts[kern] = {"HMMA": 0, "HGMMA": 0}
        elif kern is not None:
            m = re.search(r"\b(HG?MMA)\.", line)
            if m:
                counts[kern][m.group(1)] += 1
    for kern, n in counts.items():
        print(f"sass: {label} {kern}: {n['HMMA']} HMMA (mma.sync), {n['HGMMA']} HGMMA (wgmma) "
              f"instructions")
    return counts


def main():
    import torch

    # phase 1 -----------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain f32 twins in full f32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    from midi_emotion_tpu_torch.cli import generate_cli, train_cli
    from midi_emotion_tpu_torch.convert import load_model_dir, save_reference_dir
    from midi_emotion_tpu_torch.kernels.build import CUDA_SOURCES, build_all, library_path
    from midi_emotion_tpu_torch.models.config import ModelConfig
    from midi_emotion_tpu_torch.models.model import MusicTransformer
    from midi_emotion_tpu_torch.training.checkpoint import load_stats
    from midi_emotion_tpu_torch.vocab import Vocab

    vocab = Vocab()  # the default 1007-token vocabulary

    # phase 2 -----------------------------------------------------------
    t0 = time.perf_counter()
    build_all()
    print(f"built {', '.join(CUDA_SOURCES)} in {time.perf_counter() - t0:.1f} s")
    for name in CUDA_SOURCES:
        print_ptxas(library_path(name), name)
    tc_kernels = {}
    for name in ("flash_rel_attn_fwd", "flash_rel_attn_bwd", "flash_rel_attn_bwd_kv",
                 "flash_rel_attn_bwd_q", "flash_rel_attn_wide"):
        # the tensor-core kernels (kernels 1 and 4-9 in bf16, their wide
        # forms too) run mma instructions
        tc_kernels.update({k: n for k, n in print_sass_mma(library_path(name), name).items()
                           if "_tc_" in k})
    idle = [k for k, n in tc_kernels.items() if n["HMMA"] + n["HGMMA"] == 0]
    if idle:
        fail(f"tensor-core kernels without an mma instruction: {idle}")
    # kernels 1 and 4 run wgmma at every d_head they are built for: the
    # tile kernels up to 128, kernel 1's two-warpgroup form at 192 and 256,
    # kernel 4's cluster at 192 and 256 (parts of 96 and 128); so do
    # kernels 5-8 up to 128
    from midi_emotion_tpu_torch.ops.flash_attention import DECOMPOSITION_DHS

    wanted = [f"{kern} <bf16, dh={dh}>" for kern in ("flash_fwd_tc_kernel", "flash_bwd_tc_kernel")
              for dh in DECOMPOSITION_DHS]
    wanted += [f"flash_fwd_tc_parts_kernel <bf16, dh={dh}>" for dh in (192, 256)]
    # kernels 6 and 8 (DIST and REL; kernel 5 runs DIST's) and 7 on wgmma at
    # every d_head they are built for
    wanted += [f"flash_bwd_q_wg_tc_kernel <bf16, dh={dh}, {mode}>" for dh in DECOMPOSITION_DHS
               for mode in ("dist", "rel")]
    wanted += [f"flash_bwd_kv_wg_tc_kernel <bf16, dh={dh}>" for dh in DECOMPOSITION_DHS]
    wanted += [f"wide_bwd_tc_cluster_kernel <bf16, part={pw}>" for pw in (96, 128)]
    no_wgmma = [k for k in wanted if tc_kernels.get(k, {"HGMMA": 0})["HGMMA"] == 0]
    if no_wgmma:
        fail(f"kernel 1, 4, 6, 7 or 8 instantiations without a wgmma (HGMMA) instruction: "
             f"{no_wgmma}")
    # kernel 9 (the key-major sweep without dQ, mma.sync) among them, and
    # the wide forms' four sweeps
    for want in ("flash_bwd_kv_tc_kernel <bf16, dh=48>", "wide_fwd_tc_kernel",
                 "wide_dq_tc_kernel", "wide_dkdv_tc_kernel", "wide_de_tc_kernel"):
        if want not in tc_kernels:
            fail(f"no tensor-core kernel {want} in the SASS")
    # kernel 1 in bf16 past d_head 256: the cluster kernel, on wgmma
    if tc_kernels.get("wide_fwd_tc_cluster_kernel", {"HGMMA": 0})["HGMMA"] == 0:
        fail("no wgmma (HGMMA) instruction in wide_fwd_tc_cluster_kernel")

    # phase 3 -----------------------------------------------------------
    # Tolerances: f32 pins the algorithm (kernel and twin both sum in f32,
    # in different orders): 1e-4 on O and lse over 1216 keys; 1e-4 of each
    # gradient's scale for the backward, whose dE sums B*H*T terms. bf16
    # pins the kernel in its working type: both compute in f32 from the
    # same bf16 inputs and round once to bf16, so outputs may differ by a
    # bf16 ulp: 2e-2 on O (|O| up to ~2.5), 1e-3 on lse (f32), 2e-2 of each
    # gradient's scale, 2^-7 of the row scale for LayerNorm. The dropout
    # kernel and its twin round the same f32 product: exact.
    check_flash(torch, 2, 16, 1216, 48, torch.float32, True, 1e-4, 1e-4)
    check_flash(torch, 2, 16, 1216, 48, torch.bfloat16, True, 2e-2, 1e-3)
    check_flash(torch, 2, 16, 200, 48, torch.float32, False, 1e-4, 1e-4)
    check_flash(torch, 2, 16, 200, 48, torch.bfloat16, False, 2e-2, 1e-3)
    # the other d_head instantiations, one each, and 40 through the padding
    for dh in (16, 32, 40, 64, 96, 128):
        check_flash(torch, 2, 4, 333, dh, torch.float32, True, 1e-4, 1e-4)
        check_flash(torch, 2, 4, 333, dh, torch.bfloat16, True, 2e-2, 1e-3)
    # the CLI run's two prefill shapes: the one-token primer, then a refresh
    check_flash(torch, 4, 16, 1, 48, torch.bfloat16, True, 2e-2, 1e-3)
    flash = check_flash(torch, 4, 16, 1216, 48, torch.bfloat16, True, 2e-2, 1e-3, timed=True)
    check_flash_bwd(torch, TRAIN_B, 16, TRAIN_T, 48, torch.float32, True, 1e-4)
    check_flash_bwd(torch, 2, 4, 333, 64, torch.float32, False, 1e-4)
    check_flash_bwd(torch, 2, 4, 333, 64, torch.bfloat16, False, 2e-2)
    check_flash_bwd(torch, 2, 4, 100, 16, torch.float32, True, 1e-4)
    # bf16 at each other d_head, f32 at the wide ones and at 40 (padded)
    for dh in (16, 32, 40, 96, 128):
        check_flash_bwd(torch, 2, 4, 200, dh, torch.bfloat16, True, 2e-2)
        if dh > 64 or dh == 40:
            check_flash_bwd(torch, 2, 4, 200, dh, torch.float32, True, 1e-4)
    flash_bwd = check_flash_bwd(torch, TRAIN_B, 16, TRAIN_T, 48, torch.bfloat16, True, 2e-2,
                                timed=True, launches=True)
    # kernel 1 at the train step's shape too, beside the table's B 4
    flash_b8 = check_flash(torch, TRAIN_B, 16, TRAIN_T, 48, torch.bfloat16, True, 2e-2, 1e-3,
                           timed=True)
    flash["train_shape"] = {"B": TRAIN_B, **{key: flash_b8[key] for key in (
        "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err")}}
    # what the widest heads cost: d_head 128 timed beside d_head 64 at one
    # width (H * dh = 1024), kernels 1 and 4 in both dtypes, at B 2
    for H, dh in ((16, 64), (8, 128)):
        check_flash(torch, 2, H, 1216, dh, torch.float32, True, 1e-4, 1e-4, timed=True)
        check_flash(torch, 2, H, 1216, dh, torch.bfloat16, True, 2e-2, 1e-3, timed=True)
        check_flash_bwd(torch, 2, H, 1216, dh, torch.float32, True, 1e-4, timed=True)
        check_flash_bwd(torch, 2, H, 1216, dh, torch.bfloat16, True, 2e-2, timed=True)
    # past d_head 128: kernels 1 and 4 at 160, 192, 224 and 256 (160 and 224
    # through the padding), ragged T with a pad tail and a fully masked row;
    # each output within 1e-4 (f32) or 2e-2 (bf16) of 1 + its scale
    for dh in WIDE_DHS:
        for dtype, tol_o, tol_lse in ((torch.float32, 1e-4, 1e-4), (torch.bfloat16, 2e-2, 1e-3)):
            check_flash(torch, 2, 2, 333, dh, dtype, True, tol_o, tol_lse, rel=True)
            check_flash_bwd(torch, 2, 2, 333, dh, dtype, True, tol_o)
    check_flash(torch, 2, 2, 200, 256, torch.bfloat16, False, 2e-2, 1e-3, rel=True)
    check_flash_bwd(torch, 2, 2, 200, 256, torch.bfloat16, False, 2e-2)
    wide = wide_flagship_kernels(torch, card)
    # past the built widths, on the wide kernels: kernels 1 and 4 at 320
    # (padded to 384), 384 and 768, kernels 5-9 at 192, 256 and 384, kernel
    # 13 at 320, 384 and 768, f32 and bf16 at small B, the tolerances above
    for dh in STREAMED_DHS:
        for dtype, tol_o, tol_lse in ((torch.float32, 1e-4, 1e-4), (torch.bfloat16, 2e-2, 1e-3)):
            check_flash(torch, 2, 2, 333, dh, dtype, True, tol_o, tol_lse, rel=True)
            check_flash_bwd(torch, 2, 2, 333, dh, dtype, True, tol_o)
        for quant in (True, False):
            check_decode(torch, quant, shape=dict(L=2, B=4, W=256, H=2 if dh < 768 else 1, dh=dh,
                                                  S=8), lengths=(0, 1, 127, 128, 129, 200, 248))
    check_flash(torch, 2, 2, 200, 384, torch.bfloat16, False, 2e-2, 1e-3, rel=True)
    check_flash_bwd(torch, 2, 2, 200, 384, torch.float32, False, 1e-4)
    # kernels 1 and 4's cluster kernels at 9 CTAs (a non-portable cluster
    # size); kernel 13 at 1024, its widest stacked instantiation, and at
    # 1152, past it, on the per-head kernel
    check_flash(torch, 2, 1, 333, 1152, torch.bfloat16, True, 2e-2, 1e-3, rel=True)
    check_flash_bwd(torch, 2, 1, 333, 1152, torch.bfloat16, True, 2e-2)
    check_flash_bwd(torch, 2, 1, 200, 1152, torch.bfloat16, False, 2e-2)
    for dh in (1024, 1152):
        for quant in (True, False):
            check_decode(torch, quant, shape=dict(L=2, B=4, W=256, H=1, dh=dh, S=8),
                         lengths=(0, 1, 127, 128, 129, 200, 248))
    for kernel in BWD_KERNELS:
        for dh in DECOMPOSITION_WIDE_DHS:
            check_bwd_kernel(torch, kernel, 2, 2, 333, dh, torch.float32, True, 1e-4)
            check_bwd_kernel(torch, kernel, 2, 2, 333, dh, torch.bfloat16, True, 2e-2)
        check_bwd_kernel(torch, kernel, 2, 2, 200, 256, torch.float32, False, 1e-4)
    streamed = streamed_flagship_kernels(torch, card)
    check_no_fallback(torch)
    bwd_kernels = {}
    for kernel in BWD_KERNELS:  # the other decompositions' kernels, same tolerances
        check_bwd_kernel(torch, kernel, TRAIN_B, 16, TRAIN_T, 48, torch.float32, True, 1e-4)
        check_bwd_kernel(torch, kernel, 2, 4, 333, 64, torch.float32, False, 1e-4)
        check_bwd_kernel(torch, kernel, 2, 4, 100, 16, torch.float32, True, 1e-4)
        for dh in (40, 96, 128):  # 40 through the padding
            check_bwd_kernel(torch, kernel, 2, 4, 200, dh, torch.float32, True, 1e-4)
            check_bwd_kernel(torch, kernel, 2, 4, 200, dh, torch.bfloat16, True, 2e-2)
        for dh in (16, 32, 64):  # bf16 at the other instantiations
            check_bwd_kernel(torch, kernel, 2, 4, 200, dh, torch.bfloat16, True, 2e-2)
        bwd_kernels[kernel] = check_bwd_kernel(torch, kernel, TRAIN_B, 16, TRAIN_T, 48,
                                               torch.bfloat16, True, 2e-2, timed=True)
        torch.cuda.empty_cache()
    check_query_sweep_kernels(torch, QUERY_SWEEP_KERNELS)
    check_query_sweep_kernels(torch, KEY_SWEEP_KERNELS)
    check_column_is_dist(torch)
    for kernel in WGMMA_KERNELS:
        print(f"{kernel} (wgmma form): {bwd_kernels[kernel]['ms']:.4f} device ms, bound "
              f"{bwd_kernels[kernel]['bound_ms']:.4f} ms (bf16 B={TRAIN_B} H=16 T={TRAIN_T} "
              f"dh=48, causal, pad tail) on {card}")
    time_dkdv_grids(torch, card)
    check_bwd_decompositions(torch)
    # the whole split backward call (dsum, kernels 7 and 8, the f32 dQ sum)
    # beside SDPA's backward, the same yardstick as kernel 4's whole call
    with bwd_decomposition("split", "column"):
        split_call = check_flash_bwd(torch, TRAIN_B, 16, TRAIN_T, 48, torch.bfloat16, True, 2e-2,
                                     timed=True)
    print(f"split backward, the whole call: {split_call['ms']:.4f} ms against SDPA's backward "
          f"{split_call['library_ms']:.4f} ms and the merged kernel's {flash_bwd['ms']:.4f} ms "
          f"(bf16 B={TRAIN_B} H=16 T={TRAIN_T} dh=48) on {card}")
    torch.cuda.empty_cache()
    rows = TRAIN_B * TRAIN_T
    check_layernorm(torch, 4864, 768, torch.float32, 1e-5)
    check_layernorm(torch, 4, 768, torch.bfloat16, 2 ** -7)  # a decode step's rows
    ln = check_layernorm(torch, 4864, 768, torch.bfloat16, 2 ** -7, timed=True)
    check_layernorm_bwd(torch, rows, 768, torch.float32, 1e-5)
    ln_bwd = check_layernorm_bwd(torch, rows, 768, torch.bfloat16, 2 ** -7, timed=True)
    check_dropout(torch, rows, 768, torch.float32, 0.1)
    dropout = check_dropout(torch, rows, 768, torch.bfloat16, 0.1, timed=True)
    check_dal(torch, rows, 768, torch.float32, 0.1, 1e-5)
    dal_fwd, dal_bwd = check_dal(torch, rows, 768, torch.bfloat16, 0.1, 2 ** -7, timed=True)
    # kernels 12 and 3 at a ragged shape: a last tile part full, rows that
    # start inside a group of four Philox words
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2 ** -7)):
        check_layernorm_bwd(torch, rows + 1, 99, dtype, tol)
        check_dal(torch, rows + 1, 99, dtype, 0.1, tol)
    time_ln_bwd_passes(torch, rows, 768, card)
    check_dropout_places(torch, card)
    decode_int8 = check_decode(torch, True, timed=True)  # the JSON line's row: int8, staged
    check_decode(torch, False, timed=True)
    for shape in DECODE_SHAPES:
        for quant in (True, False):
            check_decode(torch, quant, shape=shape, lengths=(0, 1, 127, 128, 129, 200, 248))
    check_train_step(torch)
    torch.cuda.empty_cache()
    print(f"phases 1-3: {time.perf_counter() - t_start:.1f} s")

    # phase 4 -----------------------------------------------------------
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        mcfg = ModelConfig(**FLAGSHIP)
        model = MusicTransformer(mcfg, device="cpu").init_weights(
            torch.Generator().manual_seed(SEED))
        work = os.path.join(tmp, "flagship")
        save_reference_dir(work, mcfg, model.state_dict(), vocab)
        del model
        cpu_model = load_model_dir(work, torch.float32, "cpu")[1]
        n_params = sum(p.numel() for p in cpu_model.parameters())
        print(f"work dir: random-init flagship, {n_params} parameters")

        tokens = torch.randint(2, 1007, (2, 64), generator=torch.Generator().manual_seed(SEED))
        tokens[1, -8:] = 0  # pad keys
        cond = torch.tensor([[0.8, -0.5], [0.3, -0.9]])
        with torch.inference_mode():
            want = cpu_model(tokens, cond)
            gpu_model = load_model_dir(work, torch.float32, "cuda")[1]
            got = gpu_model(tokens.cuda(), cond.cuda()).cpu()
        del cpu_model, gpu_model
        fwd_err = (got - want).abs().max().item()
        print(f"flagship forward f32, card (kernels) vs CPU (plain twins), [2, 64]: "
              f"max|dlogits|={fwd_err:.3e} (tol 2e-3)")
        if not (torch.isfinite(got).all() and got.shape == (2, 64, 1007) and fwd_err <= 2e-3):
            fail("flagship forward on the card disagrees with the CPU")

        # phase 5 -------------------------------------------------------
        shards, features = write_dataset(tmp)
        train_args = [
            "--data_folder", shards, "--feature_file", features,
            "--conditioning", "continuous_concat", "--batch_size", str(TRAIN_B),
            "--tgt_len", str(TRAIN_T), "--dtype", "bf16", "--dropout", "0.1",
            "--num_workers", "0", "--log_step", "2", "--eval_step", "1000",
            "--max_eval_step", "1", "--gen_step", "1000000", "--seed", "1", "--device", "cuda",
        ]

        def train_and_resume():
            t1 = time.perf_counter()
            # every step's loss logged, for the decomposition runs below
            first = train_cli.main(train_args + ["--work_dir", os.path.join(tmp, "run"),
                                                 "--max_step", "3", "--log_step", "1"])
            resumed = train_cli.main(train_args + [
                "--work_dir", os.path.join(tmp, "resumed"), "--max_step", "4",
                "--restart_dir", first.args.work_dir])
            torch.cuda.synchronize()
            return first, resumed, time.perf_counter() - t1

        train_counts, (first, resumed, train_secs) = run_path(
            "train (flagship, dropout 0.1, then resume)",
            ("flash_rel_attn_fwd", "flash_rel_attn_bwd", "dropout", "dal_fwd", "dal_bwd"),
            train_and_resume)
        losses = train_losses(resumed.args.work_dir)  # its csv carries the first run's
        print(f"train CLI: {first.train_step_num} steps, checkpoint, resumed from step "
              f"{load_stats(first.args.work_dir)['step']} to {resumed.train_step_num}, "
              f"{train_secs:.1f} s; logged losses {losses}")
        if first.train_step_num != 3 or resumed.train_step_num != 4 or not losses \
                or not all(np.isfinite(losses)):
            fail("the training CLI run did not take its steps with finite losses")
        trained = resumed.args.work_dir
        merged_losses = train_losses(first.args.work_dir)
        del first
        tps, step_secs, per_step, timed_losses, _ = timed_training(torch, resumed)
        print(f"train tokens/sec: {tps:.1f} (B={TRAIN_B}, T={TRAIN_T}, bf16, dropout 0.1, "
              f"{step_secs * 1e3:.2f} ms/step over 5 steps after 2 warm-up) on {card}")
        print(f"kernel launches per train step: {per_step}")
        for impl, dqde in DECOMPOSITIONS:  # the same runner, timed in turn in this call
            with bwd_decomposition(impl, dqde):
                d_tps, d_secs, d_per_step, _, _ = timed_training(torch, resumed)
            print(f"train tokens/sec, MIDI_EMOTION_BWD={impl} DQDE={dqde}: {d_tps:.1f} "
                  f"({d_secs * 1e3:.2f} ms/step over 5 steps after 2 warm-up) on {card}; "
                  f"kernel launches per step {d_per_step}")
        del resumed
        torch.cuda.empty_cache()

        # the other backward decompositions through the CLI: same seed and
        # data, 2 steps each. Step 1's loss is the same forward as the merged
        # run's, so it must match exactly. Step 2 follows one Adam step taken
        # with gradients that differ only by where bf16 rounds them (f32 sums
        # in other orders): Adam's first step moves each parameter by about
        # lr = 2e-5 whatever its gradient's size, so only gradient elements
        # whose sign flips move apart, and those are the elements near 0,
        # which barely move the loss; 1e-3 of the loss bounds that with room.
        decomposition_counts = []
        for impl, dqde in DECOMPOSITIONS:
            def run_decomposition():
                with bwd_decomposition(impl, dqde):
                    return train_cli.main(train_args + [
                        "--work_dir", os.path.join(tmp, f"run_{impl}_{dqde}"), "--max_step", "2",
                        "--log_step", "1"])
            counts, runner = run_path(
                f"train (flagship, dropout 0.1, MIDI_EMOTION_BWD={impl} DQDE={dqde})",
                ("flash_rel_attn_fwd", *DECOMPOSITIONS[impl, dqde], "dropout", "dal_fwd",
                 "dal_bwd"),
                run_decomposition, absent=("flash_rel_attn_bwd",),
                forms=tuple((k, "wgmma") for k in DECOMPOSITIONS[impl, dqde]
                            if k in WGMMA_KERNELS),
                absent_forms=OLD_WGMMA_FORMS)
            decomposition_counts.append(counts)
            d_losses = train_losses(runner.args.work_dir)
            print(f"train CLI, MIDI_EMOTION_BWD={impl} DQDE={dqde}: logged losses {d_losses}, "
                  f"merged run {merged_losses[:2]}")
            if runner.train_step_num != 2 or len(d_losses) != 2 or not all(np.isfinite(d_losses)):
                fail(f"the {impl}/{dqde} training run did not take its steps with finite losses")
            if d_losses[0] != merged_losses[0]:
                fail(f"{impl}/{dqde}: step 1's loss differs from the merged run's")
            if abs(d_losses[1] - merged_losses[1]) > 1e-3 * (1 + abs(merged_losses[1])):
                fail(f"{impl}/{dqde}: step 2's loss is off the merged run's by more than 1e-3")
            del runner
            torch.cuda.empty_cache()

        drop0_counts, drop0 = run_path(
            "train (4 layers, dropout 0)",
            ("flash_rel_attn_fwd", "flash_rel_attn_bwd", "ln_fwd", "ln_bwd"),
            lambda: train_cli.main(train_args + [
                "--work_dir", os.path.join(tmp, "drop0"), "--dropout", "0", "--n_layer", "4",
                "--max_step", "2", "--log_step", "1"]))
        torch.cuda.empty_cache()

        # phase 5b ------------------------------------------------------
        native_counts = native_phase(torch, tmp, trained, train_args, drop0)
        del drop0

        # phase 5c ------------------------------------------------------
        parallel_counts = parallel_phase(torch, tmp, train_args, card)
        torch.cuda.empty_cache()

        # phase 5d ------------------------------------------------------
        wide_counts = wide_heads_phase(torch, tmp, vocab, train_args, card)

        # phase 6 -------------------------------------------------------
        padded_counts = serve_padded_heads(torch, vocab)
        model = load_model_dir(trained, torch.bfloat16, "cuda")[1]
        check_stacked_steps(torch, model)
        B, gen_len = 4, 1400
        inference = os.path.join(trained, "generations", "inference")
        valence, arousal = ["0.8", "-0.5", "0.3", "-0.9"], ["0.8", "0.5", "-0.3", "-0.9"]

        def serve(kv_dtype, batch, length, sub):
            def run():
                t1 = time.perf_counter()
                generate_cli.main([
                    "--model_dir", trained, "--conditioning", "continuous_concat",
                    "--dtype", "bf16", "--batch_size", str(batch),
                    "--valence", *valence[:batch], "--arousal", *arousal[:batch],
                    "--gen_len", str(length), "--max_input_len", "1216", "--device", "cuda",
                    "--kv_dtype", kv_dtype, "--batch_gen_dir", sub, "--quiet",
                ])
                torch.cuda.synchronize()
                return time.perf_counter() - t1
            return run

        serve_counts, cli_secs = run_path("generation CLI (trained work dir, native cache)",
                                          ("flash_rel_attn_fwd", "ln_fwd"),
                                          serve("native", B, gen_len, "native"))
        print(f"generation CLI run, native cache: {cli_secs:.2f} s")
        check_midis(vocab, os.path.join(inference, "_native"), B, gen_len)
        int8_counts, int8_secs = run_path(
            "generation CLI (trained work dir, --kv_dtype int8)",
            ("flash_rel_attn_fwd", "ln_fwd", "decode_attn_stacked"),
            serve("int8", B, gen_len, "int8"))
        print(f"generation CLI run, int8 cache: {int8_secs:.2f} s")
        check_midis(vocab, os.path.join(inference, "_int8"), B, gen_len)
        os.environ["MIDI_EMOTION_DECODE_STAGE"] = "0"
        try:
            unstaged_counts, _ = run_path(
                "generation CLI (--kv_dtype int8, MIDI_EMOTION_DECODE_STAGE=0)",
                ("flash_rel_attn_fwd", "ln_fwd", "decode_attn_stacked"),
                serve("int8", 2, 100, "int8_unstaged"))
        finally:
            del os.environ["MIDI_EMOTION_DECODE_STAGE"]
        check_midis(vocab, os.path.join(inference, "_int8_unstaged"), 2, 100)

        from midi_emotion_tpu_torch.generation.generate import generate

        varying_out = os.path.join(inference, "_varying")
        ramp = np.linspace(-0.9, 0.9, 48, dtype=np.float32)
        exact_counts, (redo_p, redo_d, redo_c) = run_path(
            "generate() with a varying condition (generate_exact, B 2, 48 tokens, window 256)",
            ("flash_rel_attn_fwd", "ln_fwd"),
            lambda: generate(model, vocab, varying_out, "continuous_concat",
                             varying_condition=[np.stack([ramp, -ramp]), np.stack([-ramp, ramp])],
                             gen_len=48, max_input_len=256, min_n_instruments=1,
                             short_filename=True))
        n_written = len([f for f in os.listdir(varying_out) if f.endswith(".mid")])
        if n_written + len(redo_c or []) != 2 or n_written == 0:
            fail(f"generate_exact wrote {n_written} MIDI files of 2")
        check_midis(vocab, varying_out, n_written, 48)

        # phase 7 -------------------------------------------------------
        gtps, secs = timed_generation(torch, model, vocab, B, gen_len, 1216)
        print(f"generation tokens/sec: {gtps:.1f} (B={B}, gen_len={gen_len}, window 1216, "
              f"bf16, native cache, {secs:.2f} s) on {card}")
        headline = {}
        for kv_dtype in ("native", "int8", "bf16"):
            headline[kv_dtype], secs64 = timed_generation(torch, model, vocab, 64, 1024, 1216,
                                                          kv_dtype)
            print(f"headline sampled tokens/sec, {kv_dtype} cache: {headline[kv_dtype]:.1f} "
                  f"(B=64, gen_len=1024, window 1216, top-p 0.7, bf16, {secs64:.2f} s) on {card}")
            torch.cuda.empty_cache()
        for kv_dtype in ("native", "int8"):
            profile_decode(torch, model, vocab, kv_dtype)

    measured = {"flash_rel_attn_fwd": flash, "ln_fwd": ln, "ln_bwd": ln_bwd,
                "flash_rel_attn_bwd": flash_bwd, **bwd_kernels, "dropout": dropout,
                "dal_fwd": dal_fwd, "dal_bwd": dal_bwd, "decode_attn_stacked": decode_int8}
    paths = (train_counts, drop0_counts, *decomposition_counts, *native_counts,
             *parallel_counts, *wide_counts, padded_counts, serve_counts, int8_counts,
             unstaged_counts, exact_counts)
    kernels = []
    for name, route, source, replaces in KERNELS:
        m = measured[name]
        kernels.append(dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=sum(c[name] for c in paths), max_abs_err=m["max_abs_err"], ms=m["ms"],
            plain_ms=m["plain_ms"], bound_ms=m["bound_ms"], bound_by=m["bound_by"],
            library_ms=m["library_ms"],
            **{key: m[key] for key in ("train_shape", "launch_ms") if key in m},
            **({"wide_heads": wide[name]} if name in wide else {}),
            **({"wide_source": f"midi_emotion_tpu_torch/csrc/{WIDE_SOURCES[name]}",
                "streamed_heads": streamed[name]} if name in streamed else {})))
    print(f"total {time.perf_counter() - t_start:.1f} s; train tokens/sec {tps:.1f}; headline "
          f"sampled tokens/sec native {headline['native']:.1f}, int8 {headline['int8']:.1f}, "
          f"bf16 {headline['bf16']:.1f} on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:  # one rank of phase 5c's mesh part
        mesh_rank(*sys.argv[2:7])
    else:
        main()
