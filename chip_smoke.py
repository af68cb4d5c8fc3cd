#!/usr/bin/env python3
"""Smoke test of the torch port (midi_emotion_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, on a machine with a card

Phases, each fatal on failure:
  1. refuse to start without CUDA; print the card's name and power limit;
  2. build the hand-written kernels from the sources in this checkout
     (the CUDA flash attention with nvcc into build/kernels/, the Triton
     LayerNorm at its first launch);
  3. compare each kernel with its plain PyTorch twin on the card, at the
     flagship shapes, and time both;
  4. write a random-init flagship model (continuous_concat, 20 layers,
     d_model 768, 16 heads of 48, seeded torch.Generator) as a
     reference-format work dir and check its forward pass on the card
     (kernels) against the CPU (plain twins) on a small input;
  5. run the port's generation CLI on it (bf16, batch 4, 1400 tokens,
     window 1216, so the window refreshes at T = 1216) with every kernel
     launch counter reset to 0 just before; check the MIDI files, the
     sampled ids and that every kernel was launched;
  6. time generation alone, at the smoke's shape and at the headline
     shape (batch 64, 1024 tokens, window 1216, top-p 0.7).

The second-to-last line is a JSON object with each kernel's launch count,
error and times; the last line is {"ok": true, "device": {...}}.
"""

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = dict(vocab_size=1007, mode="continuous_concat", n_layer=20, n_head=16,
                d_model=768, d_inner=3072, d_condition=192, max_seq=2048, dropout=0.1)
SEED = 0


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


def check_flash(torch, B, H, T, dh, dtype, causal, tol_o, tol_lse, timed=False):
    from midi_emotion_tpu_torch.ops.flash_attention import (
        flash_rel_attention, flash_rel_attention_plain)

    g = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v = (torch.randn((B, H, T, dh), generator=g, device="cuda").to(dtype)
               for _ in range(3))
    e = torch.randn((FLAGSHIP["max_seq"], dh), generator=g, device="cuda").to(dtype)
    pad = torch.zeros((B, T), dtype=torch.bool, device="cuda")
    if B > 1:  # batch row 1: key 0 pad (row 0 sees no key) and a pad tail
        pad[1, 0] = True
        pad[1, T - T // 6:] = True
    o, lse = flash_rel_attention(q, k, v, e, causal, pad)
    torch.cuda.synchronize()
    ro, rlse = flash_rel_attention_plain(q, k, v, e, causal, pad)
    if not (torch.isfinite(o).all() and torch.isfinite(lse).all()):
        fail(f"flash {dtype} B={B} T={T}: non-finite output")
    err_o = (o.float() - ro.float()).abs().max().item()
    err_lse = (lse - rlse).abs().max().item()
    name = f"flash {str(dtype)[6:]} B={B} H={H} T={T} dh={dh} causal={causal}"
    print(f"{name}: max|dO|={err_o:.3e} (tol {tol_o}) max|dlse|={err_lse:.3e} (tol {tol_lse})")
    if not (err_o <= tol_o and err_lse <= tol_lse):
        fail(f"{name}: kernel disagrees with its plain twin")
    if causal and B > 1 and not (o[1, :, 0].eq(0).all() and rlse[1, :, 0].eq(1e30).all()
                                 and lse[1, :, 0].eq(1e30).all()):
        fail(f"{name}: the fully masked row is not O = 0, lse = 1e30")
    out = {"max_abs_err": err_o}
    if timed:
        out["ms"] = time_ms(torch, lambda: flash_rel_attention(q, k, v, e, causal, pad))
        out["plain_ms"] = time_ms(torch, lambda: flash_rel_attention_plain(q, k, v, e, causal, pad))
        print(f"{name}: kernel {out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms")
    return out


def check_layernorm(torch, rows, D, dtype, tol, timed=False):
    from midi_emotion_tpu_torch.ops.layernorm import layernorm, layernorm_ref

    g = torch.Generator(device="cuda").manual_seed(SEED)
    x = (torch.randn((rows, D), generator=g, device="cuda") * 3 + 1).to(dtype)
    w = torch.randn((D,), generator=g, device="cuda")
    b = torch.randn((D,), generator=g, device="cuda")
    y = layernorm(x, w, b)
    torch.cuda.synchronize()
    ref = layernorm_ref(x, w, b)
    if y.dtype != dtype or not torch.isfinite(y).all():
        fail(f"layernorm {dtype}: wrong dtype or non-finite output")
    err = (y.float() - ref.float()).abs().max().item()
    bound = tol * (1 + ref.float().abs().max().item())
    name = f"layernorm {str(dtype)[6:]} [{rows}, {D}]"
    print(f"{name}: max|dy|={err:.3e} (tol {bound:.3e})")
    if not err <= bound:
        fail(f"{name}: kernel disagrees with its plain twin")
    out = {"max_abs_err": err}
    if timed:
        out["ms"] = time_ms(torch, lambda: layernorm(x, w, b), iters=100)
        out["plain_ms"] = time_ms(torch, lambda: layernorm_ref(x, w, b), iters=100)
        print(f"{name}: kernel {out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms")
    return out


def timed_generation(torch, model, vocab, B, gen_len, max_input_len):
    from midi_emotion_tpu_torch.generation.sampler import Sampler
    from midi_emotion_tpu_torch.ops.sampling import SamplingParams

    sp = SamplingParams(gen_len=gen_len, max_input_len=max_input_len, top_p=0.7, seed=1)
    cond = np.tile(np.array([[0.8, 0.8]], np.float32), (B, 1))
    primer = np.full((B, 1), vocab.start_id, np.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    song = Sampler(model, vocab, sp).generate(primer, continuous_conditions=cond)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if song.shape != (B, gen_len) or vocab.special_mask()[song[:, 1:]].any():
        fail(f"timed generation B={B}: bad output {song.shape}")
    return B * (gen_len - 1) / secs, secs


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

    from midi_emotion_tpu_torch.cli import generate_cli
    from midi_emotion_tpu_torch.convert import load_model_dir, save_reference_dir
    from midi_emotion_tpu_torch.generation import generate as generate_mod
    from midi_emotion_tpu_torch.kernels.build import cuda_library, library_path
    from midi_emotion_tpu_torch.models.model import ModelConfig, MusicTransformer
    from midi_emotion_tpu_torch.ops.flash_attention import flash_rel_attention
    from midi_emotion_tpu_torch.ops.layernorm import layernorm

    # the default 1007-token vocabulary, reached through the port's module
    # (this script itself imports nothing of the JAX package)
    vocab = generate_mod.Vocab()

    # phase 2 -----------------------------------------------------------
    t0 = time.perf_counter()
    cuda_library("flash_rel_attn_fwd")
    lib = library_path("flash_rel_attn_fwd")
    print(f"built {os.path.relpath(lib, REPO)} in {time.perf_counter() - t0:.1f} s")
    log = lib.with_name(lib.name + ".log")
    if log.exists():  # ptxas -v: registers and spills of each instantiation
        text = log.read_text()
        kinds = re.findall(r"Compiling entry function '\S*kernelI(13__nv_bfloat16|f)Li(\d+)E", text)
        regs = re.findall(r"Used (\d+) registers", text)
        spills = re.findall(r"(\d+) bytes spill stores", text)
        for (t, dh), r, sp in zip(kinds, regs, spills):
            print(f"ptxas: flash kernel <{'bf16' if t != 'f' else 'f32'}, dh={dh}>: "
                  f"{r} registers, {sp} bytes spilled")

    # phase 3 -----------------------------------------------------------
    # Tolerances: f32 pins the algorithm (kernel and twin both sum in f32,
    # in different orders, over 1216 keys): 1e-4. bf16 pins the kernel in
    # its working type: both compute in f32 from the same bf16 inputs and
    # round O to bf16, so O may differ by one bf16 ulp (2e-2 covers |O| up
    # to ~2.5) and lse, which stays f32, by 1e-3.
    check_flash(torch, 2, 16, 1216, 48, torch.float32, True, 1e-4, 1e-4)
    check_flash(torch, 2, 16, 1216, 48, torch.bfloat16, True, 2e-2, 1e-3)
    check_flash(torch, 2, 16, 200, 48, torch.float32, False, 1e-4, 1e-4)
    for dh in (16, 32, 64):  # the other d_head instantiations, one each
        check_flash(torch, 2, 4, 333, dh, torch.float32, True, 1e-4, 1e-4)
    # the CLI run's two prefill shapes: the one-token primer, then a refresh
    check_flash(torch, 4, 16, 1, 48, torch.bfloat16, True, 2e-2, 1e-3)
    flash = check_flash(torch, 4, 16, 1216, 48, torch.bfloat16, True, 2e-2, 1e-3, timed=True)
    # LayerNorm: f32 statistics in both; f32 output within 1e-5 relative
    # to the row scale, bf16 output within one bf16 ulp (2^-7 relative)
    check_layernorm(torch, 4864, 768, torch.float32, 1e-5)
    check_layernorm(torch, 4, 768, torch.bfloat16, 2 ** -7)  # a decode step's rows
    ln = check_layernorm(torch, 4864, 768, torch.bfloat16, 2 ** -7, timed=True)

    # phase 4 -----------------------------------------------------------
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        mcfg = ModelConfig(**FLAGSHIP)
        model = MusicTransformer(mcfg).init_weights(torch.Generator().manual_seed(SEED))
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
        B, gen_len = 4, 1400
        flash_rel_attention.launches = 0
        layernorm.launches = 0
        t0 = time.perf_counter()
        generate_cli.main([
            "--model_dir", work, "--conditioning", "continuous_concat", "--dtype", "bf16",
            "--batch_size", str(B), "--valence", "0.8", "-0.5", "0.3", "-0.9",
            "--arousal", "0.8", "0.5", "-0.3", "-0.9", "--gen_len", str(gen_len),
            "--max_input_len", "1216", "--device", "cuda", "--quiet",
        ])
        torch.cuda.synchronize()
        cli_secs = time.perf_counter() - t0
        launches = {"flash_rel_attn_fwd": flash_rel_attention.launches,
                    "ln_fwd": layernorm.launches}
        print(f"CLI run: {cli_secs:.2f} s; kernel launches {launches}")
        if min(launches.values()) <= 0:
            fail(f"a kernel of the path was never launched: {launches}")

        out = os.path.join(work, "generations", "inference")
        mids = sorted(f for f in os.listdir(out) if f.endswith(".mid"))
        if len(mids) < B:
            fail(f"expected >= {B} MIDI files, found {mids}")
        special = vocab.special_mask()
        for f in mids:
            tracks = generate_mod.midi_io.read_midi(os.path.join(out, f))
            ids = np.load(os.path.join(out, "inds_" + f[:-4] + ".npy"))
            if ids.shape != (gen_len,) or special[ids[1:]].any() or ids.max() >= 1007:
                fail(f"{f}: bad sampled ids")
            print(f"{f}: {len(tracks)} tracks, {sum(len(t.notes) for t in tracks)} notes")

        # phase 6 -------------------------------------------------------
        model = load_model_dir(work, torch.bfloat16, "cuda")[1]
        tps, secs = timed_generation(torch, model, vocab, B, gen_len, 1216)
        print(f"generation tokens/sec: {tps:.1f} (B={B}, gen_len={gen_len}, window 1216, "
              f"bf16, {secs:.2f} s) on {card}")
        tps64, secs64 = timed_generation(torch, model, vocab, 64, 1024, 1216)
        print(f"headline sampled tokens/sec: {tps64:.1f} (B=64, gen_len=1024, window 1216, "
              f"top-p 0.7, bf16, {secs64:.2f} s) on {card}")

    kernels = [
        dict(name="flash_rel_attn_fwd", route="cuda",
             source="midi_emotion_tpu_torch/csrc/flash_rel_attn_fwd.cu",
             replaces="midi_emotion_tpu/ops/pallas_attention.py:369",
             launches=launches["flash_rel_attn_fwd"], **flash),
        dict(name="ln_fwd", route="triton",
             source="midi_emotion_tpu_torch/ops/layernorm_triton.py",
             replaces="midi_emotion_tpu/ops/layernorm.py:53",
             launches=launches["ln_fwd"], **ln),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
