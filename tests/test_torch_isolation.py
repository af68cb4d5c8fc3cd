"""Torch port, isolation: it runs without JAX, its CUDA wrappers never run
on the CPU, and chip_smoke.py refuses to start without a card."""

import os
import subprocess
import sys

import pytest
import torch

from midi_emotion_tpu.models.config import ModelConfig
from midi_emotion_tpu_torch.kernels import build
from midi_emotion_tpu_torch.models.model import MusicTransformer
from midi_emotion_tpu_torch.ops.flash_attention import flash_rel_attention
from midi_emotion_tpu_torch.ops.layernorm import layernorm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = dict(vocab_size=1007, n_layer=2, n_head=4, d_model=64, d_inner=128,
            d_condition=16, max_seq=128, dropout=0.0)

_NO_JAX_RUN = """
import sys
import numpy as np, torch
from midi_emotion_tpu.models.config import ModelConfig
from midi_emotion_tpu.vocab import DEFAULT_VOCAB
from midi_emotion_tpu_torch.generation.sampler import Sampler
from midi_emotion_tpu_torch.models.model import MusicTransformer
from midi_emotion_tpu_torch.ops.sampling import SamplingParams
import midi_emotion_tpu_torch.cli.generate_cli, midi_emotion_tpu_torch.convert
cfg = ModelConfig(vocab_size=1007, n_layer=1, n_head=2, d_model=32, d_inner=64,
                  d_condition=8, max_seq=64, dropout=0.0)
model = MusicTransformer(cfg).init_weights(torch.Generator().manual_seed(0))
out = Sampler(model, DEFAULT_VOCAB, SamplingParams(gen_len=20, max_input_len=8)).generate(
    np.ones((2, 1), np.int32), continuous_conditions=np.zeros((2, 2), np.float32))
assert out.shape == (2, 20), out.shape
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax"))
assert not leaked, leaked
print("NO_JAX_OK")
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    return env


def test_port_runs_without_jax():
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_RUN], cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "NO_JAX_OK" in proc.stdout


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the refusal path is for CUDA-less machines")
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_cpu_paths_never_count_kernel_launches():
    flash_rel_attention.launches = 0
    layernorm.launches = 0
    cfg = ModelConfig(mode="continuous_concat", **TINY)
    model = MusicTransformer(cfg, attn_impl="kernel").init_weights(torch.Generator().manual_seed(0))
    tokens = torch.ones((2, 8), dtype=torch.long)
    with torch.inference_mode():
        logits = model(tokens, torch.zeros((2, 2)))
    assert torch.isfinite(logits).all()
    assert flash_rel_attention.launches == 0 and layernorm.launches == 0


def test_wrappers_refuse_other_devices():
    q = torch.zeros((1, 1, 4, 16), device="meta")
    with pytest.raises(ValueError, match="device"):
        flash_rel_attention(q, q, q, torch.zeros((8, 16), device="meta"))
    with pytest.raises(ValueError, match="device"):
        layernorm(torch.zeros((2, 16), device="meta"), torch.ones(16), torch.zeros(16))


def test_kernel_build_fails_loudly_without_nvcc(monkeypatch):
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", os.path.join(REPO, "no-such-toolkit"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build._nvcc()
    assert build.library_path("flash_rel_attn_fwd").name.startswith("libflash_rel_attn_fwd-")
    assert build.NVCC_FLAGS[:2] == ("-gencode", "arch=compute_90a,code=sm_90a")
