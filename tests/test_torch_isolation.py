"""Torch port, isolation: it imports neither JAX nor anything of the JAX
package (nor flax, msgpack or pandas; h5py only lazily), its entry points
default to the card, its CUDA wrappers never run on the CPU, and
chip_smoke.py refuses to start without a card."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from midi_emotion_tpu_torch.cli import train_cli
from midi_emotion_tpu_torch.convert import load_model_dir, save_reference_dir
from midi_emotion_tpu_torch.kernels import build
from midi_emotion_tpu_torch.models.config import ModelConfig
from midi_emotion_tpu_torch.models.model import MusicTransformer
from midi_emotion_tpu_torch.generation.sampler import Sampler
from midi_emotion_tpu_torch.ops import fused_dropout as fd
from midi_emotion_tpu_torch.ops.decode_attention import decode_attn_cached
from midi_emotion_tpu_torch.ops.sampling import SamplingParams
from midi_emotion_tpu_torch.ops.flash_attention import (
    flash_rel_attention, flash_rel_attention_bwd)
from midi_emotion_tpu_torch.ops.layernorm import layernorm, layernorm_bwd
from midi_emotion_tpu_torch.training.train_step import make_optimizer, make_train_step
from midi_emotion_tpu_torch.vocab import DEFAULT_VOCAB

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = dict(vocab_size=1007, n_layer=2, n_head=4, d_model=64, d_inner=128,
            d_condition=16, max_seq=128, dropout=0.0)

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "pandas", "midi_emotion_tpu")

_NO_JAX_RUN = """
import sys
import numpy as np, torch
import midi_emotion_tpu_torch.cli.generate_cli, midi_emotion_tpu_torch.cli.train_cli
import midi_emotion_tpu_torch.convert, midi_emotion_tpu_torch.training.train
import midi_emotion_tpu_torch.convert.transfer, midi_emotion_tpu_torch.convert.torch_export
import midi_emotion_tpu_torch.data.preprocess, midi_emotion_tpu_torch.data.dataset_builder
import midi_emotion_tpu_torch.data.msd_hdf5, midi_emotion_tpu_torch.utils
import midi_emotion_tpu_torch.demo, midi_emotion_tpu_torch.entry
import midi_emotion_tpu_torch.parallel.mesh, midi_emotion_tpu_torch.parallel.ring_attention
from midi_emotion_tpu_torch.convert import flax_msgpack
from midi_emotion_tpu_torch.generation.sampler import Sampler
from midi_emotion_tpu_torch.models.config import ModelConfig
from midi_emotion_tpu_torch.models.model import MusicTransformer
from midi_emotion_tpu_torch.ops.sampling import SamplingParams
from midi_emotion_tpu_torch.training.train_step import make_optimizer, make_train_step
from midi_emotion_tpu_torch.vocab import DEFAULT_VOCAB
cfg = ModelConfig(vocab_size=1007, n_layer=1, n_head=2, d_model=32, d_inner=64,
                  d_condition=8, max_seq=64, dropout=0.1)
model = MusicTransformer(cfg, device="cpu").init_weights(torch.Generator().manual_seed(0))
out = Sampler(model, DEFAULT_VOCAB, SamplingParams(gen_len=20, max_input_len=8)).generate(
    np.ones((2, 1), np.int32), continuous_conditions=np.zeros((2, 2), np.float32))
assert out.shape == (2, 20), out.shape
out = Sampler(model, DEFAULT_VOCAB, SamplingParams(gen_len=20, max_input_len=8),
              kv_dtype="int8", stage_steps=4).generate(
    np.ones((2, 1), np.int32), continuous_conditions=np.zeros((2, 2), np.float32))
assert out.shape == (2, 20), out.shape
tokens = torch.randint(2, 1007, (1, 2, 9), generator=torch.Generator().manual_seed(1))
batch = {"input": tokens[:, :, :-1], "target": tokens[:, :, 1:], "condition": torch.zeros(1, 2, 2)}
m = make_train_step(model, make_optimizer(model), clip=1.0)(batch, 1e-3, torch.Generator())
assert torch.isfinite(m["loss"]), m
tree = flax_msgpack.decode(flax_msgpack.encode({"w": model.fc.weight, "n": np.int32(3)}))
assert torch.equal(torch.from_numpy(tree["w"]), model.fc.weight) and tree["n"] == 3
leaked = sorted(m for m in sys.modules if m.split(".")[0] in %r + ("h5py",))
assert not leaked, leaked
print("NO_JAX_OK")
""" % (FORBIDDEN,)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    return env


def test_port_runs_without_jax():
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_RUN], cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "NO_JAX_OK" in proc.stdout


def _imported_roots(path):
    """Top-level names of every absolute import in a Python file."""
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_sources_import_no_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    # the kernel bench and ablation scripts, which run on the card's machine
    files += [os.path.join(REPO, "scripts", n)
              for n in ("torch_flash_bench.py", "torch_wide_fwd_ablation.py",
                        "torch_wide_bwd_ablation.py")]
    for root, _, names in os.walk(os.path.join(REPO, "midi_emotion_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    assert {os.path.join("midi_emotion_tpu_torch", "parallel", n)
            for n in ("mesh.py", "ring_attention.py")} <= {os.path.relpath(f, REPO) for f in files}
    bad = {os.path.relpath(f, REPO): sorted(set(_imported_roots(f)) & set(FORBIDDEN))
           for f in files}
    assert not {f: names for f, names in bad.items() if names}


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the refusal path is for CUDA-less machines")
    cfg = ModelConfig(mode="continuous_concat", **{**TINY, "max_seq": 2048})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MusicTransformer(cfg)
    model = MusicTransformer(cfg, device="cpu")
    save_reference_dir(str(tmp_path), cfg, model.state_dict(), DEFAULT_VOCAB)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_model_dir(str(tmp_path))
    assert load_model_dir(str(tmp_path), device="cpu")[1].device.type == "cpu"
    assert train_cli.build_parser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--work_dir", str(tmp_path / "out"), "--debug"])


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the refusal path is for CUDA-less machines")
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


COUNTED = (flash_rel_attention, flash_rel_attention_bwd, layernorm, layernorm_bwd,
           fd.fused_dropout, fd.dropout_add_layernorm, fd.dropout_add_layernorm_bwd,
           decode_attn_cached)


def test_cpu_paths_never_count_kernel_launches():
    for fn in COUNTED:
        fn.launches = 0
    for dropout in (0.0, 0.1):
        cfg = ModelConfig(mode="continuous_concat", **{**TINY, "dropout": dropout})
        model = MusicTransformer(cfg, device="cpu", attn_impl="kernel").init_weights(
            torch.Generator().manual_seed(0))
        tokens = torch.ones((1, 2, 9), dtype=torch.long)
        batch = {"input": tokens[:, :, :-1], "target": tokens[:, :, 1:],
                 "condition": torch.zeros((1, 2, 2))}
        m = make_train_step(model, make_optimizer(model), clip=1.0)(batch, 1e-3)
        assert torch.isfinite(m["loss"])
    for kv_dtype in ("int8", "bf16"):  # the stacked caches run the decode twin
        song = Sampler(model.eval(), DEFAULT_VOCAB, SamplingParams(gen_len=12, max_input_len=8),
                       kv_dtype=kv_dtype, stage_steps=4).generate(np.ones((1, 1), np.int32))
        assert song.shape == (1, 12)
    assert all(fn.launches == 0 for fn in COUNTED)


def test_wrappers_refuse_other_devices():
    q = torch.zeros((1, 1, 4, 16), device="meta")
    with pytest.raises(ValueError, match="device"):
        flash_rel_attention(q, q, q, torch.zeros((8, 16), device="meta"))
    with pytest.raises(ValueError, match="device"):
        flash_rel_attention_bwd(q, q, q, torch.zeros((8, 16), device="meta"), True, None,
                                q, torch.zeros((1, 1, 4), device="meta"), q)
    x = torch.zeros((2, 16), device="meta")
    w, b = torch.ones(16), torch.zeros(16)
    with pytest.raises(ValueError, match="device"):
        layernorm(x, w, b)
    with pytest.raises(ValueError, match="device"):
        layernorm_bwd(x, x, w)
    with pytest.raises(ValueError, match="device"):
        fd.fused_dropout(x, 1, 0.1)
    with pytest.raises(ValueError, match="device"):
        fd.dropout_add_layernorm(x, x, w, b, 1, 0.1)
    with pytest.raises(ValueError, match="device"):
        fd.dropout_add_layernorm_bwd(x, x, x, w, 1, 0.1)


def test_kernel_build_fails_loudly_without_nvcc(monkeypatch):
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", os.path.join(REPO, "no-such-toolkit"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build._nvcc()
    for name in build.CUDA_SOURCES:
        assert build.library_path(name).name.startswith(f"lib{name}-")
    assert build.NVCC_FLAGS[:2] == ("-gencode", "arch=compute_90a,code=sm_90a")
