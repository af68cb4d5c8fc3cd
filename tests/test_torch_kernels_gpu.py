"""Torch port, kernels on the card: each hand-written kernel against its
plain twin over the shapes its wrapper takes, and the wrappers' guards.
Marked ``gpu``: each test skips without a CUDA device. On a machine with
one (``--noconftest``: tests/conftest.py imports JAX, which that machine
may lack): ``python -m pytest tests/test_torch_kernels_gpu.py -q --noconftest``."""

import pytest
import torch

from midi_emotion_tpu.models.config import ModelConfig
from midi_emotion_tpu_torch.models.model import MusicTransformer
from midi_emotion_tpu_torch.ops.flash_attention import (
    flash_rel_attention, flash_rel_attention_plain)
from midi_emotion_tpu_torch.ops.layernorm import layernorm, layernorm_ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkve(B, H, T, dh, max_seq, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((B, H, T, dh), generator=g, device="cuda").to(dtype)
               for _ in range(3))
    return q, k, v, torch.randn((max_seq, dh), generator=g, device="cuda").to(dtype)


@pytest.mark.parametrize("dh", [16, 32, 48, 64])
@pytest.mark.parametrize("T", [1, 63, 64, 65, 200])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_twin_f32(cuda, dh, T, causal):
    q, k, v, e = _qkve(2, 3, T, dh, 256, torch.float32)
    pad = torch.zeros((2, T), dtype=torch.bool, device=cuda)
    pad[1, 0] = True  # batch row 1, query 0: no visible key when causal
    pad[1, T - T // 3:] = True
    o, lse = flash_rel_attention(q, k, v, e, causal, pad)
    ro, rlse = flash_rel_attention_plain(q, k, v, e, causal, pad)
    torch.testing.assert_close(o, ro, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("T,causal", [(1216, True), (300, False)])
def test_flash_kernel_matches_twin_bf16(cuda, T, causal):
    q, k, v, e = _qkve(2, 4, T, 48, 2048, torch.bfloat16, seed=1)
    o, lse = flash_rel_attention(q, k, v, e, causal, None)
    ro, rlse = flash_rel_attention_plain(q, k, v, e, causal, None)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    # both compute in f32 from the same bf16 inputs; O differs by at most
    # one bf16 ulp of its rounding, lse (kept f32) by summation order
    torch.testing.assert_close(o.float(), ro.float(), rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-3)


def test_flash_wrapper_guards_and_counter(cuda):
    q, k, v, e = _qkve(1, 2, 64, 48, 128, torch.float32)
    before = flash_rel_attention.launches
    flash_rel_attention(q, k, v, e)
    assert flash_rel_attention.launches == before + 1
    with pytest.raises(ValueError, match="contiguous"):
        flash_rel_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v, e)
    with pytest.raises(TypeError):
        flash_rel_attention(q, k.double(), v, e)
    with pytest.raises(ValueError, match="d_head"):
        flash_rel_attention(*_qkve(1, 2, 64, 40, 128, torch.float32))
    with pytest.raises(ValueError, match="max_seq"):
        flash_rel_attention(q, k, v, e[:32])
    with pytest.raises(RuntimeError, match="backward"):
        flash_rel_attention(q.requires_grad_(), k, v, e)
    assert flash_rel_attention.launches == before + 1


@pytest.mark.parametrize("rows,D", [(1, 768), (7, 768), (4864, 768), (5, 100), (3, 4096)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layernorm_kernel_matches_twin(cuda, rows, D, dtype):
    g = torch.Generator(device="cuda").manual_seed(rows)
    x = (torch.randn((2, rows, D), generator=g, device=cuda) * 2 + 0.5).to(dtype)
    w = torch.randn((D,), generator=g, device=cuda)
    b = torch.randn((D,), generator=g, device=cuda)
    before = layernorm.launches
    y = layernorm(x, w, b)
    assert layernorm.launches == before + 1 and y.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(y.float(), layernorm_ref(x, w, b).float(), rtol=tol, atol=tol)


def test_layernorm_wrapper_guards(cuda):
    x = torch.randn((4, 64), device=cuda)
    w, b = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        layernorm(x.t(), torch.ones(4, device=cuda), torch.zeros(4, device=cuda))
    with pytest.raises(ValueError, match="f32"):
        layernorm(x, w.bfloat16(), b)
    with pytest.raises(RuntimeError, match="backward"):
        layernorm(x.requires_grad_(), w, b)


def test_model_kernel_path_matches_plain_path(cuda):
    cfg = ModelConfig(mode="continuous_concat", vocab_size=1007, n_layer=2, n_head=4,
                      d_model=128, d_inner=256, d_condition=32, max_seq=256, dropout=0.0)
    gen = torch.Generator().manual_seed(0)
    cpu = MusicTransformer(cfg).init_weights(gen)
    models = {}
    for impl in ("kernel", "plain"):
        models[impl] = MusicTransformer(cfg, device=cuda, attn_impl=impl)
        models[impl].load_state_dict(cpu.state_dict())
    full = torch.randint(2, 1007, (2, 120), generator=gen)
    full[1, -10:] = 0
    strided = full.to(cuda)[:, 20:]  # a non-contiguous view, as a sliding window gives
    cond = torch.tensor([[0.5, -0.5], [0.1, 0.9]])
    with torch.inference_mode():
        want = cpu(full[:, 20:], cond)
        for impl, m in models.items():
            got = m(strided, cond.to(cuda)).cpu()
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4, msg=impl)
