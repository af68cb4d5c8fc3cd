"""Torch port, kernels on the card: each hand-written kernel against its
plain twin over the shapes its wrapper takes, and the wrappers' guards.
Marked ``gpu``: each test skips without a CUDA device. On a machine with
one (``--noconftest``: tests/conftest.py imports JAX, which that machine
may lack): ``python -m pytest tests/test_torch_kernels_gpu.py -q --noconftest``."""

import pytest
import torch

from midi_emotion_tpu_torch.models.config import ModelConfig
from midi_emotion_tpu_torch.models.model import MusicTransformer
from midi_emotion_tpu_torch.ops import decode_attention as da
from midi_emotion_tpu_torch.ops import fused_dropout as fd
from midi_emotion_tpu_torch.ops.flash_attention import (
    flash_rel_attention, flash_rel_attention_bwd, flash_rel_attention_bwd_plain,
    flash_rel_attention_plain)
from midi_emotion_tpu_torch.ops.layernorm import (
    layernorm, layernorm_bwd, layernorm_bwd_ref, layernorm_ref)
from midi_emotion_tpu_torch.training.train_step import make_optimizer, make_train_step

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


def _pad(B, T, device):
    pad = torch.zeros((B, T), dtype=torch.bool, device=device)
    pad[1, 0] = True  # batch row 1, query 0: no visible key when causal
    pad[1, T - T // 3:] = True
    return pad


@pytest.mark.parametrize("dh", [16, 32, 48, 64])
@pytest.mark.parametrize("T", [1, 63, 64, 65, 200])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_twin_f32(cuda, dh, T, causal):
    q, k, v, e = _qkve(2, 3, T, dh, 256, torch.float32)
    pad = _pad(2, T, cuda)
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


def _bwd_pair(q, k, v, e, causal, pad, seed=2):
    """(kernel, twin) backward outputs for one forward and one cotangent;
    the cotangent is zero on pad query rows, as a masked loss makes it."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    o, lse = flash_rel_attention(q, k, v, e, causal, pad)
    do = torch.randn(o.shape, generator=g, device="cuda").to(q.dtype)
    if pad is not None:
        do = do * (~pad)[:, None, :, None]
    got = flash_rel_attention_bwd(q, k, v, e, causal, pad, o, lse, do)
    want = flash_rel_attention_bwd_plain(q, k, v, e, causal, pad, o, lse, do)
    return got, want


@pytest.mark.parametrize("dh", [16, 32, 48, 64])
@pytest.mark.parametrize("T", [1, 65, 200])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_kernel_matches_twin_f32(cuda, dh, T, causal):
    q, k, v, e = _qkve(2, 3, T, dh, 256, torch.float32)
    pad = _pad(2, T, cuda)
    got, want = _bwd_pair(q, k, v, e, causal, pad)
    # f32 in both, different summation orders over <= 200 terms
    for name, a, b in zip(("dq", "dk", "dv", "de"), got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=name)
    if causal:  # the fully masked query row (batch 1, row 0) gets no gradient
        assert got[0][1, :, 0].eq(0).all()


def test_flash_bwd_kernel_matches_twin_bf16(cuda):
    q, k, v, e = _qkve(2, 4, 1216, 48, 2048, torch.bfloat16, seed=3)
    got, want = _bwd_pair(q, k, v, e, True, _pad(2, 1216, cuda))
    # f32 sums in both from the same bf16 inputs, rounded once to bf16:
    # within a few bf16 ulps of each gradient's scale
    for name, a, b in zip(("dq", "dk", "dv", "de"), got, want):
        assert a.dtype == torch.bfloat16, name
        bound = 2e-2 * (1 + b.float().abs().max().item())
        assert (a.float() - b.float()).abs().max().item() <= bound, name


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
    assert flash_rel_attention.launches == before + 1
    bwd_before = flash_rel_attention_bwd.launches
    o, _ = flash_rel_attention(q.requires_grad_(), k, v, e)
    o.sum().backward()
    assert flash_rel_attention_bwd.launches == bwd_before + 1 and q.grad is not None


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


@pytest.mark.parametrize("rows,D", [(1, 768), (7, 768), (9728, 768), (5, 100)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layernorm_bwd_kernel_matches_twin(cuda, rows, D, dtype):
    g = torch.Generator(device="cuda").manual_seed(rows + 1)
    x = (torch.randn((rows, D), generator=g, device=cuda) * 2 + 0.5).to(dtype)
    dy = torch.randn((rows, D), generator=g, device=cuda).to(dtype)
    w = torch.randn((D,), generator=g, device=cuda)
    before = layernorm_bwd.launches
    dx, dw, db = layernorm_bwd(x, dy, w)
    assert layernorm_bwd.launches == before + 1 and dx.dtype == dtype
    rdx, rdw, rdb = layernorm_bwd_ref(x, dy, w)
    # dx: f32 math in both, bf16 output within one ulp; dw/db: f32 sums
    # over `rows` terms in other orders
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(dx.float(), rdx.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(dw, rdw, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(db, rdb, rtol=1e-4, atol=1e-3)


def test_layernorm_wrapper_guards(cuda):
    x = torch.randn((4, 64), device=cuda)
    w, b = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        layernorm(x.t(), torch.ones(4, device=cuda), torch.zeros(4, device=cuda))
    with pytest.raises(ValueError, match="f32"):
        layernorm(x, w.bfloat16(), b)
    before = layernorm_bwd.launches
    layernorm(x.requires_grad_(), w, b).sum().backward()
    assert layernorm_bwd.launches == before + 1 and x.grad is not None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_kernel_mask(cuda, dtype):
    rate = 0.1
    x = torch.ones((9728, 768), dtype=dtype, device=cuda)
    before = fd.fused_dropout.launches
    y = fd.fused_dropout(x, 1234, rate)
    keep = y != 0
    n = keep.numel()
    frac = keep.float().mean().item()
    # binomial: 6 standard deviations of the keep fraction
    assert abs(frac - (1 - rate)) <= 6 * ((rate * (1 - rate)) / n) ** 0.5, frac
    torch.testing.assert_close(y, fd.dropout_plain(x, keep, rate))
    assert torch.equal(fd.fused_dropout(x, 1234, rate), y)  # a fixed seed reproduces
    assert not torch.equal(fd.fused_dropout(x, 1235, rate), y)  # a new seed differs
    # the backward draws the same mask
    xg = x.clone().requires_grad_()
    fd.fused_dropout(xg, 1234, rate).backward(torch.ones_like(x))
    assert torch.equal(xg.grad != 0, keep)
    assert fd.fused_dropout.launches == before + 5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,D", [(9728, 768), (5, 100)])
def test_dropout_add_layernorm_kernels_match_twin(cuda, dtype, rows, D):
    rate, seed = 0.1, 77
    g = torch.Generator(device="cuda").manual_seed(5)
    sub = torch.randn((rows, D), generator=g, device=cuda).to(dtype)
    res = torch.randn((rows, D), generator=g, device=cuda).to(dtype)
    dy = torch.randn((rows, D), generator=g, device=cuda).to(dtype)
    w = torch.randn((D,), generator=g, device=cuda)
    b = torch.randn((D,), generator=g, device=cuda)
    # the mask is a function of (seed, flat index): dropout of ones recovers it
    keep = fd.fused_dropout(torch.ones_like(sub), seed, rate) != 0
    y = fd.dropout_add_layernorm(sub, res, w, b, seed, rate)
    want = fd.dropout_add_layernorm_plain(sub, res, w, b, keep, rate)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(y.float(), want.float(), rtol=tol, atol=tol)
    got = fd.dropout_add_layernorm_bwd(sub, res, dy, w, seed, rate)
    ref = fd.dropout_add_layernorm_bwd_plain(sub, res, dy, w, keep, rate)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, a, r in zip(("dsub", "dres"), got[:2], ref[:2]):
        torch.testing.assert_close(a.float(), r.float(), rtol=tol, atol=tol, msg=name)
    for name, a, r in zip(("dw", "db"), got[2:], ref[2:]):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-3, msg=name)


def test_model_kernel_path_matches_plain_path(cuda):
    cfg = ModelConfig(mode="continuous_concat", vocab_size=1007, n_layer=2, n_head=4,
                      d_model=128, d_inner=256, d_condition=32, max_seq=256, dropout=0.0)
    gen = torch.Generator().manual_seed(0)
    cpu = MusicTransformer(cfg, device="cpu").init_weights(gen)
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


def test_train_step_kernels_match_plain_twins(cuda):
    """One f32 train step (dropout 0) through the kernels (flash and LN,
    both directions) against the same step on the CPU (plain twins): loss,
    grad norm and every (clipped) gradient."""
    cfg = ModelConfig(mode="continuous_concat", vocab_size=1007, n_layer=2, n_head=4,
                      d_model=128, d_inner=256, d_condition=32, max_seq=256, dropout=0.0)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(2, 1007, (1, 2, 97), generator=gen)
    tokens[0, 1, -9:] = 0
    batch = {"input": tokens[:, :, :-1], "target": tokens[:, :, 1:],
             "condition": torch.tensor([[[0.5, -0.5], [0.1, 0.9]]])}
    out = {}
    before = (flash_rel_attention_bwd.launches, layernorm_bwd.launches)
    for dev in ("cpu", "cuda"):
        model = MusicTransformer(cfg, device=dev).init_weights(torch.Generator().manual_seed(0))
        step = make_train_step(model, make_optimizer(model), clip=1.0)
        m = step({k: v.to(dev) for k, v in batch.items()}, 1e-3)
        out[dev] = (m, {n: p.grad.cpu() for n, p in model.named_parameters()})
    assert flash_rel_attention_bwd.launches == before[0] + 2
    assert layernorm_bwd.launches == before[1] + 4
    (mc, gc), (mg, gg) = out["cpu"], out["cuda"]
    torch.testing.assert_close(mg["loss"].cpu(), mc["loss"], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(mg["grad_norm"].cpu(), mc["grad_norm"], rtol=1e-4, atol=1e-5)
    for n in gc:
        torch.testing.assert_close(gg[n], gc[n], rtol=1e-4, atol=1e-5, msg=n)


def _decode_inputs(B, W, H, dh, L, S, quant, seed=0):
    """A stacked cache of random rows (quantized for int8), q, E, a stage
    and the current row, on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    D = H * dh
    rows = torch.randn((L, B, W, 2 * D), generator=g, device="cuda")
    kv, sc = da.quantize_rows(rows, 2 * H) if quant else (rows.bfloat16(), None)
    q = torch.randn((B, H, dh), generator=g, device="cuda")
    e = torch.randn((512, dh), generator=g, device="cuda")
    pend = torch.randn((S, L, B, 2 * D), generator=g, device="cuda").bfloat16()
    row = torch.randn((B, 2 * D), generator=g, device="cuda").bfloat16()
    return kv, sc, q, e, pend, row, rows[..., D:].abs().max().item()


@pytest.mark.parametrize("shape", [(64, 1408, 16, 48, 2), (3, 384, 4, 48, 3), (2, 200, 2, 16, 2)],
                         ids=["flagship", "odd", "w200-dh16"])
@pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16"])
def test_decode_kernel_matches_twin_unstaged(cuda, shape, quant):
    """acc/l within one P re-quantization unit (int8: max|V|/127, flipped
    when the f32 score sums round apart; bf16: p rounded to bf16 in both,
    1e-3 of max|V|), m and l to f32 summation order, length 0 exact."""
    B, W, H, dh, L = shape
    kv, sc, q, e, _, _, vmax = _decode_inputs(B, W, H, dh, L, 8, quant)
    for length in sorted({0, 1, 127, 128, 129, min(700, W), W}):
        e_rows = da.expand_e_rows(e, length + 1, W)
        before = da.decode_attn_cached.launches
        acc, m, l = da.decode_attn_cached(q, kv, sc, L - 1, e_rows, length)
        assert da.decode_attn_cached.launches == before + 1
        racc, rm, rl = da.decode_attn_cached_plain(q, kv, sc, L - 1, e_rows, length)
        if length == 0:
            assert (m == -1e30).all() and (l == 0).all() and (acc == 0).all()
            continue
        torch.testing.assert_close(m, rm, rtol=1e-5, atol=1e-5, msg=f"m at {length}")
        torch.testing.assert_close(l, rl, rtol=1e-5, atol=1e-5, msg=f"l at {length}")
        norm = lambda a, d: a.view(B, H, dh) / d[..., None]  # noqa: E731
        tol = vmax / 127 if quant else 1e-3 * vmax
        err = (norm(acc, l) - norm(racc, rl)).abs().max().item()
        assert err <= tol, (length, err, tol)


@pytest.mark.parametrize("shape", [(64, 1408, 16, 48, 2), (3, 384, 4, 48, 3), (2, 200, 2, 16, 2)],
                         ids=["flagship", "odd", "w200-dh16"])
@pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16"])
def test_decode_kernel_matches_twin_staged(cuda, shape, quant):
    """Staged (S 8): the normalized bf16 output within one P unit (int8)
    plus two bf16 ulps of its scale, and the stage written exactly, the
    p_cnt == S clamp included."""
    B, W, H, dh, L = shape
    S = 8
    kv, sc, q, e, pend, row, vmax = _decode_inputs(B, W, H, dh, L, S, quant, seed=1)
    for length in sorted({0, 1, 127, 128, 129, min(700, W - S), W - S}):
        e_rows = da.expand_e_rows(e, length + S + 1, W)
        for p_cnt in (0, 3, 7, 8):
            e_pend = da.expand_e_rows(e, p_cnt + 1, S + 1)
            got_pend, want_pend = pend.clone(), pend.clone()
            out, _ = da.decode_attn_cached(q, kv, sc, L - 1, e_rows, length, got_pend, e_pend,
                                           p_cnt, row)
            ref, _ = da.decode_attn_cached_plain(q, kv, sc, L - 1, e_rows, length, want_pend,
                                                 e_pend, p_cnt, row)
            assert torch.equal(got_pend, want_pend), (length, p_cnt)
            tol = (vmax / 127 if quant else 0) + 2 ** -7 * ref.float().abs().max().item()
            err = (out.float() - ref.float()).abs().max().item()
            assert out.dtype == torch.bfloat16 and err <= tol, (length, p_cnt, err, tol)


def test_decode_wrapper_guards(cuda):
    kv, sc, q, e, pend, row, _ = _decode_inputs(2, 256, 4, 48, 2, 4, True)
    e_rows = da.expand_e_rows(e, 11, 256)
    before = da.decode_attn_cached.launches
    with pytest.raises(TypeError, match="int8"):
        da.decode_attn_cached(q, kv.float(), sc, 1, e_rows, 10)
    with pytest.raises(TypeError, match="bfloat16"):
        da.decode_attn_cached(q, kv, sc.float(), 1, e_rows, 10)
    with pytest.raises(ValueError, match="e_rows"):
        da.decode_attn_cached(q, kv, sc, 1, e_rows[:128], 10)
    with pytest.raises(ValueError, match="contiguous"):
        da.decode_attn_cached(q, kv.transpose(0, 1).contiguous().transpose(0, 1), sc, 1,
                              e_rows, 10)
    with pytest.raises(ValueError, match="out of range"):
        da.decode_attn_cached(q, kv, sc, 2, e_rows, 10)
    with pytest.raises(ValueError, match="d_head"):
        da.decode_attn_cached(q[..., :40], kv, sc, 1, e_rows, 10)
    with pytest.raises(ValueError, match="stage"):
        da.decode_attn_cached(q, kv, sc, 1, e_rows, 10, pend, da.expand_e_rows(e, 6, 5), 5, row)
    assert da.decode_attn_cached.launches == before
