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
from midi_emotion_tpu_torch.ops import flash_attention as fa
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


@pytest.mark.parametrize("dh", [16, 32, 48, 64, 96, 128])
@pytest.mark.parametrize("T", [1, 63, 64, 65, 200])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_twin_f32(cuda, dh, T, causal):
    q, k, v, e = _qkve(2, 3, T, dh, 256, torch.float32)
    pad = _pad(2, T, cuda)
    o, lse = flash_rel_attention(q, k, v, e, causal, pad)
    ro, rlse = flash_rel_attention_plain(q, k, v, e, causal, pad)
    torch.testing.assert_close(o, ro, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-4)


def _assert_fwd_bf16(q, k, v, e, causal, pad):
    """The bf16 forward kernel against its twin: both compute in f32 from
    the same bf16 inputs; O differs by at most one bf16 ulp of its
    rounding, lse (kept f32) by summation order."""
    o, lse = flash_rel_attention(q, k, v, e, causal, pad)
    ro, rlse = flash_rel_attention_plain(q, k, v, e, causal, pad)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    torch.testing.assert_close(o.float(), ro.float(), rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-3)
    return o, lse


@pytest.mark.parametrize("T,causal", [(1216, True), (300, False)])
def test_flash_kernel_matches_twin_bf16(cuda, T, causal):
    _assert_fwd_bf16(*_qkve(2, 4, T, 48, 2048, torch.bfloat16, seed=1), causal, None)


@pytest.mark.parametrize("dh", [16, 32, 64, 96, 128])
@pytest.mark.parametrize("T", [1, 65, 200])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_twin_bf16_head_shapes(cuda, dh, T, causal):
    """The tensor-core forward at every other d_head, ragged T and a pad
    mask (with its fully masked row): the bf16_matches_twin tolerances."""
    o, lse = _assert_fwd_bf16(*_qkve(2, 3, T, dh, 256, torch.bfloat16, seed=5), causal,
                              _pad(2, T, cuda))
    if causal:  # O = 0 and lse = 1e30 where no key is visible
        assert o[1, :, 0].eq(0).all() and lse[1, :, 0].eq(1e30).all()


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


@pytest.mark.parametrize("dh", [16, 32, 48, 64, 96, 128])
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


def _assert_grads_bf16(names, got, want):
    """f32 sums in both from the same bf16 inputs, rounded once to bf16:
    within a few bf16 ulps (2e-2) of each gradient's scale."""
    for name, a, b in zip(names, got, want):
        assert a.dtype == torch.bfloat16, name
        bound = 2e-2 * (1 + b.float().abs().max().item())
        assert (a.float() - b.float()).abs().max().item() <= bound, name


def test_flash_bwd_kernel_matches_twin_bf16(cuda):
    q, k, v, e = _qkve(2, 4, 1216, 48, 2048, torch.bfloat16, seed=3)
    _assert_grads_bf16(("dq", "dk", "dv", "de"), *_bwd_pair(q, k, v, e, True, _pad(2, 1216, cuda)))


@pytest.mark.parametrize("dh", [16, 32, 64, 96, 128])
@pytest.mark.parametrize("T", [1, 65, 200])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_kernel_matches_twin_bf16_head_shapes(cuda, dh, T, causal):
    """The tensor-core merged backward at every other d_head, ragged T (one
    key tile, so the second block of a (b, h) has none; two; four) and a pad
    mask: within 2e-2 of each gradient's scale, dQ 0 on the fully masked
    row."""
    q, k, v, e = _qkve(2, 3, T, dh, 256, torch.bfloat16, seed=6)
    got, want = _bwd_pair(q, k, v, e, causal, _pad(2, T, cuda))
    _assert_grads_bf16(("dq", "dk", "dv", "de"), got, want)
    if causal:
        assert got[0][1, :, 0].eq(0).all()


def _check_wgmma_kernels(q, k, v, e, causal, pad):
    """Kernels 1 and 4 in bf16 against their twins (the bf16 tolerances),
    the fully masked row's O = 0, lse = 1e30 and dQ = 0 where causal, and
    a second launch of each on the same inputs bitwise the first."""
    o, lse = _assert_fwd_bf16(q, k, v, e, causal, pad)
    g = torch.Generator(device="cuda").manual_seed(2)
    do = (torch.randn(o.shape, generator=g, device="cuda") * (~pad)[:, None, :, None]).to(q.dtype)
    got = flash_rel_attention_bwd(q, k, v, e, causal, pad, o, lse, do)
    want = flash_rel_attention_bwd_plain(q, k, v, e, causal, pad, o, lse, do)
    _assert_grads_bf16(("dq", "dk", "dv", "de"), got, want)
    if causal:
        assert o[1, :, 0].eq(0).all() and lse[1, :, 0].eq(1e30).all()
        assert got[0][1, :, 0].eq(0).all()
    o2, lse2 = flash_rel_attention(q, k, v, e, causal, pad)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    again = flash_rel_attention_bwd(q, k, v, e, causal, pad, o, lse, do)
    for name, a, b in zip(("dq", "dk", "dv", "de"), got, again):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dh", [16, 32, 48, 64, 96, 128, 40])
@pytest.mark.parametrize("T", [1, 63, 64, 65, 333, 1216])
def test_wgmma_flash_kernels_bf16_causal(cuda, dh, T):
    """The wgmma kernels 1 and 4 (tiles by TMA) at every d_head they are
    built for and 40 (padded to 48), T around the 64-row tiles up to the
    flagship's, a pad tail and a fully masked row."""
    _check_wgmma_kernels(*_qkve(2, 2, T, dh, 2048, torch.bfloat16, seed=7), True,
                         _pad(2, T, cuda))


@pytest.mark.parametrize("dh", [16, 32, 48, 64, 96, 128, 40])
def test_wgmma_flash_kernels_bf16_non_causal(cuda, dh):
    """The same, non-causal at T 200: every key tile of a row, the relative
    term 0 above the diagonal."""
    _check_wgmma_kernels(*_qkve(2, 2, 200, dh, 2048, torch.bfloat16, seed=8), False,
                         _pad(2, 200, cuda))


@pytest.mark.parametrize("dh", [16, 48, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dsum_kernel_matches_torch(cuda, dtype, dh):
    """The backward's rowsum(dO * O) kernel against torch's, both f32 sums
    of the same products in other orders."""
    g = torch.Generator(device="cuda").manual_seed(8)
    o, do = (torch.randn((2, 3, 77, dh), generator=g, device="cuda").to(dtype) for _ in range(2))
    got = fa._dsum(o, do)
    assert got.shape == (2, 3, 77) and got.dtype == torch.float32
    torch.testing.assert_close(got, (do.float() * o.float()).sum(-1), rtol=1e-5, atol=1e-5)


def test_flash_wrapper_guards_and_counter(cuda):
    q, k, v, e = _qkve(1, 2, 64, 48, 128, torch.float32)
    before = flash_rel_attention.launches
    flash_rel_attention(q, k, v, e)
    assert flash_rel_attention.launches == before + 1
    with pytest.raises(ValueError, match="contiguous"):
        flash_rel_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v, e)
    with pytest.raises(TypeError):
        flash_rel_attention(q, k.double(), v, e)
    flash_rel_attention(*_qkve(1, 2, 64, 272, 128, torch.float32))  # the wide kernel, at 384
    assert flash_rel_attention.launches == before + 2
    with pytest.raises(ValueError, match="max_seq"):
        flash_rel_attention(q, k, v, e[:32])
    assert flash_rel_attention.launches == before + 2
    bwd_before = flash_rel_attention_bwd.launches
    o, _ = flash_rel_attention(q.requires_grad_(), k, v, e)
    o.sum().backward()
    assert flash_rel_attention_bwd.launches == bwd_before + 1 and q.grad is not None


# the other decompositions' kernels: wrapper -> the names of its outputs
BWD_KERNELS = {
    "bwd_dkdv": ("dk", "dv"),
    "bwd_dkdv_dq": ("dk", "dv", "dq_qk"),
    "bwd_dq_de": ("dq", "de"),
    "bwd_dq_de_dist": ("dq", "de"),
    "bwd_de_dqrel": ("dq_rel", "de"),
}


def _bwd_kernel_pair(kernel, q, k, v, e, causal, pad, seed=2):
    """(kernel, twin) outputs of one of the five wrappers, for one forward
    and one cotangent (zero on pad query rows); the launch is counted."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    o, lse = flash_rel_attention(q, k, v, e, causal, pad)
    do = (torch.randn(o.shape, generator=g, device="cuda") * (~pad)[:, None, :, None]).to(q.dtype)
    dsum = (do.float() * o.float()).sum(-1)
    wrapper = getattr(fa, kernel)
    before = wrapper.launches
    got = wrapper(q, k, v, e, causal, pad, lse, dsum, do)
    assert wrapper.launches == before + 1
    return got, getattr(fa, kernel + "_plain")(q, k, v, e, causal, pad, lse, dsum, do)


@pytest.mark.parametrize("kernel", list(BWD_KERNELS))
@pytest.mark.parametrize("dh", [16, 32, 48, 64, 96, 128])
@pytest.mark.parametrize("T", [1, 65, 200])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_decomposition_kernel_matches_twin_f32(cuda, kernel, dh, T, causal):
    q, k, v, e = _qkve(2, 3, T, dh, 256, torch.float32)
    got, want = _bwd_kernel_pair(kernel, q, k, v, e, causal, _pad(2, T, cuda))
    # f32 in both, different summation orders over <= 200 terms (dE: 1200)
    for name, a, b in zip(BWD_KERNELS[kernel], got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=name)
        if causal and name.startswith("dq"):  # the fully masked row gets no gradient
            assert a[1, :, 0].eq(0).all(), name


@pytest.mark.parametrize("kernel", list(BWD_KERNELS))
def test_flash_bwd_decomposition_kernel_matches_twin_bf16(cuda, kernel):
    q, k, v, e = _qkve(2, 4, 1216, 48, 2048, torch.bfloat16, seed=3)
    _assert_grads_bf16(BWD_KERNELS[kernel],
                       *_bwd_kernel_pair(kernel, q, k, v, e, True, _pad(2, 1216, cuda)))


@pytest.mark.parametrize("kernel", list(BWD_KERNELS))
@pytest.mark.parametrize("dh", [96, 128])
def test_flash_bwd_decomposition_kernel_matches_twin_bf16_wide_heads(cuda, kernel, dh):
    q, k, v, e = _qkve(2, 3, 200, dh, 256, torch.bfloat16, seed=7)
    _assert_grads_bf16(BWD_KERNELS[kernel],
                       *_bwd_kernel_pair(kernel, q, k, v, e, True, _pad(2, 200, cuda)))


@pytest.mark.parametrize("impl,dqde", [("split", "column"), ("fused", "column"),
                                       ("fused", "dist")])
def test_flash_bwd_decomposition_matches_merged_kernel(cuda, monkeypatch, impl, dqde):
    """Autograd through flash_rel_attention under each decomposition against
    the merged kernel (f32, 1e-4); only the decomposition's kernels launch."""
    q, k, v, e = _qkve(2, 3, 200, 48, 256, torch.float32, seed=4)
    pad = _pad(2, 200, cuda)
    do = torch.randn(q.shape, device=cuda) * (~pad)[:, None, :, None]
    grads = {}
    for run in ("merged", impl):
        monkeypatch.setenv("MIDI_EMOTION_BWD", run)
        monkeypatch.setenv("MIDI_EMOTION_DQDE", dqde)
        xs = [t.clone().requires_grad_() for t in (q, k, v, e)]
        before = {n: getattr(fa, n).launches for n in BWD_KERNELS}
        merged_before = flash_rel_attention_bwd.launches
        o, _ = flash_rel_attention(*xs, True, pad)
        grads[run] = torch.autograd.grad(o, xs, do)
        launched = {n for n in BWD_KERNELS if getattr(fa, n).launches > before[n]}
        want = {"merged": set(), "split": {"bwd_dkdv_dq", "bwd_de_dqrel"},
                "fused": {"bwd_dkdv", "bwd_dq_de_dist" if dqde == "dist" else "bwd_dq_de"}}[run]
        assert launched == want, (run, launched)
        assert flash_rel_attention_bwd.launches == merged_before + (run == "merged")
    for name, a, b in zip(("dq", "dk", "dv", "de"), grads[impl], grads["merged"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=name)


def test_flash_bwd_decomposition_wrapper_guards(cuda):
    q, k, v, e = _qkve(1, 2, 64, 48, 128, torch.float32)
    lse = torch.zeros((1, 2, 64), device=cuda)
    dsum = torch.zeros((1, 2, 64), device=cuda)
    for kernel in BWD_KERNELS:
        wrapper = getattr(fa, kernel)
        before = wrapper.launches
        with pytest.raises(ValueError, match="contiguous"):
            wrapper(q, k, v, e, True, None, lse, dsum, q.transpose(2, 3).contiguous().transpose(2, 3))
        with pytest.raises(ValueError, match="f32"):
            wrapper(q, k, v, e, True, None, lse.bfloat16(), dsum, q)
        with pytest.raises(TypeError):
            wrapper(q, k.double(), v, e, True, None, lse, dsum, q)
        assert wrapper.launches == before, kernel
        wrapper(*_qkve(1, 2, 64, 144, 128, torch.float32), True, None, lse, dsum,
                torch.zeros((1, 2, 64, 144), device=cuda))  # the wide kernel, at 192
        assert wrapper.launches == before + 1, kernel


# d_head the kernels are not built for: the wrappers pad them with zero
# columns (40 -> 48, 80 -> 96) and pass c = 1/sqrt(true d_head)
PADDED_DHS = [40, 80]


@pytest.mark.parametrize("dh", PADDED_DHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_kernels_padded_heads_match_twins(cuda, dtype, dh):
    """Kernels 1 and 4 at a d_head they are not built for, through the
    padding: O, lse and dQ, dK, dV, dE at the true width, against the twins
    at that width (f32 1e-4; bf16 as the bf16 tests)."""
    q, k, v, e = _qkve(2, 3, 200, dh, 256, dtype, seed=9)
    pad = _pad(2, 200, cuda)
    if dtype == torch.bfloat16:
        o, lse = _assert_fwd_bf16(q, k, v, e, True, pad)
    else:
        o, lse = flash_rel_attention(q, k, v, e, True, pad)
        ro, rlse = flash_rel_attention_plain(q, k, v, e, True, pad)
        torch.testing.assert_close(o, ro, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-4)
    assert o.shape == q.shape and o.is_contiguous()
    got, want = _bwd_pair(q, k, v, e, True, pad)
    assert all(a.shape == b.shape and a.is_contiguous() for a, b in zip(got, want))
    if dtype == torch.bfloat16:
        _assert_grads_bf16(("dq", "dk", "dv", "de"), got, want)
    else:
        for name, a, b in zip(("dq", "dk", "dv", "de"), got, want):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=name)


# d_head past 128: kernels 1 and 4 are built for 192 and 256 (two column
# halves, a block each); 160 and 224 reach them through the padding. Past
# 256 they run their wide form (csrc/flash_rel_attn_wide.cu), and so do
# kernels 5-9 past 128 (DECOMPOSITION_WIDE_DHS): 320 through the padding
WIDE_DHS = [160, 192, 224, 256]
STREAMED_DHS = [320, 384, 768]


@pytest.mark.parametrize("dh", WIDE_DHS + STREAMED_DHS)
@pytest.mark.parametrize("T", [1, 65, 200])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernels_wide_heads_match_twins_f32(cuda, dh, T, causal):
    """Kernels 1 and 4 in f32 past d_head 128: O, lse and dQ, dK, dV, dE
    against the twins (1e-4, as at the narrower heads), a pad tail and a
    fully masked row."""
    q, k, v, e = _qkve(2, 3, T, dh, 256, torch.float32, seed=12)
    pad = _pad(2, T, cuda)
    o, lse = flash_rel_attention(q, k, v, e, causal, pad)
    ro, rlse = flash_rel_attention_plain(q, k, v, e, causal, pad)
    torch.testing.assert_close(o, ro, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-4)
    got, want = _bwd_pair(q, k, v, e, causal, pad)
    for name, a, b in zip(("dq", "dk", "dv", "de"), got, want):
        assert a.shape == b.shape and a.is_contiguous(), name
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=name)
    if causal:
        assert o[1, :, 0].eq(0).all() and lse[1, :, 0].eq(1e30).all()
        assert got[0][1, :, 0].eq(0).all()


@pytest.mark.parametrize("dh", WIDE_DHS)
@pytest.mark.parametrize("T", [1, 63, 64, 65, 333, 1216])
def test_wgmma_flash_kernels_bf16_wide_heads_causal(cuda, dh, T):
    """The wgmma kernels 1 and 4 past d_head 128, as
    test_wgmma_flash_kernels_bf16_causal: the bf16 tolerances, the fully
    masked row, two calls bitwise equal."""
    _check_wgmma_kernels(*_qkve(2, 2, T, dh, 2048, torch.bfloat16, seed=13), True,
                         _pad(2, T, cuda))


@pytest.mark.parametrize("dh", WIDE_DHS)
def test_wgmma_flash_kernels_bf16_wide_heads_non_causal(cuda, dh):
    _check_wgmma_kernels(*_qkve(2, 2, 200, dh, 2048, torch.bfloat16, seed=14), False,
                         _pad(2, 200, cuda))


@pytest.mark.parametrize("impl,dqde", [("split", "column"), ("fused", "column"),
                                       ("fused", "dist")])
def test_wide_head_limits(cuda, monkeypatch, impl, dqde):
    """At the widths that were the kernels' limits, each kernel launches
    and matches its twin: 272 (padded to 384) on kernels 1, 4 and 13, 144
    (padded to 192) on kernels 5-9 under split and fused, bf16, each launch
    counted."""
    wide = _qkve(2, 2, 64, 272, 512, torch.bfloat16, seed=15)
    pad = _pad(2, 64, cuda)
    before = flash_rel_attention.launches, flash_rel_attention_bwd.launches
    _check_wgmma_kernels(*wide, True, pad)
    assert flash_rel_attention.launches >= before[0] + 2
    assert flash_rel_attention_bwd.launches >= before[1] + 2
    kv, sc, q, e, _, _, vmax = _decode_inputs(2, 256, 2, 272, 2, 4, True)
    e_rows = da.expand_e_rows(e, 11, 256, dh_to=da.cache_dh(272))
    n = da.decode_attn_cached.launches
    acc, m, l = da.decode_attn_cached(q, kv, sc, 1, e_rows, 10)
    assert da.decode_attn_cached.launches == n + 1
    racc, rm, rl = da.decode_attn_cached_plain(q, kv, sc, 1, e_rows, 10)
    torch.testing.assert_close(l, rl, rtol=1e-5, atol=1e-5)
    err = (acc.view(2, 2, 272) / l[..., None] - racc.view(2, 2, 272) / rl[..., None]).abs().max()
    assert err.item() <= vmax / 127
    q, k, v, e = _qkve(2, 2, 64, 144, 512, torch.bfloat16, seed=16)
    monkeypatch.setenv("MIDI_EMOTION_BWD", impl)
    monkeypatch.setenv("MIDI_EMOTION_DQDE", dqde)
    for kernel in BWD_KERNELS:
        _assert_grads_bf16(BWD_KERNELS[kernel], *_bwd_kernel_pair(kernel, q, k, v, e, True, pad))
    o, lse = flash_rel_attention(q, k, v, e, True, pad)
    do = torch.randn(o.shape, device=cuda).to(o.dtype) * (~pad)[:, None, :, None]
    want = flash_rel_attention_bwd_plain(q, k, v, e, True, pad, o, lse, do)
    _assert_grads_bf16(("dq", "dk", "dv", "de"),
                       flash_rel_attention_bwd(q, k, v, e, True, pad, o, lse, do), want)


DECOMPOSITION_WIDE_DHS = [160, 192, 224, 256, 384]


@pytest.mark.parametrize("dh", STREAMED_DHS)
@pytest.mark.parametrize("T", [1, 63, 64, 65, 333, 1216])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernels_wide_heads_streamed_bf16(cuda, dh, T, causal):
    """Kernels 1 and 4 in bf16 past d_head 256: the bf16 tolerances, the
    fully masked row, two calls bitwise equal."""
    _check_wgmma_kernels(*_qkve(2, 2, T, dh, 2048, torch.bfloat16, seed=17), causal,
                         _pad(2, T, cuda))


# kernel 1's bf16 forward past d_head 256 runs on one thread-block cluster
# per query tile, a CTA per 128 columns: 3 CTAs at 320 and 384, 4 at 512,
# 6 at 768, 8 at 1024, 9 (a non-portable cluster size) at 1152
CLUSTER_DHS = [320, 384, 512, 768, 1024, 1152]


@pytest.mark.parametrize("dh", CLUSTER_DHS)
@pytest.mark.parametrize("T", [1, 63, 65, 1216])
@pytest.mark.parametrize("causal", [True, False])
def test_wide_cluster_forward_bf16(cuda, dh, T, causal):
    """Kernel 1's cluster forward against its twin at the bf16 tolerances:
    ragged last tiles, a pad tail, the fully masked row (causal), and a
    second launch bitwise the first (the parts' partial scores are summed
    in rank order, no atomics)."""
    q, k, v, e = _qkve(2, 2, T, dh, 2048, torch.bfloat16, seed=18)
    pad = _pad(2, T, cuda) if T > 1 else None
    o, lse = _assert_fwd_bf16(q, k, v, e, causal, pad)
    if causal and pad is not None:
        assert o[1, :, 0].eq(0).all() and lse[1, :, 0].eq(1e30).all()
    o2, lse2 = flash_rel_attention(q, k, v, e, causal, pad)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


def test_wide_cluster_forward_launches_the_cluster_kernel(cuda):
    """Past d_head 256 the bf16 forward's one launch is the cluster kernel
    (counted by the wrapper), not the per-part kernel it replaced."""
    from torch.profiler import ProfilerActivity, profile

    q, k, v, e = _qkve(2, 2, 333, 384, 512, torch.bfloat16, seed=19)
    before = flash_rel_attention.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        flash_rel_attention(q, k, v, e, True, None)
        torch.cuda.synchronize()
    assert flash_rel_attention.launches == before + 1
    names = [ev.name for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
    assert any("wide_fwd_tc_cluster_kernel" in n for n in names), names
    assert not any("wide_fwd_tc_kernel" in n for n in names), names


# kernel 4's bf16 backward past d_head 256 runs on one thread-block cluster
# per (b, h) and split of its key tiles, a CTA per 128 columns, at the same
# widths: 3 CTAs at 320 and 384 up to 9 at 1152


@pytest.mark.parametrize("dh", CLUSTER_DHS)
@pytest.mark.parametrize("T", [1, 63, 65, 333])
@pytest.mark.parametrize("causal", [True, False])
def test_wide_cluster_backward_bf16(cuda, dh, T, causal):
    """Kernel 4's cluster backward against its twin at the bf16 tolerances
    (phase 3's 2e-2 of 1 + each gradient's scale): ragged last tiles, a
    pad tail, one and two splits of the key tiles, the fully masked row's
    dQ 0 (causal), and a second call bitwise the first (the parts' partial
    S and dP summed in rank order, the splits' partials in split order, no
    atomics)."""
    q, k, v, e = _qkve(2, 2, T, dh, 2048, torch.bfloat16, seed=20)
    pad = _pad(2, T, cuda)
    o, lse = flash_rel_attention(q, k, v, e, causal, pad)
    g = torch.Generator(device="cuda").manual_seed(3)
    do = (torch.randn(o.shape, generator=g, device="cuda") * (~pad)[:, None, :, None]).to(q.dtype)
    got = flash_rel_attention_bwd(q, k, v, e, causal, pad, o, lse, do)
    want = flash_rel_attention_bwd_plain(q, k, v, e, causal, pad, o, lse, do)
    _assert_grads_bf16(("dq", "dk", "dv", "de"), got, want)
    if causal:
        assert got[0][1, :, 0].eq(0).all()
    again = flash_rel_attention_bwd(q, k, v, e, causal, pad, o, lse, do)
    for name, a, b in zip(("dq", "dk", "dv", "de"), got, again):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("causal", [True, False])
def test_wide_cluster_backward_masked_rows(cuda, causal):
    """A batch row whose keys are all pad: its query rows see no key, so
    its dQ, dK and dV are zero, and dE is the other row's alone."""
    q, k, v, e = _qkve(2, 1, 200, 768, 256, torch.bfloat16, seed=21)
    pad = torch.zeros((2, 200), dtype=torch.bool, device=cuda)
    pad[1] = True
    o, lse = flash_rel_attention(q, k, v, e, causal, pad)
    do = torch.randn(o.shape, device=cuda).to(q.dtype)
    got = flash_rel_attention_bwd(q, k, v, e, causal, pad, o, lse, do)
    for name, grad in zip(("dq", "dk", "dv"), got):
        assert grad[1].eq(0).all(), name
    want = flash_rel_attention_bwd_plain(q, k, v, e, causal, pad, o, lse, do)
    _assert_grads_bf16(("dq", "dk", "dv", "de"), got, want)
    alone = flash_rel_attention_bwd_plain(*(t[:1] for t in (q, k, v)), e, causal, pad[:1],
                                          o[:1], lse[:1], do[:1])
    _assert_grads_bf16(("de",), got[3:], alone[3:])


def test_wide_cluster_backward_launches_the_cluster_kernel(cuda):
    """Past d_head 256 the bf16 merged backward's main launch is the
    cluster kernel (counted by the wrapper), not the three sweeps it
    replaced."""
    from torch.profiler import ProfilerActivity, profile

    q, k, v, e = _qkve(2, 2, 333, 384, 512, torch.bfloat16, seed=22)
    o, lse = flash_rel_attention(q, k, v, e, True, None)
    do = torch.randn(o.shape, device=cuda).to(q.dtype)
    torch.cuda.synchronize()
    before = flash_rel_attention_bwd.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        flash_rel_attention_bwd(q, k, v, e, True, None, o, lse, do)
        torch.cuda.synchronize()
    assert flash_rel_attention_bwd.launches == before + 1
    names = [ev.name for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
    assert any("wide_bwd_tc_cluster_kernel" in n for n in names), names
    for sweep in ("wide_dkdv_tc_kernel", "wide_dq_tc_kernel", "wide_de_tc_kernel"):
        assert not any(sweep in n for n in names), (sweep, names)


@pytest.mark.parametrize("kernel", list(BWD_KERNELS))
@pytest.mark.parametrize("dh", DECOMPOSITION_WIDE_DHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_decomposition_kernel_wide_heads(cuda, kernel, dh, dtype, causal):
    """Kernels 5-9 past d_head 128 (their wide form; 160 and 224 through
    the padding), against their twins (f32 1e-4; bf16 2e-2 of each
    output's scale), a pad tail and a fully masked row, and a second call
    bitwise the first."""
    q, k, v, e = _qkve(2, 2, 133, dh, 256, dtype, seed=18)
    pad = _pad(2, 133, cuda)
    got, want = _bwd_kernel_pair(kernel, q, k, v, e, causal, pad)
    if dtype == torch.bfloat16:
        _assert_grads_bf16(BWD_KERNELS[kernel], got, want)
    else:
        for name, a, b in zip(BWD_KERNELS[kernel], got, want):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=name)
    for name, a in zip(BWD_KERNELS[kernel], got):
        if causal and name.startswith("dq"):
            assert a[1, :, 0].eq(0).all(), name
    again, _ = _bwd_kernel_pair(kernel, q, k, v, e, causal, pad)
    for name, a, b in zip(BWD_KERNELS[kernel], got, again):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("kernel", list(BWD_KERNELS))
@pytest.mark.parametrize("dh", PADDED_DHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_bwd_decomposition_kernel_padded_heads(cuda, kernel, dh, dtype):
    """Kernels 5-9 through the padding, against their twins at the true
    d_head (f32 1e-4; bf16 2e-2 of each output's scale)."""
    q, k, v, e = _qkve(2, 3, 133, dh, 256, dtype, seed=10)
    got, want = _bwd_kernel_pair(kernel, q, k, v, e, True, _pad(2, 133, cuda))
    assert all(a.shape == b.shape and a.is_contiguous() for a, b in zip(got, want))
    if dtype == torch.bfloat16:
        _assert_grads_bf16(BWD_KERNELS[kernel], got, want)
    else:
        for name, a, b in zip(BWD_KERNELS[kernel], got, want):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=name)


@pytest.mark.parametrize("kernel", ["bwd_dq_de", "bwd_dq_de_dist"])
@pytest.mark.parametrize("dh", [16, 32, 48, 64, 96, 128] + PADDED_DHS)
@pytest.mark.parametrize("T", [1, 63, 64, 65, 333])
@pytest.mark.parametrize("causal", [True, False])
def test_fused_dq_de_kernel_bf16_matches_twin(cuda, kernel, dh, T, causal):
    """Kernels 5 and 6 in bf16, on the tensor cores: every d_head (40 and 80
    through the padding), T within one key tile, at its edge, past it, and
    ragged over six; a pad tail and, causal, a fully masked row, whose dQ
    is 0. Within 2e-2 of each output's scale."""
    q, k, v, e = _qkve(2, 3, T, dh, 512, torch.bfloat16, seed=11)
    pad = _pad(2, T, cuda)
    got, want = _bwd_kernel_pair(kernel, q, k, v, e, causal, pad)
    _assert_grads_bf16(BWD_KERNELS[kernel], got, want)
    if causal:
        assert got[0][1, :, 0].eq(0).all()


@pytest.mark.parametrize("kernel", ["bwd_dq_de", "bwd_dq_de_dist"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fused_dq_de_kernel_deterministic(cuda, kernel, dtype):
    """Two calls on the same inputs give bitwise-equal dQ and dE: the dE
    partials are summed in a fixed order, with no atomics."""
    q, k, v, e = _qkve(4, 4, 700, 48, 1024, dtype, seed=12)
    pad = _pad(4, 700, cuda)
    o, lse = flash_rel_attention(q, k, v, e, True, pad)
    do = torch.randn(o.shape, device=cuda).to(dtype) * (~pad)[:, None, :, None]
    dsum = (do.float() * o.float()).sum(-1)
    first = getattr(fa, kernel)(q, k, v, e, True, pad, lse, dsum, do)
    second = getattr(fa, kernel)(q, k, v, e, True, pad, lse, dsum, do)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kernel", ["bwd_dkdv_dq", "bwd_de_dqrel"])
@pytest.mark.parametrize("dh", [16, 32, 48, 64, 96, 128] + PADDED_DHS)
@pytest.mark.parametrize("T", [1, 63, 64, 65, 333])
@pytest.mark.parametrize("causal", [True, False])
def test_split_kernel_bf16_matches_twin(cuda, kernel, dh, T, causal):
    """Kernels 7 and 8 (the split decomposition) in bf16, on the tensor
    cores: every d_head (40 and 80 through the padding), T within one tile,
    at its edge, past it, and ragged over six; a pad tail and, causal, a
    fully masked row, whose dQ term is 0. Within 2e-2 of each output's
    scale."""
    q, k, v, e = _qkve(2, 3, T, dh, 512, torch.bfloat16, seed=13)
    pad = _pad(2, T, cuda)
    got, want = _bwd_kernel_pair(kernel, q, k, v, e, causal, pad)
    _assert_grads_bf16(BWD_KERNELS[kernel], got, want)
    if causal:  # dq_qk of kernel 7, dq_rel of kernel 8
        assert got[2 if kernel == "bwd_dkdv_dq" else 0][1, :, 0].eq(0).all()


@pytest.mark.parametrize("kernel", ["bwd_dkdv_dq", "bwd_de_dqrel"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_split_kernel_deterministic(cuda, kernel, dtype):
    """Two calls on the same inputs give bitwise-equal outputs: the dQ and
    dE partials are summed in a fixed order, with no atomics."""
    q, k, v, e = _qkve(4, 4, 700, 48, 1024, dtype, seed=14)
    pad = _pad(4, 700, cuda)
    o, lse = flash_rel_attention(q, k, v, e, True, pad)
    do = torch.randn(o.shape, device=cuda).to(dtype) * (~pad)[:, None, :, None]
    dsum = (do.float() * o.float()).sum(-1)
    first = getattr(fa, kernel)(q, k, v, e, True, pad, lse, dsum, do)
    second = getattr(fa, kernel)(q, k, v, e, True, pad, lse, dsum, do)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("split", [None, 2], ids=["tile-grid", "split2-grid"])
@pytest.mark.parametrize("dh", [16, 32, 48, 64, 96, 128] + PADDED_DHS)
@pytest.mark.parametrize("T", [63, 64, 65, 200, 1216])
@pytest.mark.parametrize("causal", [True, False])
def test_fused_dkdv_kernel_bf16_matches_twin(cuda, split, dh, T, causal):
    """Kernel 9 (the fused decomposition's dK/dV) in bf16, on the tensor
    cores, on either grid (one block per key tile, or two blocks a (b, h)):
    every d_head (40 and 80 through the padding), T inside, at and past a
    tile edge and the flagship's; a pad tail. Within 2e-2 of each output's
    scale, and bitwise kernel 7's dK and dV: each key tile sums the same
    products over the same query tiles in the same order."""
    q, k, v, e = _qkve(2, 3, T, dh, 2048, torch.bfloat16, seed=15)
    pad = _pad(2, T, cuda)
    o, lse = flash_rel_attention(q, k, v, e, causal, pad)
    g = torch.Generator(device="cuda").manual_seed(16)
    do = (torch.randn(o.shape, generator=g, device="cuda") * (~pad)[:, None, :, None]).bfloat16()
    dsum = (do.float() * o.float()).sum(-1)
    args = (q, k, v, e, causal, pad, lse, dsum, do)
    before = fa.bwd_dkdv.launches
    got = fa.bwd_dkdv(*args, split=split)
    assert fa.bwd_dkdv.launches == before + 1
    _assert_grads_bf16(BWD_KERNELS["bwd_dkdv"], got, fa.bwd_dkdv_plain(*args))
    for name, a, b in zip(("dk", "dv"), got, fa.bwd_dkdv_dq(*args)[:2]):
        assert torch.equal(a, b), name


def test_fused_dkdv_kernel_deterministic_and_guarded(cuda):
    """Two calls give bitwise-equal dK and dV; a grid of fewer than one
    block a (b, h) raises."""
    q, k, v, e = _qkve(4, 4, 700, 48, 1024, torch.bfloat16, seed=17)
    pad = _pad(4, 700, cuda)
    o, lse = flash_rel_attention(q, k, v, e, True, pad)
    do = torch.randn(o.shape, device=cuda).bfloat16() * (~pad)[:, None, :, None]
    args = (q, k, v, e, True, pad, lse, (do.float() * o.float()).sum(-1), do)
    for a, b in zip(fa.bwd_dkdv(*args), fa.bwd_dkdv(*args)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="split"):
        fa.bwd_dkdv(*args, split=0)


@pytest.mark.parametrize("rows", [1, 5, 7, 9728, 9729])
@pytest.mark.parametrize("D", [99, 100, 640, 768])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("dropout", [True, False], ids=["kernel12", "kernel3"])
def test_ln_bwd_kernels_row_tiles(cuda, rows, D, dtype, dropout):
    """Kernels 12 (dropout + add + LayerNorm backward) and 3 (LayerNorm
    backward), the one ``ln_bwd`` source, over row counts that leave a
    ragged last tile and widths whose rows start inside a group of four
    Philox words (D 99) or not: against the twins (kernel 12 given the mask
    recovered through kernel 10), and dgamma, dbeta bitwise equal over two
    calls (fixed partials, summed in a fixed order)."""
    rate, seed = 0.1, 91
    g = torch.Generator(device="cuda").manual_seed(rows + D)
    sub, res, dy = ((torch.randn((rows, D), generator=g, device=cuda) * 2 + 0.5).to(dtype)
                    for _ in range(3))
    w = torch.randn((D,), generator=g, device=cuda)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    if dropout:
        keep = fd.fused_dropout(torch.ones_like(sub), seed, rate) != 0
        got = fd.dropout_add_layernorm_bwd(sub, res, dy, w, seed, rate)
        want = fd.dropout_add_layernorm_bwd_plain(sub, res, dy, w, keep, rate)
        again = fd.dropout_add_layernorm_bwd(sub, res, dy, w, seed, rate)
        assert not got[0][~keep].any()  # dsub is zero off the mask
    else:
        got = layernorm_bwd(res, dy, w)
        want = layernorm_bwd_ref(res, dy, w)
        again = layernorm_bwd(res, dy, w)
    for a, r in zip(got[:-2], want[:-2]):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), r.float(), rtol=tol, atol=tol)
    for name, a, r, b in zip(("dw", "db"), got[-2:], want[-2:], again[-2:]):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-3, msg=name)
        assert torch.equal(a, b), name


@pytest.mark.parametrize("D", [2048, 4096, 8192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ln_bwd_kernels_wide_rows(cuda, D, dtype):
    """Kernels 12 and 3 at the widest rows the wrappers take (one row a
    tile past 1024 columns, fewer pipeline stages where the tiles are
    large), against the twins."""
    rate, seed = 0.1, 92
    g = torch.Generator(device="cuda").manual_seed(D)
    sub, res, dy = ((torch.randn((37, D), generator=g, device=cuda) * 2 + 0.5).to(dtype)
                    for _ in range(3))
    w = torch.randn((D,), generator=g, device=cuda)
    keep = fd.fused_dropout(torch.ones_like(sub), seed, rate) != 0
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for got, want in ((fd.dropout_add_layernorm_bwd(sub, res, dy, w, seed, rate),
                       fd.dropout_add_layernorm_bwd_plain(sub, res, dy, w, keep, rate)),
                      (layernorm_bwd(res, dy, w), layernorm_bwd_ref(res, dy, w))):
        for a, r in zip(got[:-2], want[:-2]):
            torch.testing.assert_close(a.float(), r.float(), rtol=tol, atol=tol)
        for a, r in zip(got[-2:], want[-2:]):
            torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-3)


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


# d_head past 128: the flagship's width with 3 heads of 256 at its serving
# shape, 4 of 192, one of 192 (rows whose halves are not 128-byte
# multiples), and 160 laid out at 192; past 256, where the stacked kernel's
# wide instantiations run: the flagship's width with 2 heads of 384, 320
# laid out at 384, 2 heads of 512, 768, 1024; and past 1024 channels a head
# (the per-head kernel), 1152
DECODE_WIDE = [(64, 1408, 3, 256, 2), (4, 256, 4, 192, 2), (4, 256, 1, 192, 2),
               (4, 256, 2, 160, 2), (64, 1408, 2, 384, 2), (4, 256, 2, 320, 2),
               (4, 256, 1, 768, 2), (4, 256, 2, 512, 2), (4, 256, 1, 1024, 2),
               (2, 256, 1, 1152, 2)]
DECODE_WIDE_IDS = ["flagship-dh256", "dh192", "dh192-h1", "dh160", "flagship-dh384", "dh320",
                   "dh768", "dh512", "dh1024", "dh1152"]


def _decode_inputs(B, W, H, dh, L, S, quant, seed=0):
    """A stacked cache of random rows (quantized for int8), q, E, a stage
    and the current row, on the card, laid out as the model lays them out:
    each head at cache_dh(dh) columns, zero past dh."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    D, dh_k = H * dh, da.cache_dh(dh)
    rows = torch.randn((L, B, W, 2 * D), generator=g, device="cuda")
    vmax = rows[..., D:].abs().max().item()
    rows = da.pad_groups(rows, 2 * H, dh_k)
    kv, sc = da.quantize_rows(rows, 2 * H) if quant else (rows.bfloat16(), None)
    q = torch.randn((B, H, dh), generator=g, device="cuda")
    e = torch.randn((512, dh), generator=g, device="cuda")
    pend = da.pad_groups(torch.randn((S, L, B, 2 * D), generator=g, device="cuda"), 2 * H,
                         dh_k).bfloat16()
    row = da.pad_groups(torch.randn((B, 2 * D), generator=g, device="cuda"), 2 * H,
                        dh_k).bfloat16()
    return kv, sc, q, e, pend, row, vmax


@pytest.mark.parametrize("shape", [(64, 1408, 16, 48, 2), (3, 384, 4, 48, 3), (2, 200, 2, 16, 2),
                                   (4, 256, 8, 96, 2), (4, 256, 8, 128, 2), (4, 256, 10, 128, 2),
                                   (4, 256, 16, 40, 2)] + DECODE_WIDE,
                         ids=["flagship", "odd", "w200-dh16", "dh96", "dh128", "D1280", "dh40"]
                         + DECODE_WIDE_IDS)
@pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16"])
def test_decode_kernel_matches_twin_unstaged(cuda, shape, quant):
    """acc/l within one P re-quantization unit (int8: max|V|/127, flipped
    when the f32 score sums round apart; bf16: p rounded to bf16 in both,
    1e-3 of max|V|), m and l to f32 summation order, length 0 exact."""
    B, W, H, dh, L = shape
    kv, sc, q, e, _, _, vmax = _decode_inputs(B, W, H, dh, L, 8, quant)
    for length in sorted({0, 1, 127, 128, 129, min(700, W), W}):
        e_rows = da.expand_e_rows(e, length + 1, W, dh_to=da.cache_dh(dh))
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


@pytest.mark.parametrize("shape", [(64, 1408, 16, 48, 2), (3, 384, 4, 48, 3), (2, 200, 2, 16, 2),
                                   (4, 256, 8, 96, 2), (4, 256, 8, 128, 2), (4, 256, 10, 128, 2),
                                   (4, 256, 16, 40, 2)] + DECODE_WIDE,
                         ids=["flagship", "odd", "w200-dh16", "dh96", "dh128", "D1280", "dh40"]
                         + DECODE_WIDE_IDS)
@pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16"])
def test_decode_kernel_matches_twin_staged(cuda, shape, quant):
    """Staged (S 8): the normalized bf16 output within one P unit (int8)
    plus two bf16 ulps of its scale, and the stage written exactly, the
    p_cnt == S clamp included."""
    B, W, H, dh, L = shape
    S = 8
    kv, sc, q, e, pend, row, vmax = _decode_inputs(B, W, H, dh, L, S, quant, seed=1)
    dh_k = da.cache_dh(dh)
    for length in sorted({0, 1, 127, 128, 129, min(700, W - S), W - S}):
        e_rows = da.expand_e_rows(e, length + S + 1, W, dh_to=dh_k)
        for p_cnt in (0, 3, 7, 8):
            e_pend = da.expand_e_rows(e, p_cnt + 1, S + 1, dh_to=dh_k)
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
    with pytest.raises(ValueError, match="d_head"):  # 32 is built: its cache is 32 wide
        da.decode_attn_cached(q[..., :32], kv, sc, 1, e_rows, 10)
    with pytest.raises(ValueError, match="stage"):
        da.decode_attn_cached(q, kv, sc, 1, e_rows, 10, pend, da.expand_e_rows(e, 6, 5), 5, row)
    assert da.decode_attn_cached.launches == before


@pytest.mark.parametrize("B", [4, 64, 160], ids=["B4", "B64", "B160"])
@pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16"])
def test_decode_kernel_every_cluster_split(cuda, quant, B):
    """Lengths 128k - 1, 128k and 128k + 1 up to W at the flagship widths,
    unstaged and staged. On 132 SMs the launch aims at one CTA an SM: B 4
    runs clusters of up to 8 CTAs (one or two window blocks each), B 64
    clusters of up to 2 (up to six blocks each), B 160 one CTA per batch
    row (up to eleven blocks, a two-stage ring). One launch, and one
    kernel, per call."""
    from torch.profiler import ProfilerActivity, profile

    W, H, dh, L, S = 1408, 16, 48, 2, 8
    kv, sc, q, e, pend, row, vmax = _decode_inputs(B, W, H, dh, L, S, quant, seed=2)
    lengths = sorted({n for k in range(1, W // 128 + 1) for n in (128 * k - 1, 128 * k, 128 * k + 1)
                      if n <= W - S})
    rows = [da.expand_e_rows(e, length + 1, W) for length in lengths]
    before = da.decode_attn_cached.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        outs = [da.decode_attn_cached(q, kv, sc, L - 1, e_rows, length)
                for length, e_rows in zip(lengths, rows)]
        torch.cuda.synchronize()
    assert da.decode_attn_cached.launches == before + len(lengths)
    # the card's profiler can drop kernel records under back-to-back launches,
    # so it is held to "no other kernel, none extra", the counter to one each
    names = [ev.name for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
    assert 0 < len(names) <= len(lengths), names
    assert all("decode_attn_stacked" in n for n in names), names
    for i, (length, e_rows, (acc, m, l)) in enumerate(zip(lengths, rows, outs)):
        racc, rm, rl = da.decode_attn_cached_plain(q, kv, sc, L - 1, e_rows, length)
        torch.testing.assert_close(m, rm, rtol=1e-5, atol=1e-5, msg=f"m at {length}")
        torch.testing.assert_close(l, rl, rtol=1e-5, atol=1e-5, msg=f"l at {length}")
        err = (acc.view(B, H, dh) / l[..., None] - racc.view(B, H, dh) / rl[..., None]).abs().max()
        assert err.item() <= (vmax / 127 if quant else 1e-3 * vmax), (length, err)
        p_cnt = (0, 3, 7, 8)[i % 4]
        e_rows = da.expand_e_rows(e, length + p_cnt + 1, W)
        e_pend = da.expand_e_rows(e, p_cnt + 1, S + 1)
        got_pend, want_pend = pend.clone(), pend.clone()
        before = da.decode_attn_cached.launches
        out, _ = da.decode_attn_cached(q, kv, sc, L - 1, e_rows, length, got_pend, e_pend, p_cnt,
                                       row)
        assert da.decode_attn_cached.launches == before + 1
        ref, _ = da.decode_attn_cached_plain(q, kv, sc, L - 1, e_rows, length, want_pend, e_pend,
                                             p_cnt, row)
        assert torch.equal(got_pend, want_pend), (length, p_cnt)
        tol = (vmax / 127 if quant else 0) + 2 ** -7 * ref.float().abs().max().item()
        assert (out.float() - ref.float()).abs().max().item() <= tol, (length, p_cnt)


@pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16"])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16], ids=["q-f32", "q-bf16"])
def test_decode_kernel_q_dtypes_and_head_groups(cuda, quant, q_dtype):
    """q as it comes (f32 or bf16; the kernel quantizes and casts it) against
    the twin given the same q, at H 16 and at H 20: the kernel's score units
    take 8 heads, so H 20 ends on a partial unit of 4; and on the wide
    instantiations, 2 heads of 384 and 1 of 1024."""
    for B, W, H, dh in ((4, 384, 16, 48), (3, 512, 20, 32), (4, 384, 2, 384), (2, 384, 1, 1024)):
        kv, sc, q, e, pend, row, vmax = _decode_inputs(B, W, H, dh, 2, 8, quant, seed=3)
        q = q.to(q_dtype)
        for length in (1, 300, W - 8):
            e_rows = da.expand_e_rows(e, length + 1, W)
            acc, m, l = da.decode_attn_cached(q, kv, sc, 1, e_rows, length)
            racc, rm, rl = da.decode_attn_cached_plain(q, kv, sc, 1, e_rows, length)
            torch.testing.assert_close(m, rm, rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(l, rl, rtol=1e-5, atol=1e-5)
            err = (acc.view(B, H, dh) / l[..., None] - racc.view(B, H, dh) / rl[..., None]).abs()
            assert err.max().item() <= (vmax / 127 if quant else 1e-3 * vmax), (H, length)
            got_pend, want_pend = pend.clone(), pend.clone()
            e_pend = da.expand_e_rows(e, 4, 9)
            out, _ = da.decode_attn_cached(q, kv, sc, 1, e_rows, length, got_pend, e_pend, 3, row)
            ref, _ = da.decode_attn_cached_plain(q, kv, sc, 1, e_rows, length, want_pend, e_pend,
                                                 3, row)
            assert torch.equal(got_pend, want_pend)
            tol = (vmax / 127 if quant else 0) + 2 ** -7 * ref.float().abs().max().item()
            assert (out.float() - ref.float()).abs().max().item() <= tol, (H, length)


@pytest.mark.parametrize("rows,D", [(5, 99), (9728, 768)])
def test_dropout_mask_shared_by_kernels_10_11_12(cuda, rows, D):
    """One (seed, shape) gives one mask: kernel 10 forward and backward,
    kernel 11 (dropout + add + LayerNorm) and kernel 12 (its backward) all
    agree with the twins given the mask recovered through kernel 10; and
    the keep fraction is within 6 binomial standard deviations."""
    rate, seed = 0.1, 4321
    g = torch.Generator(device="cuda").manual_seed(7)
    sub, res, dy = (torch.randn((rows, D), generator=g, device=cuda) for _ in range(3))
    w, b = torch.randn((D,), generator=g, device=cuda), torch.randn((D,), generator=g, device=cuda)
    keep = fd.fused_dropout(torch.ones_like(sub), seed, rate) != 0
    n = keep.numel()
    assert abs(keep.float().mean().item() - (1 - rate)) <= 6 * (rate * (1 - rate) / n) ** 0.5
    xg = sub.clone().requires_grad_()
    fd.fused_dropout(xg, seed, rate).backward(torch.ones_like(sub))
    assert torch.equal(xg.grad != 0, keep)
    y = fd.dropout_add_layernorm(sub, res, w, b, seed, rate)
    torch.testing.assert_close(y, fd.dropout_add_layernorm_plain(sub, res, w, b, keep, rate),
                               rtol=1e-5, atol=1e-5)
    got = fd.dropout_add_layernorm_bwd(sub, res, dy, w, seed, rate)
    want = fd.dropout_add_layernorm_bwd_plain(sub, res, dy, w, keep, rate)
    assert not got[0][~keep].any()  # dsub is zero off the mask
    for name, a, r in zip(("dsub", "dres"), got[:2], want[:2]):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-4, msg=name)


def test_dropout_mask_lanes_independent(cuda):
    """Elements 4c and 4c + 1 take two words of one Philox call: the share
    of pairs with both kept is within 6 standard deviations of (1 - rate)^2."""
    rate = 0.1
    keep = (fd.fused_dropout(torch.ones((9728, 768), device=cuda), 99, rate) != 0).view(-1, 4)
    for a, b in ((0, 1), (1, 2), (2, 3), (0, 3)):
        both = (keep[:, a] & keep[:, b]).float()
        p = (1 - rate) ** 2
        sd = (p * (1 - p) / both.numel()) ** 0.5
        assert abs(both.mean().item() - p) <= 6 * sd, (a, b, both.mean().item())


@pytest.mark.parametrize("D", [768, 99])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_kernels_draw_the_slice_of_the_global_mask(cuda, D, dtype):
    """Kernels 10, 11 and 12 given a place (b0, t0, T_g): a rank's slice of a
    [4, 40, D] activation draws the global call's mask at its elements and
    gives the global call's outputs there, bit for bit (D 99: the
    one-draw-per-element path); a place that covers the whole tensor draws
    the default's bits."""
    rate, seed, Bg, Tg = 0.1, 2024, 4, 40
    g = torch.Generator(device="cuda").manual_seed(3)
    sub, res, dy = (torch.randn((Bg, Tg, D), generator=g, device=cuda).to(dtype)
                    for _ in range(3))
    w, b = torch.randn((D,), generator=g, device=cuda), torch.randn((D,), generator=g, device=cuda)
    ones = torch.ones_like(sub)
    keep = fd.fused_dropout(ones, seed, rate) != 0
    assert torch.equal(fd.fused_dropout(ones, seed, rate, place=(0, 0, Tg)) != 0, keep)
    y = fd.dropout_add_layernorm(sub, res, w, b, seed, rate)
    ds, dr, _, _ = fd.dropout_add_layernorm_bwd(sub, res, dy, w, seed, rate)
    for b0, t0, B, T in ((2, 0, 2, 40), (1, 16, 2, 8), (0, 32, 4, 8), (3, 0, 1, 40)):
        at = (slice(b0, b0 + B), slice(t0, t0 + T))
        part = lambda t: t[at].contiguous()
        place = (b0, t0, Tg)
        assert torch.equal(fd.fused_dropout(part(ones), seed, rate, place=place) != 0, keep[at])
        got = fd.dropout_add_layernorm(part(sub), part(res), w, b, seed, rate, place=place)
        assert torch.equal(got, y[at]), place
        pds, pdr, _, _ = fd.dropout_add_layernorm_bwd(part(sub), part(res), part(dy), w, seed,
                                                      rate, place=place)
        assert torch.equal(pds, ds[at]) and torch.equal(pdr, dr[at]), place


@pytest.mark.parametrize("causal", [True, False])
def test_ring_steps_match_kernels_1_and_4(cuda, causal):
    """The ring's per-step function driven over 4 chunks in one process
    (plain f32 tensor code) against kernel 1's output and kernel 4's
    gradients (q, k, v, e), f32, pad keys across a chunk boundary: 1e-4 of
    each scale, phase 3's f32 tolerance for those kernels."""
    from midi_emotion_tpu_torch.parallel.ring_attention import ring_attention_one_process

    q, k, v, e = _qkve(2, 4, 128, 48, 256, torch.float32)
    pad = torch.zeros((2, 128), dtype=torch.bool, device=cuda)
    pad[1, 70:] = True
    w = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(9),
                    device=cuda)
    outs = []
    for fn in (lambda *a: ring_attention_one_process(*a, 4, causal, pad),
               lambda *a: flash_rel_attention(*a, causal, pad)[0]):
        leaves = [t.clone().requires_grad_() for t in (q, k, v, e)]
        o = fn(*leaves)
        (o * w).sum().backward()
        outs.append([o.detach()] + [t.grad for t in leaves])
    for got, want in zip(*outs):
        tol = 1e-4 * (1 + want.abs().max().item())
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def test_seq_rank_activation_runs_the_dropout_kernels(cuda):
    """A seq rank's positions of the model's [4, 40, 768] bf16 activation
    (``seq_part``, B > 1) through kernels 10, 11 and 12 at the rank's place
    (``dropout_place``) at rate 0.1: the global call's outputs at its
    positions, bit for bit, as the ring model's layers run them."""
    from midi_emotion_tpu_torch.parallel.mesh import Mesh, rank_grid

    cfg = ModelConfig(vocab_size=1007, mode="continuous_concat", n_layer=1, n_head=16,
                      d_model=768, d_inner=64, d_condition=192, max_seq=64, dropout=0.1)
    model = MusicTransformer(cfg, device=cuda)
    rate, seed = 0.1, 31
    g = torch.Generator(device="cuda").manual_seed(4)
    sub, res, dy = (torch.randn((4, 40, 768), generator=g, device=cuda).to(torch.bfloat16)
                    for _ in range(3))
    w, b = torch.randn((768,), generator=g, device=cuda), torch.randn((768,), generator=g,
                                                                     device=cuda)
    d = fd.fused_dropout(sub, seed, rate)
    y = fd.dropout_add_layernorm(sub, res, w, b, seed, rate)
    ds, dr, _, _ = fd.dropout_add_layernorm_bwd(sub, res, dy, w, seed, rate)
    for rank in (0, 1):
        model.mesh = Mesh(rank_grid(1, 1, 2), rank)
        ps, pr, pdy = (model.seq_part(t) for t in (sub, res, dy))
        place = model.dropout_place(*ps.shape[:2])
        at = (slice(None), slice(rank * 20, (rank + 1) * 20))
        assert torch.equal(fd.fused_dropout(ps, seed, rate, place=place), d[at])
        assert torch.equal(fd.dropout_add_layernorm(ps, pr, w, b, seed, rate, place=place), y[at])
        pds, pdr, _, _ = fd.dropout_add_layernorm_bwd(ps, pr, pdy, w, seed, rate, place=place)
        assert torch.equal(pds, ds[at]) and torch.equal(pdr, dr[at])
