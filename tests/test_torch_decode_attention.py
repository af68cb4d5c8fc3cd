"""Torch port, stacked-cache decode attention (``ops/decode_attention.py``):
the cache helpers and the kernel's plain twin against the JAX package, the
Pallas kernel run in interpret mode as tests/test_decode_attention.py runs
it. Inputs come from numpy with a seed and go through both packages.

Tolerances: quantize_rows, expand_e_rows and flush_pend are held bit for
bit, and so is the stage slot the kernel writes. m and l are f32 sums of
the same terms in other orders (rtol 1e-5). The outputs may differ by a
flip of one P re-quantization unit (about max|V|/127 of a head's output)
when the f32 score sums round differently: int8 within 1e-2 of max|V|,
bf16 (one bf16 ulp of the output) within 4e-3 of max|V|. On this seed the
two agree to ~1e-5 of max|V|."""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401 -- pins JAX to the CPU
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from midi_emotion_tpu.ops import decode_attention as jda
from midi_emotion_tpu_torch.ops import decode_attention as tda

B, W, H, DH, MS, L, S = 3, 256, 4, 48, 512, 2, 4  # tests/test_decode_attention.py::_setup
D = H * DH
LAYER = 1


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if x.dtype == jnp.bfloat16 \
        else np.asarray(x)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        kv=rng.standard_normal((L, B, W, 2 * D)).astype(np.float32),
        q=rng.standard_normal((B, H, DH)).astype(np.float32),
        e=rng.standard_normal((MS, DH)).astype(np.float32),
        pend=rng.standard_normal((S, L, B, 2 * D)).astype(np.float32),
        row=rng.standard_normal((B, 2 * D)).astype(np.float32),
    )


@pytest.mark.parametrize("shape,groups", [((2, 7, 96), 4), ((L, B, 9, 2 * D), 2 * H)])
def test_quantize_rows_bit_equal(shape, groups):
    t = np.random.default_rng(1).standard_normal(shape).astype(np.float32) * 3
    t[..., 0, :5] = 0.0  # an all-zero group prefix and exact ties at the edge
    jq, js = jda.quantize_rows(jnp.asarray(t), groups)
    tq, ts = tda.quantize_rows(torch.from_numpy(t), groups)
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.float().numpy(), _np(js))


@pytest.mark.parametrize("n", [1, 100, 257, MS, MS + 40])  # n > max_seq clamps
def test_expand_e_rows_equal(n):
    e = _inputs()["e"]
    want = jda.expand_e_rows(jnp.asarray(e), jnp.asarray(n, jnp.int32), W)
    got = tda.expand_e_rows(torch.from_numpy(e), n, W)
    assert got.shape == (W, DH) and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), _np(want))


def test_merge_self_matches():
    rng = np.random.default_rng(2)
    acc = rng.standard_normal((B, D)).astype(np.float32) * 5
    m = rng.standard_normal((B, H)).astype(np.float32)
    l = rng.uniform(1, 9, (B, H)).astype(np.float32)
    l[0] = 0.0  # nothing cached: the self term alone
    m[0] = -1e30
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((B, H, DH), (B, D), (B, D)))
    e_last = rng.standard_normal(DH).astype(np.float32)
    want = jda.merge_self(*(jnp.asarray(x) for x in (acc, m, l, q, k, v, e_last)))
    got = tda.merge_self(*(torch.from_numpy(x) for x in (acc, m, l, q, k, v, e_last)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[0].numpy(), v[0])


@pytest.mark.parametrize("quant", [True, False])
def test_flush_pend_places_rows(quant):
    x = _inputs()
    f = 37
    pend = jnp.asarray(x["pend"]).astype(jnp.bfloat16)
    tpend = torch.from_numpy(x["pend"]).bfloat16()
    if quant:
        jkv, jsc = jnp.full((L, B, W, 2 * D), 7, jnp.int8), jnp.full((L, B, 2 * H, W), 3.0,
                                                                      jnp.bfloat16)
        tkv = torch.full((L, B, W, 2 * D), 7, dtype=torch.int8)
        tsc = torch.full((L, B, 2 * H, W), 3.0, dtype=torch.bfloat16)
    else:
        jkv, jsc = jnp.full((L, B, W, 2 * D), 9.0, jnp.bfloat16), None
        tkv, tsc = torch.full((L, B, W, 2 * D), 9.0, dtype=torch.bfloat16), None
    jkv, jsc = jda.flush_pend(jkv, jsc, pend, jnp.asarray(f, jnp.int32), H)
    kv_out, sc_out = tda.flush_pend(tkv, tsc, tpend, f, H)
    assert kv_out is tkv and sc_out is tsc  # in place
    np.testing.assert_array_equal(tkv.float().numpy(), _np(jkv).astype(np.float32))
    if quant:
        np.testing.assert_array_equal(tsc.float().numpy(), _np(jsc))
    with pytest.raises(ValueError, match="overrun"):
        tda.flush_pend(tkv, tsc, tpend, W - S + 1, H)


@pytest.mark.parametrize("p_cnt", [None, 0, S - 1, S])  # None: unstaged; S: the clamp
@pytest.mark.parametrize("length", [0, 100, 129])
@pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16"])
def test_twin_matches_pallas_kernel(quant, length, p_cnt):
    x = _inputs()
    if quant:
        jkv, jsc = jda.quantize_rows(jnp.asarray(x["kv"]), 2 * H)
        tkv, tsc = tda.quantize_rows(torch.from_numpy(x["kv"]), 2 * H)
    else:
        jkv, jsc = jnp.asarray(x["kv"]).astype(jnp.bfloat16), None
        tkv, tsc = torch.from_numpy(x["kv"]).bfloat16(), None
    vmax = np.abs(x["kv"][..., D:]).max()
    tol = (1e-2 if quant else 4e-3) * vmax
    q, e = x["q"], x["e"]
    n = length + (p_cnt or 0)
    je = jda.expand_e_rows(jnp.asarray(e), jnp.asarray(n + 1, jnp.int32), W)
    te = tda.expand_e_rows(torch.from_numpy(e), n + 1, W)
    if p_cnt is None:
        with pltpu.force_tpu_interpret_mode():
            jacc, jm, jl = (np.asarray(a) for a in jda.decode_attn_cached(
                jnp.asarray(q), jkv, jsc, jnp.asarray(LAYER), je, jnp.asarray(length, jnp.int32)))
        acc, m, l = (a.numpy() for a in tda.decode_attn_cached(
            torch.from_numpy(q), tkv, tsc, LAYER, te, length))
        np.testing.assert_allclose(m, jm, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(l, jl, rtol=1e-5, atol=1e-5)
        if length == 0:  # nothing cached: the fully masked triple
            assert (m == -1e30).all() and (l == 0).all() and (acc == 0).all()
            return
        norm = lambda a, d: a.reshape(B, H, DH) / d[..., None]  # noqa: E731
        np.testing.assert_allclose(norm(acc, l), norm(jacc, jl), rtol=0, atol=tol)
        return
    jep = jda.expand_e_rows(jnp.asarray(e), jnp.asarray(p_cnt + 1, jnp.int32), S + 1)
    tep = tda.expand_e_rows(torch.from_numpy(e), p_cnt + 1, S + 1)
    row = torch.from_numpy(x["row"]).bfloat16()
    tpend = torch.from_numpy(x["pend"]).bfloat16()
    with pltpu.force_tpu_interpret_mode():
        jout, jpend = jda.decode_attn_cached(
            jnp.asarray(q), jkv, jsc, jnp.asarray(LAYER), je, jnp.asarray(length, jnp.int32),
            jnp.asarray(x["pend"]).astype(jnp.bfloat16), jep, jnp.asarray(p_cnt, jnp.int32),
            jnp.asarray(x["row"]).astype(jnp.bfloat16))
    out, pend = tda.decode_attn_cached(torch.from_numpy(q), tkv, tsc, LAYER, te, length,
                                       tpend, tep, p_cnt, row)
    assert out.dtype == torch.bfloat16 and pend is tpend  # the stage is written in place
    np.testing.assert_allclose(out.float().numpy(), _np(jout), rtol=0, atol=tol)
    np.testing.assert_array_equal(pend.float().numpy(), _np(jpend))
    np.testing.assert_array_equal(pend[min(p_cnt, S - 1), LAYER].float().numpy(),
                                  row.float().numpy())


def test_wrapper_refuses_other_devices_and_bad_stage():
    x = _inputs()
    q = torch.from_numpy(x["q"])
    kv, sc = tda.quantize_rows(torch.from_numpy(x["kv"]), 2 * H)
    e_rows = tda.expand_e_rows(torch.from_numpy(x["e"]), 1, W)
    with pytest.raises(ValueError, match="device"):
        tda.decode_attn_cached(q.to("meta"), kv, sc, 0, e_rows, 0)
    pend = torch.zeros((S, L, B, 2 * D), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="e_pend"):
        tda.decode_attn_cached(q, kv, sc, 0, e_rows, 0, pend, e_rows[:S], 0, pend[0, 0])
    with pytest.raises(ValueError, match="row_t"):
        tda.decode_attn_cached(q, kv, sc, 0, e_rows, 0, pend, e_rows[:S + 1], 0, None)
