"""Torch port, stacked-cache decode attention (``ops/decode_attention.py``):
the cache helpers and the kernel's plain twin against the JAX package, the
Pallas kernel run through its own CPU path (``interpret=True``, which it
picks on the CPU backend; the threaded TPU interpreter is not forced: under
a loaded multi-worker run it has hung). Inputs come from numpy with a seed
and go through both packages.

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

from midi_emotion_tpu.ops import decode_attention as jda
from midi_emotion_tpu_torch.ops import decode_attention as tda

B, W, H, DH, MS, L, S = 3, 256, 4, 48, 512, 2, 4  # tests/test_decode_attention.py::_setup
D = H * DH
LAYER = 1


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if x.dtype == jnp.bfloat16 \
        else np.asarray(x)


def _inputs(seed=0, dims=(B, W, H, DH, S)):
    b, w, h, dh, s = dims
    rng = np.random.default_rng(seed)
    return dict(
        kv=rng.standard_normal((L, b, w, 2 * h * dh)).astype(np.float32),
        q=rng.standard_normal((b, h, dh)).astype(np.float32),
        e=rng.standard_normal((MS, dh)).astype(np.float32),
        pend=rng.standard_normal((s, L, b, 2 * h * dh)).astype(np.float32),
        row=rng.standard_normal((b, 2 * h * dh)).astype(np.float32),
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


def _twin_vs_pallas(x, dims, quant, length, p_cnt):
    """Kernel 13's twin against the Pallas kernel on the inputs ``x`` of
    ``_inputs(dims=dims)``, unstaged (``p_cnt`` None) or staged. The port's
    cache, stage, row and E rows are laid out at ``cache_dh(dh)`` columns a
    head, as the port's model lays them out; the JAX package's at dh."""
    b, w, h, dh, s = dims
    d = h * dh
    dh_k = tda.cache_dh(dh)
    pad = lambda t: tda.pad_groups(torch.from_numpy(t), 2 * h, dh_k)  # noqa: E731
    if quant:
        jkv, jsc = jda.quantize_rows(jnp.asarray(x["kv"]), 2 * h)
        tkv, tsc = tda.quantize_rows(pad(x["kv"]), 2 * h)
    else:
        jkv, jsc = jnp.asarray(x["kv"]).astype(jnp.bfloat16), None
        tkv, tsc = pad(x["kv"]).bfloat16(), None
    vmax = np.abs(x["kv"][..., d:]).max()
    tol = (1e-2 if quant else 4e-3) * vmax
    q, e = x["q"], x["e"]
    n = length + (p_cnt or 0)
    je = jda.expand_e_rows(jnp.asarray(e), jnp.asarray(n + 1, jnp.int32), w)
    te = tda.expand_e_rows(torch.from_numpy(e), n + 1, w, dh_to=dh_k)
    if p_cnt is None:
        jacc, jm, jl = (np.asarray(a) for a in jda.decode_attn_cached(
            jnp.asarray(q), jkv, jsc, jnp.asarray(LAYER), je, jnp.asarray(length, jnp.int32)))
        acc, m, l = (a.numpy() for a in tda.decode_attn_cached(
            torch.from_numpy(q), tkv, tsc, LAYER, te, length))
        np.testing.assert_allclose(m, jm, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(l, jl, rtol=1e-5, atol=1e-5)
        if length == 0:  # nothing cached: the fully masked triple
            assert (m == -1e30).all() and (l == 0).all() and (acc == 0).all()
            return
        norm = lambda a, den: a.reshape(b, h, dh) / den[..., None]  # noqa: E731
        np.testing.assert_allclose(norm(acc, l), norm(jacc, jl), rtol=0, atol=tol)
        return
    jep = jda.expand_e_rows(jnp.asarray(e), jnp.asarray(p_cnt + 1, jnp.int32), s + 1)
    tep = tda.expand_e_rows(torch.from_numpy(e), p_cnt + 1, s + 1, dh_to=dh_k)
    row = pad(x["row"]).bfloat16()
    tpend = pad(x["pend"]).bfloat16()
    jout, jpend = jda.decode_attn_cached(
        jnp.asarray(q), jkv, jsc, jnp.asarray(LAYER), je, jnp.asarray(length, jnp.int32),
        jnp.asarray(x["pend"]).astype(jnp.bfloat16), jep, jnp.asarray(p_cnt, jnp.int32),
        jnp.asarray(x["row"]).astype(jnp.bfloat16))
    out, pend = tda.decode_attn_cached(torch.from_numpy(q), tkv, tsc, LAYER, te, length,
                                       tpend, tep, p_cnt, row)
    assert out.dtype == torch.bfloat16 and pend is tpend  # the stage is written in place
    np.testing.assert_allclose(out.float().numpy(), _np(jout), rtol=0, atol=tol)
    unpad = lambda t: t.unflatten(-1, (2 * h, dh_k))[..., :dh].flatten(-2)  # noqa: E731
    np.testing.assert_array_equal(unpad(pend).float().numpy(), _np(jpend))
    np.testing.assert_array_equal(pend[min(p_cnt, s - 1), LAYER].float().numpy(),
                                  row.float().numpy())


@pytest.mark.parametrize("p_cnt", [None, 0, S - 1, S])  # None: unstaged; S: the clamp
@pytest.mark.parametrize("length", [0, 100, 129])
@pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16"])
def test_twin_matches_pallas_kernel(quant, length, p_cnt):
    _twin_vs_pallas(_inputs(), (B, W, H, DH, S), quant, length, p_cnt)


@pytest.mark.parametrize("heads,dh", [(2, 96), (2, 128), (10, 128), (3, 256), (2, 192), (2, 160)],
                         ids=["dh96", "dh128", "D1280", "dh256", "dh192", "dh160"])
@pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16"])
def test_twin_matches_pallas_kernel_wide_heads(quant, heads, dh):
    """The head shapes past the flagship's (d_head 96, 128, 192 and 256, 160
    laid out at 192, and a width of 1280 that the kernel runs as head
    groups) at one length, unstaged and staged, with
    test_twin_matches_pallas_kernel's tolerances."""
    dims = (2, 128, heads, dh, 4)
    x = _inputs(dh + heads, dims)
    for p_cnt in (None, 2):
        _twin_vs_pallas(x, dims, quant, 100, p_cnt)


@pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16"])
def test_twin_matches_pallas_kernel_padded_heads(quant):
    """d_head 40, which the decode kernel is not built for: the port's cache
    holds each head at 48 columns, zero past 40, and the twin scales by
    1/sqrt(40); against the Pallas kernel on the 40-column cache, unstaged
    and staged, with test_twin_matches_pallas_kernel's tolerances."""
    dims = (2, 128, 4, 40, 4)
    x = _inputs(44, dims)
    for p_cnt in (None, 2):
        _twin_vs_pallas(x, dims, quant, 100, p_cnt)


def test_pad_groups():
    """pad_groups appends zero columns to each channel group and passes a
    tensor already that wide through as itself."""
    x = torch.arange(12.0).reshape(1, 12)
    assert tda.pad_groups(x, 3, 4) is x
    np.testing.assert_array_equal(tda.pad_groups(x, 3, 6).numpy(),
                                  [[0, 1, 2, 3, 0, 0, 4, 5, 6, 7, 0, 0, 8, 9, 10, 11, 0, 0]])


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


# ---- the CUDA kernel's order of work, restated in torch ----------------------
#
# csrc/decode_attn_stacked.cu splits the live window blocks of a batch row
# over a cluster of CTAs: it aims at about one CTA an SM over the batch
# (``want`` = SMs // B, 1 to 8), gives each CTA ceil(n_blocks / want)
# consecutive blocks, takes each block's prefix max m_j from the blocks'
# maxima, re-quantizes P per block from m_j, weighs each block by
# exp(m_j - m_fin) and sums the CTAs' partial (acc, l) in rank order.
# _kernel_order restates that partition for any ``want``; it is held to the
# sequential twin and to the Pallas kernel.

SHAPES = {  # B, W, H, dh, L, max_seq
    "odd": (3, 384, 4, 48, 3, 512),
    "w200-dh16": (2, 200, 2, 16, 2, 512),
    "flagship-width": (2, 1152, 16, 48, 2, 2048),  # 9 blocks: two a CTA
}


def _split(length, bw, want):
    """(n_blocks, blocks per CTA, CTAs) as the kernel's launch picks them
    for a cluster of at most ``want`` CTAs."""
    n_blocks = -(-length // bw)
    per = max(1, -(-n_blocks // want))
    return n_blocks, per, (-(-n_blocks // per) if n_blocks else 1)


def _kernel_order(q_t, kv8, sc, layer, e_rows, length, pend=None, e_pend=None, p_cnt=None,
                  row_t=None, want=8):
    B, H, dh = q_t.shape
    D, W, c = H * dh, kv8.shape[2], 1.0 / np.sqrt(dh)
    quant = sc is not None
    bw = tda.window_block(W)
    n_blocks, per, n_cta = _split(length, bw, want)
    qh = q_t.to(torch.bfloat16).float()
    q8, sq = tda.quantize_q(q_t)
    logits, values, v_scales = [], [], []
    for j in range(n_blocks):
        j0, n = j * bw, min(bw, length - j * bw)
        blk = kv8[layer, :, j0:j0 + n]
        k, v = tda._heads(blk[..., :D], H), tda._heads(blk[..., D:], H)
        if quant:
            ks = sc[layer, :, :H, j0:j0 + n].float()
            scores = (q8.float()[:, :, None, :] @ k.transpose(-1, -2))[:, :, 0] * sq[..., None] * ks
            v_scales.append(sc[layer, :, H:, j0:j0 + n].float())
        else:
            scores = (qh[:, :, None, :] @ k.transpose(-1, -2))[:, :, 0]
        logits.append((scores + qh @ e_rows[j0:j0 + n].float().T) * c)
        values.append(v)
    m_run = torch.full((B, H), tda.NEG)
    m_j = []
    for lg in logits:  # each block's max, then the prefix max over blocks 0..j
        m_run = torch.maximum(m_run, lg.amax(-1))
        m_j.append(m_run)
    m = m_run
    parts = []
    for r in range(n_cta):
        acc, l = torch.zeros((B, H, dh)), torch.zeros((B, H))
        for j in range(r * per, min(r * per + per, n_blocks)):
            p = torch.exp(logits[j] - m_j[j][..., None])
            w = torch.exp(m_j[j] - m)
            if quant:
                pv = p * v_scales[j]
                s_p = pv.amax(-1) / 127.0 + 1e-20
                res = (torch.round(pv / s_p[..., None])[:, :, None, :] @ values[j])[:, :, 0]
                res = res * s_p[..., None]
            else:
                res = (p.to(torch.bfloat16).float()[:, :, None, :] @ values[j])[:, :, 0]
            acc = acc + res * w[..., None]
            l = l + p.sum(-1) * w
        parts.append((acc, l))
    acc, l = parts[0]
    for a, b in parts[1:]:  # rank order, no atomics
        acc, l = acc + a, l + b
    if pend is None:
        return acc.reshape(B, D), m, l
    S = pend.shape[0]
    kp = tda._heads(pend[:p_cnt, layer, :, :D].transpose(0, 1), H)  # [B, H, p_cnt, dh]
    vp = tda._heads(pend[:p_cnt, layer, :, D:].transpose(0, 1), H)
    lg = ((qh[:, :, None, :] @ kp.transpose(-1, -2))[:, :, 0] + qh @ e_pend[:p_cnt].float().T) * c
    m_new = torch.maximum(m, lg.amax(-1)) if p_cnt else m
    alpha = torch.exp(m - m_new)
    pp = torch.exp(lg - m_new[..., None])
    l = l * alpha + pp.sum(-1)
    acc = acc * alpha[..., None] + (pp.to(torch.bfloat16).float()[:, :, None, :] @ vp)[:, :, 0]
    k_row, v_row = tda._heads(row_t[:, None, :D], H)[:, :, 0], tda._heads(row_t[:, None, D:], H)[:, :, 0]
    logit_s = ((qh * k_row).sum(-1) + (qh * e_pend[p_cnt].float()).sum(-1)) * c
    m_fin = torch.maximum(m_new, logit_s)
    a_old, a_new = torch.exp(m_new - m_fin), torch.exp(logit_s - m_fin)
    out = (acc * a_old[..., None] + v_row * a_new[..., None]) / (l * a_old + a_new)[..., None]
    pend[min(p_cnt, S - 1), layer] = row_t
    return out.reshape(B, D).to(torch.bfloat16), pend


def _order_inputs(shape, quant, seed):
    B, W, H, dh, L, ms = SHAPES[shape]
    rng = np.random.default_rng(seed)
    D = H * dh
    kv = rng.standard_normal((L, B, W, 2 * D)).astype(np.float32)
    x = dict(q=rng.standard_normal((B, H, dh)).astype(np.float32),
             e=rng.standard_normal((ms, dh)).astype(np.float32),
             pend=rng.standard_normal((8, L, B, 2 * D)).astype(np.float32),
             row=rng.standard_normal((B, 2 * D)).astype(np.float32),
             vmax=np.abs(kv[..., D:]).max())
    if quant:
        x["jkv"], x["jsc"] = jda.quantize_rows(jnp.asarray(kv), 2 * H)
        x["tkv"], x["tsc"] = tda.quantize_rows(torch.from_numpy(kv), 2 * H)
    else:
        x["jkv"], x["jsc"] = jnp.asarray(kv).astype(jnp.bfloat16), None
        x["tkv"], x["tsc"] = torch.from_numpy(kv).bfloat16(), None
    return x


def _lengths(W):
    """Every window-block boundary 128k and its neighbours, up to W."""
    bw = tda.window_block(W)
    return sorted({n for k in range(W // bw + 1) for n in (k * bw - 1, k * bw, k * bw + 1)
                   if 0 <= n <= W} | {W - 8})


def _close(got, want, quant, vmax, staged):
    """The file's tolerances: m and l to 1e-5; outputs within one P unit
    (int8) or 1e-3 of max|V| (bf16, unstaged) or one bf16 ulp (staged)."""
    if staged:
        tol = (vmax / 127 if quant else 0) + 2 ** -7 * np.abs(want[0]).max()
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=tol)
        return
    acc, m, l = got
    racc, rm, rl = want
    np.testing.assert_allclose(m, rm, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(l, rl, rtol=1e-5, atol=1e-5)
    if (rl > 0).all():
        norm = lambda a, d: a.reshape(*d.shape, -1) / d[..., None]  # noqa: E731
        np.testing.assert_allclose(norm(acc, l), norm(racc, rl), rtol=0,
                                   atol=vmax / 127 if quant else 1e-3 * vmax)
    else:
        assert (m == -1e30).all() and (l == 0).all() and (acc == 0).all()


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16"])
def test_kernel_order_matches_twin(shape, quant):
    """The cluster partition against the sequential twin at every block
    boundary and its neighbours, unstaged and staged (p_cnt 0, 3, 7 and 8
    in turn), the stage written exactly; clusters of at most 8, 2 and 1
    CTAs in turn (the kernel's picks at B <= 16, B 64 and B > 66 on 132
    SMs)."""
    x = _order_inputs(shape, quant, seed=3)
    W = SHAPES[shape][1]
    q, e = torch.from_numpy(x["q"]), torch.from_numpy(x["e"])
    for idx, length in enumerate(_lengths(W)):
        e_rows = tda.expand_e_rows(e, length + 1, W)
        cluster = (8, 2, 1)[idx % 3]
        got = _kernel_order(q, x["tkv"], x["tsc"], 1, e_rows, length, want=cluster)
        want = tda.decode_attn_cached_plain(q, x["tkv"], x["tsc"], 1, e_rows, length)
        _close([a.numpy() for a in got], [a.numpy() for a in want], quant, x["vmax"], False)
        p_cnt = (0, 3, 7, 8)[idx % 4]
        e_pend = tda.expand_e_rows(e, p_cnt + 1, 9)
        row = torch.from_numpy(x["row"]).bfloat16()
        stages = [torch.from_numpy(x["pend"]).bfloat16() for _ in range(2)]
        got = _kernel_order(q, x["tkv"], x["tsc"], 1, e_rows, length, stages[0], e_pend, p_cnt, row,
                            want=cluster)
        want = tda.decode_attn_cached_plain(q, x["tkv"], x["tsc"], 1, e_rows, length, stages[1],
                                            e_pend, p_cnt, row)
        _close([got[0].float().numpy()], [want[0].float().numpy()], quant, x["vmax"], True)
        assert torch.equal(stages[0], stages[1]), (length, p_cnt)


@pytest.mark.parametrize("shape,length,p_cnt,cluster", [("odd", 257, None, 8), ("odd", 383, 7, 2),
                                                         ("w200-dh16", 199, 3, 8),
                                                         ("flagship-width", 1025, None, 2),
                                                         ("flagship-width", 1151, 8, 8)])
@pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16"])
def test_kernel_order_matches_pallas_kernel(shape, length, p_cnt, cluster, quant):
    """The cluster partition against the Pallas kernel in interpret mode,
    at lengths whose last block is ragged, with CTAs of one block and, at
    the flagship width, of two and of five blocks."""
    x = _order_inputs(shape, quant, seed=4)
    W = SHAPES[shape][1]
    n = length + (p_cnt or 0)
    je = jda.expand_e_rows(jnp.asarray(x["e"]), jnp.asarray(n + 1, jnp.int32), W)
    te = tda.expand_e_rows(torch.from_numpy(x["e"]), n + 1, W)
    q = torch.from_numpy(x["q"])
    if p_cnt is None:
        want = [np.asarray(a) for a in jda.decode_attn_cached(
            jnp.asarray(x["q"]), x["jkv"], x["jsc"], jnp.asarray(1), je,
            jnp.asarray(length, jnp.int32))]
        got = [a.numpy() for a in _kernel_order(q, x["tkv"], x["tsc"], 1, te, length,
                                                want=cluster)]
        _close(got, want, quant, x["vmax"], False)
        return
    jep = jda.expand_e_rows(jnp.asarray(x["e"]), jnp.asarray(p_cnt + 1, jnp.int32), 9)
    tep = tda.expand_e_rows(torch.from_numpy(x["e"]), p_cnt + 1, 9)
    jout, jpend = jda.decode_attn_cached(
        jnp.asarray(x["q"]), x["jkv"], x["jsc"], jnp.asarray(1), je,
        jnp.asarray(length, jnp.int32), jnp.asarray(x["pend"]).astype(jnp.bfloat16), jep,
        jnp.asarray(p_cnt, jnp.int32), jnp.asarray(x["row"]).astype(jnp.bfloat16))
    out, pend = _kernel_order(q, x["tkv"], x["tsc"], 1, te, length,
                              torch.from_numpy(x["pend"]).bfloat16(), tep, p_cnt,
                              torch.from_numpy(x["row"]).bfloat16(), want=cluster)
    _close([out.float().numpy()], [_np(jout)], quant, x["vmax"], True)
    np.testing.assert_array_equal(pend.float().numpy(), _np(jpend))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_in_kernel_q_quantization_bit_equal(dtype):
    """The kernel quantizes q itself, one f32 scale per (b, h): sq =
    max|q| / 127 + 1e-20 and q8 = rint(q / sq), half to even, f32 division.
    Restated in numpy, it is bit-equal to quantize_q (the twin's), ties
    included."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((4, 16, 48)).astype(np.float32) * 3
    q[0, 0, :4] = [127.0, 2.5, -3.5, 0.5]  # sq = 1: exact halves round to even
    q[1, 2] = 0.0  # an all-zero head
    qt = torch.from_numpy(q).to(dtype)
    qf = qt.float().numpy()
    sq = np.abs(qf).max(-1) / np.float32(127) + np.float32(1e-20)
    q8 = np.rint(qf / sq[..., None]).astype(np.int8)
    got8, got_sq = tda.quantize_q(qt)
    np.testing.assert_array_equal(got_sq.numpy(), sq)
    np.testing.assert_array_equal(got8.numpy(), q8)
    if dtype == torch.float32:
        assert list(q8[0, 0, :4]) == [127, 2, -4, 0]
