"""Torch port, the work partitions of the wide forms of kernels 1 and 13
(d_head past 256), restated in torch and held to the plain twins on the CPU.

Both kernels run only on the card. Their index algebra is restated here in
f32 and held to ``flash_rel_attention_plain`` and
``decode_attn_cached_plain``:

  * kernel 1 (``csrc/flash_rel_attn_wide.cu``,
    ``cl::wide_fwd_tc_cluster_kernel``): one cluster per 64-row query tile
    and (b, h), CTA r owning d_head columns 128 r .. 128 r + 127. Per key
    tile CTA r computes its partial score over its own columns, S_r =
    Q_r K_r^T plus the band Q_r E_band,r^T (band row v at distance
    q0 - k0 + 64 - v, zero where negative or past the table) skewed into
    Srel_r; the partials are summed in rank order (every CTA the same sum),
    then the masks and the online softmax, and O_r += P V_r for the CTA's
    own columns;
  * kernel 13 (``csrc/decode_attn_stacked.cuh``, the wide instantiations
    in ``csrc/decode_attn_wide.cu``): the cluster of a batch row splits the
    live window blocks of ``bw`` keys, rank r taking blocks r * per ..
    r * per + per - 1; each rank reads every block's maximum and takes the
    prefix max m_j over blocks 0..j, which is the twin's running max at
    block j, so P and its int8 re-quantization are the twin's bit for bit;
    block j's PV is weighted by exp(m_j - m_fin), summed over the rank's
    blocks in order and over the ranks in rank order.
"""

import math

import numpy as np
import pytest
import torch

from midi_emotion_tpu_torch.ops import decode_attention as da
from midi_emotion_tpu_torch.ops import flash_attention as fa

BQ = BK = 64  # kernel 1's tiles
PW = 128      # d_head columns a CTA of kernel 1 owns
B, H, MAX_SEQ = 2, 1, 256


# ---------------------------------------------------------------------------
# kernel 1: the cluster forward
# ---------------------------------------------------------------------------


def _flash_inputs(T, dh, causal):
    rng = np.random.default_rng(dh + T + 7 * causal)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, H, T, dh)).astype(np.float32))
               for _ in range(3))
    e = torch.from_numpy(rng.standard_normal((MAX_SEQ, dh)).astype(np.float32))
    pad = torch.zeros((B, T), dtype=torch.bool)
    if T > 1:
        pad[1, 0] = True  # batch row 1: key 0 pad (causal: query 0 sees no key)
        pad[1, T - T // 4:] = True
    return q, k, v, e, pad


def _tile(x, t0, n, T):
    """Rows t0..t0+n of x [..., T, dh], zero past T (the copies' zero-fill)."""
    out = x.new_zeros((*x.shape[:-2], n, x.shape[-1]))
    m = max(0, min(n, T - t0))
    out[..., :m, :] = x[..., t0:t0 + m, :]
    return out


def _e_band(e, q0, k0):
    """The band of key tile k0 for query tile q0: E chunks kt and kt + 1,
    rows max_seq - 128 - (q0 - 63) + k0 + v (v < 128), row v at distance
    q0 - k0 + 64 - v; rows outside the table land as zeros."""
    rows = MAX_SEQ - (BQ + BK) - (q0 - (BK - 1)) + k0 + torch.arange(BQ + BK)
    ok = (rows >= 0) & (rows < MAX_SEQ)
    return torch.where(ok[:, None], e[rows.clamp(0, MAX_SEQ - 1)], 0.0)


def kernel1_cluster_partition(q, k, v, e, causal, pad):
    """-> (O, lse) by the cluster kernel's partition (see the module note)."""
    T, dh = q.shape[2], q.shape[3]
    n_parts = dh // PW
    c = 1.0 / math.sqrt(dh)
    out = torch.zeros_like(q)
    lse = torch.zeros((B, H, T))
    R = torch.arange(BQ)[:, None]
    j = torch.arange(BK)[None, :]
    skew = (BK - R + j).expand(B, H, BQ, BK)  # row R, key j reads band column 64 - R + j
    for q0 in range(0, T, BQ):
        qs = _tile(q, q0, BQ, T)
        k_end = min(T, q0 + BQ) if causal else T
        m = torch.full((B, H, BQ), -math.inf)
        l = torch.zeros((B, H, BQ))
        oacc = torch.zeros((B, H, BQ, dh))
        for k0 in range(0, k_end, BK):
            ks, vs = _tile(k, k0, BK, T), _tile(v, k0, BK, T)
            band = _e_band(e, q0, k0)
            tot = None
            for r in range(n_parts):  # rank order
                cols = slice(PW * r, PW * r + PW)
                part = qs[..., cols] @ ks[..., cols].transpose(-1, -2) \
                    + (qs[..., cols] @ band[:, cols].T).gather(-1, skew)
                tot = part if tot is None else tot + part
            live = torch.ones((B, BK), dtype=torch.bool)
            live[:, max(0, T - k0):] = False
            live[:, :max(0, min(BK, T - k0))] &= ~pad[:, k0:k0 + BK]
            ok = live[:, None, None, :] & ~(causal & (k0 + j > q0 + R))[None, None]
            sc = torch.where(ok, tot * c, -math.inf)
            m_new = torch.maximum(m, sc.amax(-1))
            mu = torch.where(m_new == -math.inf, 0.0, m_new)  # a row with no visible key yet
            alpha = torch.exp(m - mu)
            p = torch.exp(sc - mu[..., None])
            l = l * alpha + p.sum(-1)
            m = m_new
            for r in range(n_parts):  # O_r += P V_r, each rank its own columns
                cols = slice(PW * r, PW * r + PW)
                oacc[..., cols] = oacc[..., cols] * alpha[..., None] + p @ vs[..., cols]
        n = min(BQ, T - q0)
        any_ = l > 0
        inv = torch.where(any_, 1.0 / torch.where(any_, l, 1.0), 0.0)
        out[:, :, q0:q0 + n] = (oacc * inv[..., None])[:, :, :n]
        lse[:, :, q0:q0 + n] = torch.where(any_, m + torch.log(torch.where(any_, l, 1.0)),
                                           1e30)[:, :, :n]
    return out, lse


@pytest.mark.parametrize("dh", [384, 768, 1152])
@pytest.mark.parametrize("T,causal", [(130, True), (130, False), (1, True), (65, True)],
                         ids=["T130-causal", "T130-noncausal", "T1", "T65"])
def test_kernel1_cluster_partition_matches_twin(dh, T, causal):
    """3, 6 and 9 parts (9: a non-portable cluster size on the card)."""
    q, k, v, e, pad = _flash_inputs(T, dh, causal)
    o, lse = kernel1_cluster_partition(q, k, v, e, causal, pad)
    ro, rlse = fa.flash_rel_attention_plain(q, k, v, e, causal, pad)
    torch.testing.assert_close(o, ro, rtol=1e-6, atol=1e-6 * (1 + ro.abs().max().item()))
    torch.testing.assert_close(lse, rlse, rtol=1e-6, atol=1e-6)
    if causal and T > 1:  # the fully masked row: O = 0, lse = 1e30
        assert o[1, :, 0].eq(0).all() and lse[1, :, 0].eq(1e30).all()


# ---------------------------------------------------------------------------
# kernel 13: the window blocks split over a cluster's ranks
# ---------------------------------------------------------------------------

W, L = 1408, 1
LENGTHS = [0, 1, 129, 700, 1216, 1400]
RANKS = [1, 2, 3, 5, 8]


def _decode_inputs(Hd, dh, quant, seed):
    rng = np.random.default_rng(seed)
    rows = torch.from_numpy(rng.standard_normal((L, B, W, 2 * Hd * dh)).astype(np.float32))
    kv, sc = da.quantize_rows(rows, 2 * Hd) if quant else (rows.bfloat16(), None)
    q = torch.from_numpy(rng.standard_normal((B, Hd, dh)).astype(np.float32))
    e = torch.from_numpy(rng.standard_normal((2048, dh)).astype(np.float32))
    return kv, sc, q, e


def _block_logits(q, kv, sc, e_rows, length, j0, bw):
    """Block j0's logits [B, H, bw] (dead keys -1e30) and V [B, H, bw, dh],
    with the value scales (int8): the twin's arithmetic."""
    Bq, Hd, dh = q.shape
    D = Hd * dh
    c = 1.0 / math.sqrt(dh)
    qh = q.to(torch.bfloat16).float()
    blk = kv[0, :, j0:j0 + bw]
    k, v = da._heads(blk[..., :D], Hd), da._heads(blk[..., D:], Hd)
    if sc is not None:
        q8, sq = da.quantize_q(q)
        ks = sc[0, :, :Hd, j0:j0 + bw].float()
        vs = sc[0, :, Hd:, j0:j0 + bw].float()
        scores = (q8.float()[:, :, None, :] @ k.transpose(-1, -2))[:, :, 0] * sq[..., None] * ks
    else:
        vs = None
        scores = (qh[:, :, None, :] @ k.transpose(-1, -2))[:, :, 0]
    bias = qh @ e_rows[j0:j0 + bw].float().T
    live = torch.arange(j0, j0 + bw) < length
    return torch.where(live, (scores + bias) * c, da.NEG), live, v, vs


def _pv(p, v, vs):
    """(block's PV [B, H, dh], its int8 P codes or None)."""
    if vs is None:
        return (p.to(torch.bfloat16).float()[:, :, None, :] @ v)[:, :, 0], None
    pv = p * vs
    s_p = pv.amax(-1) / 127.0 + 1e-20
    p8 = torch.round(pv / s_p[..., None])
    return (p8[:, :, None, :] @ v)[:, :, 0] * s_p[..., None], p8


def twin_codes(q, kv, sc, e_rows, length):
    """The twin's running-max walk, block by block: its int8 P codes."""
    bw = da.window_block(W)
    m = torch.full(q.shape[:2], da.NEG)
    codes = []
    for j0 in range(0, length, bw):
        logits, live, v, vs = _block_logits(q, kv, sc, e_rows, length, j0, bw)
        m = torch.maximum(m, logits.amax(-1))
        codes.append(_pv(torch.where(live, torch.exp(logits - m[..., None]), 0.0), v, vs)[1])
    return codes


def kernel13_partition(q, kv, sc, e_rows, length, n_cta):
    """-> (acc [B, H * dh], m, l, int8 P codes by block) by the cluster
    split of ``n_cta`` ranks (fewer when the blocks run out)."""
    Bq, Hd, dh = q.shape
    bw = da.window_block(W)
    nblk = -(-length // bw)
    per = -(-nblk // n_cta) if nblk else 1
    blocks = [_block_logits(q, kv, sc, e_rows, length, jj * bw, bw) for jj in range(nblk)]
    bmax = [lg.amax(-1) for lg, _, _, _ in blocks]  # every rank's block maxima
    m_fin = torch.full((Bq, Hd), da.NEG)
    for x in bmax:
        m_fin = torch.maximum(m_fin, x)
    acc = torch.zeros((Bq, Hd, dh))
    l = torch.zeros((Bq, Hd))
    codes = [None] * nblk
    for rank in range(-(-nblk // per) if nblk else 0):  # rank order
        acc_r, l_r = torch.zeros((Bq, Hd, dh)), torch.zeros((Bq, Hd))
        for jj in range(rank * per, min(nblk, rank * per + per)):
            m_j = torch.full((Bq, Hd), da.NEG)  # the prefix max over blocks 0..jj
            for x in bmax[:jj + 1]:
                m_j = torch.maximum(m_j, x)
            logits, live, v, vs = blocks[jj]
            p = torch.where(live, torch.exp(logits - m_j[..., None]), 0.0)
            w_j = torch.exp(m_j - m_fin)
            res, codes[jj] = _pv(p, v, vs)
            acc_r = acc_r + res * w_j[..., None]
            l_r = l_r + p.sum(-1) * w_j
        acc, l = acc + acc_r, l + l_r
    return acc.reshape(Bq, Hd * dh), m_fin, l, codes


@pytest.mark.parametrize("Hd,dh", [(2, 384), (1, 768)], ids=["dh384", "dh768"])
@pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16"])
def test_kernel13_cluster_partition_matches_twin(Hd, dh, quant):
    """Every split of 1 to 8 ranks at every length: m exactly, the
    normalized output and l to f32 summation order (the twin rescales its
    running sums by exp(m_old - m_new) block by block, the split weights
    each block once by exp(m_j - m_fin)), and (int8) the P codes of every
    block bit for bit the twin's."""
    kv, sc, q, e = _decode_inputs(Hd, dh, quant, seed=dh + quant)
    for length in LENGTHS:
        e_rows = da.expand_e_rows(e, length + 1, W)
        racc, rm, rl = da.decode_attn_cached_plain(q, kv, sc, 0, e_rows, length)
        want_codes = twin_codes(q, kv, sc, e_rows, length)
        for n_cta in RANKS:
            acc, m, l, codes = kernel13_partition(q, kv, sc, e_rows, length, n_cta)
            assert torch.equal(m, rm), (length, n_cta)
            if length == 0:
                assert (l == 0).all() and (acc == 0).all()
                continue
            torch.testing.assert_close(l, rl, rtol=1e-5, atol=0, msg=f"l at {length}/{n_cta}")
            norm = lambda a, d: a.view(B, Hd, dh) / d[..., None]  # noqa: E731
            want = norm(racc, rl)
            torch.testing.assert_close(norm(acc, l), want, rtol=1e-5,
                                       atol=1e-5 * want.abs().max().item(),
                                       msg=f"acc at {length}/{n_cta}")
            if quant:
                assert len(codes) == len(want_codes)
                for jj, (a, b) in enumerate(zip(codes, want_codes)):
                    assert torch.equal(a, b), (length, n_cta, jj)
