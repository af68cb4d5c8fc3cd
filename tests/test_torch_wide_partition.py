"""Torch port, the work partitions of the wide forms of kernels 1, 4 and 13
(d_head past 256), restated in torch and held to the plain twins on the CPU.

The kernels run only on the card. Their index algebra is restated here in
f32 and held to ``flash_rel_attention_plain``,
``flash_rel_attention_bwd_plain`` (and, at one shape, the JAX package's
merged Pallas backward) and ``decode_attn_cached_plain``:

  * kernel 1 (``csrc/flash_rel_attn_wide.cu``,
    ``cl::wide_fwd_tc_cluster_kernel``): one cluster per 64-row query tile
    and (b, h), CTA r owning d_head columns 128 r .. 128 r + 127. Per key
    tile CTA r computes its partial score over its own columns, S_r =
    Q_r K_r^T plus the band Q_r E_band,r^T (band row v at distance
    q0 - k0 + 64 - v, zero where negative or past the table) skewed into
    Srel_r; the partials are summed in rank order (every CTA the same sum),
    then the masks and the online softmax, and O_r += P V_r for the CTA's
    own columns;
  * kernel 4 (``csrc/flash_rel_attn_wide.cu``,
    ``cl::wide_bwd_tc_cluster_kernel``): one cluster per (b, h) and split
    s of S, sweeping key tiles s, s + S, ... and inside the query tiles
    that see them, CTA r owning d_head columns 128 r .. 128 r + 127. Per
    tile pair CTA r computes S_r + Srel_r and dP_r over its own columns;
    both are summed in rank order, so every CTA has the same P and dS';
    then its own columns: dV_r += P^T dO_r, dK_r += dS'^T Q_r, dQ_r =
    dS' K_r + dsd E_band,r added to split s's f32 partial rows, and dE by
    distance: dsd (dS' at band column 64 - i + j, zero for a negative
    distance) gives dsd^T Q_r, whose band rows 64.. finish the distance
    block the query tile closes (with the block carried from the previous
    query tile) and whose rows ..63 are carried to the next; the splits'
    partials are summed in split order (dQ: causal, split s from query
    tile s on; dE: distances up to 64 (tiles - s));
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
# kernel 4: the cluster backward
# ---------------------------------------------------------------------------


def _band_dist(q0, k0):
    """[128] distance of each band row of pair (q0, k0): q0 - k0 + 64 - v."""
    return q0 - k0 + BK - torch.arange(BQ + BK)


def kernel4_cluster_partition(q, k, v, e, causal, pad, lse, dsum, do, nsplit):
    """-> (dq, dk, dv, de) by the cluster backward's partition (see the
    module note), ``nsplit`` clusters a (b, h)."""
    T, dh = q.shape[2], q.shape[3]
    n_parts, n_tiles = dh // PW, -(-T // BK)
    c = 1.0 / math.sqrt(dh)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    dq_part = torch.zeros((nsplit, B, H, T, dh))
    de_part = torch.zeros((nsplit, B, H, T, dh))  # row = distance
    R = torch.arange(BQ)[:, None]
    j = torch.arange(BK)[None, :]
    skew = (BK - R + j).expand(B, H, BQ, BK)  # row R, key j: band column 64 - R + j
    cols = [slice(PW * r, PW * r + PW) for r in range(n_parts)]

    def part_rows(part, sp, rows, blk, first):
        """blk's rows into part[sp] at ``rows`` (those in [0, T)): stored
        in the split's first key tile, added after."""
        ok = (rows >= 0) & (rows < T)
        idx = rows[ok]
        part[sp][..., idx, :] = blk[..., ok, :] + (0 if first else part[sp][..., idx, :])

    for sp in range(nsplit):
        for kt in range(sp, n_tiles, nsplit):
            k0 = kt * BK
            first = kt == sp
            ks, vs = _tile(k, k0, BK, T), _tile(v, k0, BK, T)
            live = torch.ones((B, BK), dtype=torch.bool)
            live[:, max(0, T - k0):] = False
            live[:, :max(0, min(BK, T - k0))] &= ~pad[:, k0:k0 + BK]
            dk_t, dv_t = torch.zeros((B, H, BK, dh)), torch.zeros((B, H, BK, dh))
            carried = torch.zeros((B, H, BK, dh))  # band rows 0..63 of the last query tile
            for qt in range(kt if causal else 0, n_tiles):
                q0 = qt * BQ
                qs, dos = _tile(q, q0, BQ, T), _tile(do, q0, BQ, T)
                band = _e_band(e, q0, k0)
                s_tot = dp_tot = None
                for r in range(n_parts):  # rank order
                    s_r = qs[..., cols[r]] @ ks[..., cols[r]].transpose(-1, -2) \
                        + (qs[..., cols[r]] @ band[:, cols[r]].T).gather(-1, skew)
                    dp_r = dos[..., cols[r]] @ vs[..., cols[r]].transpose(-1, -2)
                    s_tot = s_r if s_tot is None else s_tot + s_r
                    dp_tot = dp_r if dp_tot is None else dp_tot + dp_r
                i = q0 + R
                ok = (live[:, None, None, :] & (i < T)[None, None]
                      & ~(causal & (k0 + j > i))[None, None])
                rows = torch.arange(q0, q0 + BQ).clamp(max=T - 1)
                lse_t = torch.where(i[:, 0] < T, lse[..., rows], 0.0)
                dsum_t = torch.where(i[:, 0] < T, dsum[..., rows], 0.0)
                p = torch.where(ok, torch.exp(s_tot * c - lse_t[..., None]), 0.0)
                ds = p * (dp_tot - dsum_t[..., None]) * c
                # dS' by distance: dsd[i, 64 - i + j] = dS'[i, j] where i - j >= 0
                dsd = torch.zeros((B, H, BQ, BQ + BK))
                dsd.scatter_(-1, skew, torch.where(q0 + R - (k0 + j) >= 0, ds, 0.0))
                dq_t = torch.zeros((B, H, BQ, dh))
                de_lo = torch.zeros((B, H, BK, dh))
                de_hi = torch.zeros((B, H, BK, dh))
                for r in range(n_parts):  # each CTA its own columns
                    cr = cols[r]
                    dv_t[..., cr] += p.transpose(-1, -2) @ dos[..., cr]
                    dk_t[..., cr] += ds.transpose(-1, -2) @ qs[..., cr]
                    dq_t[..., cr] = ds @ ks[..., cr] + dsd @ band[:, cr]
                    de_band = dsd.transpose(-1, -2) @ qs[..., cr]
                    de_lo[..., cr] = carried[..., cr] + de_band[..., BK:, :]
                    de_hi[..., cr] = de_band[..., :BK, :]
                part_rows(dq_part, sp, torch.arange(q0, q0 + BQ), dq_t, first)
                part_rows(de_part, sp, _band_dist(q0, k0)[BK:], de_lo, first)
                carried = de_hi
            part_rows(de_part, sp, _band_dist(n_tiles * BQ, k0)[BK:], carried, first)
            n = min(BK, T - k0)
            dk[:, :, k0:k0 + n] = dk_t[:, :, :n]
            dv[:, :, k0:k0 + n] = dv_t[:, :, :n]
    dq = torch.zeros_like(q)
    for i in range(T):  # split order; causal: split s from query tile s on
        for sp in range(nsplit):
            if not (causal and sp > i // BQ):
                dq[:, :, i] += dq_part[sp][:, :, i]
    de = torch.zeros_like(e)
    for d in range(T):  # by split, then (b, h)
        for sp in range(nsplit):
            if d <= BK * (n_tiles - sp):
                for bb in range(B):
                    for hh in range(H):
                        de[e.shape[0] - 1 - d] += de_part[sp, bb, hh, d]
    return dq, dk, dv, de


def _bwd_inputs(T, dh, causal, masked_row=True):
    """Kernel 1's inputs, a cotangent and the forward's (O, lse); without
    ``masked_row``, the pad tail alone (no query row sees only pad keys)."""
    q, k, v, e, pad = _flash_inputs(T, dh, causal)
    if not masked_row:
        pad[1, 0] = False
    rng = np.random.default_rng(dh + T + 11)
    do = torch.from_numpy(rng.standard_normal((B, H, T, dh)).astype(np.float32))
    o, lse = fa.flash_rel_attention_plain(q, k, v, e, causal, pad)
    return q, k, v, e, pad, o, lse, do


@pytest.mark.parametrize("dh", [384, 768, 1152])
@pytest.mark.parametrize("T,causal", [(130, True), (130, False), (1, True), (65, True)],
                         ids=["T130-causal", "T130-noncausal", "T1", "T65"])
def test_kernel4_cluster_partition_matches_twin(dh, T, causal):
    """3, 6 and 9 parts, two splits where there are two key tiles: dQ, dK,
    dV and dE within 1e-5 of (1 + each gradient's scale) of the merged
    twin's; the fully masked row's gradients 0."""
    q, k, v, e, pad, o, lse, do = _bwd_inputs(T, dh, causal)
    dsum = (do * o).sum(-1)
    nsplit = 2 if T > BK else 1
    got = kernel4_cluster_partition(q, k, v, e, causal, pad, lse, dsum, do, nsplit)
    want = fa.flash_rel_attention_bwd_plain(q, k, v, e, causal, pad, o, lse, do)
    for name, a, b in zip(("dq", "dk", "dv", "de"), got, want):
        scale = b.abs().max().item()
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * (1 + scale), msg=name)
    if causal and T > 1:
        assert got[0][1, :, 0].eq(0).all()


def test_kernel4_cluster_partition_matches_pallas():
    """At d_head 384, T 70 (two key tiles, two splits), causal with a pad
    tail: the partition against the JAX package's merged Pallas backward
    (``_bwd_merged_kernel``, through the generic interpreter as
    ``test_torch_wide_heads.py`` runs it), 1e-4 as there. No row sees only
    pad keys: the Pallas kernels mask with a finite -1e30, so such a row
    does not get the zero gradients of the documented contract, which the
    port keeps."""
    import conftest  # noqa: F401 -- pins JAX to the CPU

    import jax
    import jax.numpy as jnp
    from midi_emotion_tpu.ops import pallas_attention
    from torch_parity import generic_interpret

    T, dh = 70, 384
    q, k, v, e, pad, _, _, do = _bwd_inputs(T, dh, True, masked_row=False)
    with generic_interpret():
        o, vjp = jax.vjp(
            lambda *x: pallas_attention.flash_relative_attention(*x, True, jnp.asarray(pad.numpy())),
            *(jnp.asarray(t.numpy()) for t in (q, k, v, e)))
        want = vjp(jnp.asarray(do.numpy()))
    o = torch.from_numpy(np.array(o))
    _, lse = fa.flash_rel_attention_plain(q, k, v, e, True, pad)
    dsum = (do * o).sum(-1)
    got = kernel4_cluster_partition(q, k, v, e, True, pad, lse, dsum, do, 2)
    for name, a, b in zip(("dq", "dk", "dv", "de"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4, err_msg=name)


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
