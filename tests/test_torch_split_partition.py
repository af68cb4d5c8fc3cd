"""Torch port, the ``split`` backward's work partitions on the card,
restated in torch and held to the plain twins on the CPU.

The bf16 paths of ``bwd_dkdv_dq`` (``csrc/flash_rel_attn_bwd_kv.cu``,
``tc::flash_bwd_kv_tc_kernel``) and ``bwd_de_dqrel``
(``csrc/flash_rel_attn_bwd_q.cu``, ``tc::flash_bwd_q_tc_kernel<REL>``) run
only on the card. Their index algebra is restated here tile by tile, in
f32, and held to ``bwd_dkdv_dq_plain`` and ``bwd_de_dqrel_plain``:

  * kernel 7: two blocks a (b, h) on alternate 64-key tiles, each sweeping
    the query tiles that see its key tile (causal: from the diagonal on);
    per pair S, the band ``Q E_band^T`` skewed into Srel (band row u at
    distance ``q0 - k0 - 63 + u``), P and dS'; dK and dV per key tile, dQ's
    key term into one f32 partial a block, the partials summed in block
    order;
  * kernel 8: two blocks a (b, h) on alternate 64-row query tiles, each
    sweeping key tiles 0..qt (the relative terms vanish above the diagonal,
    in the non-causal model too); per pair the distance-domain tile
    ``dsd[i, u]``, ``u = i - j + 63``, zero at negative distance; dQ_rel +=
    dsd E_band, and dE by distance into one f32 partial a block, summed in
    block order.
"""

import math

import numpy as np
import pytest
import torch

from midi_emotion_tpu_torch.ops import flash_attention as fa

BQ = BK = 64  # the kernels' tiles
SPLIT = 2     # blocks a (b, h)
B, H, DH, MAX_SEQ = 2, 2, 16, 256


def _inputs(T, causal):
    rng = np.random.default_rng(T + 7 * causal)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, H, T, DH)).astype(np.float32))
                   for _ in range(4))
    e = torch.from_numpy(rng.standard_normal((MAX_SEQ, DH)).astype(np.float32))
    pad = torch.zeros((B, T), dtype=torch.bool)
    pad[1, 0] = True  # batch row 1: key 0 pad (causal: query 0 sees no key)
    pad[1, T - T // 4:] = True
    o, lse = fa.flash_rel_attention_plain(q, k, v, e, causal, pad)
    do = do * (~pad)[:, None, :, None]
    dsum = (do * o).sum(-1)
    return q, k, v, e, pad, lse, dsum, do


def _band(e, dist0):
    """E rows of the band: row u at distance dist0 + u, [BQ + BK, DH], zero
    where the distance is negative or past the table."""
    dist = dist0 + torch.arange(BQ + BK)
    ok = (dist >= 0) & (dist < MAX_SEQ)
    return torch.where(ok[:, None], e[(MAX_SEQ - 1 - dist).clamp(0, MAX_SEQ - 1)], 0.0)


def _tile(x, t0, n, T):
    """Rows t0..t0+n of x [..., T, DH], zero past T (the kernels' zero-fill)."""
    out = x.new_zeros((*x.shape[:-2], n, x.shape[-1]))
    m = max(0, min(n, T - t0))
    out[..., :m, :] = x[..., t0:t0 + m, :]
    return out


def _rows(x, t0, n, T, fill):
    out = x.new_full((*x.shape[:-1], n), fill)
    m = max(0, min(n, T - t0))
    out[..., :m] = x[..., t0:t0 + m]
    return out


def kernel7_partition(q, k, v, e, causal, pad, lse, dsum, do):
    """-> (dk, dv, dq_qk) by kernel 7's partition."""
    T = q.shape[2]
    c = 1.0 / math.sqrt(DH)
    n_tiles = (T + BK - 1) // BK
    n_pad = n_tiles * BK
    dk, dv = q.new_zeros((B, H, n_pad, DH)), q.new_zeros((B, H, n_pad, DH))
    dq_part = q.new_zeros((SPLIT, B, H, n_pad, DH))
    il = torch.arange(BQ)[:, None]
    jl = torch.arange(BK)[None, :]
    for sp in range(SPLIT):
        for kt in range(sp, n_tiles, SPLIT):
            k0 = kt * BK
            ks, vs = _tile(k, k0, BK, T), _tile(v, k0, BK, T)
            live = ~_rows(pad, k0, BK, T, True)  # [B, BK]
            for qt in range(kt if causal else 0, n_tiles):
                q0 = qt * BQ
                qs, dos = _tile(q, q0, BQ, T), _tile(do, q0, BQ, T)
                lse_s, dsum_s = _rows(lse, q0, BQ, T, 1e30), _rows(dsum, q0, BQ, T, 0.0)
                band = qs @ _band(e, q0 - k0 - (BK - 1)).T  # [B, H, BQ, BQ + BK]
                srel = band.gather(-1, (il - jl + BK - 1).expand(B, H, BQ, BK))
                s = qs @ ks.transpose(-1, -2) + srel
                ok = ((q0 + il < T) & ~(causal & (k0 + jl > q0 + il)))[None, None] \
                    & live[:, None, None, :]
                p = torch.where(ok, torch.exp(s * c - lse_s[..., None]), 0.0)
                ds = p * (dos @ vs.transpose(-1, -2) - dsum_s[..., None]) * c
                dv[:, :, k0:k0 + BK] += p.transpose(-1, -2) @ dos
                dk[:, :, k0:k0 + BK] += ds.transpose(-1, -2) @ qs
                dq_part[sp, :, :, q0:q0 + BQ] += ds @ ks
    dq = dq_part[0]
    for sp in range(1, SPLIT):  # block order
        dq = dq + dq_part[sp]
    return dk[:, :, :T], dv[:, :, :T], dq[:, :, :T]


def kernel8_partition(q, k, v, e, causal, pad, lse, dsum, do):
    """-> (dq_rel, de) by kernel 8's partition. ``causal`` does not enter."""
    T = q.shape[2]
    c = 1.0 / math.sqrt(DH)
    n_tiles = (T + BQ - 1) // BQ
    n_pad = n_tiles * BQ
    dq = q.new_zeros((B, H, n_pad, DH))
    de_part = q.new_zeros((SPLIT, B, H, T, DH))  # by distance
    il = torch.arange(BQ)[:, None]
    u = torch.arange(BQ + BK)[None, :]
    jl = il + BK - 1 - u  # the key of (row i, distance column u)
    for sp in range(SPLIT):
        for qt in range(sp, n_tiles, SPLIT):
            q0 = qt * BQ
            qs, dos = _tile(q, q0, BQ, T), _tile(do, q0, BQ, T)
            lse_s, dsum_s = _rows(lse, q0, BQ, T, 1e30), _rows(dsum, q0, BQ, T, 0.0)
            for kt in range(qt + 1):
                k0 = kt * BK
                dist0 = q0 - k0 - (BK - 1)
                ks, vs = _tile(k, k0, BK, T), _tile(v, k0, BK, T)
                live = ~_rows(pad, k0, BK, T, True)  # [B, BK]
                e_band = _band(e, dist0)
                in_tile = (jl >= 0) & (jl < BK)
                j_idx = jl.clamp(0, BK - 1).expand(B, H, BQ, BQ + BK)
                s_d = (qs @ ks.transpose(-1, -2)).gather(-1, j_idx) + qs @ e_band.T
                dp_d = (dos @ vs.transpose(-1, -2)).gather(-1, j_idx)
                ok = (in_tile & (q0 + il < T) & (dist0 + u >= 0))[None, None] \
                    & live[:, None, None, :].expand(B, H, BQ, BK).gather(-1, j_idx)
                p = torch.where(ok, torch.exp(s_d * c - lse_s[..., None]), 0.0)
                dsd = p * (dp_d - dsum_s[..., None]) * c  # [B, H, BQ, BQ + BK]
                dq[:, :, q0:q0 + BQ] += dsd @ e_band
                contrib = dsd.transpose(-1, -2) @ qs  # [B, H, BQ + BK, DH] by u
                for uu in range(BQ + BK):
                    d = dist0 + uu
                    if 0 <= d < T:
                        de_part[sp, :, :, d] += contrib[:, :, uu]
    de_d = de_part[0]
    for sp in range(1, SPLIT):  # block order
        de_d = de_d + de_part[sp]
    de = q.new_zeros((MAX_SEQ, DH))
    de[MAX_SEQ - T:] = de_d.sum((0, 1)).flip(0)  # row ms-1-d holds distance d
    return dq[:, :, :T], de


@pytest.mark.parametrize("T", [63, 64, 65, 129, 200])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
def test_kernel7_partition_matches_twin(T, causal):
    args = _inputs(T, causal)
    q, k, v, e, pad, lse, dsum, do = args
    got = kernel7_partition(q, k, v, e, causal, pad, lse, dsum, do)
    want = fa.bwd_dkdv_dq_plain(q, k, v, e, causal, pad, lse, dsum, do)
    for name, a, b in zip(("dk", "dv", "dq_qk"), got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * (1 + b.abs().max().item()),
                                   msg=name)


@pytest.mark.parametrize("T", [63, 64, 65, 129, 200])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
def test_kernel8_partition_matches_twin(T, causal):
    args = _inputs(T, causal)
    q, k, v, e, pad, lse, dsum, do = args
    got = kernel8_partition(q, k, v, e, causal, pad, lse, dsum, do)
    want = fa.bwd_de_dqrel_plain(q, k, v, e, causal, pad, lse, dsum, do)
    for name, a, b in zip(("dq_rel", "de"), got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * (1 + b.abs().max().item()),
                                   msg=name)
