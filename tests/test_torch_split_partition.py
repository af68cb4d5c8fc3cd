"""Torch port, the work partitions of the card's backward kernels (the
``split`` and ``fused`` flash sweeps, and the LayerNorm backward), restated
in torch and held to the plain twins on the CPU.

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
    block order;
  * kernel 9 (``bwd_dkdv``, ``fused``): kernel 7's sweep without dQ, on a
    grid of ``split`` blocks a (b, h) numbered key-tile-major, block s
    taking key tiles s, s + split, ... (one block per key tile by default);
    each key tile's dK and dV are kernel 7's, bit for bit;
  * ``ln_bwd`` (kernels 3 and 12, ``ops/layernorm_triton.py``): program p
    of n takes the tiles of ROWS rows p, p + n, ...; the dgamma/dbeta
    partials, one a program, are summed in program order; the dropout mask
    of a tile draws one Philox call per four elements when D % 4 == 0.
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


def _kv_partition(q, k, v, e, causal, pad, lse, dsum, do, blocks, with_dq):
    """-> (dk, dv, dq partials [len(blocks), ...]) of the key-major sweep:
    block b of ``blocks`` (a list of key-tile lists, one a block) sweeps its
    key tiles in order and, inside, the query tiles that see each."""
    T = q.shape[2]
    c = 1.0 / math.sqrt(DH)
    n_tiles = (T + BK - 1) // BK
    n_pad = n_tiles * BK
    dk, dv = q.new_zeros((B, H, n_pad, DH)), q.new_zeros((B, H, n_pad, DH))
    dq_part = q.new_zeros((len(blocks) if with_dq else 0, B, H, n_pad, DH))
    il = torch.arange(BQ)[:, None]
    jl = torch.arange(BK)[None, :]
    for blk, key_tiles in enumerate(blocks):
        for kt in key_tiles:
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
                if with_dq:
                    dq_part[blk, :, :, q0:q0 + BQ] += ds @ ks
    return dk[:, :, :T], dv[:, :, :T], dq_part[..., :T, :]


def kernel7_partition(q, k, v, e, causal, pad, lse, dsum, do):
    """-> (dk, dv, dq_qk) by kernel 7's partition."""
    n_tiles = (q.shape[2] + BK - 1) // BK
    blocks = [list(range(sp, n_tiles, SPLIT)) for sp in range(SPLIT)]
    dk, dv, dq_part = _kv_partition(q, k, v, e, causal, pad, lse, dsum, do, blocks, True)
    dq = dq_part[0]
    for sp in range(1, SPLIT):  # block order
        dq = dq + dq_part[sp]
    return dk, dv, dq


def kernel9_partition(q, k, v, e, causal, pad, lse, dsum, do, split=None):
    """-> (dk, dv) by kernel 9's partition: ``split`` blocks a (b, h) (None:
    one a key tile), block s taking key tiles s, s + split, ... (every
    (b, h) at once here: the blocks share nothing)."""
    n_tiles = (q.shape[2] + BK - 1) // BK
    split = n_tiles if split is None else split
    blocks = [list(range(sp, n_tiles, split)) for sp in range(split)]
    return _kv_partition(q, k, v, e, causal, pad, lse, dsum, do, blocks, False)[:2]


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


@pytest.mark.parametrize("split", [None, 2], ids=["tile-grid", "split2-grid"])
@pytest.mark.parametrize("T", [63, 64, 65, 129, 200])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
def test_kernel9_partition_matches_twin(T, causal, split):
    q, k, v, e, pad, lse, dsum, do = _inputs(T, causal)
    args = (q, k, v, e, causal, pad, lse, dsum, do)
    got = kernel9_partition(*args, split=split)
    want = fa.bwd_dkdv_plain(*args)
    for name, a, b in zip(("dk", "dv"), got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * (1 + b.abs().max().item()),
                                   msg=name)
    # each key tile's sums are kernel 7's, whatever the grid
    for name, a, b in zip(("dk", "dv"), got, kernel7_partition(*args)):
        assert torch.equal(a, b), name


# ---------------------------------------------------------------------------
# ln_bwd (kernels 3 and 12)
# ---------------------------------------------------------------------------

LN_ROWS = 2  # rows a tile (LN_BWD_ROWS in ops/layernorm_triton.py)


def _words(seed, n_ctr):
    """A stand-in for Philox4x32-10: four 32-bit words a counter."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 2**32, (n_ctr, 4), dtype=np.int64))


def _interleave(a, b):
    """tl.interleave along the last axis."""
    return torch.stack((a, b), -1).flatten(-2)


def tile_bits(words, rows, D, block_d):
    """The bits of a [rows, block_d] tile drawn as ``ln_bwd`` draws them at
    D % 4 == 0: the call at counter row * D/4 + g for elements 4g..4g+3,
    its words interleaved into element order."""
    ctr = rows[:, None] * (D // 4) + torch.arange(block_d // 4)[None, :]
    r0, r1, r2, r3 = (words[ctr, w] for w in range(4))
    return _interleave(_interleave(r0, r2), _interleave(r1, r3))


@pytest.mark.parametrize("D", [64, 100, 768, 99])
def test_ln_bwd_grouped_draw_is_the_flat_rule(D):
    """Element i of the flat [N, D] tensor takes word i % 4 of counter
    i // 4. The tile draw (one call per four elements) gives exactly those
    bits when every row starts a group of four (D % 4 == 0); at D 99 the
    rows start inside a group, so the kernel draws per element there."""
    N, block_d = 9, 1 << (D - 1).bit_length()
    words = _words(D, N * D // 4 + block_d)
    flat = torch.arange(N * D)
    want = words[flat // 4, flat % 4].view(N, D)
    got = tile_bits(words, torch.arange(N), D, block_d)[:, :D]
    assert torch.equal(got, want) == (D % 4 == 0)


def ln_bwd_partition(x, dy, w, n_prog, eps=1e-6, sub=None, keep=None, rate=None):
    """-> (dx, ds or None, dgamma, dbeta) by ``ln_bwd``'s partition in f32:
    program p takes tiles p, p + n_prog, ... of LN_ROWS rows, sums its rows'
    dy * xhat and dy into its partial, and the partials are summed in
    program order."""
    N, D = x.shape
    n_tiles = -(-N // LN_ROWS)
    part = x.new_zeros((2, n_prog, D))
    dx, ds = torch.empty_like(x), None if sub is None else torch.empty_like(x)
    for p in range(n_prog):
        for t in range(p, n_tiles, n_prog):
            r = slice(t * LN_ROWS, min(N, (t + 1) * LN_ROWS))
            xf = x[r] if sub is None else x[r] + torch.where(keep[r], sub[r] * (1 / (1 - rate)),
                                                             0.0)
            xc = xf - xf.mean(1, keepdim=True)
            rstd = torch.rsqrt((xc * xc).mean(1, keepdim=True) + eps)
            xhat = xc * rstd
            part[0, p] += (dy[r] * xhat).sum(0)
            part[1, p] += dy[r].sum(0)
            wdy = dy[r] * w
            dx[r] = (wdy - wdy.mean(1, keepdim=True)
                     - xhat * (wdy * xhat).mean(1, keepdim=True)) * rstd
            if sub is not None:
                ds[r] = torch.where(keep[r], dx[r] * (1 / (1 - rate)), 0.0)
    acc = part[:, 0]
    for p in range(1, n_prog):  # program order
        acc = acc + part[:, p]
    return dx, ds, acc[0], acc[1]


@pytest.mark.parametrize("N,n_prog", [(1, 1), (5, 3), (7, 1), (37, 4), (37, 16)])
@pytest.mark.parametrize("D", [99, 100])
@pytest.mark.parametrize("dropout", [True, False], ids=["kernel12", "kernel3"])
def test_ln_bwd_partition_matches_twins(N, n_prog, D, dropout):
    from midi_emotion_tpu_torch.ops import fused_dropout as fd
    from midi_emotion_tpu_torch.ops.layernorm import ln_bwd_f32

    rng = np.random.default_rng(N * D + n_prog)
    x, sub, dy = (torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32) * 2 + 0.5)
                  for _ in range(3))
    w = torch.from_numpy(rng.standard_normal(D).astype(np.float32))
    if dropout:
        rate = 0.1
        keep = fd.keep_mask(5, (N, D), rate)
        dx, ds, dw, db = ln_bwd_partition(x, dy, w, n_prog, sub=sub, keep=keep, rate=rate)
        got = (ds, dx, dw, db)
        want = fd.dropout_add_layernorm_bwd_plain(sub, x, dy, w, keep, rate)
    else:
        dx, _, dw, db = ln_bwd_partition(x, dy, w, n_prog)
        got, want = (dx, dw, db), ln_bwd_f32(x, dy, w, 1e-6)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * (1 + b.abs().max().item()))
