"""Torch port, the work partition of the card's bf16 kernels 5, 6 and 8
(the query-major dQ/dE sweeps of ``MIDI_EMOTION_BWD=fused`` with
``MIDI_EMOTION_DQDE=column`` or ``dist``, and of ``split``), restated in
torch, in f32, and held on the CPU to the plain twins and to the JAX
package's Pallas kernels.

``csrc/flash_rel_attn_bwd_q.cu``'s ``wg::flash_bwd_q_wg_tc_kernel`` runs only
on the card; kernel 5 (``column``) launches kernel 6's (``dist``)
instantiation, so the two modes share one partition here, held to each
TPU kernel. Its index algebra, restated tile by tile:

  * two blocks a (b, h), block s on query tiles s, s + 2, ... of 64 rows;
    each walks the key tiles its query tile sees: DIST (and COLUMN) 0..qt
    causal and every tile non-causal, REL 0..qt in both models;
  * per pair S = Q K^T, the band Q E_band^T over 128 band rows (row v at
    distance q0 - k0 + 64 - v, zero where negative), Srel[i, j] =
    band[i, 64 - i + j], P and dS' by key column;
  * dsd [64 q][128 v] is dS' scattered by distance: dsd[i, 64 - i + j] =
    dS'[i, j], zero at a negative distance (no second softmax);
  * dQ per query tile: dS' K (DIST, COLUMN) + dsd E_band over its key
    tiles;
  * dE: dsd^T Q by band half; the upper half (v < 64) is complete after
    the pair and added to the block's f32 partial by distance, the lower
    half is carried to the next key tile (whose upper half it is) and
    written at the query tile's last band pair; the partials, one a
    block, are summed in block order.

Tolerances: against the twins 1e-6 of each output's scale (f32 sums in
another order); against the Pallas kernels 1e-4, as
``tests/test_torch_flash_bwd_impls.py`` holds the twins to them. The
Pallas kernels run as that file runs them: the JAX forward and backward
with the decomposition set, each ``_bwd_*_call``'s outputs recorded, in
the generic interpreter."""

import math

import numpy as np
import pytest
import torch

import conftest  # noqa: F401 -- pins JAX to the CPU

import jax
import jax.numpy as jnp

from midi_emotion_tpu.ops import pallas_attention
from midi_emotion_tpu_torch.ops import flash_attention as fa

from test_torch_split_partition import kernel7_partition
from torch_parity import generic_interpret

BQ = BK = 64     # the kernel's tiles
EB = BQ + BK     # band rows a pair stages
SPLIT = 2        # blocks a (b, h)
B, H, MAX_SEQ = 2, 2, 256
MODES = {  # mode -> (the twin, the Pallas launcher, the decomposition that runs it)
    "column": ("bwd_dq_de_plain", "_bwd_dq_de_call", ("fused", "column")),
    "dist": ("bwd_dq_de_dist_plain", "_bwd_dq_de_dist_call", ("fused", "dist")),
    "rel": ("bwd_de_dqrel_plain", "_bwd_de_dqrel_call", ("split", "column")),
}
# kernel 7's Pallas launcher, recorded in the split backward beside kernel 8's
KV_LAUNCHER = "_bwd_dkdv_dq_call"


def _inputs(T, dh, causal, key0=True):
    """q, k, v, e, dO (numpy f32) and the pad mask: a pad tail in batch row
    1 and, with key0, its key 0 too (causal: query 0 sees no key)."""
    rng = np.random.default_rng(T + dh + 7 * causal)
    q, k, v, do = (rng.standard_normal((B, H, T, dh)).astype(np.float32) for _ in range(4))
    e = rng.standard_normal((MAX_SEQ, dh)).astype(np.float32)
    pad = np.zeros((B, T), bool)
    pad[1, T - T // 4:] = True
    pad[1, 0] = key0
    return q, k, v, e, do, pad


def _saved(q, k, v, e, do, pad, causal):
    """torch tensors, the forward's lse and dsum = rowsum(dO * O)."""
    q, k, v, e, do = (torch.from_numpy(x) for x in (q, k, v, e, do))
    pad = torch.from_numpy(pad)
    do = do * (~pad)[:, None, :, None]
    o, lse = fa.flash_rel_attention_plain(q, k, v, e, causal, pad)
    return q, k, v, e, pad, lse, (do * o).sum(-1), do


def _tile(x, t0, n, T):
    """Rows t0..t0+n of x [..., T, dh], zero past T (TMA's zero fill)."""
    out = x.new_zeros((*x.shape[:-2], n, x.shape[-1]))
    m = max(0, min(n, T - t0))
    out[..., :m, :] = x[..., t0:t0 + m, :]
    return out


def _rows(x, t0, n, T, fill):
    out = x.new_full((*x.shape[:-1], n), fill)
    m = max(0, min(n, T - t0))
    out[..., :m] = x[..., t0:t0 + m]
    return out


def _band(e, dist_top):
    """The pair's E band [EB, dh]: row v at distance dist_top - v, zero
    where the distance is negative or past the table."""
    dist = dist_top - torch.arange(EB)
    ok = (dist >= 0) & (dist < e.shape[0])
    return torch.where(ok[:, None], e[(e.shape[0] - 1 - dist).clamp(0, e.shape[0] - 1)], 0.0)


def _pair(qs, dos, ks, vs, e, q0, k0, T, causal, live, lse_s, dsum_s, c, band):
    """One tile pair's phase A: (dS' by key column [B, H, 64, 64], the band
    [EB, dh] or None, S and the band product for the recompute check)."""
    il = torch.arange(BQ)[:, None]
    jl = torch.arange(BK)[None, :]
    s = qs @ ks.transpose(-1, -2)
    e_band, bprod = None, None
    if band:
        e_band = _band(e, q0 - k0 + 64)
        bprod = qs @ e_band.T  # [B, H, 64, EB]
        srel = bprod.gather(-1, (64 - il + jl).expand(*qs.shape[:2], BQ, BK))
        sc = s + srel
    else:  # every distance negative: Srel is 0
        sc = s
    ok = ((q0 + il < T) & ~(causal & (k0 + jl > q0 + il)))[None, None] & live[:, None, None, :]
    p = torch.where(ok, torch.exp(sc * c - lse_s[..., None]), 0.0)
    ds = p * (dos @ vs.transpose(-1, -2) - dsum_s[..., None]) * c
    return ds, e_band, s, bprod


def _scatter(ds, q0, k0):
    """dsd [B, H, 64, EB]: dS'[i, j] at v = 64 - i + j, 0 at a negative
    distance q0 + i - k0 - j; columns no key reaches stay 0."""
    il = torch.arange(BQ)[:, None]
    jl = torch.arange(BK)[None, :]
    v = (64 - il + jl).expand(*ds.shape[:2], BQ, BK)
    dsd = ds.new_zeros((*ds.shape[:2], BQ, EB))
    return dsd.scatter(-1, v, torch.where((q0 + il - k0 - jl >= 0)[None, None], ds, 0.0))


def _recompute(s, bprod, dos, vs, q0, k0, T, live, lse_s, dsum_s, c):
    """dsd formed by distance, as the TPU kernels and the card's earlier
    mma.sync kernel form it: the bias by distance is the band product
    itself, q.k and dO.v read at key j = i - 64 + v."""
    il = torch.arange(BQ)[:, None]
    v = torch.arange(EB)[None, :]
    jl = il - 64 + v
    in_tile = (jl >= 0) & (jl < BK)
    j_idx = jl.clamp(0, BK - 1).expand(*s.shape[:2], BQ, EB)
    s_d = s.gather(-1, j_idx) + bprod
    dp_d = (dos @ vs.transpose(-1, -2)).gather(-1, j_idx)
    ok = (in_tile & (q0 + il < T) & (q0 + il - k0 - jl >= 0))[None, None] \
        & live[:, None, None, :].expand(*s.shape[:2], BQ, BK).gather(-1, j_idx)
    p = torch.where(ok, torch.exp(s_d * c - lse_s[..., None]), 0.0)
    return p * (dp_d - dsum_s[..., None]) * c


def query_sweep_partition(q, k, v, e, causal, pad, lse, dsum, do, mode, scale=None,
                          check_scatter=None):
    """-> (dq or dq_rel, de) by kernel 5's and 6's (``mode`` "column" or
    "dist": one kernel on the card) or kernel 8's ("rel") partition. ``check_scatter(scattered, recomputed)``,
    where given, sees each band pair's dsd formed both ways."""
    T, dh = q.shape[2], q.shape[3]
    c = 1.0 / math.sqrt(dh) if scale is None else scale
    n_tiles = (T + BQ - 1) // BQ
    dq = q.new_zeros((B, H, n_tiles * BQ, dh))
    de_part = q.new_zeros((SPLIT, B, H, T, dh))  # one partial a block, row = distance

    def add_rows(sp, block, row0):  # the partial's rows row0 - rl += block[rl]
        for rl in range(BQ):
            if 0 <= row0 - rl < T:
                de_part[sp, :, :, row0 - rl] += block[:, :, rl]

    for sp in range(SPLIT):
        for qt in range(sp, n_tiles, SPLIT):
            q0 = qt * BQ
            qs, dos = _tile(q, q0, BQ, T), _tile(do, q0, BQ, T)
            lse_s, dsum_s = _rows(lse, q0, BQ, T, 1e30), _rows(dsum, q0, BQ, T, 0.0)
            dq_t = q.new_zeros((B, H, BQ, dh))
            carry = q.new_zeros((B, H, BQ, dh))
            last = qt if causal or mode == "rel" else n_tiles - 1
            for kt in range(last + 1):
                k0 = kt * BK
                band = kt <= qt
                ks, vs = _tile(k, k0, BK, T), _tile(v, k0, BK, T)
                live = ~_rows(pad, k0, BK, T, True)
                ds, e_band, s, bprod = _pair(qs, dos, ks, vs, e, q0, k0, T, causal, live,
                                             lse_s, dsum_s, c, band)
                if mode != "rel":
                    dq_t += ds @ ks
                if not band:
                    continue
                dsd = _scatter(ds, q0, k0)
                if check_scatter is not None:
                    check_scatter(dsd, _recompute(s, bprod, dos, vs, q0, k0, T, live, lse_s,
                                                  dsum_s, c))
                dq_t += dsd @ e_band
                contrib = dsd.transpose(-1, -2) @ qs  # [B, H, EB, dh], row v
                add_rows(sp, carry + contrib[:, :, :BQ], q0 - k0 + 64)
                carry = contrib[:, :, BQ:]
                if kt == qt:  # the query tile's last band pair
                    add_rows(sp, carry, q0 - k0)
                    carry = torch.zeros_like(carry)
            dq[:, :, q0:q0 + BQ] = dq_t
    parts = de_part.reshape(SPLIT * B * H, T, dh)
    de_d = parts[0].clone()
    for x in range(1, SPLIT * B * H):  # de_reduce_kernel's order
        de_d = de_d + parts[x]
    de = q.new_zeros((e.shape[0], dh))
    de[e.shape[0] - T:] = de_d.flip(0)  # row ms-1-d holds distance d
    return dq[:, :, :T], de


def _card_route(args, mode, dh, check_scatter=None):
    """The partition as the card runs a head of ``dh`` columns: padded with
    zero columns to ``padded_dh`` (40 -> 48), c = 1/sqrt(dh), cut back."""
    q, k, v, e, causal, pad, lse, dsum, do = args
    dh_k = fa.padded_dh(dh)
    qp, kp, vp, ep, dop = fa.pad_heads(dh_k, q, k, v, e, do)
    got = query_sweep_partition(qp, kp, vp, ep, causal, pad, lse, dsum, dop, mode,
                                scale=1.0 / math.sqrt(dh), check_scatter=check_scatter)
    return [x[..., :dh] for x in got]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("dh", [40, 128])
@pytest.mark.parametrize("T", [70, 200])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
def test_query_sweep_partition_matches_twin(mode, dh, T, causal):
    """Kernel 5's, 6's and 8's partition against their twins, a fully masked
    row (key 0 pad) and a pad tail: 1e-6 of each output's scale."""
    q, k, v, e, pad, lse, dsum, do = _saved(*_inputs(T, dh, causal), causal)
    args = (q, k, v, e, causal, pad, lse, dsum, do)
    got = _card_route(args, mode, dh)
    want = getattr(fa, MODES[mode][0])(*args)
    for name, a, b in zip(("dq", "de"), got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * (1 + b.abs().max().item()),
                                   msg=name)
    if causal:
        assert got[0][1, :, 0].eq(0).all()  # the fully masked row


@pytest.mark.parametrize("dh", [40, 128])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
def test_scattered_dsd_equals_distance_recompute(dh, causal):
    """dsd scattered from the key-column dS' is the dS the distance-domain
    recompute forms, bit for bit in f32 and after the bf16 rounding the
    kernel applies: both add the same two f32 values (q.k and the band
    product q.E) and take the same exp."""
    q, k, v, e, pad, lse, dsum, do = _saved(*_inputs(200, dh, causal), causal)
    seen = []

    def check(scattered, recomputed):
        assert torch.equal(scattered, recomputed)
        assert torch.equal(scattered.bfloat16(), recomputed.bfloat16())
        seen.append(int(scattered.ne(0).sum()))

    _card_route((q, k, v, e, causal, pad, lse, dsum, do), "rel", dh, check)
    assert len(seen) == 1 + 2 + 3 + 4 and all(n > 0 for n in seen)  # query tile qt: qt + 1


_VJPS, _RECORDED = {}, {}


def _pallas_outputs(mode, T, dh, causal):
    """The Pallas launcher's (dq term, dE) for ``mode``, recorded inside
    jax.vjp of flash_relative_attention with its decomposition set, carried
    to the port's convention: dQ times c (the JAX kernels see q pre-scaled),
    dE rows cut as the JAX backward cuts them. The pad tail only: the JAX
    kernels keep no masked row at key 0 (ROADMAP queue 3). The split
    backward ("rel") also records kernel 7's (dk, dv, dq_qk), cut to T, dQ
    times c, under mode "kv"."""
    key = (mode, T, dh, causal)
    if key in _RECORDED:
        return _RECORDED[key]
    q, k, v, e, do, pad = _inputs(T, dh, causal, key0=False)
    launcher = MODES[mode][1]
    bwd, dqde = MODES[mode][2]
    recorded = {}

    def recorder(name):
        original = getattr(pallas_attention, name)

        def call(*args, **kwargs):
            out = original(*args, **kwargs)
            recorded[name] = [np.asarray(x) for x in out]
            return out
        return call

    if key[1:] not in _VJPS:  # the forward once for both modes
        with generic_interpret():
            _VJPS[key[1:]] = jax.vjp(
                lambda *a: pallas_attention.flash_relative_attention(*a, causal, jnp.asarray(pad)),
                *(jnp.asarray(x) for x in (q, k, v, e)))[1]
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(pallas_attention, "BWD_IMPL", bwd)
        mp.setattr(pallas_attention, "DQDE_IMPL", dqde)
        for name in (launcher, KV_LAUNCHER) if bwd == "split" else (launcher,):
            mp.setattr(pallas_attention, name, recorder(name))
        with generic_interpret():
            _VJPS[key[1:]](jnp.asarray(do * ~pad[:, None, :, None]))
    finally:
        mp.undo()
    dq_j, de_j = recorded[launcher]
    pad_t = dq_j.shape[2] - T  # front rows the JAX table gained
    _RECORDED[key] = (dq_j[:, :, :T] / math.sqrt(dh), de_j[pad_t:pad_t + MAX_SEQ])
    if bwd == "split":
        dk, dv, dqk = (x[:, :, :T] for x in recorded[KV_LAUNCHER])
        _RECORDED[("kv", *key[1:])] = (dk, dv, dqk / math.sqrt(dh))
    return _RECORDED[key]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("dh", [40, 128])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
def test_query_sweep_partition_matches_pallas_kernel(mode, dh, causal):
    """Kernel 5's, 6's and 8's partition (heads of 40 padded to 48 as on
    the card) against ``_bwd_dq_de_call``, ``_bwd_dq_de_dist_call`` and
    ``_bwd_de_dqrel_call``
    with a pad tail: 1e-4."""
    T = 70
    want = _pallas_outputs(mode, T, dh, causal)
    q, k, v, e, pad, lse, dsum, do = _saved(*_inputs(T, dh, causal, key0=False), causal)
    got = _card_route((q, k, v, e, causal, pad, lse, dsum, do), mode, dh)
    for name, a, b in zip(("dq", "de"), got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("dh", [40, 128])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
def test_kernel7_partition_matches_pallas_kernel(dh, causal):
    """Kernel 7's partition (``tests/test_torch_split_partition.py``) as the
    card runs a head of ``dh`` columns: padded with zero columns to
    ``padded_dh`` (40 -> 48), c = 1/sqrt(dh), groups of two key tiles up to
    48 and one past, two blocks a (b, h); against ``_bwd_dkdv_dq_call``,
    recorded in the split backward beside kernel 8's Pallas kernel, with a
    pad tail: 1e-4."""
    T = 70
    _pallas_outputs("rel", T, dh, causal)
    want = _RECORDED[("kv", T, dh, causal)]
    q, k, v, e, pad, lse, dsum, do = _saved(*_inputs(T, dh, causal, key0=False), causal)
    dh_k = fa.padded_dh(dh)
    qp, kp, vp, ep, dop = fa.pad_heads(dh_k, q, k, v, e, do)
    got = kernel7_partition(qp, kp, vp, ep, causal, pad, lse, dsum, dop, G=2 if dh_k <= 48 else 1,
                            scale=1.0 / math.sqrt(dh))
    for name, a, b in zip(("dk", "dv", "dq_qk"), got, want):
        a = a[..., :dh]
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-4, err_msg=name)
