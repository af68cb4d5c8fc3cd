"""One-token attention over the stacked int8/bf16 KV cache: the CUDA kernel,
its plain twin and the cache helpers.

Counterpart of ``midi_emotion_tpu/ops/decode_attention.py``. The cache is
stacked over layers with K|V merged: ``kv [L, B, W, 2D]`` int8 (with
``sc [L, B, 2H, W]`` bf16 per-(row, head) scales) or bf16 (no scales).
The cache is laid out at ``dh_k = cache_dh(dh)``, the least of the
kernel's built widths (``flash_attention.KERNEL_DHS``: 16, 32, 48, 64, 96,
128, 192, 256) that holds d_head, past 256 the least multiple of 128
(``flash_attention.padded_dh``), and ``D = H * dh_k``: head h of a row holds its
key at columns ``[h*dh_k, h*dh_k + dh)`` and its value at ``[D + h*dh_k,
D + h*dh_k + dh)``; the other columns are zero. For a built d_head (the flagship's 48) dh_k = dh and nothing is
padded. Zero columns change no score, and no int8 row scale (max|x| over a
head's group is unchanged). The rows are padded where they are built and
written (``cache_rows``, ``expand_e_rows``), never per call. Decoded rows
may first sit in a step-major stage ``pend [S, L, B, 2D]`` bf16 that
``flush_pend`` lands in the cache every S steps.

``decode_attn_cached`` is the public function, with the JAX signature and
return contract. On a CUDA tensor it launches ``csrc/decode_attn_stacked.cu``
or raises; on a CPU tensor it runs ``decode_attn_cached_plain``. Nothing
else chooses between them. ``quantize_rows``, ``expand_e_rows``,
``merge_self`` and ``flush_pend`` are plain torch, as they are XLA work in
the JAX package; ``flush_pend`` writes the cache in place.

The math, per (b, h), over the ``length`` flushed rows in window blocks of
``bw`` keys (128 when ``W % 128 == 0``, else W, the JAX kernel's block):

  * scores: int8 mode dots an int8 q (per-(b, h) scale ``sq = max|q|/127 +
    1e-20``, quantized from f32) with the raw int8 K exactly, then scales
    by ``sq * ks``; bf16 mode dots bf16 q with bf16 K into f32;
  * relative bias: q cast to bf16 against the given E rows;
  * logits ``(scores + bias) / sqrt(dh)`` (the true d_head, whatever the
    cache's width), keys ``w >= length`` masked with
    -1e30; an online max and sum across blocks;
  * PV: int8 mode re-quantizes ``p * vs`` to int8 per (b, h, window block)
    with ``s_p = max/127 + 1e-20`` and dots it with the raw int8 V; bf16
    mode rounds p to bf16. The block partition is part of the function:
    kernel and twin use the same one;
  * staged: the <= S unquantized stage rows of this layer (q in bf16), then
    the current token's self term (its bias row is ``e_pend[p_cnt]`` =
    E[max_seq - 1]) and the normalization. The current row is written into
    stage slot ``(min(p_cnt, S - 1), layer)`` in place; the tail reads the
    stage as it was before that write.

Source note for the kernel (``csrc/decode_attn_stacked.cu``):
  * replaces ``ops/decode_attention.py::_kernel`` (launched by ``_run``);
  * bound on the H100: bytes. One decode step reads each layer's live cache
    once: at B 64, length 1216, D 768 the int8 rows and scales of one layer
    are 126.1 MB, 37.6 us at 3.35 TB/s; bf16 240.6 MB, 71.8 us. The
    arithmetic (an int8 dot of 48 channels per key and head) is far below
    the card's operation rate;
  * its design: one thread-block cluster per batch row covers all heads,
    so each cache row leaves HBM once: a producer warp copies tiles of 32
    rows into a 2-4 stage ring with tensor-map (TMA) copies (K halves with
    their E rows and scales, then V halves), completing on mbarriers, and
    15 consumer warps compute on them. The cluster's CTAs split the live
    window blocks, exchange their per-(block, head) maxima in distributed
    shared memory and take the prefix max ``m_j`` (the twin's running max
    at block j), so P re-quantizes as the twin's does; rank 0 sums the
    partial (acc, l) in a fixed order and runs the staged tail. Scores,
    bias and PV are ``mma.sync`` products (int8 m16n8k32 with exact integer
    sums, bf16 m16n8k16) with keys or channels on the rows and 8 heads on
    the columns. q is quantized and cast inside the kernel, so the wrapper
    launches nothing else. Any width: a CTA takes one head group (the most
    heads dividing H within 1024 channels), the grid's third index runs over
    the groups, and a model with d_model above 1024 runs as independent head
    groups. The TPU kernel's (bb, bw) grid and its host-built layouts were
    Mosaic's needs and are not carried over;
  * past d_head 256 (its tensor map's box and its k-step masks stop there)
    the wrapper launches ``csrc/decode_attn_wide.cu`` instead, the same
    function for the same TPU kernel: a block per (head, batch row) walking
    the window blocks in order, q and the f32 accumulator in shared memory
    at d_head floats, scores and PV on the CUDA cores (int8 in integers).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

# The head width the stacked cache is laid out at for heads of dh columns:
# the decode kernel is built for the flash kernels' widths, KERNEL_DHS, and
# its wide form takes multiples of 128 past them
from .flash_attention import KERNEL_DHS
from .flash_attention import padded_dh as cache_dh

NEG = -1e30
MAX_STAGE = 128  # the kernel folds at most this many stage rows


def pad_groups(x: torch.Tensor, n_groups: int, dh_to: int) -> torch.Tensor:
    """[..., G*dh] -> [..., G*dh_to]: each of the G channel groups padded
    with zero columns up to dh_to (the tensor itself when dh == dh_to)."""
    dh = x.shape[-1] // n_groups
    if dh == dh_to:
        return x
    return F.pad(x.unflatten(-1, (n_groups, dh)), (0, dh_to - dh)).flatten(-2)


def cache_rows(k: torch.Tensor, v: torch.Tensor, n_head: int, dh_k: int) -> torch.Tensor:
    """K and V rows [..., H*dh] -> the merged K|V cache row [..., 2*H*dh_k]."""
    return pad_groups(torch.cat([k, v], dim=-1), 2 * n_head, dh_k)


def quantize_rows(t: torch.Tensor, n_groups: int):
    """[..., T, C] -> (int8 values [..., T, C], scales [..., G, T] bf16).

    Symmetric per-(row, group) int8 with C split into n_groups equal channel
    groups (2*H for a merged K|V row). The values are quantized with the f32
    scale, which is then stored rounded to bf16."""
    *lead, T, C = t.shape
    g = C // n_groups
    t4 = t.reshape(*lead, T, n_groups, g).float()
    s = t4.abs().amax(dim=-1) / 127.0 + 1e-12  # [..., T, G]
    q = torch.round(t4 / s[..., None]).to(torch.int8).reshape(*lead, T, C)
    return q, s.transpose(-1, -2).to(torch.bfloat16).contiguous()


def expand_e_rows(e: torch.Tensor, n: int, W: int, dtype=torch.bfloat16,
                  dh_to: Optional[int] = None) -> torch.Tensor:
    """Relative rows for a query at position n-1: [W, dh] (or [W, dh_to],
    zero columns appended) with out[w] = E[max_seq - n + w], zero past the
    table's end (those keys are masked). n is clamped to max_seq, so
    distances saturate at the table's edge, as in the JAX package."""
    max_seq, dh = e.shape
    start = max_seq - min(int(n), max_seq)
    rows = e[start:start + W].to(dtype)
    return F.pad(rows, (0, (dh_to or dh) - dh, 0, W - rows.shape[0]))


def merge_self(acc, m, l, q_t, k_t, v_t, e_last) -> torch.Tensor:
    """Fold the current token into the flash triple exactly. acc [B, D] f32,
    m and l [B, H] f32, q_t [B, H, dh], k_t and v_t [B, D], e_last [dh] =
    E[max_seq - 1]. Returns the normalized output [B, D] in v_t's dtype."""
    B, H, dh = q_t.shape
    qf = q_t.float()
    k4 = k_t.reshape(B, H, dh).float()
    logit_s = ((qf * k4).sum(-1) + qf @ e_last.float()) / math.sqrt(dh)  # [B, H]
    m_f = torch.maximum(m, logit_s)
    a_old = torch.exp(m - m_f)
    a_new = torch.exp(logit_s - m_f)
    denom = l * a_old + a_new
    expand = lambda x: x[:, :, None].expand(B, H, dh).reshape(B, H * dh)  # noqa: E731
    out = acc * expand(a_old) + v_t.float() * expand(a_new)
    return (out / expand(denom)).to(v_t.dtype)


def flush_pend(kv: torch.Tensor, sc: Optional[torch.Tensor], pend: torch.Tensor,
               f_len: int, n_head: int):
    """Land the S staged rows ``pend [S, L, B, 2D]`` in the stacked cache at
    window position f_len, IN PLACE: quantized when the cache is int8, as one
    slab write (and one scale slab). Returns (kv, sc), the same tensors."""
    S = pend.shape[0]
    if f_len + S > kv.shape[2]:
        raise ValueError(f"flush_pend: rows [{f_len}, {f_len + S}) overrun the window "
                         f"{kv.shape[2]}")
    rows = pend.permute(1, 2, 0, 3)  # [L, B, S, 2D]
    if sc is not None:
        row8, rsc = quantize_rows(rows, 2 * n_head)
        kv[:, :, f_len:f_len + S] = row8
        sc[:, :, :, f_len:f_len + S] = rsc
    else:
        kv[:, :, f_len:f_len + S] = rows.to(kv.dtype)
    return kv, sc


def quantize_q(q_t: torch.Tensor):
    """int8 q and its per-(b, h) f32 scale, quantized from f32."""
    qf = q_t.float()
    sq = qf.abs().amax(dim=-1) / 127.0 + 1e-20  # [B, H]
    return torch.round(qf / sq[..., None]).to(torch.int8), sq


def window_block(W: int) -> int:
    """Keys per window block: the unit of the P re-quantization."""
    return 128 if W % 128 == 0 else W


def _heads(x: torch.Tensor, H: int) -> torch.Tensor:
    """[..., n, H*dh] -> f32 [..., H, n, dh]."""
    return x.unflatten(-1, (H, -1)).transpose(-2, -3).float()


def decode_attn_cached_plain(q_t, kv8, sc, layer, e_rows, length, pend=None, e_pend=None,
                             p_cnt=None, row_t=None):
    """The kernel's math in plain torch, window block by window block (the
    same blocks, so the same P re-quantization). Same arguments and return
    contract as :func:`decode_attn_cached`; the staged form writes row_t
    into ``pend`` in place."""
    B, H, dh_q = q_t.shape
    c = 1.0 / math.sqrt(dh_q)
    dh = kv8.shape[-1] // (2 * H)  # the cache's head width
    if dh != dh_q:
        q_t = F.pad(q_t, (0, dh - dh_q))
    D = H * dh
    W = kv8.shape[2]
    quant = sc is not None
    qh = q_t.to(torch.bfloat16).float()  # [B, H, dh]
    if quant:
        q8, sq = quantize_q(q_t)
        q8 = q8.float()  # integer values; f32 sums of 48 int8 products are exact
    m = torch.full((B, H), NEG, dtype=torch.float32, device=q_t.device)
    l = torch.zeros((B, H), dtype=torch.float32, device=q_t.device)
    acc = torch.zeros((B, H, dh), dtype=torch.float32, device=q_t.device)
    bw = window_block(W)
    for j0 in range(0, int(length), bw):
        blk = kv8[layer, :, j0:j0 + bw]  # [B, bw, 2D]
        k, v = _heads(blk[..., :D], H), _heads(blk[..., D:], H)  # [B, H, bw, dh]
        if quant:
            ks = sc[layer, :, :H, j0:j0 + bw].float()  # [B, H, bw]
            vs = sc[layer, :, H:, j0:j0 + bw].float()
            scores = (q8[:, :, None, :] @ k.transpose(-1, -2))[:, :, 0] * sq[..., None] * ks
        else:
            scores = (qh[:, :, None, :] @ k.transpose(-1, -2))[:, :, 0]
        bias = qh @ e_rows[j0:j0 + bw].float().T  # [B, H, bw]
        live = torch.arange(j0, j0 + bw, device=q_t.device) < length
        logits = torch.where(live, (scores + bias) * c, NEG)
        m_new = torch.maximum(m, logits.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(live, torch.exp(logits - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        m = m_new
        if quant:
            pv = p * vs
            s_p = pv.amax(-1) / 127.0 + 1e-20  # [B, H]
            p8 = torch.round(pv / s_p[..., None])
            res = (p8[:, :, None, :] @ v)[:, :, 0] * s_p[..., None]
        else:
            res = (p.to(torch.bfloat16).float()[:, :, None, :] @ v)[:, :, 0]
        acc = acc * alpha[..., None] + res
    if pend is None:
        return acc[..., :dh_q].reshape(B, H * dh_q), m, l

    S = pend.shape[0]
    kp = _heads(pend[:, layer, :, :D].transpose(0, 1), H)  # [B, H, S, dh]
    vp = _heads(pend[:, layer, :, D:].transpose(0, 1), H)
    lg = (qh[:, :, None, :] @ kp.transpose(-1, -2))[:, :, 0] + qh @ e_pend[:S].float().T
    s_live = torch.arange(S, device=q_t.device) < p_cnt
    lg = torch.where(s_live, lg * c, NEG)
    m_new = torch.maximum(m, lg.amax(-1))
    alpha = torch.exp(m - m_new)
    pp = torch.where(s_live, torch.exp(lg - m_new[..., None]), 0.0)
    l = l * alpha + pp.sum(-1)
    m = m_new
    acc = acc * alpha[..., None] + (pp.to(torch.bfloat16).float()[:, :, None, :] @ vp)[:, :, 0]

    k_row, v_row = _heads(row_t[:, None, :D], H)[:, :, 0], _heads(row_t[:, None, D:], H)[:, :, 0]
    logit_s = ((qh * k_row).sum(-1) + (qh * e_pend[p_cnt].float()).sum(-1)) * c  # [B, H]
    m_fin = torch.maximum(m, logit_s)
    a_old = torch.exp(m - m_fin)
    a_new = torch.exp(logit_s - m_fin)
    denom = l * a_old + a_new
    out = (acc * a_old[..., None] + v_row * a_new[..., None]) / denom[..., None]
    pend[min(p_cnt, S - 1), layer] = row_t
    return out[..., :dh_q].reshape(B, H * dh_q).to(torch.bfloat16), pend


# ---- the CUDA kernel --------------------------------------------------------

_N_POINTERS = 11  # q, kv, sc, e_rows, pend, e_pend, row, acc, m, l, out
_N_INTS = 12      # L, B, W, H, dh, layer, length, S, p_cnt, bw, quant, q_bf16; then scale, a stream


@functools.lru_cache(maxsize=None)
def _library(name: str = "decode_attn_stacked") -> ctypes.CDLL:
    """``csrc/<name>.cu`` (decode_attn_stacked, or decode_attn_wide past
    d_head 256), built and loaded at first use; both export ``<name>`` with
    one signature."""
    from ..kernels.build import cuda_library

    lib = cuda_library(name)
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_void_p] * _N_POINTERS + [ctypes.c_int] * _N_INTS
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def _require(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} must lie on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned (the kernel's vector loads)")


def _check(q_t, kv8, sc, layer, e_rows, length, pend, e_pend, p_cnt, row_t) -> None:
    dev = q_t.device
    if q_t.dim() != 3:
        raise ValueError(f"q_t must be [B, H, dh], got {tuple(q_t.shape)}")
    B, H, dh_q = q_t.shape
    dh = cache_dh(dh_q)
    if kv8.dim() == 4 and kv8.shape[-1] != 2 * H * dh:
        raise ValueError(f"a cache row of {kv8.shape[-1]} columns does not hold {H} heads of "
                         f"d_head {dh_q}, laid out at {dh}: it must have {2 * H * dh}")
    if q_t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q_t must be float32 or bfloat16, got {q_t.dtype}")
    if kv8.dim() != 4:
        raise ValueError(f"kv8 must be [L, B, W, 2D], got {tuple(kv8.shape)}")
    L, _, W, _ = kv8.shape
    D = H * dh
    kv_dtype = torch.bfloat16 if sc is None else torch.int8
    _require(kv8, "kv8", kv_dtype, (L, B, W, 2 * D), dev)
    if sc is not None:
        _require(sc, "sc", torch.bfloat16, (L, B, 2 * H, W), dev)
    _require(e_rows, "e_rows", torch.bfloat16, (W, dh), dev)
    if not (0 <= layer < L and 0 <= length <= W):
        raise ValueError(f"layer {layer} of {L} and length {length} of {W} out of range")
    if pend is not None:
        S = pend.shape[0]
        if not (1 <= S <= MAX_STAGE and 0 <= p_cnt <= S):
            raise ValueError(f"stage of {S} rows (at most {MAX_STAGE}), p_cnt {p_cnt}")
        _require(pend, "pend", torch.bfloat16, (S, L, B, 2 * D), dev)
        _require(e_pend, "e_pend", torch.bfloat16, (S + 1, dh), dev)
        _require(row_t, "row_t", torch.bfloat16, (B, 2 * D), dev)


def _kernel(q_t, kv8, sc, layer, e_rows, length, pend, e_pend, p_cnt, row_t):
    B, H, dh_q = q_t.shape
    L, _, W, D2 = kv8.shape
    D, dh = D2 // 2, D2 // (2 * H)
    dev = q_t.device
    quant = sc is not None
    # the kernel quantizes and casts q itself; zero columns up to the
    # cache's width change no score and no int8 q scale
    q = q_t.contiguous() if dh == dh_q else F.pad(q_t, (0, dh - dh_q))
    staged = pend is not None
    f32 = dict(dtype=torch.float32, device=dev)
    if staged:
        acc = m = l = None
        out = torch.empty((B, D), dtype=torch.bfloat16, device=dev)
    else:
        acc, m, l = torch.empty((B, D), **f32), torch.empty((B, H), **f32), torch.empty((B, H), **f32)
        out = None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    S = pend.shape[0] if staged else 0
    name = "decode_attn_wide" if dh > KERNEL_DHS[-1] else "decode_attn_stacked"
    lib = _library(name)
    rc = getattr(lib, name)(
        q.data_ptr(), kv8.data_ptr(), ptr(sc), e_rows.data_ptr(), ptr(pend), ptr(e_pend),
        ptr(row_t), ptr(acc), ptr(m), ptr(l), ptr(out), L, B, W, H, dh, int(layer), int(length),
        S, int(p_cnt or 0), window_block(W), int(quant), int(q.dtype == torch.bfloat16),
        1.0 / math.sqrt(dh_q), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")
    decode_attn_cached.launches += 1
    if dh != dh_q:  # the outputs cut back to d_head
        acc, out = (t if t is None else t.view(B, H, dh)[..., :dh_q].reshape(B, H * dh_q)
                    for t in (acc, out))
    if not staged:
        return acc, m, l
    if p_cnt == S:
        # out of contract (the sampler flushes first): the slot is clamped to
        # S - 1, written after the kernel has read the stage as it was
        pend[S - 1, layer] = row_t
    return out, pend


def decode_attn_cached(
    q_t: torch.Tensor,       # [B, H, dh], any d_head
    kv8: torch.Tensor,       # [L, B, W, 2D] int8 (or bf16) stacked cache, D = H * cache_dh(dh)
    sc: Optional[torch.Tensor],  # [L, B, 2H, W] bf16 scales, or None (bf16 cache)
    layer: int,
    e_rows: torch.Tensor,    # [W, dh_k] bf16: expand_e_rows(e, length + 1, W, dh_to=dh_k)
    length: int,             # flushed rows attended to
    pend: Optional[torch.Tensor] = None,    # [S, L, B, 2D] bf16 staged rows
    e_pend: Optional[torch.Tensor] = None,  # [S+1, dh_k] bf16: expand_e_rows(e, p_cnt+1, S+1, ...)
    p_cnt: Optional[int] = None,            # live staged rows
    row_t: Optional[torch.Tensor] = None,   # [B, 2D] bf16: this token's K|V row (cache_rows)
):
    """Flash decode over the cached rows of one layer, plus (when staged)
    the <= S unquantized stage rows and the current token's self term.
    The cache, the E rows, the stage and row_t are laid out at dh_k =
    cache_dh(dh) (see the module note); q and the outputs have d_head's
    own width, and the logits are scaled by 1/sqrt(dh).

    Unstaged: returns (acc [B, H*dh] f32, m [B, H] f32, l [B, H] f32), the
    unnormalized flash triple over the cached rows only (length 0 gives
    m = -1e30, l = 0, acc = 0); fold the current token in with merge_self.
    Staged: returns (out [B, H*dh] bf16, pend): out is normalized with the
    stage tail and the self term folded in, and row_t is written into pend
    at slot (min(p_cnt, S - 1), layer) in place.

    On a CUDA tensor this launches ``csrc/decode_attn_stacked.cu`` or
    raises; on a CPU tensor it runs :func:`decode_attn_cached_plain`."""
    if pend is not None:
        if e_pend is None or e_pend.shape[0] != pend.shape[0] + 1:
            raise ValueError("e_pend must carry pend.shape[0] + 1 rows (row p_cnt is the "
                             "self bias E[max_seq - 1])")
        if row_t is None or p_cnt is None:
            raise ValueError("staged decode needs p_cnt and row_t (the self term, appended "
                             "at stage slot (p_cnt, layer))")
    args = (q_t, kv8, sc, int(layer), e_rows, int(length), pend, e_pend,
            None if p_cnt is None else int(p_cnt), row_t)
    if q_t.device.type == "cpu":
        return decode_attn_cached_plain(*args)
    if q_t.device.type != "cuda":
        raise ValueError(f"decode_attn_cached: unsupported device {q_t.device}")
    _check(*args)
    return _kernel(*args)


decode_attn_cached.launches = 0  # kernel launches since the last reset
