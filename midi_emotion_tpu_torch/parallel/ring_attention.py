"""Ring attention: sequence-sharded relative attention, in torch.

Counterpart of ``midi_emotion_tpu/parallel/ring_attention.py``. Q, K and V
are sharded along the sequence over the mesh's "seq" axis: rank i of the
ring holds query, key and value chunk i (C = T / n positions from i * C)
and streams every key/value chunk past its queries, one hop a step, merging
the chunks with the online-softmax (flash) recurrence. Per-rank memory is
O(T / n).

* ``chunk_rel_bias``: the relative bias of one (query chunk, key chunk)
  pair from a band of 2C - 1 rows of E, skewed with the pad-flatten-reshape
  shift of ``_chunk_rel_bias`` (``ring_attention.py:41``);
* ``ring_step``: one step of the ring (scores, the band bias, the masks and
  the online-softmax update), a function of its own so that the ring's n
  steps can also be driven in one process (``ring_attention_one_process``,
  which ``chip_smoke.py`` runs on the card);
* ``ring_relative_attention``: the shard-local body (JAX ``:72``); the
  rotation is ``torch.distributed.batch_isend_irecv`` to rank (i + 1) % n of
  the seq group inside an autograd function whose backward rotates the
  gradient the other way, what ``ppermute``'s transpose gives JAX;
* ``ring_global_attention`` and ``make_ring_attention`` (JAX ``:147``,
  ``:190``): the same on GLOBAL [B, H, T, dh] arrays; each rank takes its
  chunk (and, in the first, its rows over the data axis) and the output is
  gathered back. They keep JAX's API for callers that hold whole arrays;
  the model, which holds only its chunk, calls ``ring_relative_attention``.

As in JAX, the per-chunk products are plain tensor code (the JAX ring has
no Pallas kernel), in f32, and the output is cast to q's dtype. E is
replicated, so its gradient, like every parameter's, is summed over the
seq group by the train step.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .mesh import Mesh, gather_from

NEG_INF = -1e30

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def chunk_rel_bias(q: torch.Tensor, e_ext: torch.Tensor, delta: int, C: int,
                   max_seq: int) -> torch.Tensor:
    """Relative bias of one (query chunk, key chunk) pair.

    q [B, H, C, dh]; e_ext [max_seq + 2 * T_pad, dh]: E zero-padded by T_pad
    rows on both sides; delta = query offset - key offset. Returns [B, H, C,
    C] with bias[a, b] = q[a] . E[max_seq - 1 - (delta + a - b)], zero where
    the distance is negative (j > i globally)."""
    B, H, _, dh = q.shape
    T_pad = (e_ext.shape[0] - max_seq) // 2
    W = 2 * C - 1
    # band row m = C - 1 - a + b holds E[max_seq - 1 - (delta + a - b)]
    start = max_seq + T_pad - delta - C
    qe = torch.einsum("bhad,md->bham", q, e_ext[start:start + W])  # [B, H, C, W]
    # S[a, b] = qe[a, C-1-a+b]: with both column orders reversed this is a
    # shift left by the row index, which a flat view of row stride W + 1 gives
    flat = F.pad(qe.flip(-1).reshape(B, H, C * W), (0, C))
    srel = flat.reshape(B, H, C, W + 1)[..., :C].flip(-1)
    a = torch.arange(C, device=q.device)[:, None]
    b = torch.arange(C, device=q.device)[None, :]
    return srel.masked_fill(delta + a - b < 0, 0.0)


def ring_state(q: torch.Tensor) -> State:
    """The online-softmax state (max, sum, output) before the first step,
    f32."""
    B, H, C, dh = q.shape
    m = torch.full((B, H, C, 1), NEG_INF, dtype=torch.float32, device=q.device)
    return m, torch.zeros_like(m), torch.zeros((B, H, C, dh), dtype=torch.float32,
                                               device=q.device)


def ring_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pad: torch.Tensor,
              e_ext: torch.Tensor, delta: int, max_seq: int, causal: bool,
              state: State) -> State:
    """One step of the ring: the query chunk q against the key/value chunk
    (k, v, its pad mask ``pad`` [B, C]) at offset distance ``delta``, merged
    into ``state`` by the online softmax. f32 throughout."""
    B, H, C, dh = q.shape
    m_acc, l_acc, o_acc = state
    qf = q.float()
    s = qf @ k.float().transpose(-1, -2) + chunk_rel_bias(qf, e_ext, delta, C, max_seq)
    s = s * (1.0 / math.sqrt(dh))
    masked = pad[:, None, None, :].expand(B, 1, C, C)
    if causal:
        a = torch.arange(C, device=q.device)[:, None]
        b = torch.arange(C, device=q.device)[None, :]
        masked = masked | (delta + a - b < 0)
    s = s.masked_fill(masked, NEG_INF)
    m_new = torch.maximum(m_acc, s.amax(-1, keepdim=True))
    p = torch.exp(s - m_new)
    alpha = torch.exp(m_acc - m_new)
    l_acc = l_acc * alpha + p.sum(-1, keepdim=True)
    o_acc = o_acc * alpha + p @ v.float()
    return m_new, l_acc, o_acc


def ring_finish(state: State, dtype) -> torch.Tensor:
    _, l_acc, o_acc = state
    return (o_acc / torch.where(l_acc > 0, l_acc, 1.0)).to(dtype)


def extend_e(e: torch.Tensor, T: int) -> torch.Tensor:
    """E in f32, zero-padded by T rows on both sides (``e_ext``)."""
    return F.pad(e.float(), (0, 0, T, T))


def _shift(group, ranks, step: int, *tensors):
    """Each tensor sent to the rank ``step`` places on along ``ranks`` and
    received from the one ``step`` places back. gloo sends and receives
    host memory only, so under gloo CUDA tensors travel through host
    copies, as gloo's own all-reduce carries them."""
    me = ranks.index(dist.get_rank())
    n = len(ranks)
    dst, src = ranks[(me + step) % n], ranks[(me - step) % n]
    device = tensors[0].device
    host = device.type == "cuda" and dist.get_backend(group) == "gloo"
    sends = [t.contiguous().cpu() if host else t.contiguous() for t in tensors]
    outs = [torch.empty_like(t) for t in sends]
    ops = [dist.P2POp(dist.isend, t, dst, group) for t in sends]
    ops += [dist.P2POp(dist.irecv, o, src, group) for o in outs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [o.to(device) for o in outs] if host else outs


class _Rotate(torch.autograd.Function):
    """(k, v) to the next rank of the ring; the backward sends their
    gradients to the previous one."""

    @staticmethod
    def forward(ctx, group, ranks, k, v):
        ctx.group, ctx.ranks = group, ranks
        return tuple(_shift(group, ranks, 1, k, v))

    @staticmethod
    def backward(ctx, dk, dv):
        return (None, None, *_shift(ctx.group, ctx.ranks, -1, dk, dv))


def ring_relative_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            e: torch.Tensor, group, ranks, causal: bool = True,
                            pad_keys: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The shard-local body: q, k, v [B, H, C, dh] are this rank's chunk,
    the rank at place i of ``ranks`` (the seq group's global ranks, in
    order) holding positions [i * C, (i + 1) * C); e [max_seq, dh]
    replicated; pad_keys [B, C] this chunk's key pad mask or None. Returns
    the [B, H, C, dh] output chunk, differentiable in q, k, v and e."""
    B, H, C, dh = q.shape
    n = len(ranks)
    me = ranks.index(dist.get_rank()) if n > 1 else 0
    max_seq = e.shape[0]
    e_ext = extend_e(e, n * C)
    pad = pad_keys if pad_keys is not None else torch.zeros((B, C), dtype=torch.bool,
                                                            device=q.device)
    state = ring_state(q)
    for step in range(n):
        src = (me - step) % n  # the owner of the chunk held now
        state = ring_step(q, k, v, pad, e_ext, (me - src) * C, max_seq, causal, state)
        if step != n - 1:
            k, v = _Rotate.apply(group, ranks, k, v)
            pad, = _shift(group, ranks, 1, pad)
    return ring_finish(state, q.dtype)


def ring_attention_one_process(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               e: torch.Tensor, n: int, causal: bool = True,
                               pad_keys: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ring's n steps in one process on GLOBAL [B, H, T, dh] arrays:
    each query chunk i meets the key chunks in the order the ring brings
    them, i, i - 1, ..., through ``ring_step``, as rank i of an n-rank ring
    would. Returns [B, H, T, dh]."""
    B, H, T, dh = q.shape
    if T % n:
        raise ValueError(f"T {T} does not divide into {n} chunks")
    C = T // n
    e_ext = extend_e(e, T)
    pad = pad_keys if pad_keys is not None else torch.zeros((B, T), dtype=torch.bool,
                                                            device=q.device)
    chunk = lambda t, i: t[:, :, i * C:(i + 1) * C]
    outs = []
    for i in range(n):
        state = ring_state(chunk(q, i))
        for step in range(n):
            src = (i - step) % n
            state = ring_step(chunk(q, i), chunk(k, src), chunk(v, src),
                              pad[:, src * C:(src + 1) * C], e_ext, (i - src) * C, e.shape[0],
                              causal, state)
        outs.append(ring_finish(state, q.dtype))
    return torch.cat(outs, dim=2)


def _seq_chunk(t: torch.Tensor, dim: int, i: int, n: int) -> torch.Tensor:
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size)


def ring_global_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, e: torch.Tensor,
                          mesh: Mesh, causal: bool = True,
                          pad_keys: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Ring attention on GLOBAL [B, H, T, dh] arrays, the same on every
    rank: the batch sharded over the mesh's "data" axis and the sequence
    over "seq"; each rank runs the ring on its chunk and the output is
    gathered back over both. T must divide by the seq size, B by the data
    size. Returns the global [B, H, T, dh] output."""
    nd, ns = mesh.shape["data"], mesh.shape["seq"]
    d, s = mesh.coords["data"], mesh.coords["seq"]
    if pad_keys is None:
        pad_keys = torch.zeros((q.shape[0], q.shape[2]), dtype=torch.bool, device=q.device)
    part = lambda t: _seq_chunk(_seq_chunk(t, 0, d, nd), 2, s, ns)
    out = ring_relative_attention(part(q), part(k), part(v), e, mesh.group("seq"),
                                  mesh.ranks("seq"), causal,
                                  _seq_chunk(_seq_chunk(pad_keys, 0, d, nd), 1, s, ns))
    # gather: the chunk along T over seq, then the rows over data
    out = gather_from(out.transpose(2, 3), mesh.group("seq"), s, ns).transpose(2, 3)
    return gather_from(out.movedim(0, -1), mesh.group("data"), d, nd).movedim(-1, 0)


def make_ring_attention(mesh: Mesh, axis: str = "seq", causal: bool = True):
    """fn(q, k, v, e, pad_keys=None) on GLOBAL [B, H, T, dh] arrays with T
    divisible by the size of ``mesh[axis]``: the ring runs over that axis
    (the other axes replicated) and the output is gathered back."""
    n, i = mesh.shape[axis], mesh.coords[axis]
    group, ranks = mesh.group(axis), mesh.ranks(axis)

    def apply(q, k, v, e, pad_keys=None):
        part = lambda t: _seq_chunk(t, 2, i, n)
        pad = None if pad_keys is None else _seq_chunk(pad_keys, 1, i, n)
        out = ring_relative_attention(part(q), part(k), part(v), e, group, ranks, causal, pad)
        return gather_from(out.transpose(2, 3), group, i, n).transpose(2, 3)

    return apply
