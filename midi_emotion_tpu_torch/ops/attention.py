"""Relative global attention (Music Transformer, Huang et al. 2018), torch.

Counterpart of ``midi_emotion_tpu/ops/attention.py``, with the same closed
form for the relative-position term:

    Srel[b,h,i,j] = q[b,h,i] . E[max_seq - 1 - (i - j)]   for j <= i
    Srel[b,h,i,j] = 0                                      for j >  i

(the table is indexed from its end, so short sequences use its last rows:
the reference's quirk, kept). Heads are [B, H, T, dh] at every public
function, and the decode cache is time-major [B, W, H*dh], as in the JAX
package.

``impl`` selects the prefill attention: "kernel" is the hand-written flash
kernel (``ops/flash_attention.py``), "plain" the closed form below, and
"auto" picks the kernel for a CUDA tensor and the closed form for a CPU
one. "ring" is the sequence-sharded ring of ``parallel/ring_attention.py``,
which the model runs on a mesh with a seq axis; this module's
``relative_attention`` does not take it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

ATTN_IMPLS = ("auto", "kernel", "plain", "ring")


def resolve_attn_impl(impl: str, device: torch.device) -> str:
    """"auto" -> "kernel" on a CUDA device, "plain" elsewhere."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {impl!r}")
    if impl != "auto":
        return impl
    return "kernel" if torch.device(device).type == "cuda" else "plain"


def rel_position_bias(q: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Closed-form Srel: q [B, H, L, dh], e [max_seq, dh] -> [B, H, L, L],
    by the reference's qe-masking and pad-reshape skew."""
    B, H, L, _ = q.shape
    max_seq = e.shape[0]
    qe = torch.einsum("bhld,md->bhlm", q, e[max_seq - L:])  # [B, H, L, L]
    # qe-masking: column m survives iff m >= L - 1 - l
    l_idx = torch.arange(L, device=q.device)[:, None]
    m_idx = torch.arange(L, device=q.device)[None, :]
    qe = qe.masked_fill(m_idx < L - 1 - l_idx, 0)
    padded = F.pad(qe, (1, 0))  # [B, H, L, L + 1]
    return padded.reshape(B, H, L + 1, L)[:, :, 1:, :]


def relative_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    e: torch.Tensor,
    causal: bool = True,
    pad_keys: Optional[torch.Tensor] = None,
    impl: str = "plain",
) -> torch.Tensor:
    """Full-sequence relative attention.

    q, k, v: [B, H, L, dh]; e: [max_seq, dh]; pad_keys: [B, L] bool, True
    where the KEY is pad. ``causal=False`` only for the regression model.
    Returns [B, H, L, dh]. The "plain" path gives NaN on a query row whose
    keys are all masked, as the JAX closed form does; the kernel gives 0.
    """
    impl = resolve_attn_impl(impl, q.device)
    if impl == "kernel":
        from .flash_attention import flash_rel_attention

        return flash_rel_attention(q, k, v, e, causal, pad_keys)[0]
    if impl == "ring":
        raise ValueError("impl 'ring' runs in the model on a seq mesh axis "
                         "(parallel/ring_attention.py), not on whole arrays")

    L, dh = q.shape[2], q.shape[-1]
    srel = rel_position_bias(q, e)
    logits = (q @ k.transpose(-1, -2) + srel) / math.sqrt(dh)
    mask = None
    if causal:
        mask = torch.ones((L, L), dtype=torch.bool, device=q.device).triu(1)[None, None]
    if pad_keys is not None:
        pmask = pad_keys[:, None, None, :]
        mask = pmask if mask is None else mask | pmask
    if mask is not None:
        logits = logits.masked_fill(mask, float("-inf"))
    return torch.softmax(logits, dim=-1) @ v


def decode_rel_attention(
    q_t: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    e: torch.Tensor,
    length: int,
) -> torch.Tensor:
    """One-token attention against a KV cache.

    The query sits at window position ``length - 1`` and attends to cache
    rows 0..length-1; its relative bias for key j is q . E[max_seq - length
    + j], the last ``length`` rows of the table. Only the live rows are
    read: rows past ``length`` would be masked anyway.

    q_t: [B, H, dh]; k_cache, v_cache: [B, W, H*dh] time-major, head h in
    columns [h*dh, (h+1)*dh); e: [max_seq, dh]; length: live rows, the
    current token's included. Returns [B, H, dh] in the cache's dtype.
    Scores and softmax run in f32, as in the JAX package.
    """
    B, H, dh = q_t.shape
    max_seq = e.shape[0]
    kh = k_cache[:, :length].unflatten(-1, (H, dh))  # [B, length, H, dh]
    vh = v_cache[:, :length].unflatten(-1, (H, dh))
    scores = torch.einsum("bwhd,bhd->bwh", kh, q_t)
    bias = torch.einsum("bhd,wd->bwh", q_t, e[max_seq - length:])
    logits = (scores.float() + bias.float()) / math.sqrt(dh)
    weights = torch.softmax(logits, dim=1)  # over the cache rows
    out = torch.einsum("bwh,bwhd->bhd", weights.to(v_cache.dtype), vh)
    return out.to(k_cache.dtype)


def causal_pad_mask(tokens: torch.Tensor, pad_id: int) -> torch.Tensor:
    """Reference generate_mask: [B, L, L] bool, True where key j is in the
    future (j > i) or tokens[b, j] is pad."""
    L = tokens.shape[1]
    causal = torch.ones((L, L), dtype=torch.bool, device=tokens.device).triu(1)
    return causal[None] | (tokens == pad_id)[:, None, :]
