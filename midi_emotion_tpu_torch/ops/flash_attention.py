"""Flash relative attention, forward and backward: the CUDA kernels and
their plain twins.

Counterpart of ``midi_emotion_tpu/ops/pallas_attention.py``.
``flash_rel_attention`` is a ``torch.autograd.Function``: on a CUDA tensor
its forward launches ``csrc/flash_rel_attn_fwd.cu`` and its backward
``csrc/flash_rel_attn_bwd.cu``, or raises; on a CPU tensor they run
``flash_rel_attention_plain`` and ``flash_rel_attention_bwd_plain``.
Nothing else chooses between them. The forward returns (O, lse) with the
TPU kernel's documented semantics (``pallas_attention.py:482-496``): a
query row whose keys are all masked gives O = 0 and lse = +1e30, where the
closed form in ``ops/attention.py`` gives NaN; its gradients are 0. The
backward returns dQ, dK, dV and dE (lse is not differentiable).

Scale convention: neither direction pre-scales q. The backward folds
c = 1/sqrt(dh) into dS once, so dK, dQ and dE each carry it once (the JAX
backward pre-scales q and fixes dQ up afterwards, ``pallas_attention.py:
1737-1744``). ``dsum = rowsum(dO * O)`` in f32 is plain torch, as it is XLA
work in the JAX package (``pallas_attention.py:1733-1735``).

Source note for the forward kernel:
  * replaces ``pallas_attention.py::_flash_kernel`` (launched by
    ``_flash_fwd_impl`` through ``flash_relative_attention``);
  * bound on the H100: it runs on the CUDA cores at f32, one thread per
    query row, so shared-memory reads and occupancy bound it rather than
    HBM (it reads q, k, v and the E band once per tile pair and writes O
    and lse once);
  * its design: online softmax over 64-key tiles staged in shared memory
    with the E band of the tile pair, Srel folded into the score dot as
    q.(k + E), causal tiles above the diagonal skipped, heaviest query
    tiles first. The TPU kernel's time-on-lanes layout, head/batch
    blocking, strided-rotate skew and E front-padding were Mosaic's needs
    and are not carried over; the CUDA kernel masks its own ragged edge,
    so callers never pad T.

Source note for the backward kernel (details in its source):
  * replaces ``pallas_attention.py::_bwd_merged_kernel`` (the default
    ``BWD_IMPL="merged"``, launched by ``_bwd_merged_call``);
  * bound on the H100: CUDA-core f32 FMAs fed from shared memory;
  * its design: one 256-thread block per (b, h) sweeps key tiles and,
    inside, query tiles, as the TPU's sequential grid did, so dQ (an f32
    scratch) and dE (an f32 partial per (b, h), reduced by a second kernel)
    each have one owner: no atomics, deterministic sums, nothing summed in
    bf16.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from .attention import rel_position_bias

KERNEL_DHS = (16, 32, 48, 64)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _masked(T: int, causal: bool, pad_keys: Optional[torch.Tensor], device) -> torch.Tensor:
    """[B or 1, 1, T, T] bool, True where query i may not see key j."""
    masked = torch.zeros((1, 1, T, T), dtype=torch.bool, device=device)
    if causal:
        masked = torch.ones((T, T), dtype=torch.bool, device=device).triu(1)[None, None]
    if pad_keys is not None:
        masked = masked | pad_keys[:, None, None, :]
    return masked


def flash_rel_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    e: torch.Tensor,
    causal: bool = True,
    pad_keys: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's math in plain torch, in f32 whatever the input type.

    q, k, v: [B, H, T, dh]; e: [max_seq, dh]; pad_keys: [B, T] bool (True
    = pad key) or None. Returns (O [B, H, T, dh] in q's dtype, lse
    [B, H, T] f32)."""
    dh = q.shape[-1]
    T = q.shape[2]
    qf, kf, vf = q.float(), k.float(), v.float()
    s = (qf @ kf.transpose(-1, -2) + rel_position_bias(qf, e.float())) / math.sqrt(dh)
    s = s.masked_fill(_masked(T, causal, pad_keys, q.device), float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)  # all-masked rows
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    live = l > 0
    out = (p @ vf) / torch.where(live, l, torch.ones_like(l))
    lse = torch.where(live, m + torch.log(l), torch.full_like(l, 1e30))
    return out.to(q.dtype), lse[..., 0]


def flash_rel_attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    e: torch.Tensor,
    causal: bool,
    pad_keys: Optional[torch.Tensor],
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's math in plain torch, in f32: P recomputed from
    the saved lse, explicit formulas for dV, dK and dQ's key term, and
    autograd through ``rel_position_bias`` for the relative term's dQ and
    dE. Returns (dq, dk, dv, de) in the inputs' dtypes."""
    dh = q.shape[-1]
    c = 1.0 / math.sqrt(dh)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    with torch.enable_grad():
        q_leaf = qf.detach().requires_grad_()
        e_leaf = e.float().detach().requires_grad_()
        srel = rel_position_bias(q_leaf, e_leaf)
    s = (qf @ kf.transpose(-1, -2) + srel.detach()) * c
    p = torch.exp(s - lse[..., None]).masked_fill(_masked(q.shape[2], causal, pad_keys, q.device), 0)
    dsum = (dof * o.float()).sum(-1, keepdim=True)
    ds = p * (dof @ vf.transpose(-1, -2) - dsum) * c
    dq_rel, de = torch.autograd.grad(srel, (q_leaf, e_leaf), ds)
    dq = ds @ kf + dq_rel
    dk = ds.transpose(-1, -2) @ qf
    dv = p.transpose(-1, -2) @ dof
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), de.to(e.dtype)


_N_POINTERS = {"flash_rel_attn_fwd": 7, "flash_rel_attn_bwd": 14}  # then 7 ints, a stream


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    from ..kernels.build import cuda_library

    lib = cuda_library(name)
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * _N_POINTERS[name] + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, e, pad_keys):
    if not all(t.is_cuda and t.device == q.device for t in (k, v, e)):
        raise ValueError("q, k, v and e must lie on the same CUDA device")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash kernel takes float32 or bfloat16, got {q.dtype}")
    if any(t.dtype != q.dtype for t in (k, v, e)):
        raise TypeError("q, k, v and e must share one dtype")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be [B, H, T, dh] alike: {q.shape}, {k.shape}, {v.shape}")
    B, H, T, dh = q.shape
    if dh not in KERNEL_DHS:
        raise ValueError(f"flash kernel takes d_head in {KERNEL_DHS}, got {dh}")
    if e.dim() != 2 or e.shape[1] != dh or T > e.shape[0]:
        raise ValueError(f"e must be [max_seq >= T, dh]: e {tuple(e.shape)}, T {T}")
    if pad_keys is not None:
        if pad_keys.dtype != torch.bool or pad_keys.shape != (B, T):
            raise ValueError(f"pad_keys must be bool [B, T], got {pad_keys.dtype} {tuple(pad_keys.shape)}")
        if pad_keys.device != q.device or not pad_keys.is_contiguous():
            raise ValueError("pad_keys must be contiguous on q's device")
    if not all(t.is_contiguous() for t in (q, k, v, e)):
        raise ValueError("q, k, v and e must be contiguous")


def _launch(name: str, *args) -> None:
    lib = _library(name)
    rc = getattr(lib, name)(*args)
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _fwd(q, k, v, e, causal, pad_keys):
    if q.device.type == "cpu":
        return flash_rel_attention_plain(q, k, v, e, causal, pad_keys)
    _check(q, k, v, e, pad_keys)
    B, H, T, dh = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    _launch("flash_rel_attn_fwd",
            q.data_ptr(), k.data_ptr(), v.data_ptr(), e.data_ptr(), _ptr(pad_keys),
            o.data_ptr(), lse.data_ptr(),
            B, H, T, dh, e.shape[0], int(causal), _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    flash_rel_attention.launches += 1
    return o, lse


def flash_rel_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    e: torch.Tensor,
    causal: bool,
    pad_keys: Optional[torch.Tensor],
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of ``flash_rel_attention`` -> (dq, dk, dv, de) from the
    forward's inputs, its (O, lse) and the cotangent dO. On a CUDA tensor
    this launches the hand-written kernel or raises; on a CPU tensor it
    runs :func:`flash_rel_attention_bwd_plain`."""
    if q.device.type == "cpu":
        return flash_rel_attention_bwd_plain(q, k, v, e, causal, pad_keys, o, lse, do)
    if q.device.type != "cuda":
        raise ValueError(f"flash_rel_attention_bwd: unsupported device {q.device}")
    _check(q, k, v, e, pad_keys)
    B, H, T, dh = q.shape
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous and match q: {t.dtype} {tuple(t.shape)}")
    if lse.shape != (B, H, T) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous f32 [B, H, T], got {lse.dtype} {tuple(lse.shape)}")
    dsum = (do.float() * o.float()).sum(-1)  # [B, H, T] f32
    dq, dk, dv, de = (torch.empty_like(t) for t in (q, k, v, e))
    dq_acc = torch.empty((B, H, T, dh), dtype=torch.float32, device=q.device)
    de_part = torch.empty((B * H, T, dh), dtype=torch.float32, device=q.device)
    _launch("flash_rel_attn_bwd",
            q.data_ptr(), k.data_ptr(), v.data_ptr(), e.data_ptr(), _ptr(pad_keys),
            do.data_ptr(), lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), de.data_ptr(), dq_acc.data_ptr(), de_part.data_ptr(),
            B, H, T, dh, e.shape[0], int(causal), _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    flash_rel_attention_bwd.launches += 1
    return dq, dk, dv, de


flash_rel_attention_bwd.launches = 0  # kernel launches since the last reset


class _FlashRelAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, e, causal, pad_keys):
        o, lse = _fwd(q, k, v, e, causal, pad_keys)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, e, pad_keys, o, lse)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, e, pad_keys, o, lse = ctx.saved_tensors
        dq, dk, dv, de = flash_rel_attention_bwd(q, k, v, e, ctx.causal, pad_keys, o, lse,
                                                 do.contiguous())
        return dq, dk, dv, de, None, None


def flash_rel_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    e: torch.Tensor,
    causal: bool = True,
    pad_keys: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Relative attention -> (O [B, H, T, dh], lse [B, H, T] f32),
    differentiable in q, k, v and e.

    On a CUDA tensor both directions launch the hand-written kernels or
    raise; on a CPU tensor they run the plain twins."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_rel_attention: unsupported device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, e)):
        return _FlashRelAttention.apply(q, k, v, e, causal, pad_keys)
    return _fwd(q, k, v, e, causal, pad_keys)  # no autograd node to build


flash_rel_attention.launches = 0  # forward kernel launches since the last reset
