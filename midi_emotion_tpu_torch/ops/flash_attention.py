"""Flash relative attention, forward: the CUDA kernel and its plain twin.

Counterpart of ``midi_emotion_tpu/ops/pallas_attention.py``. The wrapper
``flash_rel_attention`` launches ``csrc/flash_rel_attn_fwd.cu`` on a CUDA
tensor and runs ``flash_rel_attention_plain`` on a CPU tensor; nothing
else chooses between them. Both return (O, lse) with the TPU kernel's
semantics (``pallas_attention.py:482-496``): a query row whose keys are all
masked gives O = 0 and lse = +1e30, where the closed form in
``ops/attention.py`` gives NaN.

Source note for the kernel:
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
    masked = torch.zeros((1, 1, T, T), dtype=torch.bool, device=q.device)
    if causal:
        masked = torch.ones((T, T), dtype=torch.bool, device=q.device).triu(1)[None, None]
    if pad_keys is not None:
        masked = masked | pad_keys[:, None, None, :]
    s = s.masked_fill(masked, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)  # all-masked rows
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    live = l > 0
    out = (p @ vf) / torch.where(live, l, torch.ones_like(l))
    lse = torch.where(live, m + torch.log(l), torch.full_like(l, 1e30))
    return out.to(q.dtype), lse[..., 0]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from ..kernels.build import cuda_library

    lib = cuda_library("flash_rel_attn_fwd")
    fn = lib.flash_rel_attn_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.flash_rel_attn_error_string.argtypes = [ctypes.c_int]
    lib.flash_rel_attn_error_string.restype = ctypes.c_char_p
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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, e)):
        raise RuntimeError(
            "the flash kernel has no backward yet (ROADMAP queue 1, item 2: "
            "training, with kernel 4): "
            "run it under torch.inference_mode() or torch.no_grad()"
        )


def flash_rel_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    e: torch.Tensor,
    causal: bool = True,
    pad_keys: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Relative attention forward -> (O [B, H, T, dh], lse [B, H, T] f32).

    On a CUDA tensor this launches the hand-written kernel or raises; on a
    CPU tensor it runs :func:`flash_rel_attention_plain`."""
    if q.device.type == "cpu":
        return flash_rel_attention_plain(q, k, v, e, causal, pad_keys)
    if q.device.type != "cuda":
        raise ValueError(f"flash_rel_attention: unsupported device {q.device}")
    _check(q, k, v, e, pad_keys)
    B, H, T, dh = q.shape
    lib = _library()
    o = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_rel_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), e.data_ptr(),
        None if pad_keys is None else pad_keys.data_ptr(),
        o.data_ptr(), lse.data_ptr(),
        B, H, T, dh, e.shape[0], int(causal), _DTYPE_CODES[q.dtype], stream,
    )
    if rc != 0:
        msg = lib.flash_rel_attn_error_string(rc).decode()
        raise RuntimeError(f"flash_rel_attn_fwd launch failed: CUDA error {rc} ({msg})")
    flash_rel_attention.launches += 1
    return o, lse


flash_rel_attention.launches = 0  # kernel launches since the last reset
