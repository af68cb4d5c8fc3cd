"""Dropout, and dropout + residual add + LayerNorm, with the mask drawn
inside the kernel: the Triton kernels, their plain twins, and the autograd
functions.

Counterpart of ``midi_emotion_tpu/ops/fused_dropout.py`` and
``ops/dropout.py``:

* ``fused_dropout(x, seed, rate)`` = where(keep, x / (1 - rate), 0), the
  embedding dropout site (reference music_multi.py:101). Its backward is
  the same kernel, which draws the same mask again from the seed.
* ``dropout_add_layernorm(sub, res, weight, bias, seed, rate)`` =
  LN(res + dropout(sub)), the two per-layer sites (music_multi.py:103,
  131-135); its backward replays the mask inside the LayerNorm backward.

Semantics: ``x / (1 - rate)`` is computed as x * (1 / (1 - rate)) in f32
and rounded to x's type; the residual add runs in the input type and the
LayerNorm statistics in f32, as in the JAX kernels. Only the seed crosses
from the forward to the backward: no mask is saved.

On a CUDA tensor each function launches its Triton kernel
(``ops/layernorm_triton.py``) or raises. The JAX ``fusable()`` rule (rows
>= 512, D % 128 == 0) answered Mosaic's launch cost and does not carry
over: every shape runs the kernel. On a CPU tensor the mask comes from
``keep_mask`` and the plain twins do the math. The two masks are different
bits, as the JAX package's own paths are (its ``fused_dropout.py:32-36``):
the twins take the keep-mask as an explicit tensor, so a test can hold the
math exactly with an injected mask, and the card check recovers the
kernel's mask and hands it to the twin.

Source notes for the kernels:
  * ``dropout`` replaces ``fused_dropout.py::_drop_kernel`` (``_drop_call``),
    ``dal_fwd`` replaces ``_dal_fwd_kernel`` (``_dal_fwd``) and ``ln_bwd``
    with ``HAS_DROPOUT`` replaces ``_dal_bwd_kernel`` (``_dal_bwd``);
  * bound on the H100: HBM bandwidth, one read of each [N, D] input and
    one write of each output; the mask costs Philox arithmetic in
    registers, no memory;
  * design: the TPU's hardware PRNG, seeded per 256-row block, becomes
    counter-based Philox4x32-10 keyed by (seed, flat element index i):
    element i takes word i % 4 of the call at counter i // 4, so the mask
    is independent of how the kernel is blocked. ``dropout``, and ``ln_bwd``
    when D % 4 == 0, draw one call per four elements (``tl.randint4x``) and
    interleave its words; ``dal_fwd``, and ``ln_bwd`` at other D, pick each
    element's word from its own draw of the same call. dgamma/dbeta are
    per-program f32 partials reduced in program order by a second kernel.

Under a mesh every rank draws the same seeds, so a rank's slice of an
activation must draw its slice of the global mask, or two data-parallel
ranks would drop the same pattern on different rows. Each function takes
``place = (b0, t0, T_g)``: the local [B, T, D] tensor is rows b0.. and
positions t0.. of a global [., T_g, D] one, and element (b, t, d) draws at
global index ((b0 + b) * T_g + t0 + t) * D + d. ``None`` (the default)
is place (0, 0, T): every bit as before. Tensor-parallel ranks hold the
whole activation and pass the default.
"""

from __future__ import annotations

import torch

from .layernorm import check_rows, layernorm_ref, ln_bwd_f32


def keep_threshold(rate: float) -> int:
    """keep iff (bits >> 8) < threshold; P(keep) = threshold / 2**24."""
    if not 0.0 < rate < 1.0:
        raise ValueError(f"dropout rate must lie in (0, 1), got {rate}")
    return round((1.0 - rate) * float(2**24))


def check_place(x: torch.Tensor, place):
    """``place`` -> (b0, t0, T, T_g) for the kernels, or None for the
    default place, where local and global indices agree."""
    if place is None:
        return None
    b0, t0, T_g = (int(v) for v in place)
    if x.dim() != 3:
        raise ValueError(f"a dropout place needs a [B, T, D] tensor, got shape {tuple(x.shape)}")
    B, T, D = x.shape
    if b0 < 0 or t0 < 0 or t0 + T > T_g:
        raise ValueError(f"place {place} does not hold a slice of [{B}, {T}, {D}]")
    if (b0 + B) * T_g * D >= 2**31:
        raise ValueError("the dropout kernels index the global tensor with int32")
    if b0 == 0 and t0 == 0 and T_g == T:
        return None
    return b0, t0, T, T_g


def keep_mask(seed: int, shape, rate: float, place=None) -> torch.Tensor:
    """The CPU path's keep-mask for ``seed``: 24 random bits per element
    from a CPU ``torch.Generator``, compared with the kernels' threshold.
    Other bits than the kernels' Philox stream, with the same keep
    probability. With a ``place`` (b0, t0, T_g) the mask is the slice of
    the one drawn for the global tensor (the generator fills elements in
    flat order, so the rows past b0 + B need not be drawn)."""
    g = torch.Generator().manual_seed(int(seed))
    if place is None:
        bits = torch.randint(0, 2**24, tuple(shape), generator=g, dtype=torch.int32)
        return bits < keep_threshold(rate)
    B, T, D = shape
    b0, t0, T_g = place
    bits = torch.randint(0, 2**24, (b0 + B, T_g, D), generator=g, dtype=torch.int32)
    return (bits[b0:, t0:t0 + T] < keep_threshold(rate)).contiguous()


def dropout_plain(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """where(keep, x * (1 / (1 - rate)), 0), the product in f32 rounded to
    x's type: the twin of the dropout kernel."""
    return torch.where(keep, x.float() * (1.0 / (1.0 - rate)), 0.0).to(x.dtype)


def dropout_add_layernorm_plain(sub, res, weight, bias, keep, rate: float,
                                eps: float = 1e-6) -> torch.Tensor:
    """LN(res + dropout(sub)) with an explicit keep-mask: the twin of
    ``dal_fwd``."""
    return layernorm_ref(res + dropout_plain(sub, keep, rate), weight, bias, eps)


def dropout_add_layernorm_bwd_plain(sub, res, dy, weight, keep, rate: float,
                                    eps: float = 1e-6):
    """The twin of ``ln_bwd`` with the mask replayed -> (dsub, dres,
    dweight f32, dbias f32)."""
    D = sub.shape[-1]
    x = (res + dropout_plain(sub, keep, rate)).float().reshape(-1, D)
    dx, dw, db = ln_bwd_f32(x, dy.float().reshape(-1, D), weight, eps)
    dx = dx.reshape(sub.shape)
    ds = torch.where(keep, dx * (1.0 / (1.0 - rate)), 0.0)
    return ds.to(sub.dtype), dx.to(res.dtype), dw, db


def _device_check(name: str, *ts: torch.Tensor) -> None:
    """The device, and the kernels' contiguous layout on every device, so
    that the CPU twins refuse what the card would."""
    if ts[0].device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {ts[0].device}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name} takes contiguous tensors")


def _seed(seed) -> int:
    seed = int(seed)
    if not 0 <= seed < 2**31:
        raise ValueError(f"dropout seeds are 31-bit: got {seed}")
    return seed


# ---------------------------------------------------------------------------
# dropout alone (kernel 10)
# ---------------------------------------------------------------------------


def _dropout(x: torch.Tensor, seed: int, rate: float, place=None) -> torch.Tensor:
    kplace = check_place(x, place)
    if x.device.type == "cpu":
        return dropout_plain(x, keep_mask(seed, x.shape, rate, place), rate)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dropout kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("dropout kernel takes a contiguous x")
    if x.numel() >= 2**31:
        raise ValueError("dropout kernel indexes elements with int32")
    from . import layernorm_triton  # imports triton

    y = torch.empty_like(x)
    if y.numel():
        layernorm_triton.dropout_launch(x, y, seed, keep_threshold(rate), 1.0 / (1.0 - rate),
                                        kplace)
        fused_dropout.launches += 1
    return y


class _FusedDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed, rate, place):
        ctx.seed, ctx.rate, ctx.place = seed, rate, place
        return _dropout(x, seed, rate, place)

    @staticmethod
    def backward(ctx, g):
        return _dropout(g.contiguous(), ctx.seed, ctx.rate, ctx.place), None, None, None


def fused_dropout(x: torch.Tensor, seed: int, rate: float, place=None) -> torch.Tensor:
    """Dropout of x [..., D] with the mask drawn from ``seed`` (31-bit);
    rate in (0, 1); ``place`` (b0, t0, T_g) as in the module's notes.
    Differentiable in x: the backward draws the same mask again. A CUDA
    tensor launches the kernel in both directions or raises."""
    _device_check("fused_dropout", x)
    keep_threshold(rate)
    check_place(x, place)
    return _FusedDropout.apply(x, _seed(seed), rate, place)


fused_dropout.launches = 0  # kernel launches (forward and backward) since the last reset


# ---------------------------------------------------------------------------
# dropout + residual add + LayerNorm (kernels 11 and 12)
# ---------------------------------------------------------------------------


def _dal_fwd(sub, res, weight, bias, seed, rate, eps, place=None):
    kplace = check_place(sub, place)
    if sub.device.type == "cpu":
        keep = keep_mask(seed, sub.shape, rate, place)
        return dropout_add_layernorm_plain(sub, res, weight, bias, keep, rate, eps)
    check_rows(sub, (weight, bias), (res,))
    from . import layernorm_triton  # imports triton

    y = torch.empty_like(sub)
    if y.numel():
        layernorm_triton.dal_fwd_launch(sub, res, weight, bias, y, eps, seed,
                                        keep_threshold(rate), 1.0 / (1.0 - rate), kplace)
        dropout_add_layernorm.launches += 1
    return y


def dropout_add_layernorm_bwd(sub, res, dy, weight, seed: int, rate: float,
                              eps: float = 1e-6, place=None):
    """Backward of ``dropout_add_layernorm`` -> (dsub, dres, dweight f32,
    dbias f32), the mask drawn again from ``seed`` at ``place``. On a CUDA
    tensor this launches the Triton kernel or raises; on a CPU tensor it
    runs the twin with ``keep_mask``."""
    _device_check("dropout_add_layernorm_bwd", sub, res, dy)
    kplace = check_place(sub, place)
    if sub.device.type == "cpu":
        keep = keep_mask(seed, sub.shape, rate, place)
        return dropout_add_layernorm_bwd_plain(sub, res, dy, weight, keep, rate, eps)
    check_rows(sub, (weight,), (res, dy))
    from . import layernorm_triton  # imports triton

    ds, dr = torch.empty_like(sub), torch.empty_like(res)
    dw, db = layernorm_triton.ln_bwd_launch(
        res, sub, dy, weight, dr, ds, eps, seed, keep_threshold(rate), 1.0 / (1.0 - rate),
        place=kplace)
    dropout_add_layernorm_bwd.launches += 1
    return ds, dr, dw, db


dropout_add_layernorm_bwd.launches = 0  # kernel launches since the last reset


class _DropoutAddLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sub, res, weight, bias, seed, rate, eps, place):
        ctx.seed, ctx.rate, ctx.eps, ctx.place = seed, rate, eps, place
        ctx.save_for_backward(sub, res, weight)
        return _dal_fwd(sub, res, weight, bias, seed, rate, eps, place)

    @staticmethod
    def backward(ctx, dy):
        sub, res, weight = ctx.saved_tensors
        ds, dr, dw, db = dropout_add_layernorm_bwd(sub, res, dy.contiguous(), weight,
                                                   ctx.seed, ctx.rate, ctx.eps, ctx.place)
        return ds, dr, dw, db, None, None, None, None


def dropout_add_layernorm(sub: torch.Tensor, res: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor, seed: int, rate: float,
                          eps: float = 1e-6, place=None) -> torch.Tensor:
    """LN(res + dropout(sub)) over the last axis; sub and res [..., D] of
    one shape and dtype, weight and bias f32 [D], seed 31-bit, rate in
    (0, 1), ``place`` (b0, t0, T_g) as in the module's notes.
    Differentiable in sub, res, weight and bias. A CUDA tensor launches the
    kernels in both directions or raises."""
    _device_check("dropout_add_layernorm", sub, res)
    keep_threshold(rate)
    check_place(sub, place)
    return _DropoutAddLayerNorm.apply(sub, res, weight, bias, _seed(seed), rate, eps, place)


dropout_add_layernorm.launches = 0  # forward kernel launches since the last reset
