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
    is independent of how the kernel is blocked. ``dropout`` draws one call
    per four elements (``tl.randint4x``) and interleaves its words; the row
    kernels pick each element's word from the same call. dgamma/dbeta are
    per-program f32 partials reduced by a second kernel.
"""

from __future__ import annotations

import torch

from .layernorm import check_rows, layernorm_ref, ln_bwd_f32


def keep_threshold(rate: float) -> int:
    """keep iff (bits >> 8) < threshold; P(keep) = threshold / 2**24."""
    if not 0.0 < rate < 1.0:
        raise ValueError(f"dropout rate must lie in (0, 1), got {rate}")
    return round((1.0 - rate) * float(2**24))


def keep_mask(seed: int, shape, rate: float) -> torch.Tensor:
    """The CPU path's keep-mask for ``seed``: 24 random bits per element
    from a CPU ``torch.Generator``, compared with the kernels' threshold.
    Other bits than the kernels' Philox stream, with the same keep
    probability."""
    g = torch.Generator().manual_seed(int(seed))
    bits = torch.randint(0, 2**24, tuple(shape), generator=g, dtype=torch.int32)
    return bits < keep_threshold(rate)


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


def _device_check(name: str, x: torch.Tensor) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")


def _seed(seed) -> int:
    seed = int(seed)
    if not 0 <= seed < 2**31:
        raise ValueError(f"dropout seeds are 31-bit: got {seed}")
    return seed


# ---------------------------------------------------------------------------
# dropout alone (kernel 10)
# ---------------------------------------------------------------------------


def _dropout(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    if x.device.type == "cpu":
        return dropout_plain(x, keep_mask(seed, x.shape, rate), rate)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dropout kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("dropout kernel takes a contiguous x")
    if x.numel() >= 2**31:
        raise ValueError("dropout kernel indexes elements with int32")
    from . import layernorm_triton  # imports triton

    y = torch.empty_like(x)
    if y.numel():
        layernorm_triton.dropout_launch(x, y, seed, keep_threshold(rate), 1.0 / (1.0 - rate))
        fused_dropout.launches += 1
    return y


class _FusedDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed, rate):
        ctx.seed, ctx.rate = seed, rate
        return _dropout(x, seed, rate)

    @staticmethod
    def backward(ctx, g):
        return _dropout(g.contiguous(), ctx.seed, ctx.rate), None, None


def fused_dropout(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """Dropout of x [..., D] with the mask drawn from ``seed`` (31-bit);
    rate in (0, 1). Differentiable in x: the backward draws the same mask
    again. A CUDA tensor launches the kernel in both directions or raises."""
    _device_check("fused_dropout", x)
    keep_threshold(rate)
    return _FusedDropout.apply(x, _seed(seed), rate)


fused_dropout.launches = 0  # kernel launches (forward and backward) since the last reset


# ---------------------------------------------------------------------------
# dropout + residual add + LayerNorm (kernels 11 and 12)
# ---------------------------------------------------------------------------


def _dal_fwd(sub, res, weight, bias, seed, rate, eps):
    if sub.device.type == "cpu":
        keep = keep_mask(seed, sub.shape, rate)
        return dropout_add_layernorm_plain(sub, res, weight, bias, keep, rate, eps)
    check_rows(sub, (weight, bias), (res,))
    from . import layernorm_triton  # imports triton

    y = torch.empty_like(sub)
    if y.numel():
        layernorm_triton.dal_fwd_launch(sub, res, weight, bias, y, eps, seed,
                                        keep_threshold(rate), 1.0 / (1.0 - rate))
        dropout_add_layernorm.launches += 1
    return y


def dropout_add_layernorm_bwd(sub, res, dy, weight, seed: int, rate: float,
                              eps: float = 1e-6):
    """Backward of ``dropout_add_layernorm`` -> (dsub, dres, dweight f32,
    dbias f32), the mask drawn again from ``seed``. On a CUDA tensor this
    launches the Triton kernel or raises; on a CPU tensor it runs the
    twin with ``keep_mask``."""
    _device_check("dropout_add_layernorm_bwd", sub)
    if sub.device.type == "cpu":
        keep = keep_mask(seed, sub.shape, rate)
        return dropout_add_layernorm_bwd_plain(sub, res, dy, weight, keep, rate, eps)
    check_rows(sub, (weight,), (res, dy))
    from . import layernorm_triton  # imports triton

    ds, dr = torch.empty_like(sub), torch.empty_like(res)
    dw, db = layernorm_triton.ln_bwd_launch(
        res, sub, dy, weight, dr, ds, eps, seed, keep_threshold(rate), 1.0 / (1.0 - rate))
    dropout_add_layernorm_bwd.launches += 1
    return ds, dr, dw, db


dropout_add_layernorm_bwd.launches = 0  # kernel launches since the last reset


class _DropoutAddLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sub, res, weight, bias, seed, rate, eps):
        ctx.seed, ctx.rate, ctx.eps = seed, rate, eps
        ctx.save_for_backward(sub, res, weight)
        return _dal_fwd(sub, res, weight, bias, seed, rate, eps)

    @staticmethod
    def backward(ctx, dy):
        sub, res, weight = ctx.saved_tensors
        ds, dr, dw, db = dropout_add_layernorm_bwd(sub, res, dy.contiguous(), weight,
                                                   ctx.seed, ctx.rate, ctx.eps)
        return ds, dr, dw, db, None, None, None


def dropout_add_layernorm(sub: torch.Tensor, res: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor, seed: int, rate: float,
                          eps: float = 1e-6) -> torch.Tensor:
    """LN(res + dropout(sub)) over the last axis; sub and res [..., D] of
    one shape and dtype, weight and bias f32 [D], seed 31-bit, rate in
    (0, 1). Differentiable in sub, res, weight and bias. A CUDA tensor
    launches the kernels in both directions or raises."""
    _device_check("dropout_add_layernorm", sub)
    keep_threshold(rate)
    return _DropoutAddLayerNorm.apply(sub, res, weight, bias, _seed(seed), rate, eps)


dropout_add_layernorm.launches = 0  # forward kernel launches since the last reset
