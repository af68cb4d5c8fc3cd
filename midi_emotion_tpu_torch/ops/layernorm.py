"""LayerNorm forward and backward: the Triton kernels, their plain twins,
and the module.

Counterpart of ``midi_emotion_tpu/ops/layernorm.py``. LayerNorm over the
last axis with f32 statistics, eps 1e-6, output cast back to the input
dtype; weight and bias (the reference's names) stay f32.

``layernorm`` is a ``torch.autograd.Function``. On a CUDA tensor its
forward launches the Triton forward kernel and its backward the Triton
backward kernel, for every row count, or raises; on a CPU tensor both
directions run the plain twins (``layernorm_ref``, ``layernorm_bwd_ref``).
The TPU dispatch rule (kernel only for rows >= 512 and D % 128 == 0)
answered Mosaic's launch overhead and does not carry over, so the
one-token decode LNs run the kernel too.

Source notes for the kernels (``ops/layernorm_triton.py``):
  * forward: replaces ``layernorm.py::_fwd_kernel`` (``_fused_fwd``); one
    program per row, the whole row (D = 768 in a 1024-wide masked block)
    in registers, mean and variance in f32 from that one read;
  * backward: replaces ``layernorm.py::_bwd_kernel`` (``_fused_bwd``): dx,
    dgamma and dbeta in one pass over (x, dy), the statistics recomputed
    from x as the TPU kernel does. The TPU summed dgamma/dbeta in VMEM
    across its sequential grid; on the GPU four programs an SM each take
    tiles of two rows round the card, loading the next tiles under this
    one's reductions, and sum their rows into an f32 partial
    [n_programs, D]; a second small kernel reduces the partials in program
    order, so no sum goes through bf16 or an atomic;
  * bound on the H100: HBM bandwidth. Neither does tensor-core work; each
    [N, D] input is read once and each output written once.
"""

from __future__ import annotations

import torch
import torch.nn as nn


def layernorm_ref(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Plain torch closed form (f32 statistics): the CPU path and the
    forward kernel's oracle."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def ln_bwd_f32(xf: torch.Tensor, dyf: torch.Tensor, weight: torch.Tensor, eps: float):
    """The backward kernel's math on f32 rows [N, D]: (dx f32 [N, D],
    dweight [D], dbias [D]), the statistics recomputed from x."""
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    rs = torch.rsqrt(var + eps)
    xhat = xc * rs
    wdy = dyf * weight.float()
    c1 = wdy.mean(dim=-1, keepdim=True)
    c2 = (wdy * xhat).mean(dim=-1, keepdim=True)
    return (wdy - c1 - xhat * c2) * rs, (dyf * xhat).sum(0), dyf.sum(0)


def layernorm_bwd_ref(x: torch.Tensor, dy: torch.Tensor, weight: torch.Tensor,
                      eps: float = 1e-6):
    """Plain twin of the backward kernel -> (dx in x's dtype, dweight f32,
    dbias f32)."""
    D = x.shape[-1]
    dx, dw, db = ln_bwd_f32(x.float().reshape(-1, D), dy.float().reshape(-1, D), weight, eps)
    return dx.to(x.dtype).reshape(x.shape), dw, db


def check_rows(x: torch.Tensor, params, rows=()) -> None:
    """The kernels' input contract: x [..., D] f32 or bf16, contiguous;
    each of ``params`` contiguous f32 [D]; each of ``rows`` x's shape and
    dtype, contiguous."""
    D = x.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"layernorm kernels take float32 or bfloat16, got {x.dtype}")
    for p in params:
        if (p.device != x.device or p.dtype != torch.float32 or p.shape != (D,)
                or not p.is_contiguous()):
            raise ValueError(f"weight and bias must be contiguous f32 [{D}] on {x.device}, "
                             f"got {p.dtype} {tuple(p.shape)} on {p.device}")
    for t in (x, *rows):
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"row tensors must match x: {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("x and the other row tensors must be contiguous")
    if D > 8192:
        raise ValueError(f"layernorm kernels hold a row in registers: D={D} > 8192")
    if x.numel() >= 2**31:
        raise ValueError("layernorm kernels index elements with int32")


def _device_check(name: str, x: torch.Tensor) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")


def _fwd(x, weight, bias, eps):
    if x.device.type == "cpu":
        return layernorm_ref(x, weight, bias, eps)
    check_rows(x, (weight, bias))
    from . import layernorm_triton  # imports triton

    y = torch.empty_like(x)
    if y.numel():
        layernorm_triton.ln_fwd_launch(x, weight, bias, y, eps)
        layernorm.launches += 1
    return y


def layernorm_bwd(x: torch.Tensor, dy: torch.Tensor, weight: torch.Tensor,
                  eps: float = 1e-6):
    """Backward of ``layernorm`` -> (dx, dweight f32, dbias f32). On a CUDA
    tensor this launches the Triton backward kernel or raises; on a CPU
    tensor it runs :func:`layernorm_bwd_ref`."""
    _device_check("layernorm_bwd", x)
    if x.device.type == "cpu":
        return layernorm_bwd_ref(x, dy, weight, eps)
    check_rows(x, (weight,), (dy,))
    from . import layernorm_triton  # imports triton

    dx = torch.empty_like(x)
    dw, db = layernorm_triton.ln_bwd_launch(x, None, dy, weight, dx, None, eps)
    layernorm_bwd.launches += 1
    return dx, dw, db


layernorm_bwd.launches = 0  # kernel launches since the last reset


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, weight)
        return _fwd(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx, dw, db = layernorm_bwd(x, dy.contiguous(), weight, ctx.eps)
        return dx, dw, db, None


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis of x [..., D], differentiable in x,
    weight and bias. On a CUDA tensor both directions launch the Triton
    kernels or raise; on a CPU tensor they run the plain twins."""
    _device_check("layernorm", x)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _LayerNorm.apply(x, weight, bias, eps)
    return _fwd(x, weight, bias, eps)  # no autograd node to build


layernorm.launches = 0  # forward kernel launches since the last reset


class LayerNorm(nn.Module):
    """LayerNorm with f32 ``weight``/``bias`` (the reference's names) whose
    output keeps the input dtype."""

    def __init__(self, d: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(d, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm(x, self.weight, self.bias, self.eps)
