"""LayerNorm forward: the Triton kernel, its plain twin, and the module.

Counterpart of ``midi_emotion_tpu/ops/layernorm.py``. LayerNorm over the
last axis with f32 statistics, eps 1e-6, output cast back to the input
dtype; weight and bias (the reference's names) stay f32.

``layernorm`` launches the Triton kernel on a CUDA tensor, for every row
count, and runs ``layernorm_ref`` on a CPU tensor. The TPU dispatch rule
(kernel only for rows >= 512 and D % 128 == 0) answered Mosaic's launch
overhead and does not carry over, so the one-token decode LNs run the
kernel too.

Source note for the kernel:
  * replaces ``layernorm.py::_fwd_kernel`` (launched by ``_fused_fwd``
    through ``fused_layernorm`` / ``layernorm()``);
  * bound on the H100: HBM bandwidth. It does no tensor-core work, and
    each row is read once and written once;
  * its design: one program per row, the whole row (D = 768 in a
    1024-wide masked block) in registers, mean and variance in f32 from
    that one read. The TPU kernel's 256-row blocks and row padding are not
    needed: the mask covers the ragged width and every row is its own
    program.
"""

from __future__ import annotations

import torch
import torch.nn as nn


def layernorm_ref(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Plain torch closed form (f32 statistics): the CPU path and the
    kernel's oracle."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def _check(x, weight, bias):
    D = x.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"layernorm kernel takes float32 or bfloat16, got {x.dtype}")
    for name, p in (("weight", weight), ("bias", bias)):
        if p.device != x.device or p.dtype != torch.float32 or p.shape != (D,):
            raise ValueError(f"{name} must be f32 [{D}] on {x.device}, got "
                             f"{p.dtype} {tuple(p.shape)} on {p.device}")
        if not p.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if D > 8192:
        raise ValueError(f"layernorm kernel holds a row in registers: D={D} > 8192")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, weight, bias)):
        raise RuntimeError(
            "the layernorm kernel has no backward yet (ROADMAP queue 1, item 2: "
            "training, with kernel 3): run it under torch.inference_mode() or "
            "torch.no_grad()"
        )


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis of x [..., D]. On a CUDA tensor this
    launches the Triton kernel or raises; on a CPU tensor it runs
    :func:`layernorm_ref`."""
    if x.device.type == "cpu":
        return layernorm_ref(x, weight, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layernorm: unsupported device {x.device}")
    _check(x, weight, bias)
    from . import layernorm_triton  # imports triton

    y = torch.empty_like(x)
    if y.numel():
        layernorm_triton.launch(x, weight, bias, y, eps)
        layernorm.launches += 1
    return y


layernorm.launches = 0  # kernel launches since the last reset


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
