"""The Triton LayerNorm forward kernel (see ``ops/layernorm.py``).

Importing this module imports triton, which CPU-only machines lack, so
only ``layernorm()`` imports it, on its first launch on a CUDA tensor.
"""

from ..kernels.build import import_triton

triton = import_triton()
import triton.language as tl  # noqa: E402 -- after the cache dir is set


@triton.jit
def ln_fwd(x_ptr, w_ptr, b_ptr, y_ptr, D, eps, BLOCK_D: tl.constexpr):
    """One program per row: y = (x - mean) * rstd * w + b, f32 statistics."""
    row = tl.program_id(0).to(tl.int64)
    cols = tl.arange(0, BLOCK_D)
    live = cols < D
    x = tl.load(x_ptr + row * D + cols, mask=live, other=0.0).to(tl.float32)
    mean = tl.sum(x, axis=0) / D
    xc = tl.where(live, x - mean, 0.0)
    var = tl.sum(xc * xc, axis=0) / D
    rstd = 1.0 / tl.sqrt(var + eps)
    w = tl.load(w_ptr + cols, mask=live, other=0.0)
    b = tl.load(b_ptr + cols, mask=live, other=0.0)
    y = xc * rstd * w + b
    tl.store(y_ptr + row * D + cols, y.to(y_ptr.dtype.element_ty), mask=live)


def launch(x, weight, bias, y, eps: float) -> None:
    D = x.shape[-1]
    ln_fwd[(x.numel() // D,)](x, weight, bias, y, D, eps,
                              BLOCK_D=triton.next_power_of_2(D), num_warps=4)
