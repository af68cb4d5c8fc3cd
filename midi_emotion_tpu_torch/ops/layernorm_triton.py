"""The Triton kernels of the LayerNorm and dropout ops (see
``ops/layernorm.py`` and ``ops/fused_dropout.py``).

* ``ln_fwd``: LayerNorm forward (kernel 2).
* ``ln_bwd``: LayerNorm backward (kernel 3) and, with ``HAS_DROPOUT``, the
  backward of dropout + residual add + LayerNorm with the mask replayed
  (kernel 12): one source for both, since they share the body.
* ``dal_fwd``: LayerNorm(res + dropout(sub)) (kernel 11).
* ``dropout``: dropout alone, also its own backward (kernel 10).
* ``col_sum``: the second pass of ``ln_bwd``, summing its per-program f32
  dgamma/dbeta partials.

The dropout mask is ``_keep``: Philox bits from ``tl.randint(seed, i)``
at the element's flat index i of its [N, D] tensor, kept iff
``(bits >> 8) < thresh`` with ``thresh = round((1 - rate) * 2**24)`` (the
JAX package's rule). It depends on (seed, index) only, not on the block
layout, so the forward and backward kernels of one site, and the dropout
and dropout+LN kernels given one seed and shape, draw the same mask.

Importing this module imports triton, which CPU-only machines lack, so the
ops import it on their first launch on a CUDA tensor.
"""

import functools

import torch

from ..kernels.build import import_triton

triton = import_triton()
import triton.language as tl  # noqa: E402 -- after the cache dir is set


@triton.jit
def _keep(seed, offs, thresh):
    """Keep-mask of the elements at flat indices ``offs`` for ``seed``."""
    bits = tl.randint(seed, offs).to(tl.uint32, bitcast=True)
    return (bits >> 8).to(tl.int32) < thresh


@triton.jit
def _dropped(s, keep, inv_keep):
    """where(keep, s * inv_keep, 0), the product in f32 rounded to s's type."""
    return tl.where(keep, s.to(tl.float32) * inv_keep, 0.0).to(s.dtype)


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


@triton.jit(do_not_specialize=["seed"])
def dal_fwd(s_ptr, r_ptr, w_ptr, b_ptr, y_ptr, D, eps, seed, thresh, inv_keep,
            BLOCK_D: tl.constexpr):
    """One program per row: y = LN(r + dropout(s)). The add runs in the
    input type, the statistics in f32."""
    row = tl.program_id(0)
    cols = tl.arange(0, BLOCK_D)
    live = cols < D
    offs = row * D + cols  # int32 flat index: the mask's counter
    s = tl.load(s_ptr + offs, mask=live, other=0.0)
    r = tl.load(r_ptr + offs, mask=live, other=0.0)
    xs = _dropped(s, _keep(seed, offs, thresh), inv_keep)
    x = (r.to(tl.float32) + xs.to(tl.float32)).to(r.dtype).to(tl.float32)
    mean = tl.sum(x, axis=0) / D
    xc = tl.where(live, x - mean, 0.0)
    var = tl.sum(xc * xc, axis=0) / D
    rstd = 1.0 / tl.sqrt(var + eps)
    w = tl.load(w_ptr + cols, mask=live, other=0.0)
    b = tl.load(b_ptr + cols, mask=live, other=0.0)
    y = xc * rstd * w + b
    tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=live)


@triton.jit(do_not_specialize=["seed"])
def ln_bwd(x_ptr, s_ptr, dy_ptr, w_ptr, dx_ptr, ds_ptr, part_ptr, N, D, rows_per_prog,
           eps, seed, thresh, inv_keep, HAS_DROPOUT: tl.constexpr, BLOCK_D: tl.constexpr):
    """Each program walks ``rows_per_prog`` rows: dx = (w*dy - mean(w*dy)
    - xhat * mean(w*dy*xhat)) * rstd with the statistics recomputed, and
    sums dy*xhat and dy over its rows into f32 partials part[0, pid, :],
    part[1, pid, :]. With HAS_DROPOUT, x is r + dropout(s) (r at x_ptr),
    dx is dr, and ds = where(keep, dx * inv_keep, 0) from the same mask."""
    pid = tl.program_id(0)
    n_prog = tl.num_programs(0)
    cols = tl.arange(0, BLOCK_D)
    live = cols < D
    w = tl.load(w_ptr + cols, mask=live, other=0.0)
    dw = tl.zeros([BLOCK_D], dtype=tl.float32)
    db = tl.zeros([BLOCK_D], dtype=tl.float32)
    for k in range(rows_per_prog):
        row = pid * rows_per_prog + k
        m = live & (row < N)  # rows past N load zeros and store nothing
        offs = row * D + cols
        x = tl.load(x_ptr + offs, mask=m, other=0.0)
        if HAS_DROPOUT:
            keep = _keep(seed, offs, thresh)
            xs = _dropped(tl.load(s_ptr + offs, mask=m, other=0.0), keep, inv_keep)
            xf = (x.to(tl.float32) + xs.to(tl.float32)).to(x.dtype).to(tl.float32)
        else:
            xf = x.to(tl.float32)
        dy = tl.load(dy_ptr + offs, mask=m, other=0.0).to(tl.float32)
        mean = tl.sum(xf, axis=0) / D
        xc = tl.where(live, xf - mean, 0.0)
        var = tl.sum(xc * xc, axis=0) / D
        rstd = 1.0 / tl.sqrt(var + eps)
        xhat = xc * rstd
        dw += dy * xhat
        db += dy
        wdy = dy * w
        c1 = tl.sum(wdy, axis=0) / D
        c2 = tl.sum(wdy * xhat, axis=0) / D
        dx = (wdy - c1 - xhat * c2) * rstd
        tl.store(dx_ptr + offs, dx.to(dx_ptr.dtype.element_ty), mask=m)
        if HAS_DROPOUT:
            ds = tl.where(keep, dx * inv_keep, 0.0)
            tl.store(ds_ptr + offs, ds.to(ds_ptr.dtype.element_ty), mask=m)
    tl.store(part_ptr + pid * D + cols, dw, mask=live)
    tl.store(part_ptr + (n_prog + pid) * D + cols, db, mask=live)


@triton.jit
def col_sum(part_ptr, out_ptr, P, D, BLOCK_P: tl.constexpr, BLOCK_D: tl.constexpr):
    """out[g, :] = sum over p of part[g, p, :], in f32; g = program_id(1)."""
    cols = tl.program_id(0) * BLOCK_D + tl.arange(0, BLOCK_D)
    g = tl.program_id(1)
    live = cols < D
    acc = tl.zeros([BLOCK_D], dtype=tl.float32)
    for p0 in range(0, P, BLOCK_P):
        rows = p0 + tl.arange(0, BLOCK_P)
        m = (rows[:, None] < P) & live[None, :]
        blk = tl.load(part_ptr + (g * P + rows[:, None]) * D + cols[None, :], mask=m, other=0.0)
        acc += tl.sum(blk, axis=0)
    tl.store(out_ptr + g * D + cols, acc, mask=live)


@triton.jit(do_not_specialize=["seed"])
def dropout(x_ptr, y_ptr, N, seed, thresh, inv_keep, BLOCK: tl.constexpr):
    """y = where(keep, x * inv_keep, 0) over a flat block of BLOCK elements."""
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    live = offs < N
    x = tl.load(x_ptr + offs, mask=live, other=0.0)
    y = _dropped(x, _keep(seed, offs, thresh), inv_keep)
    tl.store(y_ptr + offs, y, mask=live)


@functools.lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def ln_fwd_launch(x, weight, bias, y, eps: float) -> None:
    D = x.shape[-1]
    ln_fwd[(x.numel() // D,)](x, weight, bias, y, D, eps,
                              BLOCK_D=triton.next_power_of_2(D), num_warps=4)


def dal_fwd_launch(sub, res, weight, bias, y, eps: float, seed: int, thresh: int,
                   inv_keep: float) -> None:
    D = sub.shape[-1]
    dal_fwd[(sub.numel() // D,)](sub, res, weight, bias, y, D, eps, seed, thresh, inv_keep,
                                 BLOCK_D=triton.next_power_of_2(D), num_warps=4)


def ln_bwd_launch(x, sub, dy, weight, dx, ds, eps: float, seed: int = 0, thresh: int = 0,
                  inv_keep: float = 1.0):
    """dx (and ds when ``sub`` is given) in place; returns (dweight,
    dbias) in f32. Four programs per SM walk the rows; their partials are
    then summed by ``col_sum``."""
    D = x.shape[-1]
    N = x.numel() // D
    rows_per_prog = max(1, triton.cdiv(N, 4 * _n_sm(x.device.index or 0)))
    n_prog = max(1, triton.cdiv(N, rows_per_prog))
    part = torch.empty((2, n_prog, D), dtype=torch.float32, device=x.device)
    has_dropout = sub is not None
    ln_bwd[(n_prog,)](
        x, sub if has_dropout else x, dy, weight, dx, ds if has_dropout else dx, part,
        N, D, rows_per_prog, eps, seed, thresh, inv_keep,
        HAS_DROPOUT=has_dropout, BLOCK_D=triton.next_power_of_2(D), num_warps=4)
    out = torch.empty((2, D), dtype=torch.float32, device=x.device)
    col_sum[(triton.cdiv(D, 128), 2)](part, out, n_prog, D, BLOCK_P=32, BLOCK_D=128,
                                      num_warps=4)
    return out[0], out[1]


def dropout_launch(x, y, seed: int, thresh: int, inv_keep: float) -> None:
    n = x.numel()
    block = 4096
    dropout[(triton.cdiv(n, block),)](x, y, n, seed, thresh, inv_keep, BLOCK=block,
                                      num_warps=8)
