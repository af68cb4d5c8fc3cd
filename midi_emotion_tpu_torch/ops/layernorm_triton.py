"""The Triton kernels of the LayerNorm and dropout ops (see
``ops/layernorm.py`` and ``ops/fused_dropout.py``).

* ``ln_fwd``: LayerNorm forward (kernel 2).
* ``ln_bwd``: LayerNorm backward (kernel 3) and, with ``HAS_DROPOUT``, the
  backward of dropout + residual add + LayerNorm with the mask replayed
  (kernel 12): one source for both, since they share the body. Bound by
  HBM bandwidth (kernel 12 reads sub, res, dy and writes dsub, dres: five
  [N, D] tensors), so its design keeps loads in flight: a few programs an
  SM, each taking tiles of rows round the card, with the next tiles' loads
  pipelined under this tile's reductions (``tl.range(num_stages=...)``);
  dgamma/dbeta stay in registers, one f32 partial a program.
* ``dal_fwd``: LayerNorm(res + dropout(sub)) (kernel 11).
* ``dropout``: dropout alone, also its own backward (kernel 10).
* ``col_sum``: the second pass of ``ln_bwd``, summing its per-program f32
  dgamma/dbeta partials in program order (no atomics: two calls give
  bitwise-equal sums).

The dropout mask: element i of a flat [N, D] tensor is kept iff
``(word[i % 4] of Philox4x32-10(seed, counter i // 4)) >> 8 < thresh``, with
``thresh = round((1 - rate) * 2**24)`` (the JAX package's 24-bit rule). One
Philox call serves four consecutive elements: ``dropout`` draws
``tl.randint4x`` once per four elements and interleaves the words into
element order, and so does ``ln_bwd`` when D % 4 == 0 (every row then
starts a group of four); ``_keep``, for ``dal_fwd`` and for ``ln_bwd`` at
other D, draws the same call per element and picks its word. The mask
depends on (seed, index) only, not on the block layout, so the forward and
backward kernels of one site, and the dropout and dropout+LN kernels given
one seed and shape, draw the same mask.

Importing this module imports triton, which CPU-only machines lack, so the
ops import it on their first launch on a CUDA tensor.
"""

import functools

import torch

from ..kernels.build import import_triton

triton = import_triton()
import triton.language as tl  # noqa: E402 -- after the cache dir is set


@triton.jit
def _keep_bits(bits, thresh):
    """Keep iff the top 24 of the 32 Philox bits lie below ``thresh``."""
    return (bits.to(tl.uint32, bitcast=True) >> 8).to(tl.int32) < thresh


@triton.jit
def _keep(seed, offs, thresh):
    """Keep-mask of the elements at flat indices ``offs`` for ``seed``: word
    ``offs % 4`` of the Philox call at counter ``offs // 4``."""
    r0, r1, r2, r3 = tl.randint4x(seed, offs // 4)
    lane = offs % 4
    bits = tl.where(lane == 0, r0, tl.where(lane == 1, r1, tl.where(lane == 2, r2, r3)))
    return _keep_bits(bits, thresh)


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


@triton.jit
def _keep_tile(seed, rows, cols, D, thresh, ALIGN4: tl.constexpr, BLOCK_D: tl.constexpr):
    """Keep-mask of the [ROWS, BLOCK_D] tile at (rows, cols), flat index
    rows * D + cols. With ALIGN4 (D % 4 == 0) every row starts a group of
    four, so one Philox call serves four elements, as in ``dropout``;
    otherwise each element draws its counter's call and picks its word."""
    if ALIGN4:
        ctr = rows[:, None] * (D // 4) + tl.arange(0, BLOCK_D // 4)[None, :]
        r0, r1, r2, r3 = tl.randint4x(seed, ctr)
        bits = tl.interleave(tl.interleave(r0, r2), tl.interleave(r1, r3))
        return _keep_bits(bits, thresh)
    return _keep(seed, rows[:, None] * D + cols[None, :], thresh)


@triton.jit(do_not_specialize=["seed"])
def ln_bwd(x_ptr, s_ptr, dy_ptr, w_ptr, dx_ptr, ds_ptr, part_ptr, N, D, eps, seed, thresh,
           inv_keep, HAS_DROPOUT: tl.constexpr, ALIGN4: tl.constexpr, ROWS: tl.constexpr,
           BLOCK_D: tl.constexpr, STAGES: tl.constexpr):
    """Program p takes the tiles of ROWS rows p, p + n_prog, ...: dx =
    (w*dy - mean(w*dy) - xhat * mean(w*dy*xhat)) * rstd with the
    statistics recomputed, and sums dy*xhat and dy over its rows into f32
    partials part[0, p, :], part[1, p, :]. With HAS_DROPOUT, x is r +
    dropout(s) (r at x_ptr), dx is dr, and ds = where(keep, dx * inv_keep,
    0) from the same mask."""
    pid = tl.program_id(0)
    n_prog = tl.num_programs(0)
    cols = tl.arange(0, BLOCK_D)
    live = cols < D
    w = tl.load(w_ptr + cols, mask=live, other=0.0)[None, :]
    dw = tl.zeros([BLOCK_D], dtype=tl.float32)
    db = tl.zeros([BLOCK_D], dtype=tl.float32)
    for t in tl.range(pid, tl.cdiv(N, ROWS), n_prog, num_stages=STAGES):
        rows = t * ROWS + tl.arange(0, ROWS)
        m = (rows < N)[:, None] & live[None, :]  # rows past N load zeros and store nothing
        offs = rows[:, None] * D + cols[None, :]
        x = tl.load(x_ptr + offs, mask=m, other=0.0)
        dy = tl.load(dy_ptr + offs, mask=m, other=0.0).to(tl.float32)
        if HAS_DROPOUT:
            keep = _keep_tile(seed, rows, cols, D, thresh, ALIGN4, BLOCK_D)
            xs = _dropped(tl.load(s_ptr + offs, mask=m, other=0.0), keep, inv_keep)
            xf = (x.to(tl.float32) + xs.to(tl.float32)).to(x.dtype).to(tl.float32)
        else:
            xf = x.to(tl.float32)
        mean = tl.sum(xf, axis=1) / D
        xc = tl.where(m, xf - mean[:, None], 0.0)
        var = tl.sum(xc * xc, axis=1) / D
        rstd = 1.0 / tl.sqrt(var + eps)
        xhat = xc * rstd[:, None]
        dw += tl.sum(dy * xhat, axis=0)
        db += tl.sum(dy, axis=0)
        wdy = dy * w
        c1 = tl.sum(wdy, axis=1) / D
        c2 = tl.sum(wdy * xhat, axis=1) / D
        dx = (wdy - c1[:, None] - xhat * c2[:, None]) * rstd[:, None]
        tl.store(dx_ptr + offs, dx.to(dx_ptr.dtype.element_ty), mask=m)
        if HAS_DROPOUT:
            ds = tl.where(keep, dx * inv_keep, 0.0)
            tl.store(ds_ptr + offs, ds.to(ds_ptr.dtype.element_ty), mask=m)
    tl.store(part_ptr + pid * D + cols, dw, mask=live)
    tl.store(part_ptr + (n_prog + pid) * D + cols, db, mask=live)


@triton.jit
def col_sum(part_ptr, out_ptr, P, D, BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr):
    """out[g, :] = sum over p of part[g, p, :] in f32, p in order by blocks
    of BLOCK_P; program (i, g) takes columns i * BLOCK_C.."""
    cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
    g = tl.program_id(1)
    live = cols < D
    acc = tl.zeros([BLOCK_C], dtype=tl.float32)
    for p0 in range(0, P, BLOCK_P):
        rows = p0 + tl.arange(0, BLOCK_P)
        m = (rows[:, None] < P) & live[None, :]
        blk = tl.load(part_ptr + (g * P + rows[:, None]) * D + cols[None, :], mask=m, other=0.0)
        acc += tl.sum(blk, axis=0)
    tl.store(out_ptr + g * D + cols, acc, mask=live)


@triton.jit(do_not_specialize=["seed"])
def dropout(x_ptr, y_ptr, N, seed, thresh, inv_keep, BLOCK: tl.constexpr):
    """y = where(keep, x * inv_keep, 0) over a flat block of BLOCK elements,
    one Philox call per four elements (the mask of ``_keep``)."""
    pid = tl.program_id(0)
    r0, r1, r2, r3 = tl.randint4x(seed, pid * (BLOCK // 4) + tl.arange(0, BLOCK // 4))
    # words in element order: element 4c + w takes word w of counter c
    bits = tl.interleave(tl.interleave(r0, r2), tl.interleave(r1, r3))
    offs = pid * BLOCK + tl.arange(0, BLOCK)
    live = offs < N
    x = tl.load(x_ptr + offs, mask=live, other=0.0)
    tl.store(y_ptr + offs, _dropped(x, _keep_bits(bits, thresh), inv_keep), mask=live)


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


# ln_bwd's launch, chosen on the H100 at [9728, 768] bf16 from 1-16 rows
# a tile, 1-8 warps, 2-8 programs an SM and 1-5 stages: 2 rows a tile
# of up to 1024 columns (one row past that), 32 elements a thread of each
# tensor (2 warps at 2 x 1024), 4 programs an SM, and loads up to 3 tiles
# ahead within 96 KB of shared memory
LN_BWD_ROWS, LN_BWD_PROGS_PER_SM, LN_BWD_STAGES = 2, 4, 3
LN_BWD_STAGE_BYTES = 96 * 1024


def ln_bwd_launch(x, sub, dy, weight, dx, ds, eps: float, seed: int = 0, thresh: int = 0,
                  inv_keep: float = 1.0, reduce: bool = True):
    """dx (and ds when ``sub`` is given) in place; returns (dweight,
    dbias) in f32, summed by ``col_sum`` from the row pass's per-program
    partials, or with ``reduce`` False the partials [2, programs, D]."""
    D = x.shape[-1]
    N = x.numel() // D
    block_d = triton.next_power_of_2(D)
    rows = LN_BWD_ROWS if block_d <= 1024 else 1
    has_dropout = sub is not None
    tile_bytes = (3 if has_dropout else 2) * rows * block_d * x.element_size()
    stages = max(1, min(LN_BWD_STAGES, LN_BWD_STAGE_BYTES // tile_bytes))
    n_prog = max(1, min(triton.cdiv(N, rows), LN_BWD_PROGS_PER_SM * _n_sm(x.device.index or 0)))
    part = torch.empty((2, n_prog, D), dtype=torch.float32, device=x.device)
    ln_bwd[(n_prog,)](
        x, sub if has_dropout else x, dy, weight, dx, ds if has_dropout else dx, part,
        N, D, eps, seed, thresh, inv_keep, HAS_DROPOUT=has_dropout, ALIGN4=D % 4 == 0,
        ROWS=rows, BLOCK_D=block_d, STAGES=stages, num_warps=max(1, rows * block_d // 1024))
    return col_sum_launch(part) if reduce else part


def col_sum_launch(part):
    """(dweight, dbias) from ln_bwd's partials [2, P, D]: 8 columns a
    program, so that D 768 takes 192 programs (the card has 132 SMs), 256
    partials a load (chosen on the H100 at P 528 from 4-32 columns and
    32-512 partials)."""
    _, P, D = part.shape
    out = torch.empty((2, D), dtype=torch.float32, device=part.device)
    col_sum[(triton.cdiv(D, 8), 2)](part, out, P, D, BLOCK_P=256, BLOCK_C=8, num_warps=4)
    return out[0], out[1]


def dropout_launch(x, y, seed: int, thresh: int, inv_keep: float) -> None:
    n = x.numel()
    block = 4096
    dropout[(triton.cdiv(n, block),)](x, y, n, seed, thresh, inv_keep, BLOCK=block,
                                      num_warps=8)
