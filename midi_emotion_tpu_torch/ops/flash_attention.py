"""Flash relative attention, forward and backward: the CUDA kernels and
their plain twins.

Counterpart of ``midi_emotion_tpu/ops/pallas_attention.py``.
``flash_rel_attention`` is a ``torch.autograd.Function``: on a CUDA tensor
its forward launches ``csrc/flash_rel_attn_fwd.cu`` and its backward the
decomposition ``MIDI_EMOTION_BWD`` names, or raises; on a CPU tensor they
run the plain twins. Nothing else chooses between them. The forward returns
(O, lse) with the TPU kernel's documented semantics
(``pallas_attention.py:482-496``): a query row whose keys are all masked
gives O = 0 and lse = +1e30, where the closed form in ``ops/attention.py``
gives NaN; its gradients are 0. The backward returns dQ, dK, dV and dE (lse
is not differentiable).

The backward decompositions, as in the JAX package
(``pallas_attention.py:133-145``, dispatched at ``:1745-1777``):
  * ``MIDI_EMOTION_BWD=merged`` (default): one kernel for everything,
    ``csrc/flash_rel_attn_bwd.cu`` (``flash_rel_attention_bwd``'s own);
  * ``split``: dK, dV and dQ's key term in the key-major sweep
    (``bwd_dkdv_dq``), then dQ's relative term and dE in the distance
    domain (``bwd_de_dqrel``); the two dQ halves sum in f32 and are cast
    once;
  * ``fused``: dQ and dE in one query-major sweep, by key column
    (``bwd_dq_de``) or, with ``MIDI_EMOTION_DQDE=dist``, with the relative
    terms in the distance domain (``bwd_dq_de_dist``); dK and dV in a
    key-major sweep (``bwd_dkdv``). ``MIDI_EMOTION_DQDE`` matters only here.
``MIDI_EMOTION_FLASH_BWD=xla`` (default ``pallas``: the kernels above)
replaces the whole backward with autograd through the plain closed form
(``flash_rel_attention_bwd_xla``), the JAX package's debug path
(``pallas_attention.py:1829-1847``); the forward still runs its kernel.
The three variables are validated at import, so a typo fails at start,
and read again at each backward call. The TPU tuning knobs (skew,
exponent, block sizes, batch per block, VMEM) have no counterpart here.

Scale convention: neither direction pre-scales q. The backward folds
c = 1/sqrt(dh) into dS once, so dK, dQ and dE each carry it once (the JAX
backward pre-scales q and fixes dQ up afterwards, ``pallas_attention.py:
1737-1744``). ``dsum = rowsum(dO * O)`` in f32, XLA work in the JAX
package (``pallas_attention.py:1733-1735``), is a small kernel of
``csrc/flash_rel_attn_bwd.cu`` on a CUDA tensor, so every decomposition's
backward runs only the port's own kernels.

Head shapes: every wrapper takes any d_head, as the JAX package's kernels
do. The forward and the merged backward (kernels 1 and 4) are built for
d_head in ``KERNEL_DHS`` (16, 32, 48, 64, 96, 128, 192, 256), the other
decompositions' kernels (5-9) for ``DECOMPOSITION_DHS`` (up to 128), in f32
and bf16, any T <= max_seq. Another d_head is padded with zero columns up to
``padded_dh`` (``pad_heads``; 40 -> 48, 80 -> 96, 160 -> 192, and past 256
the next multiple of ``WIDE_PART``: 320 -> 384), which add nothing to any
product, the kernel is given c = 1/sqrt(true d_head), and the outputs are
cut back. Past its built widths (above 256 for kernels 1 and 4, above 128
for kernels 5-9 and for kernel 4 in bf16) a wrapper launches the same
kernel's wide form, ``csrc/flash_rel_attn_wide.cu``, which never holds
d_head whole: its score side streams d_head through shared memory in
chunks and each block computes the outputs' columns of one 128-column
part, or (kernels 1 and 4 in bf16, up to ``CLUSTER_MAX_PARTS`` parts) a
cluster of one CTA a part splits the score side by columns and sums it
through distributed shared memory. In bf16 at d_head 192 and 256 kernel 1
is one block a query tile whose two warpgroups each own half the columns
and sum their partial scores in the block's shared memory, and kernel 4
is the cluster backward in two parts (of 96 at 192). ``form`` names
the form each (kernel, d_head, dtype) runs on. bf16 operands must be
16-byte aligned (the kernels copy 16-byte units); fresh and contiguous
tensors are.

Source note for the forward kernel (``csrc/flash_rel_attn_fwd.cu``):
  * replaces ``pallas_attention.py::_flash_kernel`` (launched by
    ``_flash_fwd_impl`` through ``flash_relative_attention``);
  * bf16, the main path: bound by operations (QK^T, the relative term and
    PV, about 13.6 GFLOP at B 4, H 16, T 1216, d_head 48: 0.0137 ms at the
    H100's 989 TFLOP/s). Design: Hopper's warpgroup products (``wgmma``)
    on tiles that TMA copies into shared memory under ``mbarrier``s (the
    building blocks in ``csrc/hopper_sm90.cuh``): a block is one
    warpgroup on 64 query rows, warp w owning rows 16 w.. of every
    accumulator, so the skew, the online softmax and P stay in the warp;
    per 64-key tile S = Q K^T and the band Q E_band^T by wgmma, the band
    skewed into Srel through shared memory (band rows of negative distance
    land as zeros, so Srel is 0 above the diagonal), an online softmax in
    f32, P rounded to bf16 into wgmma's register operand for P V, as the
    TPU kernel casts P; K, V and the E band's next 64-row chunk land by TMA
    while the current tile computes, two blocks an SM up to d_head 64; at
    d_head 192 and 256 (``tc::flash_fwd_tc_parts_kernel``) a block holds
    the query tile with two warpgroups, each computing the partial score
    of its half of the columns, the two summed once a tile in the block's
    shared memory, and O's columns of its half (a warpgroup's registers
    would not hold all of them), V in a ring of its own.
    Measured before the redesign, the ``mma.sync`` kernel it replaces took
    0.1255 ms at B 4 and 0.2203 at B 8 (``scripts/torch_flash_bench.py``,
    NVIDIA H100 80GB HBM3 at 700 W);
  * f32, the checks' path (held to 1e-4, which TF32 products cannot meet):
    the CUDA cores, a thread a query row, Srel folded into the score dot as
    q.(k + E), shared-memory traffic and occupancy bound it;
  * both: causal tiles above the diagonal skipped, heaviest query tiles
    first, the ragged edge masked in the kernel, so callers never pad T.
    The TPU kernel's time-on-lanes layout, head/batch blocking, strided-
    rotate skew and E front-padding were Mosaic's needs and are not
    carried over.

Source note for the merged backward kernel (``csrc/flash_rel_attn_bwd.cu``):
  * replaces ``pallas_attention.py::_bwd_merged_kernel`` (the default
    ``BWD_IMPL="merged"``, launched by ``_bwd_merged_call``);
  * both dtypes: a block sweeps key tiles of one (b, h) and, inside, query
    tiles, as the TPU's sequential grid did, so each dQ (an f32 partial)
    and dE (an f32 partial by distance) has one owning block and the
    reductions sum them in a fixed order: no atomics, deterministic sums,
    nothing summed in bf16;
  * bf16, the training path: bound by operations (the nine products over
    the visible pairs, about 72 GFLOP at B 8: 0.0733 ms). Design: all nine
    products of a tile pair (S, the band, dP, dV, dK, dQ by key and by
    distance, dE) are ``wgmma`` with f32 sums over two warpgroups, their
    tiles copied by TMA under ``mbarrier``s; dS' is rounded to bf16 as the
    TPU kernel rounds ds and scattered into the distance domain through
    shared memory, where dQ_rel and dE are plain products, the transposed
    ones reading P, dS' and the distance tile MN-major; a block sweeps
    groups of key tiles (two up to d_head 48, their f32 dK and dV kept in
    shared memory between pairs) with its own dQ and dE partials, which a
    group's query tile reads and writes once; two blocks share a (b, h),
    or one where B * H fills 7/8 of the SMs (``bwd_split``; the sweep is
    ``csrc/bwd_key_major.cuh``, shared with ``bwd_dkdv_dq``); built up to
    d_head 128 (at
    192 and 256 the cluster backward of the wide kernels below runs, in
    two parts). Measured before the redesign,
    the whole ``mma.sync`` call took 0.9731 ms at B 8, of which the main
    kernel 0.8868, ``dsum`` 0.0243 and the dQ and dE reductions 0.0345
    and 0.0287; taking the f32 partial reads and writes out of a first
    wgmma version saved 0.26 ms of its 0.76, which led to the groups
    (``scripts/torch_flash_bench.py``, same card);
  * f32, the checks' path: CUDA-core f32 FMAs fed from shared memory.

Source note for the wide kernels (``csrc/flash_rel_attn_wide.cu``, kernels
1 and 4 past d_head 256, 5-9 past 128; details in the source): each
replaces the TPU kernel its narrow counterpart replaces; bound by
operations; 64 x 64 score tiles, the score side streamed through shared
memory in d_head chunks and recomputed for each 128-column output part and
each sweep: query-major by key column (the forward, dQ), query-major by
distance (dQ's relative term for 6 and 8), key-major (dK, dV) and
distance-major (dE partials per (b, h), summed in order by a reduction).
One owner per output element: deterministic, no atomics. bf16 on the
tensor cores (``mma.sync``, f32 sums, P and dS' rounded to bf16 for the
output products), f32 (the checks' path) on the CUDA cores. Kernel 1's
bf16 forward (up to 16 parts, d_head 2048) runs instead on one
thread-block cluster per query tile, a CTA per 128-column part: each CTA
copies only its part's columns of Q, K, V and the E band by TMA and
computes its partial score S_r + Srel_r by ``wgmma``; the partials are
exchanged through distributed shared memory and summed in rank order, so
each tile's score side is computed once, split by columns, and every CTA
holds the same P; each then runs P V_r for its own columns by ``wgmma``.
Kernel 4's bf16 backward (the same widths, and 192 and 256 in two parts
of 96 or 128) runs on one cluster per (b, h)
and split of its key tiles (up to ``WIDE_BWD_SPLITS``, alternate key
tiles), sweeping each key tile's query tiles as the narrow kernel 4 does:
per tile pair CTA r computes S_r + Srel_r and dP_r by ``wgmma`` over its
columns, both are summed in rank order through distributed shared
memory, so every CTA has the same P and dS'; then, on its own columns
only, dV_r and dK_r in registers across the key tile, dQ_r and dE_r
(by distance) into the split's f32 partials, which two small kernels sum
in split order: one owner per element, no atomics.

Source note for the other decompositions' kernels (details in their
sources): in f32 (the checks' path) on the CUDA cores and bound by f32 FMAs
fed from shared memory; every bf16 path on the tensor cores (below):
  * ``csrc/flash_rel_attn_bwd_kv.cu``, the key-major sweeps: replaces
    ``_bwd_dkdv_kernel`` (``bwd_dkdv``: in f32 one block per (b, h, key
    tile), which owns its dK and dV) and ``_bwd_dkdv_dq_kernel``
    (``bwd_dkdv_dq``: in f32 one block per (b, h) with an f32 dQ scratch,
    as kernel 4);
  * ``csrc/flash_rel_attn_bwd_q.cu``, the query-major sweeps: replaces
    ``_bwd_dq_de_kernel`` (``bwd_dq_de``), ``_bwd_dq_de_dist_kernel``
    (``bwd_dq_de_dist``) and ``_bwd_de_dqrel_kernel`` (``bwd_de_dqrel``):
    one block per (b, h); a query tile owns its dQ in registers; dE
    accumulates in f32 partials per (b, h) indexed by distance, reduced by
    a second kernel. The TPU's XLA-side flips of K, V, the pad mask and E
    were Mosaic's need: the kernel reads key i - d directly.
  * their tiles are 64 rows, 32 at d_head 128, so the f32 staging fits a
    block's shared memory.
  * bf16 ``bwd_dq_de``, ``bwd_dq_de_dist`` (the ``fused`` training path)
    and ``bwd_de_dqrel`` (``split``): bound by operations; query-major: dQ
    in f32 registers across a query tile's key tiles, dS' rounded to bf16
    (as the TPU kernels round ds) and scattered into the distance domain
    (the unskew; the TPU kernels of ``dist`` and ``de_dqrel`` recompute dS
    by distance instead, because Mosaic cannot lower the unskew, and both
    start from the same f32 scores, so the scatter gives the same dS), where
    dQ_rel and dE are plain products; ``de_dqrel`` forms no dQ key term and
    visits only key tiles at or below the diagonal; two blocks a (b, h) on
    alternate query tiles, each with its own dE partial. Every product is a
    Hopper warpgroup product (``wgmma``) on tiles TMA copies under
    ``mbarrier``s, two warpgroups a tile pair (``form`` "wgmma").
    ``bwd_dq_de`` and ``bwd_dq_de_dist`` compute the same products on the
    same tiles on the card, so both launch one kernel, and kernel 5's
    outputs are kernel 6's bit for bit (the TPU needed two kernels only
    because Mosaic cannot lower the unskew as one operation);
  * bf16 ``bwd_dkdv_dq`` (``split``): bound by operations; kernel 4's
    Hopper design without its distance-domain half: S, the band (P needs
    Srel), dP, dV, dK and dQ's key term, each a ``wgmma`` on TMA tiles, two
    warpgroups a tile pair; a block sweeps groups of key tiles (two up to
    d_head 48, their f32 dK and dV in shared memory between pairs) and a
    query tile's dQ stays in registers while it meets the group, so each
    row of the block's f32 dQ partial is read and written once a group;
    one block a (b, h) where B * H fills 7/8 of the SMs, else two on
    alternate groups (``bwd_split``), the partials summed in block
    order and cast once;
  * bf16 ``bwd_dkdv`` (``fused``): bound by operations; the earlier
    ``mma.sync`` form of the key-major sweep without dQ, so a key tile
    carries nothing to the next and the grid is free: one block per (b, h,
    key tile) by default, the longest key tiles first (``split`` blocks a
    (b, h) on request); its dK and dV sum ``bwd_dkdv_dq``'s products in
    its order, on other instructions (within bf16 rounding of them).
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
from typing import Optional, Tuple

import torch

from .attention import rel_position_bias, relative_attention

KERNEL_DHS = (16, 32, 48, 64, 96, 128, 192, 256)  # kernels 1, 4 and the decode kernel 13
DECOMPOSITION_DHS = KERNEL_DHS[:6]  # kernels 5-9, up to 128
WIDE_PART = 128  # past KERNEL_DHS, heads are padded to a multiple of this
# csrc/flash_rel_attn_wide.cu's cl::MAX_PARTS: kernels 1 and 4 in bf16 run
# on a cluster of one CTA a part up to this many parts; and bw::MAX_SPLIT:
# kernel 4's cluster backward runs at most this many clusters a (b, h)
CLUSTER_MAX_PARTS = 16
WIDE_BWD_SPLITS = 2
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# variable -> (default, allowed values), as pallas_attention.py:187-190
# and :233-236
BWD_KNOBS = {
    "MIDI_EMOTION_BWD": ("merged", ("merged", "split", "fused")),
    "MIDI_EMOTION_DQDE": ("column", ("column", "dist")),
    "MIDI_EMOTION_FLASH_BWD": ("pallas", ("pallas", "xla")),
}


def bwd_knobs() -> Tuple[str, str, str]:
    """(MIDI_EMOTION_BWD, MIDI_EMOTION_DQDE, MIDI_EMOTION_FLASH_BWD) as the
    environment sets them now. A value outside its allowed set raises a
    ValueError that names the variable: ``MIDI_EMOTION_BWD=mergd`` never
    runs another branch."""
    values = []
    for name, (default, allowed) in BWD_KNOBS.items():
        value = os.environ.get(name, default)
        if value not in allowed:
            raise ValueError(f"{name}={value!r}: must be one of {allowed}")
        values.append(value)
    return values[0], values[1], values[2]


bwd_knobs()  # a typo fails at import, as in the JAX package


def _masked(T: int, causal: bool, pad_keys: Optional[torch.Tensor], device) -> torch.Tensor:
    """[B or 1, 1, T, T] bool, True where query i may not see key j."""
    masked = torch.zeros((1, 1, T, T), dtype=torch.bool, device=device)
    if causal:
        masked = torch.ones((T, T), dtype=torch.bool, device=device).triu(1)[None, None]
    if pad_keys is not None:
        masked = masked | pad_keys[:, None, None, :]
    return masked


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    """c: ``scale`` where given (heads padded past their d_head), else
    1/sqrt(d_head)."""
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def padded_dh(dh: int) -> int:
    """The d_head a kernel runs heads of ``dh`` columns at: the least entry
    of ``KERNEL_DHS`` that is >= dh, or past 256 the least multiple of
    ``WIDE_PART`` (384 for 320, 768, 1024). Any d_head >= 1: no width is
    refused."""
    if dh < 1:
        raise ValueError(f"d_head must be at least 1, got {dh}")
    for dh_k in KERNEL_DHS:
        if dh_k >= dh:
            return dh_k
    return -(-dh // WIDE_PART) * WIDE_PART


FORMS = ("cuda_cores", "mma_sync", "wgmma", "parts", "cluster", "streamed")  # form's answers


def form(kernel: int, dh: int, dtype: torch.dtype) -> str:
    """The form of attention kernel ``kernel`` (1, the forward; 4, the merged
    backward; 5-9, the ``split`` and ``fused`` decompositions' kernels) that
    runs heads of ``dh`` columns in ``dtype`` on the card, at
    ``padded_dh(dh)``:
      * ``"cuda_cores"``: f32, the kernel built for that d_head (kernels 1
        and 4 up to 256, 5-9 up to 128);
      * ``"wgmma"``: bf16 up to 128, kernels 1 and 4-8 (``csrc/
        flash_rel_attn_fwd.cu``, ``_bwd.cu``, ``_bwd_q.cu``, ``_bwd_kv.cu``):
        Hopper's warpgroup products on tiles TMA copies, a warpgroup
        holding its tile's whole d_head;
      * ``"mma_sync"``: bf16 up to 128, kernel 9, on ``mma.sync``;
      * ``"parts"``: kernel 1 in bf16 at 192 and 256, ``tc::
        flash_fwd_tc_parts_kernel`` of ``flash_rel_attn_fwd.cu``: two
        warpgroups of one block, a column part each;
      * ``"cluster"``: bf16, kernel 4 from 192 and kernel 1 past 256, up to
        ``CLUSTER_MAX_PARTS`` parts: a cluster of one CTA a part of 128
        columns (96 at 192), ``csrc/flash_rel_attn_wide.cu``;
      * ``"streamed"``: past those, ``flash_rel_attn_wide.cu``'s sweeps.
    Any d_head >= 1."""
    if kernel not in (1, 4, 5, 6, 7, 8, 9):
        raise ValueError(f"form: kernel 1 or 4-9, got {kernel}")
    dh_k = padded_dh(dh)
    bf16 = dtype == torch.bfloat16
    if kernel >= 5:
        if dh_k > DECOMPOSITION_DHS[-1]:
            return "streamed"
        if not bf16:
            return "cuda_cores"
        return "mma_sync" if kernel == 9 else "wgmma"
    if not bf16:
        return "cuda_cores" if dh_k <= KERNEL_DHS[-1] else "streamed"
    if dh_k <= DECOMPOSITION_DHS[-1]:
        return "wgmma"
    if kernel == 1 and dh_k <= KERNEL_DHS[-1]:
        return "parts"
    return "cluster" if dh_k <= CLUSTER_MAX_PARTS * WIDE_PART else "streamed"


def pad_heads(dh_to: int, *tensors: Optional[torch.Tensor]):
    """Each tensor with zero columns appended on its last axis up to
    ``dh_to`` (None and tensors already that wide pass as they are). Zero
    columns add nothing to q.k, q.E, dO.v or dO.O, so a kernel run at the
    padded width, given c = 1/sqrt(true d_head), computes the unpadded
    function in the first columns of its outputs. Any device."""
    return [t if t is None or t.shape[-1] == dh_to
            else torch.nn.functional.pad(t, (0, dh_to - t.shape[-1])) for t in tensors]


def flash_rel_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    e: torch.Tensor,
    causal: bool = True,
    pad_keys: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's math in plain torch, in f32 whatever the input type.

    q, k, v: [B, H, T, dh]; e: [max_seq, dh]; pad_keys: [B, T] bool (True
    = pad key) or None; scale: c, 1/sqrt(dh) when None. Returns (O
    [B, H, T, dh] in q's dtype, lse [B, H, T] f32)."""
    T = q.shape[2]
    qf, kf, vf = q.float(), k.float(), v.float()
    s = (qf @ kf.transpose(-1, -2) + rel_position_bias(qf, e.float())) * _scale(q, scale)
    s = s.masked_fill(_masked(T, causal, pad_keys, q.device), float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)  # all-masked rows
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    live = l > 0
    out = (p @ vf) / torch.where(live, l, torch.ones_like(l))
    lse = torch.where(live, m + torch.log(l), torch.full_like(l, 1e30))
    return out.to(q.dtype), lse[..., 0]


# ---------------------------------------------------------------------------
# the backward twins: f32 math, outputs in the inputs' dtypes; each takes
# c as ``scale`` (1/sqrt(dh) when None)
# ---------------------------------------------------------------------------


def _bwd_p_ds(q, k, v, e, causal, pad_keys, lse, dsum, do, scale=None):
    """f32 (q, k, dO, P, dS') by key column: P recomputed from the saved
    lse, dS' = c P (dO V^T - dsum), c folded in once."""
    c = _scale(q, scale)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = (qf @ kf.transpose(-1, -2) + rel_position_bias(qf, e.float())) * c
    p = torch.exp(s - lse[..., None]).masked_fill(_masked(q.shape[2], causal, pad_keys, q.device), 0)
    ds = p * (dof @ vf.transpose(-1, -2) - dsum[..., None]) * c
    return qf, kf, dof, p, ds


def _rel_adjoint_column(qf, e, ds):
    """(dQ_rel, dE) f32 of the key-column dS' through autograd of
    ``rel_position_bias``: the skew's adjoint, column by column."""
    with torch.enable_grad():
        q_leaf = qf.detach().requires_grad_()
        e_leaf = e.float().detach().requires_grad_()
        srel = rel_position_bias(q_leaf, e_leaf)
    return torch.autograd.grad(srel, (q_leaf, e_leaf), ds)


def _rel_adjoint_dist(q, k, v, e, pad_keys, lse, dsum, do, scale=None):
    """(dQ_rel, dE) f32 by distance, derived apart from the column form as
    ``_bwd_dq_de_dist_kernel`` derives it (``pallas_attention.py:880-903``):
    index the scores by d = i - j >= 0 (the relative bias is 0 above the
    diagonal in both models, so no d < 0 reaches E). There the bias is
    column-pure, Srel_d[i, d] = q_i . E[ms-1-d], a plain product; q.k and
    dO.V are read at key j = i - d. Then dQ_rel = dS_d E_rev and
    dE[ms-1-d] = sum_i dS_d[i, d] q_i."""
    B, H, T, dh = q.shape
    max_seq = e.shape[0]
    c = _scale(q, scale)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    e_rev = e.float()[max_seq - T:].flip(0)  # row d holds E[ms-1-d]
    ar = torch.arange(T, device=q.device)
    key = ar[:, None] - ar[None, :]  # [i, d] -> j = i - d
    masked = (key < 0)[None, None]
    key = key.clamp(min=0)
    if pad_keys is not None:
        masked = masked | pad_keys[:, key][:, None]
    idx = key.expand(B, H, T, T)
    s_d = ((qf @ kf.transpose(-1, -2)).gather(-1, idx) + qf @ e_rev.T) * c
    p_d = torch.exp(s_d - lse[..., None]).masked_fill(masked, 0)
    ds_d = p_d * ((dof @ vf.transpose(-1, -2)).gather(-1, idx) - dsum[..., None]) * c
    de = torch.zeros((max_seq, dh), dtype=torch.float32, device=q.device)
    de[max_seq - T:] = torch.einsum("bhid,bhic->dc", ds_d, qf).flip(0)
    return ds_d @ e_rev, de


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
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The merged backward kernel's math in plain torch, in f32: P
    recomputed from the saved lse, explicit formulas for dV, dK and dQ's
    key term, and autograd through ``rel_position_bias`` for the relative
    term's dQ and dE. Returns (dq, dk, dv, de) in the inputs' dtypes."""
    dsum = (do.float() * o.float()).sum(-1)
    qf, kf, dof, p, ds = _bwd_p_ds(q, k, v, e, causal, pad_keys, lse, dsum, do, scale)
    dq_rel, de = _rel_adjoint_column(qf, e, ds)
    dq = ds @ kf + dq_rel
    dk = ds.transpose(-1, -2) @ qf
    dv = p.transpose(-1, -2) @ dof
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), de.to(e.dtype)


def bwd_dkdv_plain(q, k, v, e, causal, pad_keys, lse, dsum, do, scale=None):
    """Twin of ``_bwd_dkdv_kernel`` -> (dk, dv)."""
    qf, _, dof, p, ds = _bwd_p_ds(q, k, v, e, causal, pad_keys, lse, dsum, do, scale)
    return (ds.transpose(-1, -2) @ qf).to(k.dtype), (p.transpose(-1, -2) @ dof).to(v.dtype)


def bwd_dkdv_dq_plain(q, k, v, e, causal, pad_keys, lse, dsum, do, scale=None):
    """Twin of ``_bwd_dkdv_dq_kernel`` -> (dk, dv, dq_qk = dS' K)."""
    qf, kf, dof, p, ds = _bwd_p_ds(q, k, v, e, causal, pad_keys, lse, dsum, do, scale)
    return ((ds.transpose(-1, -2) @ qf).to(k.dtype), (p.transpose(-1, -2) @ dof).to(v.dtype),
            (ds @ kf).to(q.dtype))


def bwd_dq_de_plain(q, k, v, e, causal, pad_keys, lse, dsum, do, scale=None):
    """Twin of ``_bwd_dq_de_kernel`` -> (dq, de), the relative term by key
    column."""
    qf, kf, _, _, ds = _bwd_p_ds(q, k, v, e, causal, pad_keys, lse, dsum, do, scale)
    dq_rel, de = _rel_adjoint_column(qf, e, ds)
    return (ds @ kf + dq_rel).to(q.dtype), de.to(e.dtype)


def bwd_dq_de_dist_plain(q, k, v, e, causal, pad_keys, lse, dsum, do, scale=None):
    """Twin of ``_bwd_dq_de_dist_kernel`` -> (dq, de): dQ's key term by key
    column, the relative terms by distance."""
    _, kf, _, _, ds = _bwd_p_ds(q, k, v, e, causal, pad_keys, lse, dsum, do, scale)
    dq_rel, de = _rel_adjoint_dist(q, k, v, e, pad_keys, lse, dsum, do, scale)
    return (ds @ kf + dq_rel).to(q.dtype), de.to(e.dtype)


def bwd_de_dqrel_plain(q, k, v, e, causal, pad_keys, lse, dsum, do, scale=None):
    """Twin of ``_bwd_de_dqrel_kernel`` -> (dq_rel, de), by distance. The
    causal flag does not enter: only d = i - j >= 0 is visited."""
    dq_rel, de = _rel_adjoint_dist(q, k, v, e, pad_keys, lse, dsum, do, scale)
    return dq_rel.to(q.dtype), de.to(e.dtype)


# ---------------------------------------------------------------------------
# the CUDA libraries
# ---------------------------------------------------------------------------

# C function -> (library csrc/<name>.cu, pointer arguments); then 7 ints
# (B, H, T, dh, max_seq, causal, dtype), the float scale c and a stream
_C_FUNCTIONS = {
    "flash_rel_attn_fwd": ("flash_rel_attn_fwd", 7),
    "flash_rel_attn_bwd": ("flash_rel_attn_bwd", 14),
    "flash_rel_attn_bwd_dkdv": ("flash_rel_attn_bwd_kv", 10),
    "flash_rel_attn_bwd_dkdv_dq": ("flash_rel_attn_bwd_kv", 12),
    "flash_rel_attn_bwd_dq_de": ("flash_rel_attn_bwd_q", 11),
    "flash_rel_attn_bwd_dq_de_dist": ("flash_rel_attn_bwd_q", 11),
    "flash_rel_attn_bwd_de_dqrel": ("flash_rel_attn_bwd_q", 11),
    "flash_rel_attn_wide_fwd": ("flash_rel_attn_wide", 7),
    "flash_rel_attn_wide_bwd": ("flash_rel_attn_wide", 13),
}


@functools.lru_cache(maxsize=None)
def _function(name: str):
    """(the C function, its library's error-string function), built and
    loaded at first use. ``flash_rel_attn_dsum`` takes 3 pointers, 3 ints
    and a stream."""
    from ..kernels.build import cuda_library

    if name == "flash_rel_attn_dsum":
        lib_name, args = "flash_rel_attn_bwd", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
    else:
        lib_name, n_pointers = _C_FUNCTIONS[name]
        args = [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * 7 + [ctypes.c_float]
        if name in ("flash_rel_attn_bwd", "flash_rel_attn_bwd_dkdv",
                    "flash_rel_attn_bwd_dkdv_dq"):
            args.append(ctypes.c_int)  # blocks a (b, h) of the bf16 kernel
        if name == "flash_rel_attn_wide_bwd":
            args.append(ctypes.c_int)  # which kernel: 4-9
    lib = cuda_library(lib_name)
    fn = getattr(lib, name)
    fn.argtypes = args + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = getattr(lib, f"{lib_name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


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
    if e.dim() != 2 or e.shape[1] != dh or T > e.shape[0]:
        raise ValueError(f"e must be [max_seq >= T, dh]: e {tuple(e.shape)}, T {T}")
    if pad_keys is not None:
        if pad_keys.dtype != torch.bool or pad_keys.shape != (B, T):
            raise ValueError(f"pad_keys must be bool [B, T], got {pad_keys.dtype} {tuple(pad_keys.shape)}")
        if pad_keys.device != q.device or not pad_keys.is_contiguous():
            raise ValueError("pad_keys must be contiguous on q's device")
    if not all(t.is_contiguous() for t in (q, k, v, e)):
        raise ValueError("q, k, v and e must be contiguous")
    _check_aligned(q=q, k=k, v=v, e=e)


def _check_aligned(**tensors):
    """bf16 operands: 16-byte aligned, as the kernels copy 16-byte units."""
    for name, t in tensors.items():
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for the bf16 kernels")


def _check_saved(q, like_q, rows):
    """The backward's extra operands: ``like_q`` contiguous and matching q,
    ``rows`` contiguous f32 [B, H, T] on q's device."""
    for name, t in like_q.items():
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous and match q: {t.dtype} {tuple(t.shape)}")
    _check_aligned(**like_q)
    for name, t in rows.items():
        if (t.shape != q.shape[:3] or t.dtype != torch.float32 or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous f32 [B, H, T], got {t.dtype} {tuple(t.shape)}")


def _launch(name: str, *args) -> None:
    fn, err = _function(name)
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({err(rc).decode()})")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _cut(dh, *tensors):
    """The first ``dh`` columns of each tensor, contiguous (no copy when it
    has no more)."""
    return [t if t.shape[-1] == dh else t[..., :dh].contiguous() for t in tensors]


def _fwd(q, k, v, e, causal, pad_keys):
    if q.device.type == "cpu":
        return flash_rel_attention_plain(q, k, v, e, causal, pad_keys)
    _check(q, k, v, e, pad_keys)
    B, H, T, dh = q.shape
    dh_k = padded_dh(dh)
    q, k, v, e = pad_heads(dh_k, q, k, v, e)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    how = form(1, dh_k, q.dtype)
    _launch("flash_rel_attn_wide_fwd" if how in ("cluster", "streamed") else "flash_rel_attn_fwd",
            q.data_ptr(), k.data_ptr(), v.data_ptr(), e.data_ptr(), _ptr(pad_keys),
            o.data_ptr(), lse.data_ptr(),
            B, H, T, dh_k, e.shape[0], int(causal), _DTYPE_CODES[q.dtype], 1.0 / math.sqrt(dh),
            torch.cuda.current_stream(q.device).cuda_stream)
    flash_rel_attention.launches += 1
    flash_rel_attention.form_launches[how] += 1
    return _cut(dh, o)[0], lse


def _launch_wide_bwd(kernel, q, k, v, e, causal, pad_keys, lse, dsum, do, outs, scale):
    """Launch ``csrc/flash_rel_attn_wide.cu``'s backward for ``kernel`` (4-9)
    on heads already padded: ``outs`` maps "dq", "dk", "dv", "de" to the
    outputs that kernel writes; an f32 dE partial [B*H, T, dh] per (b, h)
    is allocated where it writes dE, and for kernel 4's cluster backward
    (``form`` "cluster") a dQ and a dE partial per split of up to
    ``WIDE_BWD_SPLITS``."""
    B, H, T, dh_k = q.shape
    cluster = kernel == 4 and form(4, dh_k, q.dtype) == "cluster"
    slabs = 2 * WIDE_BWD_SPLITS if cluster else 1
    de_part = (torch.empty((slabs * B * H, T, dh_k), dtype=torch.float32, device=q.device)
               if "de" in outs else None)
    _launch("flash_rel_attn_wide_bwd",
            q.data_ptr(), k.data_ptr(), v.data_ptr(), e.data_ptr(), _ptr(pad_keys),
            do.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
            *(_ptr(outs.get(n)) for n in ("dq", "dk", "dv", "de")), _ptr(de_part),
            B, H, T, dh_k, e.shape[0], int(causal), _DTYPE_CODES[q.dtype], scale, kernel,
            torch.cuda.current_stream(q.device).cuda_stream)


def _launch_bwd(name, kernel, q, k, v, e, causal, pad_keys, lse, dsum, do, like, scratch,
                extra=()):
    """Check, allocate and launch one backward kernel of the other
    decompositions (``kernel``: 5-9), at the padded d_head: outputs shaped
    like the inputs named in ``like``, then the f32 scratch ``scratch``
    names: dQ partials [2, B, H, T, dh] ("dq") or dE partials [2*B*H, T,
    dh] ("de"), up to two a (b, h), or none; ``extra`` ints follow the
    scale.
    Past ``DECOMPOSITION_DHS`` the kernel's wide form runs instead. The
    outputs come back cut to d_head."""
    _check(q, k, v, e, pad_keys)
    _check_saved(q, {"do": do}, {"lse": lse, "dsum": dsum})
    B, H, T, dh = q.shape
    dh_k = padded_dh(dh)
    q, k, v, e, do = pad_heads(dh_k, q, k, v, e, do)
    inputs = {"q": q, "k": k, "v": v, "e": e}
    outs = [torch.empty_like(inputs[n]) for n in like]
    if dh_k > DECOMPOSITION_DHS[-1]:
        _launch_wide_bwd(kernel, q, k, v, e, causal, pad_keys, lse, dsum, do,
                         {"d" + n: t for n, t in zip(like, outs)}, 1.0 / math.sqrt(dh))
        return _cut(dh, *outs)
    shapes = {"dq": (2, B, H, T, dh_k), "de": (2 * B * H, T, dh_k)}
    scr = [] if scratch is None else [
        torch.empty(shapes[scratch], dtype=torch.float32, device=q.device)]
    _launch(name,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), e.data_ptr(), _ptr(pad_keys),
            do.data_ptr(), lse.data_ptr(), dsum.data_ptr(), *(t.data_ptr() for t in outs + scr),
            B, H, T, dh_k, e.shape[0], int(causal), _DTYPE_CODES[q.dtype], 1.0 / math.sqrt(dh),
            *extra, torch.cuda.current_stream(q.device).cuda_stream)
    return _cut(dh, *outs)


def _count(wrapper, kernel, q):
    """One launch of ``wrapper``'s kernel, also by its ``form``."""
    wrapper.launches += 1
    wrapper.form_launches[form(kernel, q.shape[-1], q.dtype)] += 1


def _dsum(o, do):
    """rowsum(dO * O) in f32 [B, H, T]: on a CUDA tensor the backward
    source's own kernel (o and do already checked), on a CPU tensor torch."""
    if o.device.type == "cpu":
        return (do.float() * o.float()).sum(-1)
    dsum = torch.empty(o.shape[:3], dtype=torch.float32, device=o.device)
    _launch("flash_rel_attn_dsum", do.data_ptr(), o.data_ptr(), dsum.data_ptr(),
            dsum.numel(), o.shape[-1], _DTYPE_CODES[o.dtype],
            torch.cuda.current_stream(o.device).cuda_stream)
    return dsum


# Each wrapper below takes (q, k, v, e, causal, pad_keys, lse, dsum, do):
# the forward's inputs, its lse, dsum = rowsum(dO * O) in f32 [B, H, T] and
# the cotangent dO. On a CUDA tensor it launches its kernel or raises; on a
# CPU tensor it runs its twin.


DKDV_TILE = 64  # keys a tile of the bf16 dK/dV kernel


def bwd_dkdv(q, k, v, e, causal, pad_keys, lse, dsum, do, split=None):
    """-> (dk, dv): ``csrc/flash_rel_attn_bwd_kv.cu`` for the TPU's
    ``_bwd_dkdv_kernel`` (``MIDI_EMOTION_BWD=fused``). In bf16 ``split``
    blocks share a (b, h), block s taking key tiles s, s + split, ...;
    None, one block per (b, h, key tile). The f32 kernel ignores it."""
    if q.device.type == "cpu":
        return bwd_dkdv_plain(q, k, v, e, causal, pad_keys, lse, dsum, do)
    if split is None:
        split = -(-q.shape[2] // DKDV_TILE)
    if split < 1:
        raise ValueError(f"bwd_dkdv: split must be at least 1, got {split}")
    dk, dv = _launch_bwd("flash_rel_attn_bwd_dkdv", 9, q, k, v, e, causal, pad_keys, lse, dsum, do,
                         ("k", "v"), None, (split,))
    _count(bwd_dkdv, 9, q)
    return dk, dv


BWD_MAX_SPLIT = 2  # csrc/bwd_key_major.cuh's km::MAX_SPLIT: the dQ scratch holds two partials


def bwd_split(bh: int, sms: int) -> int:
    """Blocks a (b, h) of the key-major Hopper kernels 4 and 7 in bf16
    (``csrc/bwd_key_major.cuh``): one where the ``bh`` = B * H blocks alone
    fill 7/8 of the card's ``sms`` SMs (one block an SM, and one f32 dQ
    partial), else two on alternate groups of key tiles."""
    return 1 if bh >= sms - sms // 8 else BWD_MAX_SPLIT


def _split(q, split):
    """``split`` checked (1 or 2), or ``bwd_split``'s choice for q's card
    where None; 1 in f32, whose kernels ignore it."""
    if q.dtype != torch.bfloat16:
        return 1
    if split is None:
        return bwd_split(q.shape[0] * q.shape[1],
                         torch.cuda.get_device_properties(q.device).multi_processor_count)
    if not 1 <= split <= BWD_MAX_SPLIT:
        raise ValueError(f"split must be 1 or {BWD_MAX_SPLIT}, got {split}")
    return split


def bwd_dkdv_dq(q, k, v, e, causal, pad_keys, lse, dsum, do, split=None):
    """-> (dk, dv, dq_qk): ``csrc/flash_rel_attn_bwd_kv.cu`` for the TPU's
    ``_bwd_dkdv_dq_kernel`` (``MIDI_EMOTION_BWD=split``). In bf16 ``split``
    (1 or 2) blocks share a (b, h) on alternate groups of key tiles, each
    with its own f32 dQ partial; None, ``bwd_split``'s choice. The f32
    kernel ignores it (one block per (b, h))."""
    if q.device.type == "cpu":
        return bwd_dkdv_dq_plain(q, k, v, e, causal, pad_keys, lse, dsum, do)
    dk, dv, dq_qk = _launch_bwd("flash_rel_attn_bwd_dkdv_dq", 7, q, k, v, e, causal, pad_keys, lse,
                                dsum, do, ("k", "v", "q"), "dq", (_split(q, split),))
    _count(bwd_dkdv_dq, 7, q)
    return dk, dv, dq_qk


def bwd_dq_de(q, k, v, e, causal, pad_keys, lse, dsum, do):
    """-> (dq, de): ``csrc/flash_rel_attn_bwd_q.cu`` for the TPU's
    ``_bwd_dq_de_kernel`` (``MIDI_EMOTION_BWD=fused``, ``DQDE=column``)."""
    if q.device.type == "cpu":
        return bwd_dq_de_plain(q, k, v, e, causal, pad_keys, lse, dsum, do)
    dq, de = _launch_bwd("flash_rel_attn_bwd_dq_de", 5, q, k, v, e, causal, pad_keys, lse, dsum, do,
                         ("q", "e"), "de")
    _count(bwd_dq_de, 5, q)
    return dq, de


def bwd_dq_de_dist(q, k, v, e, causal, pad_keys, lse, dsum, do):
    """-> (dq, de): ``csrc/flash_rel_attn_bwd_q.cu`` for the TPU's
    ``_bwd_dq_de_dist_kernel`` (``MIDI_EMOTION_BWD=fused``, ``DQDE=dist``)."""
    if q.device.type == "cpu":
        return bwd_dq_de_dist_plain(q, k, v, e, causal, pad_keys, lse, dsum, do)
    dq, de = _launch_bwd("flash_rel_attn_bwd_dq_de_dist", 6, q, k, v, e, causal, pad_keys, lse, dsum,
                         do, ("q", "e"), "de")
    _count(bwd_dq_de_dist, 6, q)
    return dq, de


def bwd_de_dqrel(q, k, v, e, causal, pad_keys, lse, dsum, do):
    """-> (dq_rel, de): ``csrc/flash_rel_attn_bwd_q.cu`` for the TPU's
    ``_bwd_de_dqrel_kernel`` (``MIDI_EMOTION_BWD=split``)."""
    if q.device.type == "cpu":
        return bwd_de_dqrel_plain(q, k, v, e, causal, pad_keys, lse, dsum, do)
    dq_rel, de = _launch_bwd("flash_rel_attn_bwd_de_dqrel", 8, q, k, v, e, causal, pad_keys, lse,
                             dsum, do, ("q", "e"), "de")
    _count(bwd_de_dqrel, 8, q)
    return dq_rel, de


for _wrapper in (bwd_dkdv, bwd_dkdv_dq, bwd_dq_de, bwd_dq_de_dist, bwd_de_dqrel):
    _wrapper.launches = 0  # kernel launches since the last reset
    _wrapper.form_launches = dict.fromkeys(FORMS, 0)  # the same by form


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
    forward's inputs, its (O, lse) and the cotangent dO, by the
    decomposition ``MIDI_EMOTION_BWD`` (and ``MIDI_EMOTION_DQDE``) name now.
    ``merged``: on a CUDA tensor this launches the merged kernel (counted
    here) or raises; on a CPU tensor it runs
    :func:`flash_rel_attention_bwd_plain`. ``split`` and ``fused`` compose
    the wrappers above, each a kernel or its twin by the same rule."""
    impl, dqde, _ = bwd_knobs()
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_rel_attention_bwd: unsupported device {q.device}")
    if impl == "merged" and q.device.type == "cpu":
        return flash_rel_attention_bwd_plain(q, k, v, e, causal, pad_keys, o, lse, do)
    if q.device.type == "cuda":
        _check(q, k, v, e, pad_keys)
        _check_saved(q, {"o": o, "do": do}, {"lse": lse})
    dsum = _dsum(o, do)  # [B, H, T] f32
    if impl == "split":
        dk, dv, dq_qk = bwd_dkdv_dq(q, k, v, e, causal, pad_keys, lse, dsum, do)
        dq_rel, de = bwd_de_dqrel(q, k, v, e, causal, pad_keys, lse, dsum, do)
        # the two dQ halves sum in f32 before the one output cast, as in
        # pallas_attention.py:1762-1765
        return (dq_qk.float() + dq_rel.float()).to(q.dtype), dk, dv, de
    if impl == "fused":
        dq, de = (bwd_dq_de_dist if dqde == "dist" else bwd_dq_de)(
            q, k, v, e, causal, pad_keys, lse, dsum, do)
        dk, dv = bwd_dkdv(q, k, v, e, causal, pad_keys, lse, dsum, do)
        return dq, dk, dv, de
    B, H, T, dh = q.shape
    dh_k = padded_dh(dh)
    q, k, v, e, do = pad_heads(dh_k, q, k, v, e, do)
    dq, dk, dv, de = (torch.empty_like(t) for t in (q, k, v, e))
    how = form(4, dh_k, q.dtype)
    if how in ("cluster", "streamed"):
        _launch_wide_bwd(4, q, k, v, e, causal, pad_keys, lse, dsum, do,
                         {"dq": dq, "dk": dk, "dv": dv, "de": de}, 1.0 / math.sqrt(dh))
        flash_rel_attention_bwd.launches += 1
        flash_rel_attention_bwd.form_launches[how] += 1
        return tuple(_cut(dh, dq, dk, dv, de))
    # f32 scratch: a dQ and a dE partial for each of the (up to) two blocks
    # that share a (b, h), summed in a fixed order by the kernel's reductions
    dq_acc = torch.empty((2, B, H, T, dh_k), dtype=torch.float32, device=q.device)
    de_part = torch.empty((2 * B * H, T, dh_k), dtype=torch.float32, device=q.device)
    _launch("flash_rel_attn_bwd",
            q.data_ptr(), k.data_ptr(), v.data_ptr(), e.data_ptr(), _ptr(pad_keys),
            do.data_ptr(), lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), de.data_ptr(), dq_acc.data_ptr(), de_part.data_ptr(),
            B, H, T, dh_k, e.shape[0], int(causal), _DTYPE_CODES[q.dtype], 1.0 / math.sqrt(dh),
            _split(q, None), torch.cuda.current_stream(q.device).cuda_stream)
    flash_rel_attention_bwd.launches += 1
    flash_rel_attention_bwd.form_launches[how] += 1
    return tuple(_cut(dh, dq, dk, dv, de))


flash_rel_attention_bwd.launches = 0  # merged kernel launches since the last reset
flash_rel_attention_bwd.form_launches = dict.fromkeys(FORMS, 0)  # the same by form


def flash_rel_attention_bwd_xla(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    e: torch.Tensor,
    causal: bool,
    pad_keys: Optional[torch.Tensor],
    do: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward under ``MIDI_EMOTION_FLASH_BWD=xla``, the JAX package's
    debug path (``pallas_attention.py:1837-1845``, ``jax.vjp`` of
    ``_xla_reference``): the gradients of the plain closed form
    ``ops/attention.py::relative_attention`` by autograd, in f32 from the
    forward's inputs, cast to their dtypes. Any device; it launches no
    kernel. As the closed form, it gives NaN for a query row whose keys
    are all masked."""
    with torch.enable_grad():
        leaves = [t.detach().float().requires_grad_() for t in (q, k, v, e)]
        o = relative_attention(*leaves, causal=causal, pad_keys=pad_keys, impl="plain")
    grads = torch.autograd.grad(o, leaves, do.float())
    return tuple(g.to(t.dtype) for g, t in zip(grads, (q, k, v, e)))


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
        if bwd_knobs()[2] == "xla":  # read, and validated, at each backward
            dq, dk, dv, de = flash_rel_attention_bwd_xla(q, k, v, e, ctx.causal, pad_keys, do)
        else:
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
flash_rel_attention.form_launches = dict.fromkeys(FORMS, 0)  # the same by form
