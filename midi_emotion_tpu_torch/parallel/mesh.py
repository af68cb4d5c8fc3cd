"""The process mesh, the tensor-parallel sharding rules and the collectives,
in torch.

Counterpart of ``midi_emotion_tpu/parallel/mesh.py``. The JAX package lays
its devices on a ("data", "model"[, "seq"]) ``jax.sharding.Mesh`` and lets
GSPMD insert the collectives; here each process is one rank of
``torch.distributed``, on one device, and the collectives are written out:

* ``initialize_distributed`` starts the process group from torchrun's
  environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``), with the backend the caller names: NCCL on cards,
  gloo on the CPU. A single process starts nothing.
* ``make_mesh`` lays the ranks out as JAX lays its devices,
  ``np.arange(world).reshape(n_data, n_model[, n_seq])``, so rank r sits
  where JAX's device r sits, and makes a process group along each axis,
  plus the "replica" group (data x seq: the ranks that hold the same
  parameter shards and sum their gradients).
* ``shard_batch`` gives a rank rows [i * B / n, (i + 1) * B / n) of the
  global batch, i its data coordinate. Every rank builds its loader with
  the same seed, so all see the same global batch, and slices it: the
  port's counterpart of ``host_local_batch_to_global`` and ``shard_batch``.
* ``param_spec`` / ``shard_dim``: ``_TP_RULES`` on the port's ``state_dict``
  names. A Flax Dense kernel is [in, out] and a torch Linear weight [out,
  in], so JAX's ``P(None, "model")`` on ``Wq/kernel`` is dim 0 of
  ``rga.Wq.weight``. A dimension that does not divide the model axis is
  replicated, as ``_feasible`` does (the 1007-wide vocabulary).
* The tensor-parallel layers are Megatron's, as GSPMD partitions the
  JAX rules: Wq/Wk/Wv and FFN_pre column-parallel (their input enters
  through ``copy_to``, whose backward all-reduces the input gradient), fc
  and FFN_suf row-parallel (``reduce_from`` all-reduces their output
  before the replicated bias), the embedding vocabulary-parallel, the LM
  head column-parallel with its logits gathered by ``gather_from``: an
  all-reduce of a zero-filled full-width buffer. Every collective of the
  port is an all-reduce, a broadcast or, in the ring, a send/receive, so
  the tensor-parallel path also runs under gloo on CUDA tensors, whose
  CUDA support covers all-reduce and broadcast.

A collective that fails raises; nothing falls back to one rank.
"""

from __future__ import annotations

import datetime
import os
import re
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "model", "seq")


def initialize_distributed(backend: str = "nccl", timeout: Optional[float] = None) -> bool:
    """Start the default process group from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) with
    ``backend`` ("nccl" on cards, "gloo" on the CPU), once. Does nothing
    for a single process (no ``WORLD_SIZE`` or 1) or when the group is
    already up. ``timeout`` in seconds bounds every collective. Returns
    whether a process group is up."""
    if dist.is_available() and dist.is_initialized():
        return True
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend, init_method="env://", rank=int(os.environ["RANK"]),
                            world_size=world, **kw)
    return True


def rank_device(device) -> torch.device:
    """``cuda`` without an index is ``cuda:LOCAL_RANK`` under torchrun (each
    rank on its own card); any other device is kept as it is."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return device


def rank_grid(n_data: int, n_model: int = 1, n_seq: int = 1) -> np.ndarray:
    """The ranks laid out as JAX lays its devices: [n_data, n_model] or,
    with n_seq > 1, [n_data, n_model, n_seq]."""
    shape = (n_data, n_model, n_seq) if n_seq > 1 else (n_data, n_model)
    return np.arange(n_data * n_model * n_seq).reshape(shape)


class Mesh:
    """A rank's place on the (data, model, seq) grid and its process groups.

    ``shape`` and ``coords`` name all three axes (an axis that is not laid
    out has size 1). ``group(axis)`` is the process group of the ranks that
    differ from this one only along ``axis`` ("replica": along data and
    seq), or None where that group is this rank alone; ``ranks(axis)`` its
    global ranks, in coordinate order."""

    def __init__(self, grid: np.ndarray, rank: int, groups=None):
        self.grid = grid
        self.axis_names = AXES[:grid.ndim]
        full = grid if grid.ndim == 3 else grid[..., None]
        self.rank = rank
        self.size = grid.size
        self.shape = dict(zip(AXES, full.shape))
        where = np.argwhere(full == rank)
        if len(where) != 1:
            raise ValueError(f"rank {rank} is not on the mesh {grid.shape}")
        self.coords = dict(zip(AXES, (int(c) for c in where[0])))
        self._groups = groups or {}
        d, m, s = (self.coords[a] for a in AXES)
        self._ranks = {"data": full[:, m, s].tolist(), "model": full[d, :, s].tolist(),
                       "seq": full[d, m, :].tolist(),
                       "replica": full[:, m, :].reshape(-1).tolist()}

    def group(self, axis: str):
        return self._groups.get(axis)

    def ranks(self, axis: str) -> List[int]:
        return self._ranks[axis]


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, n_seq: int = 1) -> Mesh:
    """The (data, model[, seq]) mesh over every process (one without a
    process group). ``n_data`` defaults to world / (n_model * n_seq); the
    mesh must cover every rank. With a process group up, every rank must
    call this together: it makes the groups of every axis, in one order on
    all ranks."""
    up = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if up else 1
    rank = dist.get_rank() if up else 0
    if n_data is None:
        n_data = world // (n_model * n_seq)
    if n_data * n_model * n_seq != world:
        raise ValueError(f"a mesh of data {n_data} x model {n_model} x seq {n_seq} does not "
                         f"cover the {world} processes")
    grid = rank_grid(n_data, n_model, n_seq)
    groups = {}
    if world > 1:
        full = grid if grid.ndim == 3 else grid[..., None]
        lines = {"data": [full[:, m, s] for m in range(n_model) for s in range(n_seq)],
                 "model": [full[d, :, s] for d in range(n_data) for s in range(n_seq)],
                 "seq": [full[d, m, :] for d in range(n_data) for m in range(n_model)],
                 "replica": [full[:, m, :].reshape(-1) for m in range(n_model)]}
        for axis, members in lines.items():
            for ranks in members:
                if len(ranks) > 1:
                    g = dist.new_group(ranks.tolist())  # every rank makes every group
                    if rank in ranks:
                        groups[axis] = g
    return Mesh(grid, rank, groups)


def shard_batch(batch: Dict, mesh: Mesh, leading_accum: bool = False) -> Dict:
    """This rank's rows of a global batch: rows [i * B / n, (i + 1) * B / n)
    of each array, i the data coordinate. With ``leading_accum`` the arrays
    carry a leading [accumulate_steps] axis and the batch is axis 1."""
    n = mesh.shape["data"]
    if n == 1:
        return batch
    axis = 1 if leading_accum else 0
    i = mesh.coords["data"]
    out = {}
    for k, v in batch.items():
        B = v.shape[axis]
        if B % n:
            raise ValueError(f"batch of {B} rows does not divide over {n} data ranks")
        rows = slice(i * B // n, (i + 1) * B // n)
        out[k] = v[:, rows] if leading_accum else v[rows]
    return out


# ---------------------------------------------------------------------------
# tensor-parallel sharding rules
# ---------------------------------------------------------------------------

# state_dict name regex -> the dim sharded over "model": JAX's _TP_RULES
# (parallel/mesh.py:83) through the name map of convert/__init__.py, the
# Dense kernels transposed
_TP_RULES = [
    # attention projections: shard heads (output dim of Wq/Wk/Wv, input of fc)
    (r"rga\.(Wq|Wk|Wv)\.weight$", 0),
    (r"rga\.(Wq|Wk|Wv)\.bias$", 0),
    (r"rga\.fc\.weight$", 1),
    # MLP: shard the hidden dimension
    (r"FFN_pre\.weight$", 0),
    (r"FFN_pre\.bias$", 0),
    (r"FFN_suf\.weight$", 1),
    # embedding + output head: shard the vocab (or regression output) dimension
    (r"^embedding\.weight$", 0),
    (r"^fc(\.0)?\.weight$", 0),
    (r"^fc(\.0)?\.bias$", 0),
]


def param_spec(name: str) -> Optional[int]:
    """The dim of parameter ``name`` that the rules shard, or None
    (replicated)."""
    for pattern, dim in _TP_RULES:
        if re.search(pattern, name):
            return dim
    return None


def shard_dim(name: str, shape: Sequence[int], n_model: int) -> Optional[int]:
    """``param_spec`` where the dim divides ``n_model`` (``_feasible``), else
    None; None for every parameter at n_model 1."""
    dim = param_spec(name)
    if n_model == 1 or dim is None or dim >= len(shape) or shape[dim] % n_model:
        return None
    return dim


def shard_dims(named_shapes, n_model: int) -> Dict[str, Optional[int]]:
    """{name: shard dim or None} for (name, tensor or shape) pairs."""
    return {name: shard_dim(name, tuple(getattr(t, "shape", t)), n_model)
            for name, t in named_shapes}


def local_part(t: torch.Tensor, dim: Optional[int], mesh: Mesh) -> torch.Tensor:
    """This rank's shard of a whole tensor ``t`` along ``dim`` (a contiguous
    copy), or ``t`` itself when it is replicated."""
    if dim is None:
        return t
    n, i = mesh.shape["model"], mesh.coords["model"]
    return t.chunk(n, dim=dim)[i].contiguous()


def gather_whole(t: torch.Tensor, dim: Optional[int], mesh: Mesh) -> torch.Tensor:
    """The whole tensor from every model rank's shard ``t`` along ``dim``
    (an all-reduce of a zero-filled buffer); ``t`` when replicated. Every
    rank of the model group must call it."""
    if dim is None or mesh.shape["model"] == 1:
        return t
    n, i = mesh.shape["model"], mesh.coords["model"]
    shape = list(t.shape)
    size = shape[dim]
    shape[dim] = size * n
    whole = torch.zeros(shape, dtype=t.dtype, device=t.device)
    whole.narrow(dim, i * size, size).copy_(t)
    dist.all_reduce(whole, group=mesh.group("model"))
    return whole


# ---------------------------------------------------------------------------
# collectives as autograd functions
# ---------------------------------------------------------------------------


def _group_sum(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over ``group``, in f32 for a half type (each rank's part is
    rounded once to the compute type, as one process's product is; the sum
    of the parts is rounded once more), in x's dtype."""
    y = (x.float() if x.dtype in (torch.bfloat16, torch.float16) else x.clone()).contiguous()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _CopyTo(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _group_sum(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    """Sum over the group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _group_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    """The whole last dim from each rank's slice (an all-reduce of a
    zero-filled buffer); the backward keeps this rank's slice."""

    @staticmethod
    def forward(ctx, x, group, index, n):
        size = x.shape[-1]
        ctx.cols = (index * size, size)
        whole = x.new_zeros((*x.shape[:-1], size * n))
        whole.narrow(-1, index * size, size).copy_(x)
        dist.all_reduce(whole, group=group)
        return whole

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, *ctx.cols).contiguous(), None, None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: x as it is, its gradient summed over ``group``."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: the sum of x over ``group``, its gradient as it is."""
    return x if group is None else _ReduceFrom.apply(x, group)


def gather_from(x: torch.Tensor, group, index: int, n: int) -> torch.Tensor:
    """The rank slices ``x`` [..., V / n] of ``group`` joined on the last dim."""
    return x if group is None else _GatherFrom.apply(x, group, index, n)


def all_reduce_(tensors: List[torch.Tensor], group) -> None:
    """Sum each tensor over ``group`` in place, through one flat buffer per
    dtype (one all-reduce each)."""
    if group is None or not tensors:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def barrier(mesh: Mesh) -> None:
    """Every rank of the mesh waits for the others (nothing for one rank)."""
    if mesh.size > 1:
        dist.barrier()
