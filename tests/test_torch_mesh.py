"""The port's mesh (``midi_emotion_tpu_torch/parallel/mesh.py``) against the
JAX package's, without processes: the tensor-parallel sharding rules on
every parameter of the flagship config and of a tiny one, the rank layout,
and the batch and parameter slicing."""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401 -- pins JAX to the CPU

import jax

from midi_emotion_tpu.models.model import MusicTransformer as JaxMusicTransformer
from midi_emotion_tpu.models.model import init_params
from midi_emotion_tpu.parallel import mesh as jmesh
from midi_emotion_tpu_torch.convert import state_dict_from_jax_params
from midi_emotion_tpu_torch.models.model import MusicTransformer
from midi_emotion_tpu_torch.parallel import mesh as mesh_lib
from torch_parity import config_pair

FLAGSHIP = dict(vocab_size=1007, mode="continuous_concat", n_layer=20, n_head=16, d_model=768,
                d_inner=3072, d_condition=192, max_seq=2048)
TINY = dict(vocab_size=1008, n_layer=2, n_head=4, d_model=64, d_inner=128, d_condition=16,
            max_seq=64)


def _jax_dims(shapes, tcfg, n_model):
    """{port parameter name: shard dim or None} as JAX's
    ``_feasible(param_spec(path), shape, mesh)`` gives them for the
    parameter shapes ``shapes``, mapped through the port's name map
    (``state_dict_from_jax_params``): a Dense kernel comes back transposed,
    so its dim is flipped."""
    mesh = jmesh.make_mesh(n_data=1, n_model=n_model, devices=jax.devices()[:n_model])
    specs = {}

    def mark(kp, leaf):
        path = "/".join(str(getattr(k, "key", k)) for k in kp)
        spec = jmesh._feasible(jmesh.param_spec(path), leaf.shape, mesh)
        dims = [i for i, axis in enumerate(spec) if axis == "model"]
        specs[path] = dims[0] if dims else None
        # a marker whose shape shows whether the name map transposes it
        return np.full((2, 3) if len(leaf.shape) == 2 else (1,), len(specs) - 1, np.float32)

    markers = jax.tree_util.tree_map_with_path(mark, shapes)
    paths = list(specs)
    out = {}
    for name, t in state_dict_from_jax_params(markers, tcfg).items():
        dim = specs[paths[int(t.reshape(-1)[0])]]
        if dim is not None and tuple(t.shape) == (3, 2):  # [in, out] -> [out, in]
            dim = 1 - dim
        out[name] = dim
    return out


@pytest.mark.parametrize("mode", ["continuous_concat", "continuous_token", "none", "regression"])
@pytest.mark.parametrize("size", ["flagship", "tiny"])
def test_shard_dims_match_jax_rules(size, mode):
    """At model 2 and 4, every parameter's shard dim is JAX's: the flagship
    shards heads and MLP and replicates its 1007-wide vocabulary; the tiny
    config's 1008 shards it."""
    base = FLAGSHIP if size == "flagship" else TINY
    jcfg, tcfg = config_pair(**{**base, "mode": mode})
    names = dict(MusicTransformer(tcfg, device="meta").named_parameters())
    shapes = jax.eval_shape(lambda: init_params(JaxMusicTransformer(jcfg),
                                                jax.random.PRNGKey(0)))
    for n_model in (2, 4):
        want = _jax_dims(shapes, tcfg, n_model)
        got = mesh_lib.shard_dims(names.items(), n_model)
        assert got == want, n_model
        assert sum(d is not None for d in got.values()) >= 6 * base["n_layer"]
    vocab_dim = mesh_lib.shard_dims(names.items(), 2)["embedding.weight"]
    assert vocab_dim == (None if size == "flagship" else 0)


@pytest.mark.parametrize("shape", [(2, 1, 1), (1, 2, 1), (2, 2, 1), (1, 1, 4), (2, 1, 2)])
def test_rank_layout_matches_jax_device_grid(shape):
    """Rank r sits where JAX's device r sits on make_mesh(n_data, n_model,
    n_seq), and each axis's group holds the ranks of its line (the grid
    make_mesh lays out, read at every rank without processes)."""
    n_data, n_model, n_seq = shape
    world = n_data * n_model * n_seq
    jax_mesh = jmesh.make_mesh(n_data=n_data, n_model=n_model, n_seq=n_seq,
                               devices=jax.devices()[:world])
    ids = np.vectorize(lambda d: d.id)(jax_mesh.devices)
    names = jax_mesh.axis_names
    for r in range(world):
        m = mesh_lib.Mesh(mesh_lib.rank_grid(n_data, n_model, n_seq), r)
        assert m.axis_names == names and m.grid.shape == ids.shape
        where = tuple(int(c) for c in np.argwhere(ids == r)[0])
        assert tuple(m.coords[a] for a in names) == where
        for axis in names:
            line = [int(ids[tuple(slice(None) if a == axis else where[j]
                                  for j, a in enumerate(names))][i])
                    for i in range(jax_mesh.shape[axis])]
            assert m.ranks(axis) == line


def test_shard_batch_and_local_parts():
    """Data rank i takes rows [i B / n, (i + 1) B / n), the accumulate axis
    kept; a model rank's parameter slice and the gathered whole."""
    batch = {"input": np.arange(2 * 4 * 3).reshape(2, 4, 3), "condition": np.zeros((2, 4, 2))}
    rows = []
    for r in range(2):
        m = mesh_lib.Mesh(mesh_lib.rank_grid(2, 1), r)
        part = mesh_lib.shard_batch(batch, m, leading_accum=True)
        assert part["input"].shape == (2, 2, 3) and part["condition"].shape == (2, 2, 2)
        rows.append(part["input"])
    np.testing.assert_array_equal(np.concatenate(rows, axis=1), batch["input"])
    flat = {"input": batch["input"][0]}
    m = mesh_lib.Mesh(mesh_lib.rank_grid(2, 1), 1)
    np.testing.assert_array_equal(mesh_lib.shard_batch(flat, m)["input"], flat["input"][2:])
    with pytest.raises(ValueError, match="does not divide"):
        mesh_lib.shard_batch({"input": np.zeros((3, 5))}, m)
    w = torch.arange(24.0).reshape(4, 6)
    parts = [mesh_lib.local_part(w, 1, mesh_lib.Mesh(mesh_lib.rank_grid(1, 2), r))
             for r in range(2)]
    assert torch.equal(torch.cat(parts, dim=1), w) and parts[0].is_contiguous()
    one = mesh_lib.make_mesh()
    assert one.shape == {"data": 1, "model": 1, "seq": 1} and one.group("replica") is None
    assert mesh_lib.gather_whole(parts[0], 1, one) is parts[0]
    with pytest.raises(ValueError, match="does not cover"):
        mesh_lib.make_mesh(2)


def test_initialize_distributed_is_a_no_op_for_one_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert mesh_lib.initialize_distributed("gloo") is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert mesh_lib.initialize_distributed("gloo") is False
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert mesh_lib.rank_device("cuda") == torch.device("cuda", 3)
    assert mesh_lib.rank_device("cuda:0") == torch.device("cuda", 0)
    assert mesh_lib.rank_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("D", [16, 7])
def test_dropout_place_draws_the_slice_of_the_global_mask(D):
    """A rank's [B, T, D] slice at place (b0, t0, T_g) drops what one
    process drops at those elements of the global tensor, forward and
    backward, in the dropout and the dropout + add + LayerNorm functions;
    the default place is the old mask."""
    from midi_emotion_tpu_torch.ops import fused_dropout as fd

    rate, seed = 0.25, 11
    g = torch.Generator().manual_seed(0)
    sub, res, dy = (torch.randn((4, 12, D), generator=g) for _ in range(3))
    w, b = torch.randn(D, generator=g), torch.randn(D, generator=g)
    whole_y = fd.dropout_add_layernorm(sub.requires_grad_(), res, w, b, seed, rate)
    whole_y.backward(dy)
    whole_d = fd.fused_dropout(res, seed, rate)
    for b0, t0, B, T in ((0, 0, 4, 12), (2, 0, 2, 12), (1, 4, 2, 4), (3, 8, 1, 4)):
        rows, cols = slice(b0, b0 + B), slice(t0, t0 + T)
        part = lambda t: t[rows, cols].detach().clone()
        s = part(sub).requires_grad_()
        y = fd.dropout_add_layernorm(s, part(res), w, b, seed, rate, place=(b0, t0, 12))
        y.backward(part(dy))
        assert torch.equal(y, whole_y[rows, cols]) and torch.equal(s.grad, sub.grad[rows, cols])
        d = fd.fused_dropout(part(res), seed, rate, place=(b0, t0, 12))
        assert torch.equal(d, whole_d[rows, cols])
        keep = fd.keep_mask(seed, (B, T, D), rate, (b0, t0, 12))
        assert torch.equal(keep, fd.keep_mask(seed, (4, 12, D), rate)[rows, cols])
    assert torch.equal(fd.fused_dropout(res, seed, rate, place=(0, 0, 12)), whole_d)
    with pytest.raises(ValueError, match="slice"):
        fd.fused_dropout(res, seed, rate, place=(0, 4, 12))
    with pytest.raises(ValueError, match=r"\[B, T, D\]"):
        fd.fused_dropout(res[0], seed, rate, place=(0, 0, 12))


def test_seq_part_is_contiguous_and_the_dropout_functions_refuse_strides():
    """A seq rank's positions of a [B, T, D] activation (B > 1) come back
    contiguous, as the dropout kernels take them, and the dropout functions
    refuse a strided tensor on the CPU as the card does, so a CPU run of the
    ring model sees a layout the card would reject."""
    from midi_emotion_tpu_torch.models.config import ModelConfig
    from midi_emotion_tpu_torch.ops import fused_dropout as fd

    cfg = ModelConfig(**{**TINY, "mode": "continuous_concat", "dropout": 0.1})
    model = MusicTransformer(cfg, device="cpu")
    x = torch.randn((4, 16, 64), generator=torch.Generator().manual_seed(1))
    w, b = torch.ones(64), torch.zeros(64)
    for rank in (0, 1):
        model.mesh = mesh_lib.Mesh(mesh_lib.rank_grid(1, 1, 2), rank)
        part = model.seq_part(x)
        assert part.is_contiguous() and torch.equal(part, x[:, rank * 8:(rank + 1) * 8])
        place = model.dropout_place(*part.shape[:2])
        assert place == (0, rank * 8, 16)
        y = fd.fused_dropout(x, 5, 0.1)
        assert torch.equal(fd.fused_dropout(part, 5, 0.1, place=place), y[:, rank * 8:][:, :8])
    strided = x[:, 8:]
    with pytest.raises(ValueError, match="contiguous"):
        fd.fused_dropout(strided, 5, 0.1, place=(0, 8, 16))
    with pytest.raises(ValueError, match="contiguous"):
        fd.dropout_add_layernorm(strided.contiguous(), strided, w, b, 5, 0.1, place=(0, 8, 16))
    with pytest.raises(ValueError, match="contiguous"):
        fd.dropout_add_layernorm_bwd(strided.contiguous(), strided.contiguous(), strided, w, 5,
                                     0.1, place=(0, 8, 16))
