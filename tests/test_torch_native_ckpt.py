"""Torch port, native checkpoints: the port's Flax msgpack codec held to
Flax's on shared trees (decoded bitwise, encoded byte for byte, chunked
leaves), native work dirs the JAX package writes served and resumed by the
port (logits within 1e-4, the f32 bound of tests/test_torch_model.py; one
more Adam step from the restored optimizer.msgpack within 1e-5, the
trajectory bound of tests/test_torch_training.py), native dirs the port
writes read back bitwise by the JAX package, and the training and
generation CLIs on a JAX-written native dir."""

import csv
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import conftest  # noqa: F401 -- pins JAX to the CPU
from synth_data import make_dataset

import jax
import jax.numpy as jnp
from flax import serialization

from midi_emotion_tpu.training import checkpoint as jckpt
from midi_emotion_tpu.training import train_step as jts
from midi_emotion_tpu.training.metrics import CsvWriter as JaxCsvWriter
from midi_emotion_tpu.vocab import DEFAULT_VOCAB as JAX_VOCAB
from midi_emotion_tpu_torch.cli import generate_cli, train_cli
from midi_emotion_tpu_torch.convert import (
    flax_msgpack, is_native_dir, jax_params_from_state_dict, load_model_dir,
    save_reference_dir, state_dict_from_jax_params)
from midi_emotion_tpu_torch.convert import native
from midi_emotion_tpu_torch.training import checkpoint as tckpt
from midi_emotion_tpu_torch.training.train_step import make_optimizer, make_train_step
from midi_emotion_tpu_torch.vocab import DEFAULT_VOCAB

from torch_parity import assert_close, config_pair, model_pair

TINY = dict(vocab_size=1007, n_layer=2, n_head=4, d_model=64, d_inner=128, d_condition=16,
            max_seq=64, dropout=0.0, remat=False)
TOKENS = np.array([[1, 5, 9, 100, 882, 7], [1, 900, 30, 0, 0, 0]], np.int32)
COND = np.array([[0.5, -0.5], [-0.25, 1.0]], np.float32)


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------


def _tiny_params():
    jcfg = config_pair(mode="continuous_concat", **TINY)[0]
    return jax.device_get(model_pair(jcfg)[1])


def _trees():
    params = _tiny_params()
    rng = np.random.RandomState(0)
    return {
        "params": params,
        # an optax state: int32 scalar count, empty maps, "0".."2" keys
        "optax": serialization.to_state_dict(
            jax.device_get(jts.make_optimizer(1.0).init(params))),
        # keys sorted, as msgpack_serialize's tree_map leaves them
        "bf16": {"b": np.asarray(jnp.asarray(rng.randn(7), jnp.bfloat16)),
                 "w": np.asarray(jnp.asarray(rng.randn(3, 5), jnp.bfloat16))},
        "npscalar": {"d": np.float64(1e-300), "f": np.float32(2.5), "i": np.int64(-7),
                     "u": np.uint8(200), "v": np.arange(6, dtype=np.int16)},
    }


def _assert_tree_bitwise(got, want, path="/"):
    """got: the port's decoding; want: Flax's msgpack_restore."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _assert_tree_bitwise(got[k], want[k], f"{path}{k}/")
        return
    if want.dtype.name == "bfloat16":
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, path
        assert tuple(got.shape) == want.shape, path
        assert got.view(torch.int16).numpy().tobytes() == np.asarray(want).tobytes(), path
        return
    assert type(got) is type(want), (path, type(got), type(want))
    assert got.dtype == want.dtype and got.shape == want.shape, path
    assert got.tobytes() == want.tobytes(), path


@pytest.mark.parametrize("name", ["params", "optax", "bf16", "npscalar"])
def test_codec_decodes_flax_bytes_bitwise(name):
    tree = _trees()[name]
    raw = serialization.to_bytes(tree)
    want = serialization.msgpack_restore(raw)
    _assert_tree_bitwise(flax_msgpack.decode(raw), want)
    _assert_tree_bitwise(flax_msgpack.decode(bytearray(raw)), want)


@pytest.mark.parametrize("name", ["params", "optax", "bf16", "npscalar"])
def test_codec_encodes_flax_bytes(name):
    tree = _trees()[name]
    assert flax_msgpack.encode(tree) == serialization.msgpack_serialize(tree)
    assert flax_msgpack.encode(tree) == serialization.to_bytes(tree)
    # the port's own leaves: torch tensors (bf16 too) encode as Flax's arrays
    if name in ("params", "bf16"):
        as_torch = jax.tree_util.tree_map(
            lambda a: torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
            if a.dtype.name == "bfloat16" else torch.from_numpy(np.array(a)), tree)
        assert flax_msgpack.encode(as_torch) == serialization.msgpack_serialize(tree)


def test_codec_keeps_insertion_order_and_scalar_types():
    """``to_bytes`` keeps each map's insertion order (``msgpack_serialize``
    without in_place sorts, through jax.tree_map); Python scalars, None,
    complex and every int width encode as msgpack does."""
    tree = {"z": np.zeros(2, np.float32), "a": {"y": 1, "b": -40, "c": 300, "d": -300,
                                                 "e": 70000, "f": -70000, "g": 2 ** 40,
                                                 "h": -2 ** 40, "s": "x" * 40, "n": None,
                                                 "t": True, "q": 0.25, "j": 1 + 2j}}
    raw = serialization.to_bytes(tree)
    assert flax_msgpack.encode(tree) == raw
    got = flax_msgpack.decode(raw)
    assert list(got) == ["z", "a"] and got["a"] == serialization.msgpack_restore(raw)["a"]
    with pytest.raises(TypeError):
        flax_msgpack.encode({"t": (1, 2)})  # strict types, as msgpack_serialize


def test_codec_reads_and_writes_chunked_leaves(monkeypatch):
    """A leaf above MAX_CHUNK_SIZE bytes goes out as flat chunks; the
    JAX package itself is untouched (only Flax's constant is patched)."""
    tree = {"big": np.arange(1001 * 3, dtype=np.float32).reshape(3, 1001),
            "bf": np.asarray(jnp.arange(700, dtype=jnp.bfloat16)),
            "small": {"x": np.arange(10, dtype=np.int8)}}
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 1000)
    raw = serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in raw
    got = flax_msgpack.decode(raw)
    np.testing.assert_array_equal(got["big"], tree["big"])
    assert got["bf"].dtype == torch.bfloat16 and tuple(got["bf"].shape) == (700,)
    assert got["bf"].view(torch.int16).numpy().tobytes() == tree["bf"].tobytes()
    np.testing.assert_array_equal(got["small"]["x"], tree["small"]["x"])
    assert flax_msgpack.encode(tree, max_chunk_size=1000) == raw
    monkeypatch.undo()
    _assert_tree_bitwise(flax_msgpack.decode(raw), serialization.msgpack_restore(raw))


# ---------------------------------------------------------------------------
# native work dirs the JAX package writes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["continuous_concat", "continuous_token", "discrete_token",
                                  "regression"])
def test_port_serves_jax_native_dir(tmp_path, mode):
    """JAX save_checkpoint -> the port's load_model_dir: the same config,
    vocab and weights, logits within 1e-4."""
    jcfg, tcfg = config_pair(mode=mode, **TINY)
    jmodel, params, _ = model_pair(jcfg)
    vocab = JAX_VOCAB.with_extra_tokens(["<V-2>", "<A2>"]) if mode == "discrete_token" \
        else JAX_VOCAB
    jckpt.save_checkpoint(str(tmp_path), params, jcfg, vocab)
    assert is_native_dir(str(tmp_path))
    cfg, model, tvocab = load_model_dir(str(tmp_path), device="cpu")
    assert cfg == tcfg and tvocab.to_dict() == vocab.to_dict()
    want = np.asarray(jmodel.apply({"params": params}, TOKENS, COND, True))
    with torch.inference_mode():
        got = model(torch.from_numpy(TOKENS).long(), torch.from_numpy(COND))
    assert_close(got, want, 1e-4)
    # the tree maps back to itself, key order and all (so the bytes agree)
    back = jax_params_from_state_dict(model.state_dict(), cfg)
    assert flax_msgpack.encode(back) == serialization.to_bytes(jax.device_get(params))


def _batches(n, B=3, T=12, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        tgt = rng.randint(2, 1000, size=(1, B, T)).astype(np.int32)
        tgt[:, :, -3:] = 0
        out.append({"input": rng.randint(2, 1000, size=(1, B, T)).astype(np.int32),
                    "target": tgt,
                    "condition": rng.uniform(-1, 1, size=(1, B, 2)).astype(np.float32)})
    return out


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """A native work dir the JAX package wrote after 2 train steps (mode
    "none", as the trajectory test, for its fewer exactly-zero gradients):
    model, optimizer, stats and a performance.csv."""
    jcfg = config_pair(mode="none", **TINY)[0]
    jmodel, params, _ = model_pair(jcfg)
    opt = jts.make_optimizer(1.0)
    step = jts.make_train_step(jmodel, opt, accumulate_steps=1, donate=False)
    opt_state = opt.init(params)
    batches, lrs = _batches(3), [1e-3, 2e-3, 5e-4]
    for batch, lr in zip(batches[:2], lrs[:2]):
        params, opt_state, _ = step(params, opt_state, batch, jax.random.PRNGKey(0),
                                    np.float32(lr))
    work = str(tmp_path_factory.mktemp("jax_native"))
    jckpt.save_checkpoint(work, params, jcfg, JAX_VOCAB, opt_state=opt_state,
                          stats={"step": 2, "hour": 0.01, "epoch": 0, "sample": 6})
    writer = JaxCsvWriter(os.path.join(work, "performance.csv"),
                          ["epoch", "step", "hour", "lr", "trn_loss", "val_loss", "val_l1_v",
                           "val_l1_a"])
    writer.update({"epoch": 0, "step": 1, "hour": 0.01, "lr": 1e-3, "trn_loss": 6.9,
                   "val_loss": np.nan, "val_l1_v": np.nan, "val_l1_a": np.nan})
    return dict(dir=work, cfg=jcfg, params=params, opt_state=opt_state, step=step,
                batch=batches[2], lr=lrs[2])


def test_adam_resumes_from_jax_optimizer_msgpack(tmp_path, jax_native):
    """A native dir after 2 JAX train steps: its logits to 1e-4;
    optimizer.msgpack -> torch Adam (count -> step, mu/nu -> exp_avg /
    exp_avg_sq through the name map), then one more step on both sides:
    loss to 1e-5, every parameter to 1e-5 (the key biases aside, as in
    tests/test_torch_training.py)."""
    work, jcfg = jax_native["dir"], jax_native["cfg"]
    cfg, model, _ = load_model_dir(work, device="cpu", param_dtype=torch.float32)
    want = np.asarray(model_pair(jcfg)[0].apply({"params": jax_native["params"]}, TOKENS, COND,
                                                True))
    with torch.inference_mode():  # the trained weights serve as JAX's do
        assert_close(model(torch.from_numpy(TOKENS).long(), torch.from_numpy(COND)), want, 1e-4)
    optimizer = make_optimizer(model)
    assert tckpt.load_opt_state(work, optimizer, model)
    adam = serialization.to_state_dict(jax.device_get(jax_native["opt_state"]))["1"]
    mu = state_dict_from_jax_params(adam["mu"], cfg)
    for name, p in model.named_parameters():
        state = optimizer.state[p]
        assert int(state["step"]) == 2
        assert torch.equal(state["exp_avg"], mu[name]), name
    params, _, jm = jax_native["step"](jax_native["params"], jax_native["opt_state"],
                                       jax_native["batch"], jax.random.PRNGKey(0),
                                       np.float32(jax_native["lr"]))
    batch = {k: torch.from_numpy(v).long() if v.dtype != np.float32 else torch.from_numpy(v)
             for k, v in jax_native["batch"].items()}
    tm = make_train_step(model, optimizer, clip=1.0)(batch, jax_native["lr"])
    assert_close(tm["loss"].item(), float(jm["loss"]), 1e-5)
    got = model.state_dict()
    for name, w in state_dict_from_jax_params(params, cfg).items():
        if not name.endswith("Wk.bias"):
            assert_close(got[name], w, 1e-5)
    # a tree that does not fit, or a truncated file, leaves the optimizer afresh
    fresh = make_optimizer(model)
    wrong = {"0": {"count": np.asarray(1, np.int32), "mu": {"embedding": {}}, "nu": {}}}
    assert not native.load_adam_state(wrong, fresh, model) and not fresh.state
    cut = os.path.join(str(tmp_path), "optimizer.msgpack")
    with open(os.path.join(work, "optimizer.msgpack"), "rb") as f:
        open(cut, "wb").write(f.read()[:5000])
    assert not tckpt.load_opt_state(str(tmp_path), fresh, model) and not fresh.state


def test_port_native_dir_reads_back_in_jax(tmp_path, jax_native):
    """The port's save_native_dir after one port step: the JAX package's
    load_model_dir and load_opt_state(template) give back the port's trees
    bitwise; the port's own decoder reads every leaf back bitwise. A dir
    never holds both layouts."""
    cfg, model, vocab = load_model_dir(jax_native["dir"], device="cpu",
                                       param_dtype=torch.float32)
    optimizer = make_optimizer(model)
    tckpt.load_opt_state(jax_native["dir"], optimizer, model)
    batch = {k: torch.from_numpy(v).long() if v.dtype != np.float32 else torch.from_numpy(v)
             for k, v in jax_native["batch"].items()}
    make_train_step(model, optimizer, clip=1.0)(batch, 1e-3)
    work = str(tmp_path / "native")
    written = tckpt.save_native_dir(work, model, cfg, vocab, optimizer,
                                    stats={"step": 3, "hour": 0.0, "epoch": 0, "sample": 9})
    assert set(written) == {"model.msgpack", "optimizer.msgpack"}
    assert written["model.msgpack"][0] == os.path.getsize(os.path.join(work, "model.msgpack"))
    assert sorted(os.listdir(work)) == ["model.msgpack", "model_config.json", "optimizer.msgpack",
                                        "stats.json", "vocab.json"]
    jcfg, jparams, jvocab = jckpt.load_model_dir(work)
    assert jcfg == jax_native["cfg"] and jvocab.to_dict() == vocab.to_dict()
    want_params = jax_params_from_state_dict(model.state_dict(), cfg)
    _assert_tree_bitwise(jax.device_get(jparams), want_params)
    template = jax.device_get(jts.make_optimizer(1.0).init(jparams))
    restored = jckpt.load_opt_state(work, template)
    assert restored is not None
    want_opt = native.opt_state_from_adam(optimizer, model, 1.0)
    restored = serialization.to_state_dict(jax.device_get(restored))
    assert int(restored["1"]["count"]) == 3 and restored["1"]["count"].dtype == np.int32
    _assert_tree_bitwise(restored, want_opt)
    _assert_tree_bitwise(flax_msgpack.read(os.path.join(work, "optimizer.msgpack")), want_opt)
    _assert_tree_bitwise(native.load_params(work), want_params)
    assert json.load(open(os.path.join(work, "stats.json")))["step"] == 3

    # save_checkpoint keeps the layout a dir holds; no writer mixes them
    tckpt.save_checkpoint(work, model, cfg, vocab, optimizer)
    assert not any(f.endswith(".pt") for f in os.listdir(work))
    with pytest.raises(ValueError, match="native"):
        save_reference_dir(work, cfg, model.state_dict(), vocab)
    ref = str(tmp_path / "reference")
    tckpt.save_checkpoint(ref, model, cfg, vocab, optimizer)
    assert not is_native_dir(ref) and os.path.exists(os.path.join(ref, "optimizer.pt"))
    with pytest.raises(ValueError, match="reference layout"):
        tckpt.save_native_dir(ref, model, cfg, vocab)
    assert not is_native_dir(ref)


# ---------------------------------------------------------------------------
# the CLIs on a JAX-written native dir
# ---------------------------------------------------------------------------


def test_restart_and_generate_cli_on_jax_native_dir(tmp_path, jax_native):
    """train_cli --restart_dir <native dir> continues from its stats.json
    step, Adam state and performance.csv, with the dir's config but for
    the remat, which --remat auto resolves for this run (the plain
    attention on the CPU: dots); generate_cli serves the dir."""
    folder, records = make_dataset(str(tmp_path / "data"), n_songs=12, bars_per_song=8)
    feats = str(tmp_path / "features.csv")
    with open(feats, "w") as f:
        f.write("file,valence,note_density_per_instrument,n_instruments,is_matched\n")
        f.writelines(f"{r['file']},{r['valence']},{3.0 + i * 0.1},4,True\n"
                     for i, r in enumerate(records))
    runner = train_cli.main([
        "--data_folder", folder, "--feature_file", feats, "--conditioning", "none",
        "--tgt_len", "24", "--batch_size", "3", "--lr", "1e-3", "--log_step", "1",
        "--eval_step", "100", "--gen_step", "1000", "--max_eval_step", "1", "--seed", "1",
        "--dtype", "f32", "--num_workers", "0", "--device", "cpu",
        "--work_dir", str(tmp_path / "run"), "--max_step", "4",
        "--restart_dir", jax_native["dir"]])
    assert runner.train_step_num == 4 and runner.cfg == dataclasses.replace(
        native.read_config_and_vocab(jax_native["dir"])[0], remat=True, remat_policy="dots")
    assert {int(s["step"]) for s in runner.optimizer.state.values()} == {4}  # 2 restored + 2
    with open(os.path.join(runner.args.work_dir, "performance.csv")) as f:
        rows = list(csv.DictReader(f))
    assert [int(r["step"]) for r in rows] == [1, 2, 3]  # the JAX row, then steps 2 and 3
    assert json.load(open(os.path.join(runner.args.work_dir, "stats.json")))["step"] == 3
    generate_cli.main([
        "--model_dir", jax_native["dir"], "--conditioning", "none", "--batch_size", "2",
        "--gen_len", "16", "--max_input_len", "12", "--dtype", "f32", "--device", "cpu",
        "--quiet", "--short_filename", "--seed", "3"])
    out = os.path.join(jax_native["dir"], "generations", "inference")
    assert len([f for f in os.listdir(out) if f.endswith(".npy")]) == 2
    assert DEFAULT_VOCAB.to_dict() == JAX_VOCAB.to_dict()
