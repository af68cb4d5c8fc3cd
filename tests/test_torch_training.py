"""Torch port, training: the train step held to the JAX ``make_train_step``
over a 4-update trajectory from the same weights (f32, dropout 0, clip
1.0, an LR that changes, pad targets, 2 microbatches per update), one
regression (L1) step, the eval step, the data layer against the JAX one,
and the Runner through the training CLI on the CPU: train, checkpoint,
resume, and serve the trained work dir."""

import os

import numpy as np
import pytest
import torch

import conftest  # noqa: F401 -- pins JAX to the CPU
from synth_data import make_dataset, make_feature_csv

import jax

from midi_emotion_tpu.data import loader as jloader
from midi_emotion_tpu.data.features import preprocess_features as jax_preprocess_features
from midi_emotion_tpu.training import train_step as jts
from midi_emotion_tpu.training.checkpoint import load_model_dir as jax_load_model_dir
from midi_emotion_tpu_torch.cli import generate_cli, train_cli
from midi_emotion_tpu_torch.convert import state_dict_from_jax_params
from midi_emotion_tpu_torch.data import loader as tloader
from midi_emotion_tpu_torch.data.features import preprocess_features
from midi_emotion_tpu_torch.ops import flash_attention as fa
from midi_emotion_tpu_torch.training.train_step import (
    make_eval_step, make_optimizer, make_train_step)

from torch_parity import assert_close, config_pair, model_pair

TINY = dict(vocab_size=1007, n_layer=2, n_head=4, d_model=32, d_inner=64, d_condition=8,
            max_seq=64, dropout=0.0, remat=False)


def _batches(n, A, B, T, seed=0):
    """n updates of [A, B, ...] numpy microbatches; targets end in pads."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        tgt = rng.randint(2, 1000, size=(A, B, T)).astype(np.int32)
        tgt[:, :, -3:] = 0
        out.append({"input": rng.randint(2, 1000, size=(A, B, T)).astype(np.int32),
                    "target": tgt,
                    "condition": rng.uniform(-1, 1, size=(A, B, 2)).astype(np.float32)})
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype != np.float32 else torch.from_numpy(v)
            for k, v in batch.items()}


def _run_both(jcfg, batches, lrs, accumulate, attn_impl="plain"):
    jmodel, params, tmodel = model_pair(jcfg, attn_impl)
    opt = jts.make_optimizer(1.0)
    jstep = jts.make_train_step(jmodel, opt, accumulate_steps=accumulate, donate=False)
    tstep = make_train_step(tmodel, make_optimizer(tmodel), clip=1.0,
                            accumulate_steps=accumulate)
    opt_state = opt.init(params)
    out = []
    for batch, lr in zip(batches, lrs):
        params, opt_state, jm = jstep(params, opt_state, batch, jax.random.PRNGKey(0),
                                      np.float32(lr))
        tm = tstep(_torch_batch(batch), lr)
        out.append((jm, tm))
    return out, params, tmodel


def _assert_params_close(tmodel, params, tcfg, tol):
    """Every parameter to ``tol``, but the key projections' biases: their
    gradient is zero in exact arithmetic (a shift of every key's score
    leaves the softmax unchanged), so Adam turns each package's rounding
    noise into steps of about the LR, of either sign."""
    got = tmodel.state_dict()
    for name, w in state_dict_from_jax_params(params, tcfg).items():
        if not name.endswith("Wk.bias"):
            assert_close(got[name], w, tol)


def test_train_step_trajectory_matches_jax():
    """4 updates of 2 microbatches: loss and pre-clip grad norm to 1e-5 at
    every update, the parameters to 1e-5 at the end (Adam's first steps
    move each weight by about lr, so this pins clip, accumulation, bias
    correction and the LR placement). Mode "none": continuous_concat's
    condition channels are constant over time, which gives more
    exactly-zero gradients (see _assert_params_close)."""
    jcfg, tcfg = config_pair(mode="none", **TINY)
    lrs = [1e-3, 5e-4, 2e-3, 1e-3]
    out, params, tmodel = _run_both(jcfg, _batches(4, 2, 3, 12), lrs, accumulate=2)
    for jm, tm in out:
        assert_close(tm["loss"].item(), float(jm["loss"]), 1e-5)
        assert_close(tm["grad_norm"].item(), float(jm["grad_norm"]), 1e-5)
    assert float(out[0][0]["grad_norm"]) > 1.0  # the clip is active
    _assert_params_close(tmodel, params, tcfg, 1e-5)


def test_train_step_trajectory_matches_jax_at_d_head_256():
    """2 updates of 2 microbatches at one head of 256 (the widest the
    port's kernels are built for), the port's attention through the flash
    wrapper (its twins on the CPU): loss and
    grad norm to 1e-5 at each update, the parameters to 1e-4 after: at
    this width Adam's first steps turn rounding noise in gradient elements
    near 0 into moves of up to the LR, whatever the attention path (with
    the plain closed form in place of the flash twin the same run ends
    3.5e-5 apart)."""
    jcfg, tcfg = config_pair(mode="none", **{**TINY, "n_head": 1, "d_model": 256})
    assert fa.padded_dh(256) == 256  # the card's kernels take this head whole
    out, params, tmodel = _run_both(jcfg, _batches(2, 2, 2, 12, seed=2), [1e-3, 5e-4],
                                    accumulate=2, attn_impl="kernel")
    for jm, tm in out:
        assert_close(tm["loss"].item(), float(jm["loss"]), 1e-5)
        assert_close(tm["grad_norm"].item(), float(jm["grad_norm"]), 1e-5)
    _assert_params_close(tmodel, params, tcfg, 1e-4)


def test_train_step_trajectory_matches_jax_at_d_head_384():
    """The same at one head of 384 in each of the 2 layers, past the built
    widths of every kernel (the card runs the wide kernels there): 2
    updates of 2 microbatches, loss and grad norm to 1e-5 at each update,
    the parameters to 1e-4 after."""
    jcfg, tcfg = config_pair(mode="none", **{**TINY, "n_head": 1, "d_model": 384})
    assert fa.padded_dh(384) == 384
    out, params, tmodel = _run_both(jcfg, _batches(2, 2, 2, 12, seed=2), [1e-3, 5e-4],
                                    accumulate=2, attn_impl="kernel")
    for jm, tm in out:
        assert_close(tm["loss"].item(), float(jm["loss"]), 1e-5)
        assert_close(tm["grad_norm"].item(), float(jm["grad_norm"]), 1e-5)
    _assert_params_close(tmodel, params, tcfg, 1e-4)


def test_regression_step_and_eval_step_match_jax():
    """One L1 regression update (loss, grad norm, parameters to 1e-5) and
    the LM eval step's loss, top-1 and top-5 (to 1e-5)."""
    jcfg, tcfg = config_pair(mode="regression", **TINY)
    batch = _batches(1, 1, 2, 10, seed=1)[0]
    batch.pop("target")
    out, params, tmodel = _run_both(jcfg, [batch], [1e-3], accumulate=1)
    (jm, tm), = out
    assert_close(tm["loss"].item(), float(jm["loss"]), 1e-5)
    assert_close(tm["grad_norm"].item(), float(jm["grad_norm"]), 1e-5)
    _assert_params_close(tmodel, params, tcfg, 1e-5)

    jcfg = config_pair(mode="continuous_concat", **TINY)[0]
    jmodel, params, tmodel = model_pair(jcfg)
    ebatch = {k: v[0] for k, v in _batches(1, 1, 2, 10, seed=2)[0].items()}
    with torch.no_grad():  # half the targets are the model's top choice
        top = tmodel(torch.from_numpy(ebatch["input"]).long(),
                     torch.from_numpy(ebatch["condition"])).argmax(-1).numpy()
    ebatch["target"][:, ::2] = top[:, ::2]
    want = jts.make_eval_step(jmodel)(params, ebatch)
    got = make_eval_step(tmodel)(_torch_batch(ebatch))
    assert float(want["top1"]) > 0.3
    for key in ("loss", "top1", "top5", "n_elements"):
        assert_close(got[key].item(), float(want[key]), 1e-5)


def test_preprocess_features_matches_jax_without_pandas(tmp_path):
    path = str(tmp_path / "features.csv")
    make_feature_csv(path, n_songs=40)
    lines = open(path).read().splitlines()
    for row, col in ((3, 1), (7, 2), (11, 4), (15, 3)):  # NA fields, is_matched too
        parts = lines[row].split(",")
        parts[col] = ""
        lines[row] = ",".join(parts)
    open(path, "w").write("\n".join(lines) + "\n")
    for n_bins in (None, 5):
        for labeled_only in (True, False):
            want = jax_preprocess_features(path, n_bins=n_bins, use_labeled_only=labeled_only)
            got = preprocess_features(path, n_bins=n_bins, use_labeled_only=labeled_only)
            assert repr(got) == repr(want)


def test_song_shards_load_in_both_packages(tmp_path):
    rng = np.random.RandomState(0)
    bars = [rng.randint(0, 100, size=(n, 2)).astype(np.int16) for n in (5, 0, 9)]
    for save, load in ((tloader.save_song_shard, jloader.load_song_shard),
                       (jloader.save_song_shard, tloader.load_song_shard)):
        path = str(tmp_path / f"{save.__module__.split('.')[0]}.npz")
        save(path, "song", bars)
        got = load(path)
        assert len(got) == len(bars)
        for g, b in zip(got, bars):
            np.testing.assert_array_equal(g, b)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    folder, records = make_dataset(str(root), n_songs=12, bars_per_song=8)
    csv = str(root / "features.csv")
    rows = ["file,valence,note_density_per_instrument,n_instruments,is_matched"]
    rows += [f"{r['file']},{r['valence']},{3.0 + i * 0.1},4,True" for i, r in enumerate(records)]
    with open(csv, "w") as f:
        f.write("\n".join(rows) + "\n")
    return folder, csv


def test_runner_trains_checkpoints_resumes_and_serves(tmp_path, dataset):
    folder, csv = dataset
    base = ["--data_folder", folder, "--feature_file", csv,
            "--n_layer", "2", "--n_head", "4", "--d_model", "32", "--d_inner", "64",
            "--d_condition", "8", "--tgt_len", "24", "--batch_size", "4", "--lr", "1e-3",
            "--log_step", "2", "--eval_step", "100", "--gen_step", "1000",
            "--max_eval_step", "1", "--seed", "1", "--dtype", "f32", "--num_workers", "0",
            "--device", "cpu"]
    runner = train_cli.main(base + ["--work_dir", str(tmp_path / "a"), "--max_step", "4"])
    assert runner.train_step_num == 4
    wd = runner.args.work_dir
    for f in ("model.pt", "model_config.pt", "mappings.pt", "optimizer.pt", "stats.json",
              "performance.csv"):
        assert os.path.exists(os.path.join(wd, f)), f
    resumed = train_cli.main(base + ["--work_dir", str(tmp_path / "b"), "--max_step", "6",
                                     "--restart_dir", wd])
    assert resumed.optimizer.state and resumed.train_step_num == 6
    wd2 = resumed.args.work_dir
    # the JAX package reads the port's reference-format work dir
    jcfg, jparams, _ = jax_load_model_dir(wd2)
    saved = torch.load(os.path.join(wd2, "model.pt"))
    for name, w in state_dict_from_jax_params(jparams, resumed.cfg).items():
        assert torch.equal(w, saved[name]), name
    generate_cli.main([
        "--model_dir", wd2, "--conditioning", "continuous_concat", "--valence", "0.5",
        "--arousal", "-0.5", "--batch_size", "1", "--gen_len", "16", "--max_input_len", "12",
        "--dtype", "f32", "--device", "cpu", "--quiet", "--short_filename",
    ])
    out = os.path.join(wd2, "generations", "inference")
    assert any(f.endswith(".npy") for f in os.listdir(out))
