"""Data, tensor and sequence (ring) parallelism of the torch port on a
2-process gloo group on the CPU, held to one port process on the global
batch and to the JAX package's mesh.

One group (``torch_dist.run_group``, a hard deadline, its workers killed
on failure) runs every job of this file in turn; each test reads its jobs'
results. Sizes: 2 layers, d_model 64, 4 heads, T 64, global B 4.

Tolerances: the mesh sums the batch, the tensor-parallel products and the
gradients in other orders than one process, so losses, grad norms and
gradients agree to 1e-6 (of their scale), not bitwise. So do the
parameters after two Adam steps, where the gradient is at least 1e-5.
Adam's step m / sqrt(v) moves by about lr * dg / |g| for a change dg of
the gradient, and the rounding noise dg is ~1e-9 here, so below 1e-5 the
noise shows (the key projections' biases, whose gradient is 0 in exact
arithmetic, an embedding row only pad reaches, move by up to lr either
way): those elements are held to the steps' sum only.
Against JAX: 1e-5, the figure of
``test_torch_training.py::test_train_step_trajectory_matches_jax``.
``test_torch_ring.py`` holds the ring attention itself.
"""

import os

import numpy as np
import pytest
import torch

import conftest  # noqa: F401 -- pins JAX to the CPU

import jax
import jax.numpy as jnp

import torch_dist as td
from midi_emotion_tpu.models.config import ModelConfig as JaxModelConfig
from midi_emotion_tpu.models.model import MusicTransformer as JaxMusicTransformer
from midi_emotion_tpu.parallel import mesh as jmesh
from midi_emotion_tpu.training import train_step as jts
from midi_emotion_tpu_torch.convert import (jax_params_from_state_dict, load_model_dir,
                                            state_dict_from_jax_params)
from synth_data import make_dataset
from torch_parity import assert_close

LRS = [1e-3, 2e-3]
DP_BATCHES = {a: td.make_batches(2, a, 4, 1008, seed=a, pad_rows=(2, 3)) for a in (1, 2)}
DROP = {**td.TINY, "dropout": 0.1}
REMAT = {**td.TINY, "dropout": 0.1, "remat": True, "remat_policy": "dots"}


def _steps(name, cfg, batches, mesh=None, accumulate=1, attn="plain"):
    return name, ("train_steps", dict(cfg_kw=cfg, batches=batches, lrs=LRS, mesh_shape=mesh,
                                      accumulate=accumulate, attn_impl=attn))


def _runner_args(folder, csv, work_dir, *extra):
    return ["--data_folder", folder, "--feature_file", csv, "--n_layer", "2", "--n_head", "4",
            "--d_model", "64", "--d_inner", "128", "--d_condition", "16", "--tgt_len", "32",
            "--batch_size", "4", "--lr", "1e-3", "--log_step", "1", "--eval_step", "1",
            "--max_eval_step", "1", "--gen_step", "1000", "--seed", "1", "--dtype", "f32",
            "--num_workers", "0", "--device", "cpu", "--dropout", "0.1", "--work_dir",
            work_dir, *extra]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    # 24 songs: the 5% test split holds one
    folder, records = make_dataset(str(root), n_songs=24, bars_per_song=8)
    csv = str(root / "features.csv")
    rows = ["file,valence,note_density_per_instrument,n_instruments,is_matched"]
    rows += [f"{r['file']},{r['valence']},{3.0 + i * 0.1},4,True" for i, r in enumerate(records)]
    with open(csv, "w") as f:
        f.write("\n".join(rows) + "\n")
    return folder, csv, root


@pytest.fixture(scope="module")
def group(data, tmp_path_factory):
    """{job name: [rank 0's result, rank 1's]} from one 2-process group."""
    folder, csv, root = data
    tp_dir = str(root / "tp")
    jobs = dict([
        _steps("dp_a1", td.TINY, DP_BATCHES[1], (2, 1, 1)),
        _steps("dp_a2", td.TINY, DP_BATCHES[2], (2, 1, 1), accumulate=2),
        _steps("dp_drop", DROP, DP_BATCHES[2], (2, 1, 1), accumulate=2),
        _steps("tp_1008", td.TINY, DP_BATCHES[1], (1, 2, 1)),
        _steps("tp_1007", {**td.TINY, "vocab_size": 1007}, DP_BATCHES[1], (1, 2, 1)),
        _steps("tp_remat", REMAT, DP_BATCHES[1], (1, 2, 1)),
        _steps("ring_0", td.TINY, DP_BATCHES[1], (1, 1, 2), attn="ring"),
        _steps("ring_drop", DROP, DP_BATCHES[1], (1, 1, 2), attn="ring"),
        _steps("ring_remat", REMAT, DP_BATCHES[1], (1, 1, 2), attn="ring"),
        ("runner_dp", ("runner_run", dict(argv=_runner_args(
            folder, csv, str(root / "dp"), "--mesh_data", "2", "--max_step", "2")))),
        ("runner_tp", ("runner_run", dict(argv=_runner_args(
            folder, csv, tp_dir, "--mesh_model", "2", "--max_step", "2", "--gen_step", "1",
            "--gen_len", "8", "--max_gen_input_len", "8")))),
        ("runner_tp_restart", ("runner_run", dict(argv=_runner_args(
            folder, csv, str(root / "tp_restart"), "--mesh_model", "2", "--max_step", "3"),
            restart_from=tp_dir))),
        ("runner_ring", ("runner_run", dict(argv=_runner_args(
            folder, csv, str(root / "ring"), "--mesh_seq", "2", "--attn_impl", "ring",
            "--conditioning", "continuous_token", "--max_step", "2")))),
    ])
    results = td.run_group(2, list(jobs.values()), tmp_path_factory.mktemp("group"))
    return {name: [r[i] for r in results] for i, name in enumerate(jobs)}


def _close(got, want, tol):
    for name, w in want.items():
        assert_close(got[name], w, tol * (1 + float(w.abs().max())))


def _close_params(got, want, grads, tol):
    """Parameters after Adam steps: to ``tol`` where the gradient ``grads``
    (the first step's; a Runner's least over its steps) is at least 1e-5, to the sum of the
    LRs elsewhere."""
    for name, w in want.items():
        live = grads[name].abs() >= 1e-5
        assert_close(got[name][live], w[live], tol)
        assert float((got[name] - w).abs().max()) <= sum(LRS), name


def _same_as_one_process(results, ref):
    for res in results:  # every rank reports the global values
        assert_close(np.array(res["metrics"]), np.array(ref["metrics"]), 1e-6)
        _close(res["grads"], ref["grads"], 1e-6)
        _close_params(res["state"], ref["state"], ref["grads"], 1e-6)


def _jax_steps(cfg_kw, batches, n_data=1, n_model=1, accumulate=1):
    """JAX's make_train_step on a make_mesh(n_data, n_model) mesh from the
    port's init -> ([(loss, grad norm)], the final parameters by port name)."""
    tmodel = td.tiny_model(cfg_kw)
    jcfg = JaxModelConfig(**cfg_kw)
    mesh = jmesh.make_mesh(n_data=n_data, n_model=n_model,
                           devices=jax.devices()[:n_data * n_model])
    params = jmesh.shard_params(
        jax.tree.map(jnp.asarray, jax_params_from_state_dict(tmodel.state_dict(), tmodel.config)),
        mesh)
    opt = jts.make_optimizer(1.0)
    opt_state = jax.jit(opt.init)(params)
    step = jts.make_train_step(JaxMusicTransformer(jcfg), opt, accumulate_steps=accumulate,
                               donate=False)
    metrics = []
    for batch, lr in zip(batches, LRS):
        params, opt_state, m = step(params, opt_state,
                                    jmesh.shard_batch(batch, mesh, leading_accum=True),
                                    jax.random.PRNGKey(0), np.float32(lr))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics, state_dict_from_jax_params(jax.device_get(params), tmodel.config)


@pytest.mark.parametrize("accumulate", [1, 2])
def test_data_parallel_matches_one_process_and_jax(group, accumulate):
    """Global B 4 over 2 data ranks, rank 1's rows mostly pad: the same
    losses, grad norms and gradients as one process on the global batch
    (the loss is the mean over the global batch's non-pad targets, not a
    mean of the ranks' means), and, with gradient accumulation, JAX's
    data-parallel step."""
    batches = DP_BATCHES[accumulate]
    res = group[f"dp_a{accumulate}"]
    ref = td.train_steps(td.TINY, batches, LRS, accumulate)
    _same_as_one_process(res, ref)
    if accumulate == 1:
        return
    metrics, state = _jax_steps(td.TINY, batches, n_data=2, accumulate=accumulate)
    assert_close(np.array(res[0]["metrics"]), np.array(metrics), 1e-5)
    _close_params(res[0]["state"], state, ref["grads"], 1e-5)


def test_data_parallel_dropout_draws_the_global_mask(group):
    """At dropout 0.1 each rank draws its rows of the mask one process draws
    on the global batch, so the steps are one process's (rank 0 and rank 1
    dropping the same pattern would not be)."""
    _same_as_one_process(group["dp_drop"],
                         td.train_steps(DROP, DP_BATCHES[2], LRS, accumulate=2))


@pytest.mark.parametrize("vocab", [1008, 1007])
def test_tensor_parallel_matches_one_process_and_jax(group, vocab):
    """2 model ranks: heads, MLP and (1008) the vocabulary sharded, 1007
    replicated, as JAX's _feasible leaves it. One process's and JAX's
    n_model=2 steps."""
    cfg = {**td.TINY, "vocab_size": vocab}
    res = group[f"tp_{vocab}"]
    ref = td.train_steps(cfg, DP_BATCHES[1], LRS)
    _same_as_one_process(res, ref)
    metrics, state = _jax_steps(cfg, DP_BATCHES[1], n_model=2)
    assert_close(np.array(res[0]["metrics"]), np.array(metrics), 1e-5)
    _close_params(res[0]["state"], state, ref["grads"], 1e-5)


def test_remat_under_tensor_and_sequence_parallelism(group):
    """--remat dots with the collectives and the ring inside the recomputed
    layers: the steps of one process without recomputation."""
    ref = td.train_steps(DROP, DP_BATCHES[1], LRS)
    _same_as_one_process(group["tp_remat"], ref)
    _same_as_one_process(group["ring_remat"], ref)


@pytest.mark.parametrize("job,cfg", [("ring_0", td.TINY), ("ring_drop", DROP)])
def test_ring_train_step_matches_plain_step(group, job, cfg):
    """--attn_impl ring over 2 seq ranks (each runs the layer stack on its 32
    positions): the plain attention's steps in one process, at dropout 0
    and at 0.1 (each rank draws its positions of the global mask)."""
    _same_as_one_process(group[job], td.train_steps(cfg, DP_BATCHES[1], LRS))


def test_runner_data_parallel_matches_one_process_runner(group, data):
    """train_cli --mesh_data 2 (dropout 0.1, eval every step): the training
    and validation losses rank 0 logs are one process's, and so are the
    parameters."""
    folder, csv, root = data
    res = group["runner_dp"]
    ref = td.runner_run(_runner_args(folder, csv, str(root / "one"), "--max_step", "2"))
    (trn, val), (want_trn, want_val) = res[0]["csv"], ref["csv"]
    assert len(trn) == 2 and len(val) == 2 and res[1]["csv"] is None
    assert_close(np.array(trn + val), np.array(want_trn + want_val), 1e-6)
    for r in res:
        _close_params(r["state"], ref["state"], ref["grads"], 1e-6)


def test_runner_tensor_parallel_checkpoints_whole_and_restarts(group, data):
    """train_cli --mesh_model 2: the work dir holds the whole model in the
    layout one process writes (it loads into one process with the run's
    parameters, bitwise), rank 0 generates the corners with the whole model,
    and --restart_dir cuts it to the mesh again (the step counter goes on
    from the dir's, the losses those of a one-process restart)."""
    folder, csv, root = data
    res = group["runner_tp"]
    work_dir = res[0]["work_dir"]
    _, model, _ = load_model_dir(work_dir, device="cpu")
    for name, p in model.named_parameters():
        assert torch.equal(p, res[0]["state"][name]), name
    assert any(f.endswith(".mid") for f in os.listdir(os.path.join(work_dir, "generations",
                                                                   "training")))
    restarted = group["runner_tp_restart"][0]
    ref = td.runner_run(_runner_args(folder, csv, str(root / "one_restart"), "--max_step", "3",
                                     "--restart_dir", work_dir))
    # two copied from the dir, then steps 1 and 2 from the dir's saved step 1
    assert len(restarted["csv"][0]) == 4
    assert_close(np.array(restarted["csv"][0]), np.array(ref["csv"][0]), 1e-6)
    _close_params(restarted["state"], ref["state"], ref["grads"], 1e-6)


def test_runner_ring_continuous_token(group, data):
    """train_cli --mesh_seq 2 --attn_impl ring in continuous_token mode (the
    2-slot condition prefix lies in rank 0's chunk): the losses and
    parameters of one process with the plain attention."""
    folder, csv, root = data
    res = group["runner_ring"]
    ref = td.runner_run(_runner_args(folder, csv, str(root / "one_ct"), "--max_step", "2",
                                     "--conditioning", "continuous_token"))
    assert_close(np.array(sum(res[0]["csv"], [])), np.array(sum(ref["csv"], [])), 1e-6)
    _close_params(res[1]["state"], ref["state"], ref["grads"], 1e-6)
