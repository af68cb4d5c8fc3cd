"""Activation recomputation in the torch port (``--remat``, ``ModelConfig.remat``
/ ``remat_policy``): the same steps as without it, the "dots" policy
keeping the Linear products, and ``auto`` resolved as the JAX Runner
resolves it."""

import dataclasses
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from midi_emotion_tpu_torch.cli import train_cli
from midi_emotion_tpu_torch.models.config import ModelConfig
from midi_emotion_tpu_torch.models.model import MusicTransformer, resolve_remat
from midi_emotion_tpu_torch.training.train_step import make_optimizer, make_train_step
from synth_data import make_dataset

TINY = dict(vocab_size=1007, mode="continuous_concat", n_layer=2, n_head=4, d_model=64,
            d_inner=128, d_condition=16, max_seq=64)
REMATS = {"none": dict(remat=False), "dots": dict(remat=True, remat_policy="dots"),
          "full": dict(remat=True, remat_policy="full")}


def _batch(seed=0, T=64):
    rng = np.random.RandomState(seed)
    ids = torch.from_numpy(rng.randint(2, 1007, size=(1, 3, T + 1))).long()
    ids[0, 1, T // 2:] = 0  # a row of pad
    return {"input": ids[..., :-1], "target": ids[..., 1:],
            "condition": torch.from_numpy(rng.uniform(-1, 1, (1, 3, 2)).astype(np.float32))}


def _steps(remat, dropout, n=2):
    cfg = ModelConfig(**TINY, dropout=dropout, **REMATS[remat]).validate()
    model = MusicTransformer(cfg, device="cpu").init_weights(torch.Generator().manual_seed(0))
    step = make_train_step(model, make_optimizer(model), clip=1.0)
    gen = torch.Generator().manual_seed(3)
    metrics, grads = [], []
    for i in range(n):
        m = step(_batch(i), 1e-3, gen)
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()})
    return metrics, grads, {k: p.detach() for k, p in model.named_parameters()}


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_remat_steps_are_bitwise_the_plain_steps(dropout):
    """Two steps under "dots" and "full": every loss, grad norm, gradient and
    parameter bitwise those without recomputation, dropout included (the
    recompute draws the masks again from the same seeds)."""
    want = _steps("none", dropout)
    for remat in ("dots", "full"):
        got = _steps(remat, dropout)
        assert got[0] == want[0], remat
        for g, w in zip(got[1], want[1]):
            assert all(torch.equal(g[k], w[k]) for k in w), remat
        assert all(torch.equal(got[2][k], want[2][k]) for k in want[2]), remat


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def test_dots_keeps_the_linear_products_and_reruns_the_rest():
    """What the backward recomputes: "full" reruns each layer's six Linear
    products (aten.addmm) and its attention products; "dots" takes the
    Linear products from the forward (none rerun) and reruns the attention
    products (aten.bmm), as dots_with_no_batch_dims_saveable does."""
    addmm, bmm = torch.ops.aten.addmm.default, torch.ops.aten.bmm.default
    counts = {}
    for remat in REMATS:
        cfg = ModelConfig(**TINY, dropout=0.0, **REMATS[remat])
        model = MusicTransformer(cfg, device="cpu").init_weights(torch.Generator().manual_seed(0))
        b = {k: v[0] for k, v in _batch().items()}
        logits = model(b["input"], b["condition"])
        with _OpCount() as c:
            logits.float().square().mean().backward()
        counts[remat] = c.counts
    assert counts["none"].get(addmm, 0) == 0
    assert counts["full"].get(addmm, 0) == 6 * TINY["n_layer"]
    assert counts["dots"].get(addmm, 0) == 0
    assert counts["dots"].get(bmm, 0) > counts["none"].get(bmm, 0)
    assert counts["full"].get(bmm, 0) == counts["dots"].get(bmm, 0)


def test_auto_resolves_as_the_jax_runner():
    """JAX (``training/train.py:129-134``): "none" under the Pallas flash
    kernel, "dots" under the XLA closed form and the ring; the port's
    "kernel", "plain" and "ring" are those three."""
    jax_rule = lambda impl: "none" if impl == "pallas" else "dots"
    for port, jax_impl in (("kernel", "pallas"), ("plain", "xla"), ("ring", "ring")):
        assert resolve_remat("auto", port) == jax_rule(jax_impl)
        for choice in ("none", "dots", "full"):
            assert resolve_remat(choice, port) == choice
    with pytest.raises(ValueError, match="remat"):
        resolve_remat("some", "plain")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    folder, records = make_dataset(str(root), n_songs=8, bars_per_song=6)
    csv = str(root / "features.csv")
    rows = ["file,valence,note_density_per_instrument,n_instruments,is_matched"]
    rows += [f"{r['file']},{r['valence']},{3.0 + i * 0.1},4,True" for i, r in enumerate(records)]
    with open(csv, "w") as f:
        f.write("\n".join(rows) + "\n")
    return folder, csv


def _runner_args(dataset):
    folder, csv = dataset
    return ["--data_folder", folder, "--feature_file", csv, "--n_layer", "2", "--n_head", "4",
            "--d_model", "32", "--d_inner", "64", "--d_condition", "8", "--tgt_len", "24",
            "--batch_size", "2", "--log_step", "1", "--eval_step", "100", "--gen_step", "1000",
            "--max_eval_step", "1", "--seed", "1", "--dtype", "f32", "--num_workers", "0",
            "--device", "cpu", "--max_step", "2"]


def test_runner_writes_the_resolved_remat_into_its_config(tmp_path, dataset):
    """A new run's config carries --remat (auto on the CPU: the plain
    attention, so "dots"); the same losses under each. A restart from the
    run's own dir (the reference layout, whose config holds no remat)
    resolves --remat, auto too, as a new run does; so does one from a
    native dir, whatever remat its config holds."""
    base = _runner_args(dataset)
    losses = {}
    for flag, want in (("auto", ("dots", True)), ("none", ("dots", False)),
                       ("full", ("full", True))):
        runner = train_cli.main(base + ["--work_dir", str(tmp_path / flag), "--remat", flag])
        assert (runner.cfg.remat_policy, runner.cfg.remat) == want
        assert runner.model.config == runner.cfg
        with open(os.path.join(runner.args.work_dir, "performance.csv")) as f:
            losses[flag] = [r.split(",")[4] for r in f.read().splitlines()[1:]]
    assert losses["auto"] == losses["none"] == losses["full"]
    for flag, want in (("auto", ("dots", True)), ("none", ("dots", False))):
        resumed = train_cli.main(base + ["--work_dir", str(tmp_path / f"r{flag}"), "--remat",
                                         flag, "--max_step", "3", "--restart_dir",
                                         runner.args.work_dir])
        assert resumed.cfg == dataclasses.replace(runner.cfg, remat=want[1],
                                                  remat_policy=want[0])
        assert resumed.model.config is resumed.cfg


def test_restart_resolves_auto_from_this_runs_attention(tmp_path, dataset, monkeypatch):
    """A restart under the default --remat auto resolves as a new run on
    the same attention does, whatever the dir's config holds: "none" under
    the flash kernels (stood in for here, where the model runs the plain
    attention), from a reference dir (no remat in its config: not
    ModelConfig's default "dots") and from a native dir that says "full"."""
    from midi_emotion_tpu_torch.training import checkpoint as ckpt
    from midi_emotion_tpu_torch.training import train as train_mod

    base = _runner_args(dataset)
    first = train_cli.main(base + ["--work_dir", str(tmp_path / "first"), "--remat", "full"])
    native_dir = str(tmp_path / "native")
    ckpt.save_native_dir(native_dir, first.model, first.cfg, first.vocab,
                         stats=ckpt.load_stats(first.args.work_dir))
    monkeypatch.setattr(train_mod, "resolve_attn_impl", lambda impl, device: "kernel")
    for name, restart in (("reference", first.args.work_dir), ("native", native_dir)):
        resumed = train_cli.main(base + ["--work_dir", str(tmp_path / f"resumed_{name}"),
                                         "--max_step", "3", "--restart_dir", restart])
        assert resumed.cfg == dataclasses.replace(first.cfg, remat=False, remat_policy="dots")
        assert resumed.train_step_num == 3
