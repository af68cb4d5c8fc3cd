"""Torch port, generation: ``Sampler.generate`` is token-identical to the JAX
sampler in f32 under injected uniforms, through the cache growth and the
sliding-window refreshes; ``generate()`` and the CLI write MIDI files that
read back."""

import os

import numpy as np
import pytest
import torch

import conftest  # noqa: F401 -- pins JAX to the CPU

from midi_emotion_tpu.data import midi_io
from midi_emotion_tpu.generation.sampler import Sampler as JaxSampler
from midi_emotion_tpu.models.config import ModelConfig
from midi_emotion_tpu.ops.sampling import SamplingParams as JaxSamplingParams
from midi_emotion_tpu.vocab import DEFAULT_VOCAB, emotion_bin_tokens
from midi_emotion_tpu_torch.cli import generate_cli
from midi_emotion_tpu_torch.convert import save_reference_dir
from midi_emotion_tpu_torch.generation.generate import generate
from midi_emotion_tpu_torch.generation.sampler import Sampler
from midi_emotion_tpu_torch.models.model import MusicTransformer
from midi_emotion_tpu_torch.ops.sampling import SamplingParams

from torch_parity import model_pair

TINY = dict(  # tests/test_sampler.py's TINY config
    vocab_size=1007, n_layer=2, n_head=4, d_model=64, d_inner=128,
    d_condition=16, max_seq=256, dropout=0.0,
)


@pytest.mark.parametrize("mode", ["continuous_concat", "discrete_token"])
def test_sampler_matches_jax_under_injected_uniforms(mode):
    vocab = DEFAULT_VOCAB
    if mode == "discrete_token":
        vocab = vocab.with_extra_tokens(emotion_bin_tokens(5))
    cfg = ModelConfig(mode=mode, **{**TINY, "vocab_size": len(vocab)})
    jmodel, params, tmodel = model_pair(cfg)
    B, gen_len = 2, 40
    # window 24 (22 after the discrete prefix) with the default hop of
    # window // 8: one growing chunk, then five sliding refreshes
    sp = dict(gen_len=gen_len, max_input_len=24, top_p=0.9, penalty_coeff=0.5)
    primer = np.full((B, 1), vocab.start_id, np.int32)
    cond = np.array([[0.8, -0.4], [-0.6, 0.2]], np.float32)
    prefix = None
    if mode == "discrete_token":
        prefix = np.array([[vocab.extra_id("<V2>"), vocab.extra_id("<A-1>")],
                           [vocab.extra_id("<V-2>"), vocab.extra_id("<A0>")]], np.int32)
    u = np.random.default_rng(0).uniform(size=(gen_len - 1, B)).astype(np.float32)

    want = JaxSampler(jmodel, params, vocab, JaxSamplingParams(**sp)).generate(
        primer, continuous_conditions=cond, discrete_prefix_ids=prefix, uniforms=u)
    got = Sampler(tmodel, vocab, SamplingParams(**sp)).generate(
        primer, continuous_conditions=cond, discrete_prefix_ids=prefix, uniforms=u)
    assert got.shape == (B, gen_len)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_unported_paths_raise():
    cfg = ModelConfig(mode="continuous_concat", **TINY)
    model = MusicTransformer(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Sampler(model, DEFAULT_VOCAB, SamplingParams(), kv_dtype="int8")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Sampler(model, DEFAULT_VOCAB, SamplingParams()).generate_exact(np.ones((1, 1)))


def test_generate_writes_midi(tmp_path):
    cfg = ModelConfig(mode="continuous_concat", **TINY)
    model = MusicTransformer(cfg).init_weights(torch.Generator().manual_seed(0))
    out = str(tmp_path / "gen")
    redo_p, redo_d, redo_c = generate(
        model, DEFAULT_VOCAB, out, "continuous_concat",
        continuous_conditions=[[0.8, 0.8], [-0.8, -0.8]],
        gen_len=32, max_input_len=16, min_n_instruments=1, step="7", seed=3,
    )
    mids = sorted(f for f in os.listdir(out) if f.endswith(".mid"))
    assert len(mids) + len(redo_c or []) == 2
    assert mids, "a random model's notes should give at least one file"
    for f in mids:
        assert f.startswith("7_") and "_s3_V" in f
        midi_io.read_midi(os.path.join(out, f))
        ids = np.load(os.path.join(out, "inds_" + f[:-4] + ".npy"))
        assert ids.shape == (32,) and not DEFAULT_VOCAB.special_mask()[ids[1:]].any()


def test_cli_on_reference_work_dir(tmp_path):
    """CLI -> convert.load_model_dir -> generate() on the CPU, from a
    reference-format work dir (whose config always has max_seq 2048)."""
    cfg = ModelConfig(mode="continuous_concat", **{**TINY, "max_seq": 2048})
    model = MusicTransformer(cfg).init_weights(torch.Generator().manual_seed(1))
    model_dir = str(tmp_path / "work")
    save_reference_dir(model_dir, cfg, model.state_dict(), DEFAULT_VOCAB)
    generate_cli.main([
        "--model_dir", model_dir, "--conditioning", "continuous_concat",
        "--valence", "0.5", "-0.5", "--arousal", "0.5", "0.1", "--batch_size", "2",
        "--gen_len", "24", "--max_input_len", "16", "--dtype", "f32",
        "--device", "cpu", "--short_filename", "--quiet",
    ])
    out = os.path.join(model_dir, "generations", "inference")
    mids = [f for f in os.listdir(out) if f.endswith(".mid")]
    assert sorted(mids) == ["0_V05_A05.mid", "1_V-05_A01.mid"]
    for f in mids:
        midi_io.read_midi(os.path.join(out, f))
