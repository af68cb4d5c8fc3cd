"""Torch port, generation: ``Sampler.generate`` (native and stacked caches),
``generate_exact`` and per-step conditions are token-identical to the JAX
sampler in f32 under injected uniforms, through the cache growth, the
stage flushes and the sliding-window refreshes; the stacked decode steps'
logits match JAX's; ``generate()`` and the CLI write MIDI files that read
back.

The JAX side runs its Pallas kernels through their own CPU path
(``interpret=True``, chosen by the kernels on the CPU backend). The
threaded TPU interpreter (``pltpu.force_tpu_interpret_mode``) is not
forced here: under a loaded multi-worker run it has hung in a futex
wait with every thread idle."""

import os

import numpy as np
import pytest
import torch

import conftest  # noqa: F401 -- pins JAX to the CPU
import jax.numpy as jnp

from midi_emotion_tpu.generation.sampler import Sampler as JaxSampler
from midi_emotion_tpu.models.config import ModelConfig as JaxModelConfig
from midi_emotion_tpu.models.model import MusicTransformer as JaxMusicTransformer
from midi_emotion_tpu.ops.sampling import SamplingParams as JaxSamplingParams
from midi_emotion_tpu.vocab import DEFAULT_VOCAB as JAX_VOCAB
from midi_emotion_tpu.vocab import emotion_bin_tokens
from midi_emotion_tpu_torch.cli import generate_cli
from midi_emotion_tpu_torch.convert import save_reference_dir
from midi_emotion_tpu_torch.data import midi_io
from midi_emotion_tpu_torch.generation.generate import generate
from midi_emotion_tpu_torch.generation import sampler as sampler_module
from midi_emotion_tpu_torch.generation.sampler import Sampler
from midi_emotion_tpu_torch.models.config import ModelConfig
from midi_emotion_tpu_torch.models.model import MusicTransformer
from midi_emotion_tpu_torch.ops.sampling import SamplingParams
from midi_emotion_tpu_torch.vocab import DEFAULT_VOCAB

from torch_parity import model_pair

TINY = dict(  # tests/test_sampler.py's TINY config
    vocab_size=1007, n_layer=2, n_head=4, d_model=64, d_inner=128,
    d_condition=16, max_seq=256, dropout=0.0,
)


@pytest.mark.parametrize("mode", ["continuous_concat", "discrete_token"])
def test_sampler_matches_jax_under_injected_uniforms(mode):
    vocab, jvocab = DEFAULT_VOCAB, JAX_VOCAB
    if mode == "discrete_token":
        vocab = vocab.with_extra_tokens(emotion_bin_tokens(5))
        jvocab = jvocab.with_extra_tokens(emotion_bin_tokens(5))
    cfg = JaxModelConfig(mode=mode, **{**TINY, "vocab_size": len(vocab)})
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

    want = JaxSampler(jmodel, params, jvocab, JaxSamplingParams(**sp)).generate(
        primer, continuous_conditions=cond, discrete_prefix_ids=prefix, uniforms=u)
    got = Sampler(tmodel, vocab, SamplingParams(**sp)).generate(
        primer, continuous_conditions=cond, discrete_prefix_ids=prefix, uniforms=u)
    assert got.shape == (B, gen_len)
    np.testing.assert_array_equal(got, np.asarray(want))


def _unpad_heads(x: np.ndarray, n_groups: int, dh: int) -> np.ndarray:
    """[..., G*dh_k] stacked-cache columns -> [..., G*dh]: each group's
    first dh columns (the port lays d_head 40 out at 48)."""
    return x.reshape(*x.shape[:-1], n_groups, -1)[..., :dh].reshape(*x.shape[:-1], -1)


# d_head 40 (H * dh = 80): a width the decode kernel is not built for, so the
# port's stacked cache holds each head at 48 columns
DH40 = dict(n_head=2, d_model=80)
# past d_head 128: one head of 256, a width the kernels are built for, and
# two of 160, which the port's cache holds at 192 columns a head
DH256 = dict(n_head=1, d_model=256)
DH160 = dict(n_head=2, d_model=320)
# past d_head 256, where the wide kernels run: two layers of one head of 384
DH384 = dict(n_head=1, d_model=384, n_layer=2)


@pytest.mark.parametrize("kv_dtype,heads", [("int8", {}), ("bf16", {}), ("int8", DH40),
                                            ("bf16", DH40), ("int8", DH256), ("bf16", DH256),
                                            ("int8", DH160), ("bf16", DH160), ("bf16", DH384)],
                         ids=["int8", "bf16", "int8-dh40", "bf16-dh40", "int8-dh256",
                              "bf16-dh256", "int8-dh160", "bf16-dh160", "bf16-dh384"])
def test_stacked_step_logits_match_jax(kv_dtype, heads):
    """prefill_q, then one decode_step_q and one decode_step_staged from the
    prefilled cache, at the TINY config (and at d_head 40, whose cache the
    port pads to 48 columns a head, 256, and 160, padded to 192): the cache
    rows and the stage slot equal, the logits as close as the tolerances
    below say."""
    cfg = JaxModelConfig(mode="continuous_concat", **{**TINY, **heads})
    jmodel, params, tmodel = model_pair(cfg)
    variables = {"params": params}
    B, T, W, S = 2, 12, 128, 4
    rng = np.random.default_rng(5)
    tokens = rng.integers(2, 900, (B, T)).astype(np.int32)
    cond = np.array([[0.5, -0.5], [0.1, 0.9]], np.float32)
    nxt = np.array([5, 7], np.int32)
    quant = kv_dtype == "int8"
    jl0, jcache = jmodel.apply(variables, jnp.asarray(tokens), jnp.asarray(cond), W, quant,
                               method=JaxMusicTransformer.prefill_q)
    ce = jmodel.apply(variables, jnp.asarray(cond),
                      method=JaxMusicTransformer.condition_embedding)
    jl1, _ = jmodel.apply(variables, jnp.asarray(nxt), ce, jcache,
                          method=JaxMusicTransformer.decode_step_q)
    pend = jnp.zeros((S, cfg.n_layer, B, 2 * cfg.d_model), jnp.bfloat16)
    jl2, jpend = jmodel.apply(variables, jnp.asarray(nxt), ce, jcache["kv"],
                              jcache.get("sc"), pend, jcache["length"], 0,
                              method=JaxMusicTransformer.decode_step_staged)
    groups, dh = 2 * cfg.n_head, cfg.d_model // cfg.n_head
    with torch.inference_mode():
        tc = torch.from_numpy(cond)
        tl0, cache = tmodel.prefill_q(torch.from_numpy(tokens).long(), tc, W, quant)
        kv = cache["kv"].float().numpy()
        jkv = np.asarray(jcache["kv"].astype(jnp.float32))
        if not heads:
            np.testing.assert_array_equal(kv, jkv)
        else:
            # layer 0's rows come from the same f32 embedding in both; past
            # it the two f32 forwards round an ulp apart, which can carry a
            # value over an int8 (or bf16) rounding boundary: one unit. At
            # d_model 256 and 320 the layer-0 projections' own f32 sums
            # round apart too (4 of 131072 bf16 values, one ulp, on this
            # seed), so layer 0 is held to the unit as well
            if cfg.d_model < 256:
                np.testing.assert_array_equal(_unpad_heads(kv[0], groups, dh), jkv[0])
            unit = 1.0 if quant else 2 ** -8 * np.abs(jkv).max()
            np.testing.assert_allclose(_unpad_heads(kv, groups, dh), jkv, rtol=0, atol=unit)
        assert kv.shape[-1] == groups * {16: 16, 40: 48, 256: 256, 160: 192, 384: 384}[dh]
        assert not kv.reshape(*kv.shape[:-1], groups, -1)[..., dh:].any()  # zero padding
        tce = tmodel.condition_embedding(tc)
        tpend = torch.zeros((S, cfg.n_layer, B, cache["kv"].shape[-1]), dtype=torch.bfloat16)
        # the staged step leaves the cache alone, so it runs first
        tl2, tpend = tmodel.decode_step_staged(torch.from_numpy(nxt).long(), tce, cache["kv"],
                                               cache.get("sc"), tpend, cache["length"], 0)
        tl1, cache1 = tmodel.decode_step_q(torch.from_numpy(nxt).long(), tce, cache)
    assert cache1["length"] == T + 1
    # int8: q is quantized per step, and an f32 GEMM that rounds q one ulp
    # apart can move one int8 unit (on this seed: batch row 0 of the staged
    # step, 1.5e-3 of logits ~0.6); each of those flips is within int8
    # error, 1e-2 of the logit scale. bf16 quantizes nothing: 1e-4; at
    # d_model 256 and 320, where some bf16 cache values round one ulp apart
    # (above), one bf16 ulp of the logit scale (the flips moved the steps'
    # logits by 6e-4 at d_model 256, where the bf16 cache itself is 4e-3
    # off the native cache's logits in either package).
    for got, want in ((tl0, jl0), (tl1, jl1), (tl2, jl2)):
        want = np.asarray(want)
        tol = (1e-2 * np.abs(want).max() if quant
               else 2 ** -8 * np.abs(want).max() if cfg.d_model >= 256 else 1e-4)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    stage = _unpad_heads(tpend.float().numpy(), groups, dh)
    jstage = np.asarray(jpend.astype(jnp.float32))
    if cfg.d_model < 256:
        np.testing.assert_array_equal(stage, jstage)
    else:  # the written row's bf16 values, one ulp apart as the cache rows above
        np.testing.assert_allclose(stage, jstage, rtol=0, atol=2 ** -8 * np.abs(jstage).max())


def _stacked_sampler_case(heads, kv_dtype="int8", top_p=0.9):
    cfg = JaxModelConfig(mode="continuous_concat", **{**TINY, "n_layer": 1, "n_head": 2,
                                                      "max_seq": 128, **heads})
    jmodel, params, tmodel = model_pair(cfg)
    B, gen_len = 2, 24
    sp = dict(gen_len=gen_len, max_input_len=12, top_p=top_p, penalty_coeff=0.5)
    kw = dict(kv_dtype=kv_dtype, stage_steps=4, slide_hop=2)
    primer = np.full((B, 1), DEFAULT_VOCAB.start_id, np.int32)
    cond = np.array([[0.8, -0.4], [-0.6, 0.2]], np.float32)
    u = np.random.default_rng(0).uniform(size=(gen_len - 1, B)).astype(np.float32)
    want = JaxSampler(jmodel, params, JAX_VOCAB, JaxSamplingParams(**sp), **kw).generate(
        primer, continuous_conditions=cond, uniforms=u)
    sampler = Sampler(tmodel, DEFAULT_VOCAB, SamplingParams(**sp), **kw)
    flushes = []
    real_flush = sampler_module.flush_pend
    sampler_module.flush_pend = lambda kv, sc, pend, f_len, n_head: flushes.append(f_len) or \
        real_flush(kv, sc, pend, f_len, n_head)
    try:
        got = sampler.generate(primer, continuous_conditions=cond, uniforms=u)
    finally:
        sampler_module.flush_pend = real_flush
    assert flushes == [1, 5, 9]
    np.testing.assert_array_equal(got, np.asarray(want))


def test_stacked_sampler_matches_jax_under_injected_uniforms():
    """int8 cache, stage depth 4: three flushed super-steps in the first
    chunk, then window refreshes every 2 tokens, token-identical to the
    JAX stacked sampler (Pallas in interpret mode) under the same uniforms."""
    _stacked_sampler_case({})


def test_stacked_sampler_matches_jax_at_padded_d_head():
    """The same at d_head 40 (H * dh = 80), a width the decode kernel is not
    built for: the port's cache, stage and E rows hold each head at 48
    columns, zero past 40; token-identical to the JAX sampler, whose cache
    is 40 wide."""
    _stacked_sampler_case(DH40)


@pytest.mark.parametrize("kv_dtype", ["int8", "bf16"])
@pytest.mark.parametrize("heads", [DH256, DH160, DH384], ids=["dh256", "dh160", "dh384"])
def test_stacked_sampler_matches_jax_at_wide_d_head(heads, kv_dtype):
    """The same past d_head 128, through the int8 and the bf16 cache: one
    head of 256, two of 160, which the port's cache, stage and E rows hold
    at 192 columns, zero past 160, and two layers of one head of 384;
    token-identical to the JAX sampler.

    The two-layer case samples with top-p 1e-3 (the most likely token):
    past one layer, and at d_model 256 and above, the two packages' f32
    forwards round an ulp apart and now and then carry a cached bf16 or
    int8 value over a rounding boundary (test_stacked_step_logits_match_jax
    holds those to a unit). At top-p 0.9 such a flip moves one batch row's
    logits by about 8e-4 at a window refresh, and where that row's uniform
    sits as close to a cumulative-probability boundary the rows part: the
    same happens at d_model 64 with two layers, at top-p 0.9 on this seed
    (the logits agree to 6e-7 up to the flip)."""
    _stacked_sampler_case(heads, kv_dtype, top_p=1e-3 if heads is DH384 else 0.9)


@pytest.mark.parametrize("varying", [False, True])
@pytest.mark.parametrize("mode", ["continuous_concat", "continuous_token"])
def test_generate_exact_matches_jax(mode, varying):
    """A full forward per token, with constant or per-step conditions,
    through the window roll (window 16, 30 tokens). The seed is one where
    no sampling boundary falls within f32 rounding: with seed 3 the varying
    continuous_concat case met one at token 18 of batch row 1, where the
    two packages' logits agreed to 6e-7 and still picked different tokens
    (the uniform sat on a cumulative-probability boundary)."""
    cfg = JaxModelConfig(mode=mode, **{**TINY, "d_condition": 16 if mode ==
                                       "continuous_concat" else -1})
    jmodel, params, tmodel = model_pair(cfg)
    B, gen_len = 2, 30
    sp = dict(gen_len=gen_len, max_input_len=16, top_p=0.9, penalty_coeff=0.5)
    primer = np.full((B, 1), DEFAULT_VOCAB.start_id, np.int32)
    rng = np.random.default_rng(6)
    u = rng.uniform(size=(gen_len - 1, B)).astype(np.float32)
    kw = {"continuous_conditions": np.array([[0.8, -0.4], [-0.6, 0.2]], np.float32)}
    if varying:
        kw = {"varying_conditions": rng.uniform(-1, 1, (B, gen_len, 2)).astype(np.float32)}
    want = JaxSampler(jmodel, params, JAX_VOCAB, JaxSamplingParams(**sp)).generate_exact(
        primer, uniforms=u, **kw)
    got = Sampler(tmodel, DEFAULT_VOCAB, SamplingParams(**sp)).generate_exact(
        primer, uniforms=u, **kw)
    assert got.shape == (B, gen_len)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_generate_varying_conditions_matches_jax():
    """The cached approximation: each step's condition block recomputed,
    through growth and refreshes."""
    cfg = JaxModelConfig(mode="continuous_concat", **TINY)
    jmodel, params, tmodel = model_pair(cfg)
    B, gen_len = 2, 40
    sp = dict(gen_len=gen_len, max_input_len=24, top_p=0.9, penalty_coeff=0.5)
    primer = np.full((B, 1), DEFAULT_VOCAB.start_id, np.int32)
    rng = np.random.default_rng(4)
    u = rng.uniform(size=(gen_len - 1, B)).astype(np.float32)
    vc = rng.uniform(-1, 1, (B, gen_len, 2)).astype(np.float32)
    want = JaxSampler(jmodel, params, JAX_VOCAB, JaxSamplingParams(**sp)).generate(
        primer, uniforms=u, varying_conditions=vc)
    got = Sampler(tmodel, DEFAULT_VOCAB, SamplingParams(**sp)).generate(
        primer, uniforms=u, varying_conditions=vc)
    np.testing.assert_array_equal(got, np.asarray(want))
    with pytest.raises(ValueError, match="gen_len"):
        Sampler(tmodel, DEFAULT_VOCAB, SamplingParams(**sp)).generate(
            primer, uniforms=u, varying_conditions=vc[:, 1:])


def test_stage_steps_knob(monkeypatch):
    """MIDI_EMOTION_DECODE_STAGE: default 8, an integer in [0, 128]; the
    native cache never stages."""
    cfg = ModelConfig(mode="continuous_concat", **TINY)
    model = MusicTransformer(cfg, device="cpu")
    sp = SamplingParams()
    monkeypatch.delenv("MIDI_EMOTION_DECODE_STAGE", raising=False)
    assert Sampler(model, DEFAULT_VOCAB, sp, kv_dtype="int8").stage_steps == 8
    assert Sampler(model, DEFAULT_VOCAB, sp).stage_steps == 0
    monkeypatch.setenv("MIDI_EMOTION_DECODE_STAGE", "0")
    assert Sampler(model, DEFAULT_VOCAB, sp, kv_dtype="bf16").stage_steps == 0
    monkeypatch.setenv("MIDI_EMOTION_DECODE_STAGE", "eight")
    with pytest.raises(ValueError, match="must be an integer"):
        Sampler(model, DEFAULT_VOCAB, sp, kv_dtype="int8")
    with pytest.raises(ValueError, match=r"\[0, 128\]"):
        Sampler(model, DEFAULT_VOCAB, sp, kv_dtype="int8", stage_steps=129)
    with pytest.raises(ValueError, match="kv_dtype"):
        Sampler(model, DEFAULT_VOCAB, sp, kv_dtype="fp8")


@pytest.mark.parametrize("kv_dtype,stage", [("int8", "8"), ("int8", "0"), ("bf16", "3")])
def test_stacked_sampler_runs_through_slides(monkeypatch, kv_dtype, stage):
    """Every stacked mode through growth, flushes, remainders and refreshes
    (the step logits are pinned to JAX above): valid tokens, right shape."""
    monkeypatch.setenv("MIDI_EMOTION_DECODE_STAGE", stage)
    cfg = ModelConfig(mode="continuous_concat", **TINY)
    model = MusicTransformer(cfg, device="cpu").init_weights(torch.Generator().manual_seed(2))
    sp = SamplingParams(gen_len=60, max_input_len=24, top_p=0.9)
    song = Sampler(model, DEFAULT_VOCAB, sp, kv_dtype=kv_dtype).generate(
        np.full((2, 1), DEFAULT_VOCAB.start_id, np.int32),
        continuous_conditions=np.zeros((2, 2), np.float32))
    assert song.shape == (2, 60)
    assert not DEFAULT_VOCAB.special_mask()[song[:, 1:]].any()


def test_generate_writes_midi(tmp_path):
    cfg = ModelConfig(mode="continuous_concat", **TINY)
    model = MusicTransformer(cfg, device="cpu").init_weights(torch.Generator().manual_seed(0))
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
    model = MusicTransformer(cfg, device="cpu").init_weights(torch.Generator().manual_seed(1))
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


def test_generate_varying_condition_writes_midi(tmp_path):
    cfg = ModelConfig(mode="continuous_concat", **TINY)
    model = MusicTransformer(cfg, device="cpu").init_weights(torch.Generator().manual_seed(0))
    out = str(tmp_path / "gen")
    ramp = np.linspace(-0.8, 0.8, 24, dtype=np.float32)
    generate(model, DEFAULT_VOCAB, out, "continuous_concat",
             varying_condition=[np.stack([ramp, -ramp]), np.stack([-ramp, ramp])],
             gen_len=24, max_input_len=16, min_n_instruments=1, short_filename=True)
    mids = sorted(f for f in os.listdir(out) if f.endswith(".mid"))
    assert mids
    for f in mids:
        midi_io.read_midi(os.path.join(out, f))
        assert np.load(os.path.join(out, "inds_" + f[:-4] + ".npy")).shape == (24,)


@pytest.mark.parametrize("kv_dtype", ["int8", "bf16"])
def test_cli_stacked_cache_writes_midi(tmp_path, kv_dtype):
    cfg = ModelConfig(mode="continuous_concat", **{**TINY, "max_seq": 2048})
    model = MusicTransformer(cfg, device="cpu").init_weights(torch.Generator().manual_seed(1))
    model_dir = str(tmp_path / "work")
    save_reference_dir(model_dir, cfg, model.state_dict(), DEFAULT_VOCAB)
    generate_cli.main([
        "--model_dir", model_dir, "--conditioning", "continuous_concat",
        "--valence", "0.5", "-0.5", "--arousal", "0.5", "0.1", "--batch_size", "2",
        "--gen_len", "40", "--max_input_len", "16", "--kv_dtype", kv_dtype,
        "--device", "cpu", "--short_filename", "--quiet",
    ])
    out = os.path.join(model_dir, "generations", "inference")
    mids = sorted(f for f in os.listdir(out) if f.endswith(".mid"))
    assert mids == ["0_V05_A05.mid", "1_V-05_A01.mid"]
    for f in mids:
        midi_io.read_midi(os.path.join(out, f))
        ids = np.load(os.path.join(out, "inds_" + f[:-4] + ".npy"))
        assert ids.shape == (40,) and not DEFAULT_VOCAB.special_mask()[ids[1:]].any()
