"""Torch port, model: the MusicTransformer held to the JAX one on shared
weights (JAX init_params carried across by state_dict_from_jax_params).
Forward logits within 1e-4 (the bound tests/test_model.py holds JAX to),
prefill and decode within 2e-5."""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401 -- pins JAX to the CPU

import jax.numpy as jnp

from midi_emotion_tpu.models.config import ModelConfig
from midi_emotion_tpu.models.model import MusicTransformer as JaxMusicTransformer

from torch_parity import assert_close, model_pair

TINY = dict(  # tests/test_model.py's TINY config
    vocab_size=1017, n_layer=2, n_head=4, d_model=64, d_inner=128,
    d_condition=16, max_seq=128, dropout=0.1,
)
# row 0 has no pad key, row 1 ends in pads
TOKENS = np.array([[1, 5, 9, 100, 882, 7], [1, 900, 30, 0, 0, 0]], np.int32)
COND = np.array([[0.5, -0.5], [-0.25, 1.0]], np.float32)


@pytest.mark.parametrize(
    "mode", ["none", "discrete_token", "continuous_concat", "continuous_token", "regression"])
def test_forward_matches_jax(mode):
    cfg = ModelConfig(mode=mode, **TINY)
    jmodel, params, tmodel = model_pair(cfg)
    # "kernel" reaches the flash wrapper, which runs its twin on the CPU
    tkernel = model_pair(cfg, attn_impl="kernel")[2]
    want = np.asarray(jmodel.apply({"params": params}, TOKENS, COND, True))
    tokens, cond = torch.from_numpy(TOKENS).long(), torch.from_numpy(COND)
    with torch.inference_mode():
        got = tmodel(tokens, cond)
        got_kernel = tkernel(tokens, cond)
    assert got.shape == want.shape
    assert_close(got, want, 1e-4)
    assert_close(got_kernel, want, 1e-4)


@pytest.mark.parametrize("mode", ["continuous_concat", "continuous_token", "discrete_token"])
def test_prefill_and_decode_match_jax(mode):
    cfg = ModelConfig(mode=mode, **TINY)
    jmodel, params, tmodel = model_pair(cfg)
    variables = {"params": params}
    prompt = TOKENS[:1, :4].repeat(2, axis=0)
    window = 16
    jlogits, jcache = jmodel.apply(variables, prompt, COND, window,
                                   method=JaxMusicTransformer.prefill)
    cond = torch.from_numpy(COND)
    with torch.inference_mode():
        tlogits, tcache = tmodel.prefill(torch.from_numpy(prompt).long(), cond, window)
        assert_close(tlogits, jlogits, 2e-5)
        jce = tce = None
        if mode == "continuous_concat":
            jce = jmodel.apply(variables, COND, method=JaxMusicTransformer.condition_embedding)
            tce = tmodel.condition_embedding(cond)
        for step, tok in enumerate([17, 300, 950, 2]):
            token = np.full((2,), tok, np.int32)
            jlogits, jcache = jmodel.apply(variables, jnp.asarray(token), jce, jcache,
                                           method=JaxMusicTransformer.decode_step)
            tlogits, tcache = tmodel.decode_step(torch.from_numpy(token).long(), tce, tcache)
            assert tcache["length"] == int(jcache["length"]), step
            assert_close(tlogits, jlogits, 2e-5)
    for i in range(cfg.n_layer):
        assert_close(tcache["k"][i], jcache["k"][i], 2e-5)
        assert_close(tcache["v"][i], jcache["v"][i], 2e-5)
