"""Shared helpers for the torch port's parity tests: one small config built
in both packages with the same weights (JAX ``init_params`` carried across
by ``state_dict_from_jax_params``)."""

import functools

import jax
import numpy as np
import torch

from midi_emotion_tpu.models.config import ModelConfig
from midi_emotion_tpu.models.model import MusicTransformer as JaxMusicTransformer
from midi_emotion_tpu.models.model import init_params
from midi_emotion_tpu_torch.convert import state_dict_from_jax_params
from midi_emotion_tpu_torch.models.model import MusicTransformer


@functools.lru_cache(maxsize=None)
def _jax_model(cfg: ModelConfig):
    jmodel = JaxMusicTransformer(cfg)
    return jmodel, init_params(jmodel, jax.random.PRNGKey(0))


def model_pair(cfg: ModelConfig, attn_impl: str = "plain"):
    """(jax_model, jax_params, torch_model), all f32 on the CPU. The JAX
    side is built once per config; the torch model is new on every call."""
    jmodel, params = _jax_model(cfg)
    tmodel = MusicTransformer(cfg, dtype=torch.float32, device="cpu", attn_impl=attn_impl)
    tmodel.load_state_dict(state_dict_from_jax_params(params, cfg))
    return jmodel, params, tmodel.eval()


def assert_close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)
