"""Shared helpers for the torch port's parity tests: one small config built
in both packages from one dict, with the same weights (JAX ``init_params``
carried across by ``state_dict_from_jax_params``)."""

import contextlib
import dataclasses
import functools

import jax
import numpy as np
import torch
from jax.experimental import pallas as pl

from midi_emotion_tpu.models.config import ModelConfig as JaxModelConfig
from midi_emotion_tpu.models.model import MusicTransformer as JaxMusicTransformer
from midi_emotion_tpu.models.model import init_params
from midi_emotion_tpu_torch.convert import state_dict_from_jax_params
from midi_emotion_tpu_torch.models.config import ModelConfig
from midi_emotion_tpu_torch.models.model import MusicTransformer


def config_pair(**kw):
    """(JAX ModelConfig, the port's ModelConfig) from one set of fields."""
    return JaxModelConfig(**kw), ModelConfig(**kw)


def port_config(jcfg: JaxModelConfig) -> ModelConfig:
    """The port's ModelConfig with the fields of a JAX one."""
    return ModelConfig(**dataclasses.asdict(jcfg))


@functools.lru_cache(maxsize=None)
def _jax_model(cfg: JaxModelConfig):
    jmodel = JaxMusicTransformer(cfg)
    return jmodel, init_params(jmodel, jax.random.PRNGKey(0))


def model_pair(cfg: JaxModelConfig, attn_impl: str = "plain"):
    """(jax_model, jax_params, torch_model), all f32 on the CPU. The JAX
    side is built once per config; the torch model is new on every call."""
    jmodel, params = _jax_model(cfg)
    tcfg = port_config(cfg)
    tmodel = MusicTransformer(tcfg, dtype=torch.float32, device="cpu", attn_impl=attn_impl)
    tmodel.load_state_dict(state_dict_from_jax_params(params, tcfg))
    return jmodel, params, tmodel.eval()


def assert_close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


@contextlib.contextmanager
def generic_interpret():
    """The flash Pallas kernels through the generic interpreter
    (``pallas_call(interpret=True)``, the path the JAX package's decode and
    LayerNorm kernels pick on the CPU), not the threaded TPU interpreter
    (``pltpu.force_tpu_interpret_mode``), which has hung multi-worker runs."""
    call = pl.pallas_call
    pl.pallas_call = functools.partial(call, interpret=True)
    try:
        yield
    finally:
        pl.pallas_call = call
