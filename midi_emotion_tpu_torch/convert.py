"""Moving weights into the port's modules.

* ``state_dict_from_jax_params``: a JAX parameter tree (numpy or jax
  arrays) -> the reference's ``state_dict`` names, through the JAX
  package's ``convert/torch_import.py::params_to_torch_state_dict``. The
  port's modules carry those names, so the result loads with
  ``load_state_dict``.
* ``load_model_dir``: a reference work dir (``model_config.pt``,
  ``model.pt``, ``mappings.pt``) straight into a ``MusicTransformer``.

The JAX package's native work dirs (``model_config.json`` with
``model.msgpack``) are not read yet.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import torch

from midi_emotion_tpu.convert.torch_import import params_to_torch_state_dict
from midi_emotion_tpu.models.config import ModelConfig
from midi_emotion_tpu.vocab import Vocab

from .models.model import MusicTransformer


def state_dict_from_jax_params(params, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """JAX/Flax parameters -> a state_dict for the port's MusicTransformer."""
    return params_to_torch_state_dict(params, cfg)


def save_reference_dir(model_dir: str, cfg: ModelConfig,
                       state_dict: Dict[str, torch.Tensor], vocab: Vocab) -> None:
    """Write a reference-format work dir (the layout ``load_model_dir``
    reads): model_config.pt, model.pt and mappings.pt."""
    os.makedirs(model_dir, exist_ok=True)
    torch.save(cfg.to_reference_dict(), os.path.join(model_dir, "model_config.pt"))
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()},
               os.path.join(model_dir, "model.pt"))
    torch.save(vocab.get_maps(), os.path.join(model_dir, "mappings.pt"))


def load_model_dir(
    model_dir: str,
    dtype: torch.dtype = torch.float32,
    device="cpu",
    attn_impl: str = "auto",
) -> Tuple[ModelConfig, MusicTransformer, Vocab]:
    """Load (config, model, vocab) from a reference work dir."""
    if os.path.exists(os.path.join(model_dir, "model_config.json")):
        raise NotImplementedError(
            f"{model_dir} is a native JAX work dir (model_config.json + "
            "model.msgpack); reading it is not ported yet (ROADMAP queue 1, "
            "item 3: native msgpack checkpoints). Export it to the reference "
            "format with midi_emotion_tpu.convert.torch_export first."
        )
    cfg_fp = os.path.join(model_dir, "model_config.pt")
    if not os.path.exists(cfg_fp):
        raise FileNotFoundError(f"{model_dir}: no model_config.pt (reference work dir)")
    # reference work dirs pickle plain python dicts; torch.load needs
    # weights_only=False for them, as the JAX package's loader does
    cfg = ModelConfig.from_reference_dict(
        torch.load(cfg_fp, map_location="cpu", weights_only=False))
    model_fp = os.path.join(model_dir, "model.pt")
    state_dict = torch.load(model_fp, map_location="cpu", weights_only=False)
    state_dict = {k: v for k, v in state_dict.items()
                  if not k.endswith("positional_embedding")}
    maps_fp = os.path.join(model_dir, "mappings.pt")
    vocab = Vocab()
    if os.path.exists(maps_fp):
        vocab = Vocab.from_maps(torch.load(maps_fp, map_location="cpu", weights_only=False))
    model = MusicTransformer(cfg, dtype=dtype, device=device, attn_impl=attn_impl)
    model.load_state_dict(state_dict)
    return cfg, model.eval(), vocab
