"""Moving weights into and out of the port's modules.

* ``state_dict_from_jax_params``: a JAX parameter tree (numpy arrays, or
  anything ``np.asarray`` takes) -> the reference's ``state_dict`` names.
  The name map is the one of the JAX package's
  ``convert/torch_import.py::params_to_torch_state_dict``, kept here so the
  port imports nothing of the JAX package. The port's modules carry those
  names, so the result loads with ``load_state_dict``.
* ``save_reference_dir`` / ``load_model_dir``: a reference work dir
  (``model_config.pt``, ``model.pt``, ``mappings.pt``). The trainer writes
  this layout too, so a model the port trains loads in both packages.

The JAX package's native work dirs (``model_config.json`` with
``model.msgpack``) are not read yet.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

from .models.config import ModelConfig
from .models.model import MusicTransformer, resolve_device
from .vocab import Vocab


def state_dict_from_jax_params(params, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """JAX/Flax parameters -> a state_dict for the port's MusicTransformer
    (Dense kernels [in, out] become Linear weights [out, in])."""
    sd = {}
    t = lambda a: torch.from_numpy(np.asarray(a).copy())
    sd["embedding.weight"] = t(params["embedding"]["embedding"])
    if "fc_condition" in params:
        sd["fc_condition.weight"] = t(params["fc_condition"]["kernel"]).T.contiguous()
        sd["fc_condition.bias"] = t(params["fc_condition"]["bias"])
    for i in range(cfg.n_conditions):
        key = f"fc_condition_{i}"
        if key in params:
            sd[f"fc_condition.{i}.weight"] = t(params[key]["kernel"]).T.contiguous()
            sd[f"fc_condition.{i}.bias"] = t(params[key]["bias"])
    for i in range(cfg.n_layer):
        layer = params[f"enc_layers_{i}"]
        p = f"enc_layers.{i}."
        for name in ("Wq", "Wk", "Wv", "fc"):
            sd[f"{p}rga.{name}.weight"] = t(layer["rga"][name]["kernel"]).T.contiguous()
            sd[f"{p}rga.{name}.bias"] = t(layer["rga"][name]["bias"])
        sd[f"{p}rga.E"] = t(layer["rga"]["E"])
        for name in ("FFN_pre", "FFN_suf"):
            sd[f"{p}{name}.weight"] = t(layer[name]["kernel"]).T.contiguous()
            sd[f"{p}{name}.bias"] = t(layer[name]["bias"])
        for name in ("layernorm1", "layernorm2"):
            sd[f"{p}{name}.weight"] = t(layer[name]["scale"])
            sd[f"{p}{name}.bias"] = t(layer[name]["bias"])
    head = "fc.0" if cfg.is_regression else "fc"
    sd[f"{head}.weight"] = t(params["fc"]["kernel"]).T.contiguous()
    sd[f"{head}.bias"] = t(params["fc"]["bias"])
    return sd


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
    device="cuda",
    attn_impl: str = "auto",
    param_dtype=None,
) -> Tuple[ModelConfig, MusicTransformer, Vocab]:
    """Load (config, model, vocab) from a reference work dir, onto the card
    unless ``device`` says otherwise. ``param_dtype`` as in
    ``MusicTransformer`` (default: ``dtype``)."""
    device = resolve_device(device)
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
    model = MusicTransformer(cfg, dtype=dtype, device=device, attn_impl=attn_impl,
                             param_dtype=param_dtype)
    model.load_state_dict(state_dict)
    return cfg, model.eval(), vocab
