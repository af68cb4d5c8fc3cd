"""The JAX package's native work dirs, read and written by the port.

Counterpart of ``midi_emotion_tpu/training/checkpoint.py``
(``save_checkpoint`` :39, ``load_params`` :62, ``is_native_dir`` :90,
``load_model_dir`` :94). A native work dir holds

    model_config.json   -- ModelConfig.to_json()
    vocab.json          -- Vocab.to_dict()
    model.msgpack       -- the Flax parameter tree (flax.serialization)
    optimizer.msgpack   -- the optax state of ``make_optimizer(clip)``
    stats.json          -- {step, hour, epoch, sample}
    performance.csv     -- the metric log

and the msgpack files go through the port's own codec
(``flax_msgpack.py``). The parameter tree maps onto the port's
``state_dict`` through ``state_dict_from_jax_params`` and back through
``jax_params_from_state_dict``, Dense kernels transposed.

The optimizer: the JAX package's Adam is
``optax.chain(clip_by_global_norm(clip), scale_by_adam(0.9, 0.999, 1e-8),
scale(-1))`` (``training/train_step.py:41``; no clip entry when clip is 0),
whose state is ``{"0": {}, "1": {"count": int32[], "mu": params, "nu":
params}, "2": {}}``. Its ``count``, ``mu`` and ``nu`` are torch Adam's
``step``, ``exp_avg`` and ``exp_avg_sq``, with the same bias correction.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.model import MusicTransformer
from ..vocab import Vocab
from . import flax_msgpack, state_dict_from_jax_params

MODEL_FILE, OPT_FILE = "model.msgpack", "optimizer.msgpack"


def is_native_dir(model_dir: str) -> bool:
    return os.path.exists(os.path.join(model_dir, "model_config.json"))


def _sorted(tree):
    """Every map's keys in sorted order, as Flax's ``init_params`` gives
    them (so the port writes the bytes the JAX package writes)."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def _leaf(t: torch.Tensor, transpose: bool = False):
    """A tensor -> a C-ordered numpy array on the host (a bfloat16 tensor
    stays a torch tensor: numpy has no bfloat16)."""
    t = t.detach().cpu()
    if transpose:
        t = t.T
    if t.dtype == torch.bfloat16:
        return t.contiguous()
    return np.ascontiguousarray(t.numpy())


def jax_params_from_state_dict(state_dict: Dict[str, torch.Tensor], cfg: ModelConfig) -> Dict:
    """The port's ``state_dict`` -> the JAX package's parameter tree,
    the inverse of ``state_dict_from_jax_params`` (Linear weights [out, in]
    become Dense kernels [in, out]). Raises a ValueError naming any entry
    that does not map (the positional table aside)."""
    sd = dict(state_dict)

    def dense(name):
        return {"kernel": _leaf(sd.pop(f"{name}.weight"), transpose=True),
                "bias": _leaf(sd.pop(f"{name}.bias"))}

    params: Dict = {"embedding": {"embedding": _leaf(sd.pop("embedding.weight"))}}
    if "fc_condition.weight" in sd:
        params["fc_condition"] = dense("fc_condition")
    for i in range(cfg.n_conditions):
        if f"fc_condition.{i}.weight" in sd:
            params[f"fc_condition_{i}"] = dense(f"fc_condition.{i}")
    for i in range(cfg.n_layer):
        p = f"enc_layers.{i}."
        layer = {"rga": {name: dense(f"{p}rga.{name}") for name in ("Wq", "Wk", "Wv", "fc")}}
        layer["rga"]["E"] = _leaf(sd.pop(f"{p}rga.E"))
        for name in ("FFN_pre", "FFN_suf"):
            layer[name] = dense(f"{p}{name}")
        for name in ("layernorm1", "layernorm2"):
            layer[name] = {"scale": _leaf(sd.pop(f"{p}{name}.weight")),
                           "bias": _leaf(sd.pop(f"{p}{name}.bias"))}
        params[f"enc_layers_{i}"] = layer
    params["fc"] = dense("fc.0" if cfg.is_regression else "fc")
    leftover = [k for k in sd if not k.endswith("positional_embedding")]
    if leftover:
        raise ValueError(f"state_dict entries with no JAX counterpart: {leftover}")
    return _sorted(params)


def load_params(work_dir: str) -> Dict:
    """The parameter tree of ``model.msgpack``."""
    return flax_msgpack.read(os.path.join(work_dir, MODEL_FILE))


def read_config_and_vocab(model_dir: str) -> Tuple[ModelConfig, Vocab]:
    with open(os.path.join(model_dir, "model_config.json")) as f:
        cfg = ModelConfig.from_json(f.read())
    with open(os.path.join(model_dir, "vocab.json")) as f:
        vocab = Vocab.from_dict(json.load(f))
    return cfg, vocab


def load_native_dir(
    model_dir: str,
    dtype: torch.dtype = torch.float32,
    device="cuda",
    attn_impl: str = "auto",
    param_dtype=None,
) -> Tuple[ModelConfig, MusicTransformer, Vocab]:
    """(config, model, vocab) from a native work dir; the arguments as in
    ``convert.load_model_dir``."""
    cfg, vocab = read_config_and_vocab(model_dir)
    state_dict = state_dict_from_jax_params(load_params(model_dir), cfg)
    model = MusicTransformer(cfg, dtype=dtype, device=device, attn_impl=attn_impl,
                             param_dtype=param_dtype)
    model.load_state_dict(state_dict)
    return cfg, model.eval(), vocab


def write_native_model(work_dir: str, cfg: ModelConfig, state_dict: Dict[str, torch.Tensor],
                       vocab: Vocab) -> int:
    """model_config.json, vocab.json and model.msgpack, as the JAX
    ``save_checkpoint`` writes them; returns model.msgpack's bytes."""
    os.makedirs(work_dir, exist_ok=True)
    with open(os.path.join(work_dir, "model_config.json"), "w") as f:
        f.write(cfg.to_json())
    with open(os.path.join(work_dir, "vocab.json"), "w") as f:
        json.dump(vocab.to_dict(), f)
    return flax_msgpack.write(os.path.join(work_dir, MODEL_FILE),
                              jax_params_from_state_dict(state_dict, cfg))


# ---------------------------------------------------------------------------
# the optimizer: torch Adam <-> optax's chain state
# ---------------------------------------------------------------------------


def opt_state_from_adam(optimizer: torch.optim.Optimizer, model: MusicTransformer,
                        clip: float) -> Dict:
    """torch Adam's state -> the optax state of the JAX package's
    ``make_optimizer(clip)``. A parameter with no state yet (no step
    taken) gets optax's initial state: count 0, zero moments."""
    mu, nu, counts = {}, {}, set()
    for name, p in model.named_parameters():
        state = optimizer.state.get(p, {})
        if state:
            mu[name], nu[name] = state["exp_avg"], state["exp_avg_sq"]
            counts.add(int(state["step"]))
        else:
            mu[name] = nu[name] = torch.zeros_like(p, device="cpu")
            counts.add(0)
    if len(counts) != 1:
        raise ValueError(f"parameters at different Adam steps {sorted(counts)}: optax keeps one "
                         "count")
    adam = {"count": np.asarray(counts.pop(), np.int32),
            "mu": jax_params_from_state_dict(mu, model.config),
            "nu": jax_params_from_state_dict(nu, model.config)}
    chain = ([{}] if clip > 0 else []) + [adam, {}]
    return {str(i): s for i, s in enumerate(chain)}


def load_adam_state(tree: Dict, optimizer: torch.optim.Optimizer,
                    model: MusicTransformer) -> bool:
    """Restore torch Adam in place from an optax state tree. Returns False,
    leaving the optimizer as it was, when the tree does not fit the model
    (another chain, a missing or misshapen moment), as the JAX package's
    ``load_opt_state`` returns None."""
    adam = None
    if isinstance(tree, dict):
        adam = next((v for v in tree.values() if isinstance(v, dict) and "mu" in v), None)
    if adam is None:
        return False
    params = dict(model.named_parameters())
    try:
        mu = state_dict_from_jax_params(adam["mu"], model.config)
        nu = state_dict_from_jax_params(adam["nu"], model.config)
        count = int(np.asarray(adam["count"]))
    except (KeyError, TypeError, ValueError):
        return False
    for moments in (mu, nu):
        if moments.keys() != params.keys() or any(
                moments[n].shape != p.shape for n, p in params.items()):
            return False
    index = {}
    for group in optimizer.param_groups:
        for p in group["params"]:
            index[id(p)] = len(index)
    state = {index[id(p)]: {"step": torch.tensor(float(count)), "exp_avg": mu[n],
                            "exp_avg_sq": nu[n]}
             for n, p in params.items()}
    optimizer.load_state_dict({"state": state,
                               "param_groups": optimizer.state_dict()["param_groups"]})
    return True
