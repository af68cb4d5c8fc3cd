"""Training and evaluation steps, in torch.

Counterpart of ``midi_emotion_tpu/training/train_step.py``: one step runs
the forward, loss and backward of each microbatch (gradient accumulation
over a leading ``[accumulate_steps]`` axis, reference ``--accumulate_step``,
train.py:309, 319-325), averages the losses and gradients, clips by global
norm and takes an Adam step.

* Global-norm clip as optax computes it: g is kept when its global norm is
  under ``clip`` and scaled by clip / norm otherwise
  (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm, which optax
  does not).
* Adam(0.9, 0.999, eps 1e-8) is ``torch.optim.Adam``, with the LR set on its
  param group at the call site each step (the JAX step multiplies the LR in
  after ``scale_by_adam``; the arithmetic is the same). Its
  ``state_dict`` is what the reference saves as ``optimizer.pt``.
* ``grad_norm`` is the norm before the clip (``train_step.py:120``).

The parameters are the model's f32 masters; the model computes in its own
dtype (``models/model.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..models.model import MusicTransformer
from .metrics import topk_accuracy


def cross_entropy_ignore_pad(
    logits: torch.Tensor, target: torch.Tensor, pad_id: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean CE over non-pad targets (torch CrossEntropyLoss(ignore_index),
    train.py:124), in f32; 0 when every target is pad. Returns (loss,
    n_valid)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, target[..., None].long())[..., 0]
    valid = target != pad_id
    n = valid.sum()
    return -torch.where(valid, ll, 0.0).sum() / n.clamp(min=1), n


def l1_loss(pred: torch.Tensor, condition: torch.Tensor) -> torch.Tensor:
    """The regression model's training loss (train.py:283-284)."""
    return (pred.float() - condition.float()).abs().mean()


def make_optimizer(model: torch.nn.Module) -> torch.optim.Adam:
    """Adam(0.9, 0.999, eps 1e-8) over the model's parameters; the LR is set
    per step by the train step."""
    return torch.optim.Adam(model.parameters(), lr=0.0, betas=(0.9, 0.999), eps=1e-8)


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, f32 (optax.global_norm)."""
    return torch.linalg.vector_norm(
        torch.stack([n.float() for n in torch._foreach_norm(grads)]))


def make_loss_fn(model: MusicTransformer) -> Callable:
    cfg = model.config

    def loss_fn(batch: Dict[str, torch.Tensor], generator=None) -> torch.Tensor:
        out = model(batch["input"], batch["condition"], generator=generator)
        if cfg.is_regression:
            return l1_loss(out, batch["condition"])
        return cross_entropy_ignore_pad(out, batch["target"], cfg.pad_id)[0]

    return loss_fn


def make_train_step(
    model: MusicTransformer,
    optimizer: torch.optim.Optimizer,
    clip: float,
    accumulate_steps: int = 1,
) -> Callable:
    """Returns step(batch, lr, generator=None) -> {"loss", "grad_norm"}
    (0-dim tensors on the model's device, not synchronised), updating the
    model's parameters and the optimizer's state in place.

    ``batch`` holds tensors with a leading [accumulate_steps] axis:
    "input" [A, B, T] int, "condition" [A, B, 2] float and, for the LM,
    "target" [A, B, T'] int. ``generator`` (a CPU ``torch.Generator``)
    draws the dropout seeds."""
    loss_fn = make_loss_fn(model)

    def step(batch: Dict[str, torch.Tensor], lr: float,
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss_sum = torch.zeros((), dtype=torch.float32, device=model.device)
        for a in range(accumulate_steps):
            loss = loss_fn({k: v[a] for k, v in batch.items()}, generator)
            loss.backward()
            loss_sum += loss.detach()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        if accumulate_steps > 1:  # mean over microbatches
            torch._foreach_div_(grads, accumulate_steps)
        gnorm = global_norm(grads)
        if clip > 0:
            torch._foreach_mul_(grads, clip / torch.clamp(gnorm, min=clip))
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()
        return {"loss": loss_sum / accumulate_steps, "grad_norm": gnorm}

    return step


def make_eval_step(model: MusicTransformer) -> Callable:
    """Returns step(batch) -> per-batch loss and metrics (evaluate(),
    train.py:222-274); batch tensors have no accumulate axis."""
    cfg = model.config

    @torch.inference_mode()
    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model.eval()
        logits = model(batch["input"], batch["condition"])
        out: Dict[str, torch.Tensor] = {}
        if cfg.is_regression:
            pred = logits.clamp(-1.0, 1.0).float()  # train.py:247
            cond = batch["condition"].float()
            out["loss"] = (pred - cond).abs().mean()
            out["l1_v"] = (pred[:, 0] - cond[:, 0]).abs().mean()
            out["l1_a"] = (pred[:, 1] - cond[:, 1]).abs().mean()
            out["l1_mean"] = (out["l1_v"] + out["l1_a"]) / 2
            out["l1_mean_normal"] = out["l1_mean"] / 2
            out["n_elements"] = torch.tensor(pred.shape[0])
        else:
            out["loss"] = cross_entropy_ignore_pad(logits, batch["target"], cfg.pad_id)[0]
            accs = topk_accuracy(logits, batch["target"], (1, 5), ignore_index=cfg.pad_id)
            out["top1"] = accs["top1"]
            out["top5"] = accs["top5"]
            out["n_elements"] = torch.tensor(batch["input"].numel())
        return out

    return step
