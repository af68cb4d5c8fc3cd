"""Sampling math, in torch.

Counterpart of ``midi_emotion_tpu/ops/sampling.py`` (whose module imports
jax, so ``SamplingParams`` is defined again here): NaN-zeroing ->
special-symbol exclusion -> per-sample dual temperature (note vs rest,
keyed on whether the previous token is a TIMESHIFT) -> log_softmax ->
repeat-penalty temperature boost -> top-k sort -> nucleus (top-p) mask ->
softmax -> categorical draw -> repeat-count update. All in float32
whatever the model's dtype.

RNG contract (the JAX package's): the draw is inverse-CDF over the sorted,
top-p-masked distribution with one uniform per (step, sample),
``token = sort_idx[argmax(cumsum(probs) >= u)]``. Given the same uniforms
the two packages pick the same tokens; their generators differ, so
cross-framework identity needs injected uniforms.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Defaults mirror the reference's generate.py:20-25 and its CLI."""

    gen_len: int = 2048
    max_input_len: int = 1216
    temperatures: Tuple[float, float] = (1.2, 1.2)  # (note/timeshift, rest)
    top_k: int = -1
    top_p: float = 0.7
    penalty_coeff: float = 0.5
    seed: int = 0


def sample_step(
    logits: torch.Tensor,
    temp_key: torch.Tensor,
    repeat_counts: torch.Tensor,
    uniforms: torch.Tensor,
    exclude_mask: torch.Tensor,
    ts_range: Tuple[int, int],
    params: SamplingParams,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sampling step for a batch.

    logits: [B, V]; temp_key: [B] int, the previous token (picks the
    temperature); repeat_counts: [B] int; uniforms: [B] f32 in [0, 1);
    exclude_mask: [V] bool, True at special ids; ts_range: (lo, hi) ids of
    TIMESHIFT tokens. Returns (token [B] int64, new_repeat_counts [B]).
    """
    neg_inf = float("-inf")
    logits = logits.float()
    logits = torch.where(torch.isnan(logits), 0.0, logits)
    logits = logits.masked_fill(exclude_mask[None, :], neg_inf)

    ts_lo, ts_hi = ts_range
    is_ts = (temp_key >= ts_lo) & (temp_key < ts_hi)
    temp = torch.where(is_ts, params.temperatures[0], params.temperatures[-1]).float()

    logp = torch.log_softmax(logits, dim=-1)
    if params.penalty_coeff > 0:
        rc = repeat_counts.float()
        mult = torch.clamp_min(torch.log((rc + 1.0) / 4.0) * params.penalty_coeff, 0.0)
        temp = temp + mult * temp
    logp = logp / temp[:, None]

    V = logits.shape[-1]
    k_eff = V if (params.top_k <= 0 or params.top_k > V) else params.top_k
    # stable descending sort: ties (e.g. the -inf excluded ids) keep index
    # order, as lax.top_k does
    top_vals, top_idx = torch.sort(logp, dim=-1, descending=True, stable=True)
    top_vals, top_idx = top_vals[:, :k_eff], top_idx[:, :k_eff]

    if 0.0 < params.top_p < 1.0:
        cum = torch.cumsum(torch.softmax(top_vals, dim=-1), dim=-1)
        remove = cum > params.top_p
        remove[:, 0] = False  # always keep the argmax
        top_vals = top_vals.masked_fill(remove, neg_inf)

    probs = torch.softmax(top_vals, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    picked = torch.argmax((cum >= uniforms[:, None]).int(), dim=-1)
    token = torch.gather(top_idx, 1, picked[:, None])[:, 0]

    num_choices = (probs > 0).sum(dim=-1)
    new_counts = torch.where(num_choices <= 2, repeat_counts + 1, repeat_counts // 2)
    return token, new_counts
