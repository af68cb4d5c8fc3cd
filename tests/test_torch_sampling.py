"""Torch port, sampling: ``sample_step`` is token- and count-identical to the
JAX one on the same logits and uniforms."""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401 -- pins JAX to the CPU

import jax.numpy as jnp

from midi_emotion_tpu.ops import sampling as jsampling
from midi_emotion_tpu.vocab import DEFAULT_VOCAB
from midi_emotion_tpu_torch.ops import sampling as tsampling

CASES = {
    "greedy": dict(top_k=1, top_p=0.0, penalty_coeff=0.0),
    "top_k": dict(top_k=20, top_p=0.0, penalty_coeff=0.0),
    "top_p": dict(top_k=-1, top_p=0.7, penalty_coeff=0.0),
    "repeat_penalty": dict(top_k=-1, top_p=0.9, penalty_coeff=0.5),
    "defaults": dict(),  # top-p 0.7, penalty 0.5, temperatures 1.2
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sample_step_matches_jax(case):
    rng = np.random.default_rng(sorted(CASES).index(case))
    B, V = 16, len(DEFAULT_VOCAB)
    # a few very sharp rows so top-p keeps 1-2 tokens and the repeat
    # counter takes both branches
    logits = (rng.standard_normal((B, V)) * np.where(np.arange(B) < 4, 30.0, 2.0)[:, None])
    logits = logits.astype(np.float32)
    logits[0, 5] = np.nan
    temp_key = rng.integers(0, V, size=B).astype(np.int32)
    temp_key[:4] = DEFAULT_VOCAB.timeshift_base + 3  # note temperature branch
    counts = rng.integers(0, 12, size=B).astype(np.int32)
    u = rng.uniform(size=B).astype(np.float32)
    exclude = DEFAULT_VOCAB.special_mask()
    ts_range = (int(DEFAULT_VOCAB.timeshift_base), int(DEFAULT_VOCAB.base_size))
    kw = dict(CASES[case], temperatures=(1.1, 1.3)) if CASES[case] else {}

    want_tok, want_cnt = jsampling.sample_step(
        jnp.asarray(logits), jnp.asarray(temp_key), jnp.asarray(counts), jnp.asarray(u),
        jnp.asarray(exclude), ts_range, jsampling.SamplingParams(**kw),
    )
    got_tok, got_cnt = tsampling.sample_step(
        torch.from_numpy(logits), torch.from_numpy(temp_key).long(),
        torch.from_numpy(counts).long(), torch.from_numpy(u), torch.from_numpy(exclude),
        ts_range, tsampling.SamplingParams(**kw),
    )
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(want_cnt))
    assert not exclude[got_tok.numpy()].any()


def test_exclusion_ties_keep_index_order():
    """Every id excluded but one: the stable sort puts the -inf ties in
    index order after it, as lax.top_k does, so the draw cannot land on
    them."""
    V = 10
    exclude = np.ones(V, bool)
    exclude[7] = False
    logits = np.zeros((2, V), np.float32)
    tok, _ = tsampling.sample_step(
        torch.from_numpy(logits), torch.zeros(2, dtype=torch.long),
        torch.zeros(2, dtype=torch.long), torch.tensor([0.0, 0.999]),
        torch.from_numpy(exclude), (8, 10), tsampling.SamplingParams(top_p=0.0),
    )
    assert tok.tolist() == [7, 7]
