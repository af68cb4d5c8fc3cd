"""Torch port, ops: each function held to its JAX counterpart on the same
numpy inputs, in f32 at rtol/atol 2e-5 (the bound tests/test_pallas_attention.py
holds the JAX flash kernel to)."""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401 -- pins JAX to the CPU

import jax.numpy as jnp

from midi_emotion_tpu.ops import attention as jattn
from midi_emotion_tpu.ops import pallas_attention
from midi_emotion_tpu.ops.layernorm import layernorm_ref as jax_layernorm_ref
from midi_emotion_tpu_torch.ops import attention as tattn
from midi_emotion_tpu_torch.ops.flash_attention import flash_rel_attention
from midi_emotion_tpu_torch.ops.layernorm import LayerNorm, layernorm_ref

from torch_parity import assert_close, generic_interpret


TOL = 2e-5


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_layernorm_ref_matches_jax():
    rng = np.random.default_rng(0)
    x, w, b = _rand(rng, 3, 5, 64), _rand(rng, 64), _rand(rng, 64)
    want = jax_layernorm_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = layernorm_ref(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    assert_close(got, want, TOL)
    ln = LayerNorm(64)
    ln.load_state_dict({"weight": torch.from_numpy(w), "bias": torch.from_numpy(b)})
    with torch.inference_mode():
        assert_close(ln(torch.from_numpy(x)), want, TOL)


def test_rel_position_bias_and_mask_match_jax():
    rng = np.random.default_rng(1)
    q, e = _rand(rng, 2, 3, 24, 16), _rand(rng, 64, 16)
    assert_close(tattn.rel_position_bias(torch.from_numpy(q), torch.from_numpy(e)),
                 jattn.rel_position_bias(jnp.asarray(q), jnp.asarray(e)), TOL)
    tokens = rng.integers(0, 3, size=(2, 24)).astype(np.int32)
    np.testing.assert_array_equal(
        tattn.causal_pad_mask(torch.from_numpy(tokens), 0).numpy(),
        np.asarray(jattn.causal_pad_mask(jnp.asarray(tokens), 0)),
    )


@pytest.mark.parametrize("causal,with_pads", [(True, False), (True, True), (False, False)])
def test_relative_attention_matches_jax(causal, with_pads):
    rng = np.random.default_rng(2)
    B, H, T, dh, max_seq = 2, 2, 40, 16, 64
    q, k, v = (_rand(rng, B, H, T, dh) for _ in range(3))
    e = _rand(rng, max_seq, dh)
    pk = None
    if with_pads:
        pk = np.zeros((B, T), bool)
        pk[:, -T // 4:] = True
    want = jattn.relative_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(e), causal=causal,
        pad_keys=None if pk is None else jnp.asarray(pk), impl="xla",
    )
    args = [torch.from_numpy(a) for a in (q, k, v, e)]
    tpk = None if pk is None else torch.from_numpy(pk)
    for impl in ("plain", "kernel"):  # "kernel" on a CPU tensor = the flash twin
        got = tattn.relative_attention(*args, causal=causal, pad_keys=tpk, impl=impl)
        assert_close(got, want, TOL)


def test_decode_rel_attention_matches_jax():
    rng = np.random.default_rng(3)
    B, H, dh, W, max_seq, length = 2, 4, 16, 32, 64, 20
    q = _rand(rng, B, H, dh)
    kc, vc = _rand(rng, B, W, H * dh), _rand(rng, B, W, H * dh)
    e = _rand(rng, max_seq, dh)
    want = jattn.decode_rel_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                      jnp.asarray(e), jnp.asarray(length, jnp.int32))
    got = tattn.decode_rel_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                     torch.from_numpy(vc), torch.from_numpy(e), length)
    assert_close(got, want, TOL)


def _flash_twin_vs_pallas(seed, T, dh, max_seq):
    """(O, lse) of the flash wrapper's CPU path against the Pallas kernel in
    the generic interpreter at B 1, H 2, with key 0 and a tail of keys
    padded; row 0, which sees no key, held to O = 0 and lse = +1e30."""
    rng = np.random.default_rng(seed)
    B, H = 1, 2
    q, k, v = (_rand(rng, B, H, T, dh) for _ in range(3))
    e = _rand(rng, max_seq, dh)
    pk = np.zeros((B, T), bool)
    pk[:, 0] = True
    pk[:, -T // 4:] = True
    with generic_interpret():
        want_o, want_lse = pallas_attention._flash_fwd_impl(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(e), True,
            jnp.asarray(pk), return_lse=True,
        )
    got_o, got_lse = flash_rel_attention(
        *(torch.from_numpy(a) for a in (q, k, v, e)), True, torch.from_numpy(pk))
    assert_close(got_o[:, :, 1:], np.asarray(want_o)[:, :, 1:], TOL)
    assert_close(got_lse[:, :, 1:], np.asarray(want_lse)[:, :, 0, 1:T], TOL)
    assert np.all(got_o.numpy()[:, :, 0] == 0)
    assert np.all(got_lse.numpy()[:, :, 0] == np.float32(1e30))


def test_flash_twin_matches_pallas_kernel():
    """(O, lse) of the flash wrapper's CPU path against the Pallas kernel in
    the generic interpreter, with a padded key tail and a fully masked query row (key
    0 is pad, so row 0 sees no key).

    The fully masked row is held to the documented contract, O = 0 and
    lse = +1e30, and not to the Pallas kernel: its mask value is a finite
    -1e30, so such a row's softmax is uniform over the masked keys of its
    first block and its l > 0 guard never fires."""
    _flash_twin_vs_pallas(4, T=200, dh=16, max_seq=256)


@pytest.mark.parametrize("dh", [96, 128])
def test_flash_twin_matches_pallas_kernel_wide_heads(dh):
    """The d_head 96 and 128 that the port's kernels take, as
    test_flash_twin_matches_pallas_kernel, at a short T."""
    _flash_twin_vs_pallas(dh, T=40, dh=dh, max_seq=64)
