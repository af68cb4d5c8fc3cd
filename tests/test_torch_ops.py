"""Torch port, ops: each function held to its JAX counterpart on the same
numpy inputs, in f32 at rtol/atol 2e-5 (the bound tests/test_pallas_attention.py
holds the JAX flash kernel to)."""

import math

import numpy as np
import pytest
import torch

import conftest  # noqa: F401 -- pins JAX to the CPU

import jax
import jax.numpy as jnp

from midi_emotion_tpu.ops import attention as jattn
from midi_emotion_tpu.ops import pallas_attention
from midi_emotion_tpu.ops.layernorm import layernorm_ref as jax_layernorm_ref
from midi_emotion_tpu_torch.ops import attention as tattn
from midi_emotion_tpu_torch.ops import flash_attention as fa
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


def _card_route(dh, *tensors):
    """The tensors as the card's wrappers hand them to a kernel: padded with
    zero columns to ``padded_dh(dh)``; and c = 1/sqrt(d_head)."""
    return fa.pad_heads(fa.padded_dh(dh), *tensors), 1.0 / math.sqrt(dh)


def _flash_twin_vs_pallas(seed, T, dh, max_seq):
    """(O, lse) of the flash wrapper's CPU path, and of the twin on the
    card's route (heads padded to ``padded_dh``, c passed, O cut back),
    against the Pallas kernel in the generic interpreter at B 1, H 2, with
    key 0 and a tail of keys padded; row 0, which sees no key, held to O =
    0 and lse = +1e30."""
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
    padded, c = _card_route(dh, *(torch.from_numpy(a) for a in (q, k, v, e)))
    o, lse = fa.flash_rel_attention_plain(*padded, True, torch.from_numpy(pk), scale=c)
    assert o[..., dh:].eq(0).all()
    assert_close(o[:, :, 1:, :dh], np.asarray(want_o)[:, :, 1:], TOL)
    assert_close(lse[:, :, 1:], np.asarray(want_lse)[:, :, 0, 1:T], TOL)


def test_flash_twin_matches_pallas_kernel():
    """(O, lse) of the flash wrapper's CPU path against the Pallas kernel in
    the generic interpreter, with a padded key tail and a fully masked query row (key
    0 is pad, so row 0 sees no key).

    The fully masked row is held to the documented contract, O = 0 and
    lse = +1e30, and not to the Pallas kernel: its mask value is a finite
    -1e30, so such a row's softmax is uniform over the masked keys of its
    first block and its l > 0 guard never fires."""
    _flash_twin_vs_pallas(4, T=200, dh=16, max_seq=256)


@pytest.mark.parametrize("dh", [96, 128, 160, 192, 256])
def test_flash_twin_matches_pallas_kernel_wide_heads(dh):
    """The d_head 96 to 256 that the port's kernels take (160 padded to
    192), as test_flash_twin_matches_pallas_kernel, at a short T."""
    _flash_twin_vs_pallas(dh, T=40, dh=dh, max_seq=64)


# d_head outside KERNEL_DHS: the wrappers pad them with zero columns on the
# card (40 -> 48, 80 -> 96)
PADDED_DHS = [40, 80]


@pytest.mark.parametrize("dh", PADDED_DHS)
def test_flash_twin_matches_pallas_kernel_padded_heads(dh):
    """A d_head the kernels are not built for, as
    test_flash_twin_matches_pallas_kernel, at a short T."""
    _flash_twin_vs_pallas(dh + 1, T=24, dh=dh, max_seq=64)


@pytest.mark.parametrize("dh", PADDED_DHS)
def test_flash_backward_twin_matches_pallas_kernel_padded_heads(dh):
    """Autograd through the flash wrapper (its merged backward twin on the
    CPU) against jax.grad of the Pallas flash attention in the generic
    interpreter (the merged Pallas backward) at a d_head the kernels are
    not built for: dQ, dK, dV and dE to 1e-4, causal with a pad tail."""
    rng = np.random.default_rng(dh)
    B, H, T, max_seq = 2, 2, 24, 64
    q, k, v, g = (_rand(rng, B, H, T, dh) for _ in range(4))
    e = _rand(rng, max_seq, dh)
    pk = np.zeros((B, T), bool)
    pk[:, -T // 4:] = True

    def loss(q_, k_, v_, e_):
        o = pallas_attention.flash_relative_attention(q_, k_, v_, e_, True, jnp.asarray(pk))
        return jnp.sum(o * g)

    with generic_interpret():
        want = jax.grad(loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (q, k, v, e)))
    xs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, e)]
    o, _ = flash_rel_attention(*xs, True, torch.from_numpy(pk))
    got = torch.autograd.grad(o, xs, torch.from_numpy(g))
    for name, a, b in zip(("dq", "dk", "dv", "de"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dh", PADDED_DHS + [160, 224])
def test_padded_heads_match_unpadded_twins(dh, causal):
    """The card's route for such a d_head, run through the twins: q, k, v,
    e and dO padded with zero columns by ``pad_heads`` to ``padded_dh``,
    c = 1/sqrt(true d_head) passed as the scale, the outputs cut back;
    against the twins at the true d_head: O, lse and the merged backward's
    dQ, dK, dV, dE to 1e-6."""
    gen = torch.Generator().manual_seed(dh)
    B, H, T, max_seq = 2, 3, 37, 64
    q, k, v, do = (torch.randn((B, H, T, dh), generator=gen) for _ in range(4))
    e = torch.randn((max_seq, dh), generator=gen)
    pad = torch.zeros((B, T), dtype=torch.bool)
    pad[1, 0] = True
    pad[1, -T // 4:] = True
    dh_k = fa.padded_dh(dh)
    assert dh_k == {40: 48, 80: 96, 160: 192, 224: 256}[dh]
    qp, kp, vp, ep, dop = fa.pad_heads(dh_k, q, k, v, e, do)
    assert qp.shape[-1] == ep.shape[-1] == dh_k and qp[..., dh:].eq(0).all()
    scale = 1.0 / math.sqrt(dh)
    o, lse = fa.flash_rel_attention_plain(q, k, v, e, causal, pad)
    op, lsep = fa.flash_rel_attention_plain(qp, kp, vp, ep, causal, pad, scale=scale)
    torch.testing.assert_close(op[..., :dh], o, rtol=1e-6, atol=1e-6)
    assert op[..., dh:].eq(0).all()
    torch.testing.assert_close(lsep, lse, rtol=1e-6, atol=1e-6)
    want = fa.flash_rel_attention_bwd_plain(q, k, v, e, causal, pad, o, lse, do)
    got = fa.flash_rel_attention_bwd_plain(qp, kp, vp, ep, causal, pad,
                                           *fa.pad_heads(dh_k, o), lse, dop, scale=scale)
    for name, a, b in zip(("dq", "dk", "dv", "de"), got, want):
        torch.testing.assert_close(a[..., :dh], b, rtol=1e-6, atol=1e-6, msg=name)


def test_padded_dh_bounds():
    """Every d_head up to 256 maps to the least width kernels 1, 4 and 13
    are built for that holds it; above 256 raises a ValueError naming
    d_head. Kernels 5-9 (``decomposition_dh``) stop at 128, naming d_head
    and the variables that chose each."""
    assert [fa.padded_dh(d) for d in (1, 16, 17, 40, 48, 80, 97, 128, 129, 160, 192, 193,
                                      224, 256)] == \
        [16, 16, 32, 48, 48, 96, 128, 128, 192, 192, 192, 256, 256, 256]
    with pytest.raises(ValueError, match="d_head <= 256, got 257"):
        fa.padded_dh(257)
    for wrapper, chosen in fa.CHOSEN_BY.items():
        assert fa.decomposition_dh(97, wrapper) == 128
        with pytest.raises(ValueError, match=f"{wrapper} \\(chosen by {chosen}\\) takes "
                                             "d_head <= 128, got 129"):
            fa.decomposition_dh(129, wrapper)


@pytest.mark.parametrize("dh", [192, 256])
def test_flash_backward_twin_matches_pallas_kernel_wider_heads(dh):
    """Autograd through the flash wrapper (the merged backward twin) and
    the twin on the card's route (heads padded to ``padded_dh``, c passed,
    the gradients cut back) against jax.grad of the Pallas flash attention
    in the generic interpreter, past d_head 128: dQ, dK, dV and dE to 1e-4,
    causal with a pad tail, one head, T 16."""
    rng = np.random.default_rng(dh + 3)
    B, H, T, max_seq = 1, 1, 16, 32
    q, k, v, g = (_rand(rng, B, H, T, dh) for _ in range(4))
    e = _rand(rng, max_seq, dh)
    pk = np.zeros((B, T), bool)
    pk[:, -T // 4:] = True

    def loss(q_, k_, v_, e_):
        o = pallas_attention.flash_relative_attention(q_, k_, v_, e_, True, jnp.asarray(pk))
        return jnp.sum(o * g)

    with generic_interpret():
        want = jax.grad(loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (q, k, v, e)))
    xs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, e)]
    o, lse = flash_rel_attention(*xs, True, torch.from_numpy(pk))
    got = torch.autograd.grad(o, xs, torch.from_numpy(g))
    (qp, kp, vp, ep, gp, op), c = _card_route(dh, *xs, torch.from_numpy(g), o.detach())
    routed = fa.flash_rel_attention_bwd_plain(qp.detach(), kp.detach(), vp.detach(), ep.detach(),
                                              True, torch.from_numpy(pk), op, lse, gp, scale=c)
    for name, a, r, b in zip(("dq", "dk", "dv", "de"), got, routed, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4, err_msg=name)
        np.testing.assert_allclose(r[..., :dh].numpy(), np.asarray(b), rtol=1e-4, atol=1e-4,
                                   err_msg=name)

