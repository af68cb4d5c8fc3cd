"""Torch port, heads wider than the kernels' built widths: the flash
forward and its merged backward at d_head 320 (padded to 384 on the card),
384, 768 and 1024, held to the JAX package's Pallas kernels in the generic
interpreter (which take d_head whole, as the port's wide kernels stream
it), through the wrappers' CPU path and through the card's route (heads
padded to ``padded_dh``, c = 1/sqrt(true d_head) passed, outputs cut back).
Short sequences (T <= 24, B * H <= 2) keep the interpreter's time down;
one jax.vjp per width gives both the forward and the backward."""

import math

import numpy as np
import pytest
import torch

import conftest  # noqa: F401 -- pins JAX to the CPU

import jax
import jax.numpy as jnp

from midi_emotion_tpu.ops import attention as jattn
from midi_emotion_tpu.ops import pallas_attention
from midi_emotion_tpu_torch.ops import flash_attention as fa

from torch_parity import generic_interpret

# d_head -> (B, H, T): 320 is padded to 384 on the card, the others are
# multiples of the wide kernels' 128-column part
WIDE = {320: (1, 2, 24), 384: (2, 1, 20), 768: (1, 1, 16), 1024: (1, 1, 12)}
MAX_SEQ = 32


def _jax_lse(q, k, e, pk):
    """The JAX package's closed-form log-sum-exp of the causal, key-padded
    relative logits: [B, H, T]."""
    T, dh = q.shape[2], q.shape[-1]
    logits = (q @ jnp.swapaxes(k, -1, -2) + jattn.rel_position_bias(q, e)) / math.sqrt(dh)
    masked = jnp.triu(jnp.ones((T, T), bool), 1)[None, None] | pk[:, None, None, :]
    return jax.nn.logsumexp(jnp.where(masked, -jnp.inf, logits), axis=-1)


@pytest.mark.parametrize("dh", list(WIDE))
def test_flash_matches_pallas_kernel_wide_heads(dh):
    """Causal with a pad tail. The forward: O of the wrapper's CPU path and
    of the twin on the card's route against the Pallas forward's, lse
    against the JAX closed form's: 2e-5 (the bound test_torch_ops.py holds
    O and lse to). The backward: autograd through the wrapper (the merged
    backward twin on the CPU) and the merged twin on the card's route
    against the merged Pallas backward's dQ, dK, dV and dE: 1e-4."""
    B, H, T = WIDE[dh]
    rng = np.random.default_rng(dh)
    q, k, v, g = (rng.standard_normal((B, H, T, dh)).astype(np.float32) for _ in range(4))
    e = rng.standard_normal((MAX_SEQ, dh)).astype(np.float32)
    pk = np.zeros((B, T), bool)
    pk[:, -T // 4:] = True
    with generic_interpret():
        want_o, vjp = jax.vjp(
            lambda *a: pallas_attention.flash_relative_attention(*a, True, jnp.asarray(pk)),
            *(jnp.asarray(a) for a in (q, k, v, e)))
        want = vjp(jnp.asarray(g))
    want_o = np.asarray(want_o)
    want_lse = np.asarray(_jax_lse(*(jnp.asarray(a) for a in (q, k, e, pk))))

    xs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, e)]
    pad = torch.from_numpy(pk)
    o, lse = fa.flash_rel_attention(*xs, True, pad)
    np.testing.assert_allclose(o.detach().numpy(), want_o, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=2e-5, atol=2e-5)
    got = torch.autograd.grad(o, xs, torch.from_numpy(g))

    dh_k = fa.padded_dh(dh)
    assert dh_k == (384 if dh == 320 else dh)
    c = 1.0 / math.sqrt(dh)
    qp, kp, vp, ep, gp = fa.pad_heads(dh_k, *(x.detach() for x in xs), torch.from_numpy(g))
    op, lsep = fa.flash_rel_attention_plain(qp, kp, vp, ep, True, pad, scale=c)
    assert op[..., dh:].eq(0).all()
    np.testing.assert_allclose(op[..., :dh].numpy(), want_o, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lsep.numpy(), want_lse, rtol=2e-5, atol=2e-5)
    routed = fa.flash_rel_attention_bwd_plain(qp, kp, vp, ep, True, pad, op, lsep, gp, scale=c)
    for name, a, r, b in zip(("dq", "dk", "dv", "de"), got, routed, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4, err_msg=name)
        np.testing.assert_allclose(r[..., :dh].numpy(), np.asarray(b), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
        assert r[..., dh:].eq(0).all(), name
