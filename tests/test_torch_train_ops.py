"""Torch port, the training ops: each backward and dropout path held to
its JAX counterpart on the same numpy inputs, in f32 on the CPU, where the
port's wrappers run their plain twins and the Pallas kernels run in
interpret mode (``pltpu.force_tpu_interpret_mode``, as the JAX package's
own tests run them). The interpreter draws zero bits, which the JAX
dropout kernels read as keep-everything, so those comparisons use an
all-keep mask; a random mask is injected into the twins and held to
``jax.grad`` of the composed closed form."""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401 -- pins JAX to the CPU

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from midi_emotion_tpu.ops import fused_dropout as jfd
from midi_emotion_tpu.ops import pallas_attention
from midi_emotion_tpu.ops.layernorm import fused_layernorm
from midi_emotion_tpu.ops.layernorm import layernorm_ref as jax_layernorm_ref
from midi_emotion_tpu_torch.ops import fused_dropout as fd
from midi_emotion_tpu_torch.ops.flash_attention import flash_rel_attention
from midi_emotion_tpu_torch.ops.layernorm import layernorm

from torch_parity import assert_close

RATE = 0.25


def _rand(rng, *shape, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _ln_inputs(seed, rows=26, d=128):
    rng = np.random.default_rng(seed)
    return (_rand(rng, 2, rows // 2, d, scale=2, shift=0.5), _rand(rng, 2, rows // 2, d),
            _rand(rng, 2, rows // 2, d), (rng.random(d) + 0.5).astype(np.float32),
            _rand(rng, d))


def _grads(fn, *arrays):
    """torch: (output, grads of sum(output * cot)) for float32 arrays;
    the cotangent is the last array."""
    *xs, cot = [torch.from_numpy(a) for a in arrays]
    xs = [x.requires_grad_() for x in xs]
    y = fn(*xs)
    return y.detach(), torch.autograd.grad(y, xs, cot)


def test_layernorm_backward_matches_pallas_kernel():
    """Kernel 3's twin: dx to 1e-5, dgamma/dbeta (sums over 26 rows) to
    1e-4, against jax.vjp of fused_layernorm."""
    x, dy, _, w, b = _ln_inputs(0)
    with pltpu.force_tpu_interpret_mode():
        y, vjp = jax.vjp(fused_layernorm, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
        want = vjp(jnp.asarray(dy))
    got_y, got = _grads(layernorm, x, w, b, dy)
    assert_close(got_y, y, 2e-5)
    for g, r, tol in zip(got, want, (1e-5, 1e-4, 1e-4)):
        assert_close(g, r, tol)


def test_fused_dropout_allkeep_matches_pallas_kernel():
    """Kernel 10's twin with an all-keep mask: forward and gradient exact to
    1e-6 against fd.fused_dropout in interpret mode."""
    x, g, *_ = _ln_inputs(1)
    kd = jax.random.key_data(jax.random.PRNGKey(7))
    with pltpu.force_tpu_interpret_mode():
        y, vjp = jax.vjp(lambda a: jfd.fused_dropout(a, kd, RATE), jnp.asarray(x))
        (want_dx,) = vjp(jnp.asarray(g))
    keep = torch.ones(x.shape, dtype=torch.bool)
    got_y, (got_dx,) = _grads(lambda a: fd.dropout_plain(a, keep, RATE), x, g)
    assert_close(got_y, y, 1e-6)
    assert_close(got_dx, want_dx, 1e-6)


def test_dropout_add_layernorm_allkeep_matches_pallas_kernels():
    """Kernels 11 and 12's twins with an all-keep mask against
    fd.dropout_add_layernorm in interpret mode: y to 2e-5, dsub and dres
    to 2e-5, dgamma/dbeta to 1e-4."""
    sub, res, dy, w, b = _ln_inputs(2)
    kd = jax.random.key_data(jax.random.PRNGKey(7))
    with pltpu.force_tpu_interpret_mode():
        y, vjp = jax.vjp(lambda s, r, g_, b_: jfd.dropout_add_layernorm(s, r, g_, b_, kd, RATE),
                         *(jnp.asarray(a) for a in (sub, res, w, b)))
        want = vjp(jnp.asarray(dy))
    keep = torch.ones(sub.shape, dtype=torch.bool)
    t = [torch.from_numpy(a) for a in (sub, res, dy, w, b)]
    assert_close(fd.dropout_add_layernorm_plain(t[0], t[1], t[3], t[4], keep, RATE), y, 2e-5)
    got = fd.dropout_add_layernorm_bwd_plain(t[0], t[1], t[2], t[3], keep, RATE)
    for g, r, tol in zip(got, want, (2e-5, 2e-5, 1e-4, 1e-4)):
        assert_close(g, r, tol)


def test_dropout_twins_with_injected_mask_match_jax_closed_form():
    """A random mask injected into the twins, against jax.grad of
    layernorm_ref(res + where(mask, sub / keep, 0)) and of the dropout
    alone: 2e-5 on outputs and per-element grads, 1e-4 on dgamma/dbeta."""
    sub, res, dy, w, b = _ln_inputs(3)
    mask = np.random.default_rng(4).random(sub.shape) < 1 - RATE

    def composed(s, r, g_, b_):
        return jax_layernorm_ref(r + jnp.where(mask, s / (1 - RATE), 0.0), g_, b_)

    y, vjp = jax.vjp(composed, *(jnp.asarray(a) for a in (sub, res, w, b)))
    want = vjp(jnp.asarray(dy))
    keep = torch.from_numpy(mask)
    t = [torch.from_numpy(a) for a in (sub, res, dy, w, b)]
    assert_close(fd.dropout_add_layernorm_plain(t[0], t[1], t[3], t[4], keep, RATE), y, 2e-5)
    got = fd.dropout_add_layernorm_bwd_plain(t[0], t[1], t[2], t[3], keep, RATE)
    for g, r, tol in zip(got, want, (2e-5, 2e-5, 1e-4, 1e-4)):
        assert_close(g, r, tol)
    dropped = fd.dropout_plain(t[0], keep, RATE)
    assert_close(dropped, jnp.where(mask, sub / (1 - RATE), 0.0), 1e-6)


def test_dropout_wrappers_replay_their_mask_on_the_cpu():
    """The CPU path draws its mask from the seed in both directions: the
    gradient's zeros are the output's, a seed reproduces, and the keep
    fraction is binomial (6 standard deviations)."""
    x = torch.ones((64, 96), requires_grad=True)
    y = fd.fused_dropout(x, 11, RATE)
    y.backward(torch.ones_like(y))
    keep = y.detach() != 0
    assert torch.equal(x.grad != 0, keep)
    assert torch.equal(fd.fused_dropout(x.detach(), 11, RATE), y.detach())
    assert abs(keep.float().mean().item() - (1 - RATE)) < 6 * (RATE * (1 - RATE) / keep.numel()) ** 0.5
    sub, res = torch.randn(8, 96, requires_grad=True), torch.randn(8, 96, requires_grad=True)
    w, b = torch.ones(96, requires_grad=True), torch.zeros(96, requires_grad=True)
    out = fd.dropout_add_layernorm(sub, res, w, b, 5, RATE)
    mask = fd.keep_mask(5, sub.shape, RATE)
    assert_close(out.detach(), fd.dropout_add_layernorm_plain(sub, res, w, b, mask, RATE).detach(), 0)
    out.backward(torch.randn(out.shape, generator=torch.Generator().manual_seed(0)))
    assert torch.equal(sub.grad != 0, mask)


@pytest.mark.parametrize("T,dh,causal,pad_tail", [
    (40, 48, True, True),
    (32, 16, False, False),
])
def test_flash_backward_matches_pallas_kernel(T, dh, causal, pad_tail):
    """Autograd through the port's flash wrapper (its plain backward twin
    on the CPU) against jax.grad of flash_relative_attention in interpret
    mode (the merged Pallas backward), dQ, dK, dV and dE to 1e-4. No pad at
    key 0: the Pallas forward does not zero a fully masked row (ROADMAP
    queue 3); the next test holds that row."""
    B, H, max_seq = 2, 2, 128
    rng = np.random.default_rng(T + dh)
    q, k, v, g = (_rand(rng, B, H, T, dh) for _ in range(4))
    e = _rand(rng, max_seq, dh)
    pk = np.zeros((B, T), bool)
    if pad_tail:
        pk[:, -T // 4:] = True
    jpk = jnp.asarray(pk) if pad_tail else None

    def loss(q_, k_, v_, e_):
        return jnp.sum(pallas_attention.flash_relative_attention(q_, k_, v_, e_, causal, jpk) * g)

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (q, k, v, e)))
    tpk = torch.from_numpy(pk) if pad_tail else None
    _, got = _grads(lambda a, b_, c, d: flash_rel_attention(a, b_, c, d, causal, tpk)[0],
                    q, k, v, e, g)
    # dE carries the 1/sqrt(dh) scale the two packages place differently
    for name, a, b_ in zip(("dq", "dk", "dv", "de"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), rtol=1e-4, atol=1e-4, err_msg=name)


def test_flash_backward_fully_masked_row_has_zero_gradient():
    """Key 0 is pad, so causal query 0 sees no key: its output is 0 and no
    gradient flows through it, whatever its cotangent."""
    rng = np.random.default_rng(9)
    B, H, T, dh = 1, 2, 24, 16
    q, k, v = (torch.from_numpy(_rand(rng, B, H, T, dh)).requires_grad_() for _ in range(3))
    e = torch.from_numpy(_rand(rng, 64, dh)).requires_grad_()
    pad = torch.zeros((B, T), dtype=torch.bool)
    pad[:, 0] = True
    o, lse = flash_rel_attention(q, k, v, e, True, pad)
    assert o[:, :, 0].eq(0).all() and lse[:, :, 0].eq(1e30).all()
    g = torch.zeros_like(o)
    g[:, :, 0] = 1.0  # cotangent on the masked row only
    dq, dk, dv, de = torch.autograd.grad(o, (q, k, v, e), g)
    for t in (dq, dk, dv, de):
        assert t.eq(0).all()
