"""Torch port, the alternative flash backward decompositions
(``MIDI_EMOTION_BWD=split|fused``, ``MIDI_EMOTION_DQDE=column|dist``):
the port's twins on the CPU against the JAX package's Pallas backward in
the generic interpreter (``pallas_call(interpret=True)``; the threaded TPU
interpreter, ``pltpu.force_tpu_interpret_mode``, has hung multi-worker
runs), with ``pallas_attention.BWD_IMPL``/``DQDE_IMPL`` set as
``tests/test_pallas_attention.py`` sets them.

Each interpret-mode backward takes 13-21 s here, so the JAX forward runs
once per input case and each decomposition's backward once, recorded: the
end gradients and, through recorders around the five ``_bwd_*_call``
launchers, each Pallas kernel's own outputs. Those are cut to T and
carried to the port's scale convention (the JAX kernels see q pre-scaled
by c = 1/sqrt(dh), so their dQ terms are multiplied by c, as
``pallas_attention.py:1780`` does; dE rows are cut as ``:1784`` cuts
them)."""

import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import conftest  # noqa: F401 -- pins JAX to the CPU

import jax
import jax.numpy as jnp

from midi_emotion_tpu.ops import pallas_attention
from midi_emotion_tpu_torch.models.config import ModelConfig
from midi_emotion_tpu_torch.models.model import MusicTransformer
from midi_emotion_tpu_torch.ops import flash_attention as fa
from midi_emotion_tpu_torch.training.train_step import make_optimizer, make_train_step

from torch_parity import generic_interpret

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = {  # T, dh, causal, pad tail (no pad at key 0: ROADMAP queue 3)
    "causal-pad": (40, 48, True, True),
    "noncausal-dh16": (32, 16, False, False),
}
# d_head outside KERNEL_DHS, which the wrappers pad on the card: held for
# the fused decomposition's dQ/dE kernels alone
PADDED_CASES = {
    "causal-pad-dh40": (24, 40, True, True),
    "noncausal-dh80": (24, 80, False, False),
}
ALL_CASES = {**CASES, **PADDED_CASES}
IMPLS = {"split": ("split", "column"), "fused-column": ("fused", "column"),
         "fused-dist": ("fused", "dist")}
# twin -> (the Pallas launcher it is held to, the decomposition that runs
# it, the names of its outputs: "dq*" terms carry the JAX dQ scale, "de"
# is a padded E table)
KERNELS = {
    "bwd_dkdv_dq_plain": ("_bwd_dkdv_dq_call", "split", ("dk", "dv", "dq_qk")),
    "bwd_de_dqrel_plain": ("_bwd_de_dqrel_call", "split", ("dq_rel", "de")),
    "bwd_dq_de_plain": ("_bwd_dq_de_call", "fused-column", ("dq", "de")),
    "bwd_dq_de_dist_plain": ("_bwd_dq_de_dist_call", "fused-dist", ("dq", "de")),
    "bwd_dkdv_plain": ("_bwd_dkdv_call", "fused-column", ("dk", "dv")),
}
B, H, MAX_SEQ = 2, 2, 128


def _inputs(case):
    T, dh, _, pad_tail = ALL_CASES[case]
    rng = np.random.default_rng(T + dh)
    q, k, v, g = (rng.standard_normal((B, H, T, dh)).astype(np.float32) for _ in range(4))
    e = rng.standard_normal((MAX_SEQ, dh)).astype(np.float32)
    pk = np.zeros((B, T), bool)
    if pad_tail:
        pk[:, -T // 4:] = True
    return q, k, v, e, g, pk


_VJPS, _RUNS = {}, {}


def _jax_run(case, impl):
    """(dq, dk, dv, de) of jax.grad through flash_relative_attention with
    the decomposition ``impl``, and {launcher: its outputs as numpy}; the
    forward once per case, each backward once."""
    if (case, impl) in _RUNS:
        return _RUNS[case, impl]
    _, _, causal, pad_tail = ALL_CASES[case]
    q, k, v, e, g, pk = _inputs(case)
    if case not in _VJPS:
        jpk = jnp.asarray(pk) if pad_tail else None
        with generic_interpret():
            _, _VJPS[case] = jax.vjp(
                lambda *a: pallas_attention.flash_relative_attention(*a, causal, jpk),
                *(jnp.asarray(x) for x in (q, k, v, e)))
    recorded = {}

    def recorder(name, original):
        def call(*args, **kwargs):
            out = original(*args, **kwargs)
            recorded[name] = [np.asarray(x) for x in out]
            return out
        return call

    bwd, dqde = IMPLS[impl]
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(pallas_attention, "BWD_IMPL", bwd)
        mp.setattr(pallas_attention, "DQDE_IMPL", dqde)
        for name, _, _ in KERNELS.values():
            mp.setattr(pallas_attention, name, recorder(name, getattr(pallas_attention, name)))
        with generic_interpret():
            grads = [np.asarray(x) for x in _VJPS[case](jnp.asarray(g))]
    finally:
        mp.undo()
    _RUNS[case, impl] = grads, recorded
    return _RUNS[case, impl]


def _torch(case):
    q, k, v, e, g, pk = _inputs(case)
    pad = torch.from_numpy(pk) if ALL_CASES[case][3] else None
    return [torch.from_numpy(x) for x in (q, k, v, e, g)] + [pad]


@pytest.mark.parametrize("impl", list(IMPLS))
@pytest.mark.parametrize("case", list(CASES))
def test_decomposition_matches_pallas_backward(monkeypatch, case, impl):
    """Autograd through the port's flash_rel_attention (its twins on the
    CPU) with the knobs set, against jax.grad of the Pallas backward with
    the same decomposition: dQ, dK, dV and dE to 1e-4."""
    want, _ = _jax_run(case, impl)
    bwd, dqde = IMPLS[impl]
    monkeypatch.setenv("MIDI_EMOTION_BWD", bwd)
    monkeypatch.setenv("MIDI_EMOTION_DQDE", dqde)
    q, k, v, e, g, pad = _torch(case)
    xs = [t.requires_grad_() for t in (q, k, v, e)]
    o, _ = fa.flash_rel_attention(*xs, CASES[case][2], pad)
    got = torch.autograd.grad(o, xs, g)
    for name, a, b in zip(("dq", "dk", "dv", "de"), got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-4, err_msg=name)


def _twin_vs_pallas(case, twin):
    launcher, impl, names = KERNELS[twin]
    _, recorded = _jax_run(case, impl)
    q, k, v, e, g, pad = _torch(case)
    T, dh, causal, _ = ALL_CASES[case]
    o, lse = fa.flash_rel_attention_plain(q, k, v, e, causal, pad)
    dsum = (g * o).sum(-1)
    got = getattr(fa, twin)(q, k, v, e, causal, pad, lse, dsum, g)
    outs = recorded[launcher]
    assert len(outs) == len(got) == len(names)
    for name, a, b in zip(names, got, outs):
        if name == "de":
            pad_t = recorded[launcher][0].shape[2] - T  # front rows the JAX table gained
            b = b[pad_t:pad_t + MAX_SEQ]
        else:
            b = b[:, :, :T]
            if name.startswith("dq"):
                b = b / math.sqrt(dh)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("twin", list(KERNELS))
@pytest.mark.parametrize("case", list(CASES))
def test_twin_matches_its_pallas_kernel(case, twin):
    """Each twin's own outputs (the two dQ halves of ``split`` included)
    against its Pallas kernel's, recorded inside the JAX backward and
    carried to the port's convention: 1e-4."""
    _twin_vs_pallas(case, twin)


@pytest.mark.parametrize("twin", ["bwd_dq_de_plain", "bwd_dq_de_dist_plain"])
@pytest.mark.parametrize("case", list(PADDED_CASES))
def test_dq_de_twins_match_pallas_kernels_padded_heads(case, twin):
    """Kernels 5 and 6's twins at a d_head the kernels are not built for
    (40, 80), against their Pallas kernels as above: 1e-4."""
    _twin_vs_pallas(case, twin)


@pytest.mark.parametrize("twin", list(KERNELS))
@pytest.mark.parametrize("dh", [40, 80])
def test_padded_heads_match_unpadded_decomposition_twins(dh, twin):
    """The card's route for such a d_head through each decomposition's
    twin: q, k, v, e and dO padded with zero columns (``pad_heads``), c =
    1/sqrt(true d_head) as the scale, the outputs cut back; against the
    twin at the true d_head to 1e-6, with a fully masked row and a pad
    tail."""
    gen = torch.Generator().manual_seed(dh)
    Bs, Hs, T, max_seq = 2, 2, 45, 64
    q, k, v, do = (torch.randn((Bs, Hs, T, dh), generator=gen) for _ in range(4))
    e = torch.randn((max_seq, dh), generator=gen)
    pad = torch.zeros((Bs, T), dtype=torch.bool)
    pad[1, 0] = True
    pad[1, -T // 3:] = True
    o, lse = fa.flash_rel_attention_plain(q, k, v, e, True, pad)
    dsum = (do * o).sum(-1)
    want = getattr(fa, twin)(q, k, v, e, True, pad, lse, dsum, do)
    dh_k = fa.padded_dh(dh)
    got = getattr(fa, twin)(*fa.pad_heads(dh_k, q, k, v, e), True, pad, lse, dsum,
                            *fa.pad_heads(dh_k, do), scale=1.0 / math.sqrt(dh))
    for name, a, b in zip(KERNELS[twin][2], got, want):
        assert a.shape[-1] == dh_k, name
        torch.testing.assert_close(a[..., :dh], b, rtol=1e-6, atol=1e-6, msg=name)


@pytest.mark.parametrize("impl", list(IMPLS))
@pytest.mark.parametrize("shape", [(2, 3, 70, 32, True, 96), (2, 2, 33, 64, False, 33),
                                   (1, 2, 1, 16, True, 8)], ids=["causal", "noncausal", "T1"])
def test_twin_compositions_match_merged_twin(monkeypatch, shape, impl):
    """f32: every decomposition's twins compose to the merged twin's
    gradients to 1e-5, with a fully masked row and a pad tail."""
    Bs, Hs, T, dh, causal, max_seq = shape
    gen = torch.Generator().manual_seed(T)
    q, k, v, do = (torch.randn((Bs, Hs, T, dh), generator=gen) for _ in range(4))
    e = torch.randn((max_seq, dh), generator=gen)
    pad = torch.zeros((Bs, T), dtype=torch.bool)
    if T > 3:
        pad[-1, 0] = True
        pad[-1, -T // 3:] = True
    o, lse = fa.flash_rel_attention_plain(q, k, v, e, causal, pad)
    want = fa.flash_rel_attention_bwd_plain(q, k, v, e, causal, pad, o, lse, do)
    bwd, dqde = IMPLS[impl]
    monkeypatch.setenv("MIDI_EMOTION_BWD", bwd)
    monkeypatch.setenv("MIDI_EMOTION_DQDE", dqde)
    got = fa.flash_rel_attention_bwd(q, k, v, e, causal, pad, o, lse, do)
    for name, a, b in zip(("dq", "dk", "dv", "de"), got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=name)
    if causal and T > 3:
        assert got[0][-1, :, 0].eq(0).all()


@pytest.mark.parametrize("name,value", [("MIDI_EMOTION_BWD", "mergd"),
                                        ("MIDI_EMOTION_DQDE", "distance")])
def test_invalid_knob_raises_naming_it(monkeypatch, name, value):
    """A bad value raises a ValueError naming the variable: at import (a
    fresh interpreter) and at a backward call."""
    env = {**os.environ, name: value, "PYTHONPATH": REPO}
    run = subprocess.run([sys.executable, "-c", "import midi_emotion_tpu_torch.ops.flash_attention"],
                         env=env, capture_output=True, text=True, timeout=120)
    assert run.returncode != 0 and "ValueError" in run.stderr and name in run.stderr, run.stderr
    monkeypatch.setenv(name, value)
    q = torch.randn((1, 1, 4, 16), requires_grad=True)
    o, _ = fa.flash_rel_attention(q, q.detach(), q.detach(), torch.randn((8, 16)))
    with pytest.raises(ValueError, match=name):
        o.sum().backward()


@pytest.mark.parametrize("impl", list(IMPLS))
def test_train_step_gradients_match_merged(monkeypatch, impl):
    """A 2-layer model's f32 train step through flash_rel_attention (its
    twins) under each decomposition gives the merged one's loss, grad norm
    and every clipped gradient (1e-5)."""
    cfg = ModelConfig(mode="continuous_concat", vocab_size=1007, n_layer=2, n_head=4,
                      d_model=64, d_inner=128, d_condition=16, max_seq=96, dropout=0.0)
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(2, 1007, (1, 2, 49), generator=gen)
    tokens[0, 1, -7:] = 0
    batch = {"input": tokens[:, :, :-1], "target": tokens[:, :, 1:],
             "condition": torch.tensor([[[0.5, -0.5], [0.1, 0.9]]])}
    out = {}
    for run in ("merged", impl):
        bwd, dqde = ("merged", "column") if run == "merged" else IMPLS[impl]
        monkeypatch.setenv("MIDI_EMOTION_BWD", bwd)
        monkeypatch.setenv("MIDI_EMOTION_DQDE", dqde)
        model = MusicTransformer(cfg, device="cpu", attn_impl="kernel").init_weights(
            torch.Generator().manual_seed(0))
        m = make_train_step(model, make_optimizer(model), clip=1.0)(batch, 1e-3)
        out[run] = (m, {n: p.grad.clone() for n, p in model.named_parameters()})
    (mm, gm), (mi, gi) = out["merged"], out[impl]
    torch.testing.assert_close(mi["loss"], mm["loss"], rtol=0, atol=0)
    torch.testing.assert_close(mi["grad_norm"], mm["grad_norm"], rtol=1e-5, atol=1e-5)
    for n in gm:
        torch.testing.assert_close(gi[n], gm[n], rtol=1e-5, atol=1e-5, msg=n)
