"""The torch port's ring attention (``parallel/ring_attention.py``) against
the JAX package's: its per-chunk bias and its steps driven in one process,
then the ring itself on a 4-process gloo group, over 2 and 4 sequence
ranks, and training on meshes that mix the axes.

Tolerances: outputs and gradients (q, k, v, e) 2e-5, the figure of
``test_ring_attention.py`` for the forward; the one-process ring against
the closed form 1e-5 (both f32, other summation orders); train steps as in
``test_torch_parallel.py`` (1e-6 of each scale).
"""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401 -- pins JAX to the CPU

import jax
import jax.numpy as jnp

import torch_dist as td
from midi_emotion_tpu.ops.attention import relative_attention as jax_relative_attention
from midi_emotion_tpu.parallel import mesh as jmesh
from midi_emotion_tpu.parallel import ring_attention as jring
from midi_emotion_tpu_torch.ops.attention import relative_attention
from midi_emotion_tpu_torch.parallel.ring_attention import (chunk_rel_bias, extend_e,
                                                            ring_attention_one_process)
from torch_parity import assert_close

# (B, H, dh, causal, first pad key of each row): pad keys that start inside
# a chunk and run across the boundaries after it
CASES = [(2, 2, 16, True, (None, None)), (2, 2, 16, True, (None, 24)),
         (2, 2, 16, False, (24, 45))]
LRS = [1e-3, 2e-3]
DROP = {**td.TINY, "dropout": 0.1}
BATCHES = td.make_batches(2, 1, 4, 1008, seed=7, pad_rows=(1,))


@pytest.mark.parametrize("delta", [0, 16, 48, -16])
def test_chunk_rel_bias_matches_jax(delta):
    """One (query chunk, key chunk) pair's band bias, at the distances the
    ring meets (delta < 0: a key chunk after the query chunk)."""
    q, _, _, e, _, _ = td.ring_inputs(2, 2, 16, True, (None, None))
    C, T = 16, td.T
    q = q[:, :, :C]
    got = chunk_rel_bias(q, extend_e(e, T), delta, C, e.shape[0])
    e_ext = jnp.pad(jnp.asarray(e.numpy()), ((T, T), (0, 0)))
    want = jring._chunk_rel_bias(jnp.asarray(q.numpy()), e_ext, delta, C, e.shape[0])
    assert_close(got.numpy(), np.asarray(want), 1e-6)


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("case", CASES)
def test_ring_steps_in_one_process_match_the_closed_form(case, n):
    """The ring's n steps driven in one process (what chip_smoke.py runs on
    the card): the closed form's output and autograd gradients."""
    q, k, v, e, pad, w = td.ring_inputs(*case)
    causal = case[3]
    outs = []
    for fn in (lambda *a: ring_attention_one_process(*a, n, causal, pad),
               lambda *a: relative_attention(*a, causal=causal, pad_keys=pad, impl="plain")):
        leaves = [t.clone().requires_grad_() for t in (q, k, v, e)]
        o = fn(*leaves)
        (o * w).sum().backward()
        outs.append([o.detach()] + [t.grad for t in leaves])
    for got, want in zip(*outs):
        assert_close(got.numpy(), want.numpy(), 1e-5)


def _jax_ring(case, n):
    """JAX's make_ring_attention on an n-device mesh and its closed form:
    (out, dq, dk, dv, de) of each for sum(out * w)."""
    q, k, v, e, pad, w = (None if t is None else jnp.asarray(t.numpy())
                          for t in td.ring_inputs(*case))
    causal = case[3]
    mesh = jmesh.make_mesh(n_data=n, n_model=1, devices=jax.devices()[:n])
    ring = jring.make_ring_attention(mesh, axis="data", causal=causal)
    out = []
    for fn in (lambda *a: ring(*a, pad_keys=pad),
               lambda *a: jax_relative_attention(*a, causal=causal, pad_keys=pad)):
        def both(q, k, v, e, w, fn=fn):
            o, vjp = jax.vjp(fn, q, k, v, e)
            return (o, *vjp(w))
        out.append(jax.jit(both)(q, k, v, e, w))
    return out


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """{job name: [each rank's result]} from one 4-process group."""
    jobs = {
        # n = 4: the ring over the whole group
        "ring4": ("ring_attention_cases", dict(cases=CASES, mesh_shape=(1, 1, 4))),
        # n = 2 on each of 2 data rows (ring_global_attention)
        "ring2x2": ("ring_attention_cases", dict(cases=CASES, mesh_shape=(2, 1, 2))),
        "dp_ring": ("train_steps", dict(cfg_kw=DROP, batches=BATCHES, lrs=LRS,
                                        mesh_shape=(2, 1, 2), attn_impl="ring")),
        "dp_tp": ("train_steps", dict(cfg_kw=DROP, batches=BATCHES, lrs=LRS,
                                      mesh_shape=(2, 2, 1))),
        "tp_ring": ("train_steps", dict(cfg_kw=td.TINY, batches=BATCHES, lrs=LRS,
                                        mesh_shape=(1, 2, 2), attn_impl="ring")),
    }
    results = td.run_group(4, list(jobs.values()), tmp_path_factory.mktemp("group"))
    return {name: [r[i] for r in results] for i, name in enumerate(jobs)}


@pytest.mark.parametrize("job,n", [("ring4", 4), ("ring2x2", 2)])
def test_ring_attention_matches_jax(group, job, n):
    """Every rank's gathered output and summed gradients against JAX's ring
    on n devices and JAX's closed form."""
    for i, case in enumerate(CASES):
        for want in _jax_ring(case, n):
            for res in group[job]:
                for got, w in zip(res[i], want):
                    assert_close(got.numpy(), np.asarray(w), 2e-5)


@pytest.mark.parametrize("job,cfg", [("dp_ring", DROP), ("dp_tp", DROP), ("tp_ring", td.TINY)])
def test_mixed_meshes_match_one_process(group, job, cfg):
    """data 2 x seq 2 (ring) and data 2 x model 2 at dropout 0.1, and model 2
    x seq 2: the losses, grad norms and gradients of one process on the
    global batch with the plain attention."""
    ref = td.train_steps(cfg, BATCHES, LRS)
    for res in group[job]:
        assert_close(np.array(res["metrics"]), np.array(ref["metrics"]), 1e-6)
        for name, w in ref["grads"].items():
            assert_close(res["grads"][name], w, 1e-6 * (1 + float(w.abs().max())))
