"""Multi-process checks of the torch port's mesh on the CPU: a gloo process
group of local processes, each running the same list of jobs.

``run_group(world, jobs, tmp)`` starts ``world`` copies of this file, each
one rank (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` set
as torchrun sets them, and ``initialize_distributed("gloo", timeout=60)``),
runs the jobs in order, and returns each rank's results. A worker that
fails or outlives the deadline gets the whole group killed, and the call
raises with the workers' logs. The jobs are the functions below; they
import torch and the port only, so a worker starts in a few seconds, and
the tests call the same functions in their own process for the
one-process reference.
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from midi_emotion_tpu_torch.models.config import ModelConfig  # noqa: E402
from midi_emotion_tpu_torch.models.model import MusicTransformer  # noqa: E402
from midi_emotion_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from midi_emotion_tpu_torch.training.train_step import (make_optimizer,  # noqa: E402
                                                       make_train_step)

# the tests' tiny size: 2 layers, d_model 64, 4 heads, T 64
TINY = dict(vocab_size=1008, mode="none", n_layer=2, n_head=4, d_model=64, d_inner=128,
            d_condition=-1, max_seq=64, dropout=0.0, remat=False)
T = 64


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_group(world: int, jobs, tmp, timeout: float = 150.0):
    """Run ``jobs`` ([(function name, kwargs)]) on ``world`` gloo ranks;
    returns [rank 0's results, rank 1's, ...], one entry per job."""
    tmp = str(tmp)
    spec = os.path.join(tmp, "jobs.pt")
    torch.save(jobs, spec)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]),
               OMP_NUM_THREADS="1")
    procs, logs = [], []
    for r in range(world):
        log = open(os.path.join(tmp, f"rank{r}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(world), str(port), spec,
             os.path.join(tmp, f"out{r}.pt")], stdout=log, stderr=subprocess.STDOUT, env=env))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
        for log in logs:
            log.close()
    if any(p.returncode != 0 for p in procs):
        tails = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.log")) as f:
                tails.append(f"--- rank {r} (rc {procs[r].returncode}) ---\n{f.read()[-3000:]}")
        raise RuntimeError("the process group failed or timed out:\n" + "\n".join(tails))
    return [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def make_batches(n: int, A: int, B: int, vocab: int, seed: int = 0, pad_rows=(), mode="none"):
    """n updates of [A, B, ...] numpy microbatches; the rows in
    ``pad_rows`` are pad from a third of the way on, the others end in 3
    pads. continuous_token targets carry the model's 2-slot prefix."""
    rng = np.random.RandomState(seed)
    T_in = T - 2 if mode == "continuous_token" else T
    out = []
    for _ in range(n):
        ids = rng.randint(2, vocab, size=(A, B, T_in + 1)).astype(np.int32)
        ids[:, :, -3:] = 0
        for r in pad_rows:
            ids[:, r, T_in // 3:] = 0
        tgt = ids[..., 1:]
        if mode == "continuous_token":
            tgt = np.concatenate([np.zeros((A, B, 2), np.int32), tgt], axis=-1)
        out.append({"input": ids[..., :-1], "target": tgt,
                    "condition": rng.uniform(-1, 1, size=(A, B, 2)).astype(np.float32)})
    return out


def to_torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).long() if v.dtype != np.float32
            else torch.from_numpy(v) for k, v in batch.items()}


def tiny_model(cfg_kw, attn_impl="plain", seed=0) -> MusicTransformer:
    cfg = ModelConfig(**cfg_kw).validate()
    return MusicTransformer(cfg, device="cpu", attn_impl=attn_impl).init_weights(
        torch.Generator().manual_seed(seed))


def whole_state(model: MusicTransformer):
    """The model's parameters as one process holds them (gathered over the
    model axis on a mesh)."""
    return _whole(model, lambda p: p.detach())


def whole_grads(model: MusicTransformer):
    """The parameters' gradients (after the step's clip), gathered so."""
    return _whole(model, lambda p: p.grad)


def _whole(model, part):
    if model.mesh is None:
        return {n: part(p).clone() for n, p in model.named_parameters()}
    return {n: mesh_lib.gather_whole(part(p), model.shard_dims[n], model.mesh).clone()
            for n, p in model.named_parameters()}


# ---------------------------------------------------------------------------
# jobs
# ---------------------------------------------------------------------------


def train_steps(cfg_kw, batches, lrs, accumulate=1, mesh_shape=None, attn_impl="plain",
                drop_seed=5):
    """Train steps of the tiny model from one init, on a mesh of
    ``mesh_shape`` (n_data, n_model, n_seq) or in one process. Returns
    {"metrics": [(loss, grad norm)], "grads": the first step's whole
    (clipped) gradients, "state": the whole parameters at the end}."""
    model = tiny_model(cfg_kw, attn_impl)
    mesh = None
    if mesh_shape is not None:
        mesh = mesh_lib.make_mesh(*mesh_shape)
        model.parallelize(mesh)
    step = make_train_step(model, make_optimizer(model), 1.0, accumulate_steps=accumulate)
    gen = torch.Generator().manual_seed(drop_seed)
    metrics, grads = [], None
    for batch, lr in zip(batches, lrs):
        b = to_torch(batch)
        if mesh is not None:
            b = mesh_lib.shard_batch(b, mesh, leading_accum=True)
        m = step(b, lr, gen)
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
        grads = grads or whole_grads(model)
    return {"metrics": metrics, "grads": grads, "state": whole_state(model)}


def ring_attention_cases(cases, mesh_shape, seed=0):
    """Ring attention on global arrays over a (data, model, seq) mesh
    (``ring_global_attention``, or ``make_ring_attention`` over seq when
    data is 1) for each (B, H, dh, causal, pad_from) case: the output and
    the gradients of sum(out * w) in q, k, v and e, summed over the ranks.
    ``pad_from[b]`` is the first pad key of row b (None: no pad)."""
    from midi_emotion_tpu_torch.parallel.ring_attention import (make_ring_attention,
                                                                ring_global_attention)
    import torch.distributed as dist

    mesh = mesh_lib.make_mesh(*mesh_shape)
    out = []
    for case in cases:
        q, k, v, e, pad, w = ring_inputs(*case, seed=seed)
        leaves = [t.requires_grad_() for t in (q, k, v, e)]
        causal = case[3]
        if mesh.shape["data"] == 1:
            o = make_ring_attention(mesh, "seq", causal)(*leaves, pad_keys=pad)
        else:
            o = ring_global_attention(*leaves, mesh, causal=causal, pad_keys=pad)
        (o * w).sum().backward()
        grads = [t.grad for t in leaves]
        for g in grads:
            dist.all_reduce(g)
        out.append((o.detach(), *grads))
    return out


def ring_inputs(B, H, dh, causal, pad_from, seed=0, max_seq=T):
    """q, k, v [B, H, T, dh], e [max_seq, dh], the key pad mask [B, T] and the
    output weights, from a numpy seed."""
    rng = np.random.RandomState(seed)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    q, k, v, w = t(B, H, T, dh), t(B, H, T, dh), t(B, H, T, dh), t(B, H, T, dh)
    e = t(max_seq, dh)
    pad = None
    if any(p is not None for p in pad_from):
        pad = torch.zeros((B, T), dtype=torch.bool)
        for b, p in enumerate(pad_from):
            if p is not None:
                pad[b, p:] = True
    return q, k, v, e, pad, w


def runner_run(argv, restart_from=None):
    """train_cli.main(argv) on this rank, restarted from the one run dir
    under ``restart_from`` when given -> {"work_dir": the run's work dir,
    "state": the whole parameters after the run, "grads": each gradient
    element's least magnitude over the steps, "csv": the training and validation losses in rank 0's
    performance.csv (None on the others)}."""
    from midi_emotion_tpu_torch.cli import train_cli
    from midi_emotion_tpu_torch.training.train import Runner

    if restart_from is not None:
        run, = os.listdir(restart_from)
        argv = argv + ["--restart_dir", os.path.join(restart_from, run)]
    args = train_cli.parse_args(argv)  # train_cli.main, with the step watched
    if args.seed > 0:
        np.random.seed(args.seed)
    runner = Runner(args)
    step, least = runner._train_fn, {}

    def watched(*a, **kw):
        metrics = step(*a, **kw)
        for name, g in whole_grads(runner.model).items():
            least[name] = torch.minimum(least[name], g.abs()) if name in least else g.abs()
        return metrics

    runner._train_fn = watched
    runner.run()
    return {"work_dir": runner.args.work_dir, "state": whole_state(runner.model),
            "grads": least,
            "csv": read_losses(runner.args.work_dir) if runner.main else None}


def read_losses(work_dir):
    """(training losses, validation losses) logged in a performance.csv."""
    import csv

    with open(os.path.join(work_dir, "performance.csv")) as f:
        rows = list(csv.DictReader(f))
    pick = lambda key: [float(r[key]) for r in rows if r[key] not in ("", "nan")]
    return pick("trn_loss"), pick("val_loss")


def _worker(rank: int, world: int, port: str, spec: str, out: str) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
    torch.set_num_threads(1)
    import torch.distributed as dist

    mesh_lib.initialize_distributed("gloo", timeout=60)
    try:
        jobs = torch.load(spec, weights_only=False)
        results = [globals()[name](**kw) for name, kw in jobs]
        torch.save(results, out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
