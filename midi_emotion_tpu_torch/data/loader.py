"""Data loaders, in numpy.

A copy of ``midi_emotion_tpu/data/loader.py`` that imports the port's own
``vocab`` and ``data/codec``; only the comments about the JAX backend
changed. Shards stay byte-compatible between the two packages.

Host-side samplers reproducing the reference's stochastic training policy
(the reference's ``src/data/loader.py``), the exhaustive-eval pre-chunking
(``loader_exhaustive.py``), and the generations regression loader
(``loader_generations.py``) -- but emitting **fixed-shape** numpy batches:
where the reference's filter_collate drops failed samples and yields
variable batch sizes (collate.py:37-43), we resample a replacement index so
device batches stay full and static (fixed shapes; the per-sample
distribution is unchanged, only the batch composition differs).

Song shards: our native format is one ``.npz`` per song holding the
(event, value) int16 rows of all bars plus bar lengths; the reference's
per-song ``.pt`` files ({"file", "bars": [int16 tensors]},
preprocess_pianorolls.py:64-68) load transparently when torch is available.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..vocab import CLS, START, Vocab
from . import codec


# ---------------------------------------------------------------------------
# song shards
# ---------------------------------------------------------------------------


def save_song_shard(path: str, file_id: str, bars: Sequence[np.ndarray]) -> None:
    bar_lens = np.array([len(b) for b in bars], np.int32)
    tokens = (
        np.concatenate(bars, axis=0) if bars else np.zeros((0, 2), np.int16)
    )
    np.savez_compressed(path, tokens=tokens.astype(np.int16), bar_lens=bar_lens)


def load_song_shard(path: str) -> List[np.ndarray]:
    if path.endswith(".pt"):
        import torch

        item = torch.load(path, map_location="cpu", weights_only=False)
        return [b.numpy() for b in item["bars"]]
    with np.load(path) as z:
        tokens, bar_lens = z["tokens"], z["bar_lens"]
    out = []
    off = 0
    for n in bar_lens:
        out.append(tokens[off : off + int(n)])
        off += int(n)
    return out


def _find_shard(folder: str, file_id: str) -> Optional[str]:
    for ext in (".npz", ".pt"):
        p = os.path.join(folder, file_id + ext)
        if os.path.exists(p):
            return p
    return None


# ---------------------------------------------------------------------------
# vocabulary extension shared by the loaders (loader.py:54-75)
# ---------------------------------------------------------------------------


def extend_vocab(
    vocab: Vocab,
    data: List[dict],
    conditioning: str,
    regression: bool,
    use_cls_token: bool = True,
) -> Vocab:
    extra: List[str] = []
    if conditioning == "discrete_token":
        seen = []
        for sample in data:
            for label in ("valence", "arousal"):
                tok = sample[label]
                if tok is not None and tok not in seen:
                    seen.append(tok)
        extra = sorted(seen)
    if regression and use_cls_token:
        extra = extra + [CLS]
    return vocab.with_extra_tokens(tuple(extra)) if extra else vocab


# ---------------------------------------------------------------------------
# training loader
# ---------------------------------------------------------------------------


class Loader:
    """Map-style stochastic training sampler (loader.py:15-195)."""

    def __init__(
        self,
        data_folder: str,
        data: List[dict],
        input_len: int,
        conditioning: str,
        vocab: Optional[Vocab] = None,
        pad: bool = True,
        use_start_token: bool = True,
        max_transpose: int = 3,
        n_try: int = 5,
        bar_start_prob: float = 0.5,
        overfit: bool = False,
        regression: bool = False,
        max_samples: Optional[int] = None,
        min_n_instruments: int = 3,
        use_cls_token: bool = True,
        always_use_discrete_condition: bool = False,
        seed: int = 0,
    ):
        self.data_folder = data_folder
        self.input_len = input_len
        self.conditioning = conditioning
        self.n_try = n_try
        self.min_n_instruments = min_n_instruments
        self.bar_start_prob = bar_start_prob
        self.overfit = overfit
        self.one_sample = None
        self.regression = regression
        self.pad = pad
        self.use_start_token = use_start_token
        self.always_use_discrete_condition = always_use_discrete_condition
        self.transpose_options = list(range(-max_transpose, max_transpose + 1))
        self.rng = np.random.RandomState(seed)

        if conditioning == "continuous_token":
            self.input_len -= 2  # loader.py:56-57

        # keep only songs whose shard exists (loader.py:48-49)
        self.data = [d for d in data if _find_shard(data_folder, d["file"])]
        self.vocab = extend_vocab(
            vocab or Vocab(), self.data, conditioning, regression, use_cls_token
        )
        if max_samples is not None and max_samples > 0 and not overfit:
            self.data = self.data[:max_samples]

        # loader.py:80-81
        self.n_bars = max(round(input_len / 256 * 4), 1)

    # -- reference-parity accessors --------------------------------------
    def get_vocab_len(self) -> int:
        return len(self.vocab)

    def get_maps(self) -> dict:
        return self.vocab.get_maps()

    def get_pad_idx(self) -> int:
        return self.vocab.pad_id

    def __len__(self) -> int:
        return len(self.data)

    # ---------------------------------------------------------------------
    def sample(self, idx: int):
        """One draw of the stochastic policy; None if no window with enough
        instruments was found within n_try attempts (loader.py:96-195)."""
        if self.overfit and self.one_sample is not None:
            return self.one_sample
        vocab = self.vocab
        rng = self.rng

        all_bars = load_song_shard(_find_shard(self.data_folder, self.data[idx]["file"]))

        bars = None
        n_instruments = 0
        for _ in range(self.n_try):
            max_start = max(0, len(all_bars) - self.n_bars - 1)
            start = rng.randint(0, max_start + 1)
            window = all_bars[start : min(len(all_bars), start + self.n_bars)]
            if window:
                cand = np.concatenate(window, axis=0)
                n_instruments = len(
                    np.unique(cand[cand[:, 0] < vocab.timeshift_event, 0] // 2)
                )
            else:
                cand, n_instruments = None, 0
            if n_instruments >= self.min_n_instruments:
                bars = cand
                break
        if bars is None:
            return None

        # transpose (loader.py:125-128)
        if self.transpose_options:
            n = self.transpose_options[rng.randint(len(self.transpose_options))]
            values = vocab.transpose_tuples(bars[:, 0], bars[:, 1], n)
            bars = np.stack([bars[:, 0], values], axis=1)

        ids = vocab.encode_tuples(bars[:, 0], bars[:, 1]).astype(np.int64)

        # bar-start coin flip (loader.py:134-148)
        r = rng.uniform()
        start_at_beginning = not (r > self.bar_start_prob and len(ids) > self.input_len)
        if start_at_beginning:
            if self.use_start_token:
                ids = np.concatenate([[vocab.start_id], ids])
        else:
            s = rng.randint(0, len(ids) - self.input_len)
            ids = ids[s : s + self.input_len + 1]

        if self.regression:
            ids = np.concatenate([[vocab.extra_id(CLS)], ids])

        condition = np.array([np.nan, np.nan], np.float32)
        if self.conditioning == "discrete_token" and (
            start_at_beginning or self.always_use_discrete_condition
        ):
            v = vocab.extra_id(self.data[idx]["valence"])
            a = vocab.extra_id(self.data[idx]["arousal"])
            ids = np.concatenate([[v, a], ids])
        elif self.conditioning in ("continuous_token", "continuous_concat") or self.regression:
            condition = np.array(
                [self.data[idx]["valence"], self.data[idx]["arousal"]], np.float32
            )

        ids = ids[: self.input_len + 1]
        if self.pad:
            n_pad = self.input_len + 1 - len(ids)
            if n_pad > 0:
                ids = np.concatenate([ids, np.full(n_pad, vocab.pad_id)])

        ids = ids.astype(np.int32)
        input_ = ids[:-1]
        if self.regression:
            target = None
        else:
            target = ids[1:]
            if self.conditioning == "continuous_token":
                # left-pad target to realign with the model's condition
                # prefix (loader.py:184-187)
                target = np.concatenate(
                    [np.full(2, vocab.pad_id, np.int32), target]
                )
        out = (input_, condition, target)
        if self.overfit:
            self.one_sample = out
        return out

    # ---------------------------------------------------------------------
    def batches(self, batch_size: int, shuffle: bool = True):
        """One epoch of fixed-shape batches (finite, like a torch
        DataLoader pass). Failed samples are replaced by a redraw of a
        random index (not dropped); datasets smaller than the batch are
        filled with replacement."""
        if len(self.data) == 0:
            return  # empty split (tiny corpora): an empty epoch, not a crash
        order = np.arange(len(self.data))
        if shuffle:
            self.rng.shuffle(order)
        if len(order) < batch_size:
            pad = self.rng.randint(len(self.data), size=batch_size - len(order))
            order = np.concatenate([order, pad])
        for i in range(0, len(order) - batch_size + 1, batch_size):
            yield self.collect([int(j) for j in order[i : i + batch_size]])

    def epochs(self, batch_size: int, shuffle: bool = True):
        """Endless epoch-concatenated batch stream (the training loop's
        `while True` over the DataLoader, train.py:302-303)."""
        if len(self.data) == 0:
            raise ValueError(
                "training split is empty -- the feature file / filters left "
                "no usable songs (check --feature_file and --full_dataset)"
            )
        while True:
            yield from self.batches(batch_size, shuffle)

    def collect(self, indices: List[int], max_redraw: int = 64):
        inputs, conds, targets = [], [], []
        need = len(indices)
        tries = 0
        queue = list(indices)
        while len(inputs) < need:
            if queue:
                idx = queue.pop()
            else:
                idx = int(self.rng.randint(len(self.data)))
                tries += 1
                if tries > max_redraw:
                    raise RuntimeError("could not fill a batch; data too sparse")
            s = self.sample(idx)
            if s is None:
                continue
            inputs.append(s[0])
            conds.append(s[1])
            targets.append(s[2])
        batch = {
            "input": np.stack(inputs),
            "condition": np.stack(conds),
        }
        if targets[0] is not None:
            batch["target"] = np.stack(targets)
        return batch


# ---------------------------------------------------------------------------
# exhaustive evaluation loader
# ---------------------------------------------------------------------------


class LoaderExhaustive:
    """Pre-chunks every test song into non-overlapping windows
    (loader_exhaustive.py:14-132)."""

    def __init__(
        self,
        data_folder: str,
        data: List[dict],
        input_len: int,
        conditioning: str,
        vocab: Optional[Vocab] = None,
        pad: bool = True,
        use_start_token: bool = True,
        always_use_discrete_condition: bool = False,
        regression: bool = False,
        max_samples: Optional[int] = None,
        use_cls_token: bool = True,
    ):
        self.input_len = input_len
        self.conditioning = conditioning
        self.regression = regression

        data = [d for d in data if _find_shard(data_folder, d["file"])]
        self.vocab = extend_vocab(
            vocab or Vocab(), data, conditioning, regression, use_cls_token
        )
        vocab = self.vocab

        if conditioning in ("continuous_token", "discrete_token"):
            self.input_len -= 2  # loader_exhaustive.py:45-50
        if regression and use_cls_token:
            self.input_len -= 1

        chunk_len = self.input_len if regression else self.input_len + 1

        if max_samples is not None and max_samples > 0:
            data = data[:max_samples]

        self.data: List[Tuple[np.ndarray, np.ndarray]] = []
        for rec in data:
            bars = load_song_shard(_find_shard(data_folder, rec["file"]))
            if not bars:
                continue
            song = np.concatenate(bars, axis=0)
            ids = vocab.encode_tuples(song[:, 0], song[:, 1]).astype(np.int32)
            if use_start_token:
                ids = np.concatenate([[vocab.start_id], ids]).astype(np.int32)

            condition = np.array([np.nan, np.nan], np.float32)
            if conditioning in ("continuous_token", "continuous_concat") or regression:
                condition = np.array(
                    [rec["valence"], rec["arousal"]], np.float32
                )
            cond_tokens = None
            if conditioning == "discrete_token":
                cond_tokens = np.array(
                    [vocab.extra_id(rec["valence"]), vocab.extra_id(rec["arousal"])],
                    np.int32,
                )
                if not always_use_discrete_condition:
                    ids = np.concatenate([cond_tokens, ids])

            n_chunks = len(ids) // chunk_len
            for c in range(n_chunks):
                chunk = ids[c * chunk_len : (c + 1) * chunk_len]
                if regression and use_cls_token:
                    chunk = np.concatenate([[vocab.extra_id(CLS)], chunk])
                if conditioning == "discrete_token" and always_use_discrete_condition:
                    chunk = np.concatenate([cond_tokens, chunk])
                self.data.append((chunk.astype(np.int32), condition))

    def get_vocab_len(self) -> int:
        return len(self.vocab)

    def get_maps(self) -> dict:
        return self.vocab.get_maps()

    def get_pad_idx(self) -> int:
        return self.vocab.pad_id

    def __len__(self) -> int:
        return len(self.data)

    def sample(self, idx: int):
        chunk, condition = self.data[idx]
        if self.regression:
            return chunk, condition, None
        input_, target = chunk[:-1], chunk[1:]
        if self.conditioning == "continuous_token":
            target = np.concatenate(
                [np.full(2, self.vocab.pad_id, np.int32), target]
            )
        return input_, condition, target

    def batches(self, batch_size: int, drop_last: bool = True):
        n = len(self.data)
        end = n - batch_size + 1 if drop_last else n
        for i in range(0, end, batch_size):
            samples = [self.sample(j) for j in range(i, min(i + batch_size, n))]
            batch = {
                "input": np.stack([s[0] for s in samples]),
                "condition": np.stack([s[1] for s in samples]),
            }
            if samples[0][2] is not None:
                batch["target"] = np.stack([s[2] for s in samples])
            yield batch


# ---------------------------------------------------------------------------
# generations loader (emotion regression over generated samples)
# ---------------------------------------------------------------------------

_DISCRETE2CONTINUOUS = {"-2": -0.8, "-1": -0.4, "0": 0.0, "1": 0.4, "2": 0.8}
_VA_RE = re.compile(r"_V(-?\d+)_A(-?\d+)")


def _condition_from_name(name: str) -> Optional[np.ndarray]:
    """Parse continuous conditions out of generate()'s V/A filename tags
    (generate.py:210-214: str(round(c, 2)).replace('.', ''))."""
    m = _VA_RE.search(name)
    if not m:
        return None

    def parse(s: str) -> float:
        neg = s.startswith("-")
        digits = s.lstrip("-")
        val = float(digits[0] + "." + digits[1:]) if len(digits) > 1 else float(digits)
        return -val if neg else val

    return np.array([parse(m.group(1)), parse(m.group(2))], np.float32)


class LoaderGenerations:
    """Windows over generated token dumps for emotion regression
    (loader_generations.py:12-98). Reads our ``inds_*.npy`` (condition from
    the V/A filename tags) and the reference's ``*.pt``
    ({"inds", "condition"}) interchangeably."""

    def __init__(
        self,
        gen_folder: str,
        seq_len: int,
        vocab: Optional[Vocab] = None,
        use_cls_token: bool = True,
        overlap: float = 0.5,
    ):
        base = vocab or Vocab()
        self.vocab = base.with_extra_tokens(tuple(list(base.extra_tokens) + [CLS])) \
            if (use_cls_token and CLS not in base.extra_tokens) else base
        self.seq_len = seq_len
        n_vocab = base.base_size

        inner = seq_len - 1 if use_cls_token else seq_len
        hop = int(inner * (1 - overlap))
        self.data: List[Tuple[np.ndarray, np.ndarray]] = []

        names = sorted(os.listdir(gen_folder)) if os.path.isdir(gen_folder) else []
        for name in names:
            path = os.path.join(gen_folder, name)
            condition = None
            if name.endswith(".npy") and name.startswith("inds_"):
                inds = np.load(path).astype(np.int64)
                condition = _condition_from_name(name)
            elif name.endswith(".pt"):
                import torch

                d = torch.load(path, map_location="cpu", weights_only=False)
                inds = d["inds"].numpy().astype(np.int64)
                condition = d.get("condition")
                if condition is not None and not isinstance(condition, np.ndarray):
                    if isinstance(condition[0], str):
                        condition = np.array(
                            [
                                _DISCRETE2CONTINUOUS[c[2:-1]]
                                for c in list(condition)[:2]
                            ],
                            np.float32,
                        )
                    else:
                        condition = np.asarray(condition, np.float32)
            else:
                continue
            if condition is None:
                continue
            inds = inds[inds < n_vocab]  # strip specials/out-of-vocab
            for s in range(0, len(inds) - inner + 1, max(1, hop)):
                w = inds[s : s + inner].astype(np.int32)
                if use_cls_token:
                    w = np.concatenate([[self.vocab.extra_id(CLS)], w]).astype(
                        np.int32
                    )
                self.data.append((w, np.asarray(condition, np.float32)))

    def get_vocab_len(self) -> int:
        return len(self.vocab)

    def get_maps(self) -> dict:
        return self.vocab.get_maps()

    def get_pad_idx(self) -> int:
        return self.vocab.pad_id

    def __len__(self) -> int:
        return len(self.data)

    def sample(self, idx: int):
        w, c = self.data[idx]
        return w, c, None

    def batches(self, batch_size: int, drop_last: bool = False):
        """drop_last defaults False like the torch DataLoader the reference
        evaluates generations with -- a partial final batch must survive or
        small generation sets (n < batch_size) evaluate to nothing."""
        n = len(self.data)
        end = n - batch_size + 1 if drop_last else n
        for i in range(0, end, batch_size):
            group = [self.sample(j) for j in range(i, min(i + batch_size, n))]
            yield {
                "input": np.stack([g[0] for g in group]),
                "condition": np.stack([g[1] for g in group]),
            }


# set once per worker process by the pool initializer (spawn context: the
# parent already initialized torch and CUDA and is multi-threaded, so
# fork() would risk deadlocks in the children -- spawn pays one pickle of
# the Loader per worker instead; it holds feature dicts and the vocab, not
# the song shards, so the payload is small)
_WORKER_LOADER: Optional["Loader"] = None


def _init_worker(loader: "Loader"):
    global _WORKER_LOADER
    _WORKER_LOADER = loader


def _collect_in_worker(seed: int, indices: List[int]):
    loader = _WORKER_LOADER
    # per-task RNG (torch DataLoader-style per-worker seeding): redraws and
    # augmentation jitter differ per batch but are reproducible from the
    # parent's master seed
    loader.rng = np.random.RandomState(seed)
    return loader.collect(indices)


def epochs_multiprocess(
    loader: "Loader",
    batch_size: int,
    num_workers: int,
    shuffle: bool = True,
    seed: int = 0,
    prefetch_factor: int = 2,
):
    """Endless batch stream materialized by ``num_workers`` spawned worker
    processes -- the reference's DataLoader(num_workers=8) (train.py:87-93).

    The parent draws the epoch order (the same policy as :meth:`Loader.
    batches`); workers run :meth:`Loader.collect` (shard IO + tokenization +
    augmentation, the CPU-bound part) and ship finished numpy batches back.
    Submission is bounded at ``num_workers * prefetch_factor`` outstanding
    batches; results are yielded in order, so the stream is deterministic
    given ``seed`` regardless of worker count or scheduling."""
    if len(loader.data) == 0:
        raise ValueError(
            "training split is empty -- the feature file / filters left "
            "no usable songs (check --feature_file and --full_dataset)"
        )
    import multiprocessing as mp
    from collections import deque

    # spawn, not fork: the trainer calls this after torch and CUDA are
    # initialized, and forking a multi-threaded process is a known
    # deadlock pattern (CPython warns outright). Workers get the Loader
    # via the pool initializer and never touch the card.
    ctx = mp.get_context("spawn")
    pool = ctx.Pool(num_workers, initializer=_init_worker, initargs=(loader,))
    master = np.random.RandomState(seed + 7919)

    def tasks():
        while True:
            order = np.arange(len(loader.data))
            if shuffle:
                master.shuffle(order)
            if len(order) < batch_size:
                pad = master.randint(len(loader.data), size=batch_size - len(order))
                order = np.concatenate([order, pad])
            for i in range(0, len(order) - batch_size + 1, batch_size):
                chunk = [int(j) for j in order[i : i + batch_size]]
                yield int(master.randint(2**31)), chunk

    task_iter = tasks()
    pending: deque = deque()
    try:
        while True:
            while len(pending) < num_workers * prefetch_factor:
                pending.append(pool.apply_async(_collect_in_worker, next(task_iter)))
            yield pending.popleft().get()
    finally:
        pool.terminate()
        pool.join()


def prefetch(iterator, size: int = 2):
    """Background-thread batch prefetcher -- the host-side pipelining role
    of the reference's DataLoader(num_workers=8) (train.py:87-93). Keeps
    ``size`` ready batches ahead of the training loop; numpy batch
    assembly overlaps the device step."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=size)
    _END = object()

    def worker():
        try:
            for item in iterator:
                q.put(item)
        finally:
            q.put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            return
        yield item


def filter_collate(batch: List) -> Dict[str, np.ndarray]:
    """Reference-parity collate (collate.py:37-43): drop None samples and
    stack the rest. Provided for API compatibility; the framework's own
    batching resamples instead (fixed shapes)."""
    batch = [b for b in batch if b is not None and b[0] is not None]
    if not batch:
        return {}
    out = {
        "input": np.stack([b[0] for b in batch]),
        "condition": np.stack([b[1] for b in batch]),
    }
    if batch[0][2] is not None:
        out["target"] = np.stack([b[2] for b in batch])
    return out
