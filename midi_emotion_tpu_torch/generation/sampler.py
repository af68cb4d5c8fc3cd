"""KV-cached, batched autoregressive sampler, in torch.

Counterpart of ``midi_emotion_tpu/generation/sampler.py``, native-cache
path (``kv_dtype="native"``). Each chunk prefills (or continues) a
per-layer time-major cache and runs a Python loop of sample + decode
steps on the device; the host sees token ids only at window refreshes and
at the end. The chunk arithmetic is the JAX package's, so the two packages
sample the same tokens from the same uniforms:

 * staged cache growth: the buffers start at ``cache_stage`` rows and grow
   between chunks, which is invisible to the sampled distribution;
 * window sliding in hops: past ``max_input_len`` each refresh re-prefills
   the last ``max_input_len`` tokens and takes ``slide_hop`` samples.

The stacked int8/bf16 cache and the full-forward ``generate_exact`` are
not ported yet and raise.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from midi_emotion_tpu.vocab import Vocab

from ..models.model import MusicTransformer
from ..ops.sampling import SamplingParams, sample_step


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


class Sampler:
    def __init__(
        self,
        model: MusicTransformer,
        vocab: Vocab,
        sampling: SamplingParams,
        slide_hop: Optional[int] = None,
        cache_stage: int = 256,
        kv_dtype: str = "native",
    ):
        cfg = model.config
        if cfg.is_regression:
            raise ValueError("regression models cannot generate")
        if kv_dtype != "native":
            raise NotImplementedError(
                f"kv_dtype={kv_dtype!r}: the stacked int8/bf16 serving cache is "
                "not ported yet (ROADMAP queue 1, item 1: generate_exact and "
                "the stacked cache with kernel 13); use kv_dtype='native'"
            )
        self.model = model
        self.vocab = vocab
        self.sampling = sampling
        self.cfg = cfg
        self.device = model.device
        self.cache_stage = cache_stage
        self.slide_hop = slide_hop
        self.exclude_mask = torch.as_tensor(vocab.special_mask(), device=self.device)
        self.ts_range = (int(vocab.timeshift_base), int(vocab.base_size))

    def generate_exact(self, *args, **kwargs):
        raise NotImplementedError(
            "generate_exact (a full-window forward per token, for per-step "
            "varying conditions) is not ported yet (ROADMAP queue 1, item 1: "
            "generate_exact and the stacked cache with kernel 13)"
        )

    # ------------------------------------------------------------------
    def _prefill(self, prompt: np.ndarray, cond: torch.Tensor, window: int):
        tokens = torch.as_tensor(prompt, dtype=torch.long, device=self.device)
        logits, cache = self.model.prefill(tokens, cond, window)
        ce = None
        if self.cfg.mode == "continuous_concat":
            ce = self.model.condition_embedding(cond)
        return logits, cache, ce

    @staticmethod
    def _grow_cache(cache, w_out: int):
        """Zero-pad every layer's buffers to w_out rows."""
        w_in = cache["k"][0].shape[1]
        if w_in == w_out:
            return cache

        def grow(buf):
            out = buf.new_zeros((buf.shape[0], w_out, buf.shape[2]))
            out[:, :w_in] = buf
            return out

        return {
            "k": [grow(k) for k in cache["k"]],
            "v": [grow(v) for v in cache["v"]],
            "length": cache["length"],
        }

    def _decode_chunk(self, n_steps, cache, logits, temp_key, counts, uniforms, ce):
        """n_steps of sample + decode. Every chunk's first sample comes from
        the logits the previous chunk (or prefill) left. Returns (tokens
        [n_steps, B], logits, cache, counts)."""
        model = self.model
        tokens = []
        for t in range(n_steps):
            token, counts = sample_step(
                logits, temp_key, counts, uniforms[t], self.exclude_mask,
                self.ts_range, self.sampling,
            )
            logits, cache = model.decode_step(token, ce, cache)
            temp_key = token
            tokens.append(token)
        return torch.stack(tokens), logits, cache, counts

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def generate(
        self,
        primer_ids: np.ndarray,
        continuous_conditions: Optional[np.ndarray] = None,
        discrete_prefix_ids: Optional[np.ndarray] = None,
        generator: Optional[torch.Generator] = None,
        uniforms: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Generate a batch of token sequences.

        primer_ids: [B, P] int, e.g. a column of <START> ids; they appear in
        the output. continuous_conditions: [B, 2] (valence, arousal).
        discrete_prefix_ids: [B, C] emotion-token ids prepended to every
        model input but never emitted. generator: a torch.Generator on the
        model's device for the uniforms (default: seeded from
        ``SamplingParams.seed``); its stream differs from JAX's for the same
        seed. uniforms: optional [gen_len-1, B] pre-drawn uniforms, the
        injection hook for cross-framework parity.

        Returns [B, P + gen_len - 1] int32: primer plus sampled tokens.
        """
        cfg, sampling, device = self.cfg, self.sampling, self.device
        primer_ids = np.asarray(primer_ids, np.int32)
        B, P = primer_ids.shape

        max_input_len = sampling.max_input_len
        n_prefix = 0
        if cfg.mode == "continuous_token":
            max_input_len -= cfg.n_conditions
        if discrete_prefix_ids is not None:
            discrete_prefix_ids = np.asarray(discrete_prefix_ids, np.int32)
            n_prefix = discrete_prefix_ids.shape[1]
            max_input_len -= n_prefix

        if continuous_conditions is None:
            cond = torch.zeros((B, 2), dtype=torch.float32, device=device)
        else:
            cond = torch.as_tensor(np.asarray(continuous_conditions, np.float32), device=device)

        n_total_steps = sampling.gen_len - 1
        if uniforms is None:
            if generator is None:
                generator = torch.Generator(device=device).manual_seed(max(0, sampling.seed))
            u_all = torch.rand((n_total_steps, B), generator=generator, device=device)
        else:
            u_all = torch.as_tensor(np.asarray(uniforms, np.float32), device=device)
            if u_all.shape != (n_total_steps, B):
                raise ValueError(f"uniforms {tuple(u_all.shape)} != {(n_total_steps, B)}")

        counts = torch.zeros((B,), dtype=torch.long, device=device)
        # first-step temperature key: the first primer column
        temp_key = torch.as_tensor(primer_ids[:, 0], dtype=torch.long, device=device)

        def model_input(tok_block: np.ndarray) -> np.ndarray:
            if discrete_prefix_ids is not None:
                return np.concatenate([discrete_prefix_ids, tok_block], axis=1)
            return tok_block

        device_chunks = []  # [n_i, B] token tensors, fetched at refreshes
        song_len = P
        fetched = primer_ids
        steps_done = 0
        hop = self.slide_hop or max(1, max_input_len // 8)
        stage = self.cache_stage
        w_max = min(_round_up(max_input_len + n_prefix + cfg.seq_prefix + hop, 128),
                    cfg.max_seq)
        itemsize = torch.finfo(self.model.dtype).bits // 8
        full_cache_bytes = 2 * cfg.n_layer * B * cfg.n_head * w_max * cfg.d_head * itemsize
        # staged growth holds old and new buffers together at each
        # transition; past this size allocate the full window at once
        if full_cache_bytes > 6.5e9:
            stage = w_max

        def fetch_song() -> np.ndarray:
            nonlocal fetched, device_chunks
            if device_chunks:
                host = torch.cat(device_chunks).T.cpu().numpy().astype(np.int32)
                fetched = np.concatenate([fetched, host], axis=1)
                device_chunks = []
            return fetched

        state = None  # (logits, cache, ce, w_cur) carried between chunks
        while steps_done < n_total_steps:
            cur_len = song_len  # tokens so far, prefixes excluded
            overhead = n_prefix + cfg.seq_prefix

            if state is None or cur_len > max_input_len:
                # (re)prefill over the full reference window
                visible = min(cur_len, max_input_len)
                prompt = model_input(fetch_song()[:, cur_len - visible:])
                if cur_len > max_input_len:
                    n_steps = hop
                    w_cur = min(_round_up(visible + overhead + n_steps + 1, 128), cfg.max_seq)
                else:
                    live = visible + overhead
                    w_cur = min(max(_round_up(live + 1, stage), stage), w_max)
                    # sample k sees cur_len + k tokens; past the reference
                    # window a refresh is required for parity
                    n_steps = min(w_cur - live, max_input_len - cur_len + 1)
                n_steps = max(1, min(n_total_steps - steps_done, n_steps))
                assert visible + overhead + n_steps <= w_cur <= cfg.max_seq, (
                    visible, overhead, n_steps, w_cur)
                logits, cache, ce = self._prefill(prompt, cond, w_cur)
            else:
                logits, cache, ce, w_in = state
                live = cur_len + overhead
                w_cur = min(max(_round_up(live + 1, stage), w_in), w_max)
                n_steps = min(n_total_steps - steps_done, w_cur - live,
                              max_input_len - cur_len + 1)
                assert n_steps >= 1, (live, w_cur, cur_len, max_input_len)

            cache = self._grow_cache(cache, w_cur)
            tokens, logits, cache, counts = self._decode_chunk(
                n_steps, cache, logits, temp_key, counts,
                u_all[steps_done: steps_done + n_steps], ce,
            )
            device_chunks.append(tokens)
            song_len += n_steps
            temp_key = tokens[-1]
            steps_done += n_steps
            state = None if song_len > max_input_len else (logits, cache, ce, w_cur)

        return fetch_song()
