"""KV-cached, batched autoregressive sampler, in torch.

Counterpart of ``midi_emotion_tpu/generation/sampler.py``. Each chunk
prefills (or continues) a cache and runs a Python loop of sample + decode
steps on the device; the host sees token ids only at window refreshes and
at the end. The chunk arithmetic is the JAX package's, so the two packages
sample the same tokens from the same uniforms:

 * cache growth (native cache): the buffers start at ``cache_stage`` rows
   and grow between chunks, which is invisible to the sampled distribution;
 * window sliding in hops: past ``max_input_len`` each refresh re-prefills
   the last ``max_input_len`` tokens and takes ``slide_hop`` samples.

``kv_dtype`` picks the cache: "native" (per-layer time-major buffers, the
exact path), or the stacked cache of ``ops/decode_attention.py`` with its
hand-written decode kernel, "int8" (quantized; tokens can differ from
"native" within int8 error) or "bf16". The stacked cache is allocated at
full width up front. With ``stage_steps`` S > 0 (default 8, or
``MIDI_EMOTION_DECODE_STAGE``) decoded rows go to a step-major stage that is
flushed into the cache every S steps; chunks that carry their cache forward
are sized to a multiple of S so a carried cache is always fully flushed.

``generate_exact`` runs a full-window forward per token (the reference's
loop), for per-step varying conditions and as the exact oracle.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..models.model import MusicTransformer
from ..ops.decode_attention import flush_pend
from ..ops.sampling import SamplingParams, sample_step
from ..vocab import Vocab


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
        stage_steps: Optional[int] = None,
    ):
        cfg = model.config
        if cfg.is_regression:
            raise ValueError("regression models cannot generate")
        if kv_dtype not in ("native", "int8", "bf16"):
            raise ValueError(f"kv_dtype must be native, int8 or bf16, got {kv_dtype!r}")
        if stage_steps is None:
            # staged rows per flush for the stacked caches; 0 = none
            raw = os.environ.get("MIDI_EMOTION_DECODE_STAGE", "8")
            try:
                stage_steps = int(raw)
            except ValueError:
                raise ValueError(
                    f"MIDI_EMOTION_DECODE_STAGE={raw!r}: must be an integer "
                    "(staged rows per flush; 0 disables staging)"
                ) from None
        if not 0 <= stage_steps <= 128:
            raise ValueError(
                f"stage_steps={stage_steps}: must be in [0, 128] (the "
                "sampler's window slack only guarantees in-bounds flushes "
                "for modest stage depths)"
            )
        self.stage_steps = stage_steps if kv_dtype != "native" else 0
        self.kv_dtype = kv_dtype
        self.model = model
        self.vocab = vocab
        self.sampling = sampling
        self.cfg = cfg
        self.device = model.device
        self.cache_stage = cache_stage
        self.slide_hop = slide_hop
        self.exclude_mask = torch.as_tensor(vocab.special_mask(), device=self.device)
        self.ts_range = (int(vocab.timeshift_base), int(vocab.base_size))

    # ------------------------------------------------------------------
    def _prefill(self, prompt: np.ndarray, cond: torch.Tensor, window: int):
        tokens = torch.as_tensor(prompt, dtype=torch.long, device=self.device)
        if self.kv_dtype == "native":
            logits, cache = self.model.prefill(tokens, cond, window)
        else:
            logits, cache = self.model.prefill_q(tokens, cond, window, self.kv_dtype == "int8")
        ce = None
        if self.cfg.mode == "continuous_concat":
            ce = self.model.condition_embedding(cond)
        return logits, cache, ce

    @staticmethod
    def _grow_cache(cache, w_out: int):
        """Zero-pad every layer's native buffers to w_out rows (the stacked
        cache is allocated at full width and never grows)."""
        if "kv" in cache or cache["k"][0].shape[1] == w_out:
            return cache
        w_in = cache["k"][0].shape[1]

        def grow(buf):
            out = buf.new_zeros((buf.shape[0], w_out, buf.shape[2]))
            out[:, :w_in] = buf
            return out

        return {
            "k": [grow(k) for k in cache["k"]],
            "v": [grow(v) for v in cache["v"]],
            "length": cache["length"],
        }

    def _to_staged(self, cache, batch: int):
        """Give a prefill_q cache its step-major stage [S, L, B, 2d] bf16."""
        if "pend" not in cache:
            L, _, _, D2 = cache["kv"].shape
            cache = {**cache, "pend": torch.zeros((self.stage_steps, L, batch, D2),
                                                  dtype=torch.bfloat16, device=self.device)}
        return cache

    def _step_ce(self, ce, conds, t):
        """The continuous_concat block for step t: per-step when the
        conditions vary, else the chunk's."""
        return ce if conds is None else self.model.condition_embedding(conds[t])

    def _decode_chunk(self, n_steps, cache, logits, temp_key, counts, uniforms, ce, conds):
        """n_steps of sample + decode (native or unstaged stacked cache).
        Every chunk's first sample comes from the logits the previous chunk
        (or prefill) left. Returns (tokens [n_steps, B], logits, cache,
        counts)."""
        model = self.model
        step = model.decode_step if self.kv_dtype == "native" else model.decode_step_q
        tokens = []
        for t in range(n_steps):
            token, counts = sample_step(
                logits, temp_key, counts, uniforms[t], self.exclude_mask,
                self.ts_range, self.sampling,
            )
            logits, cache = step(token, self._step_ce(ce, conds, t), cache)
            temp_key = token
            tokens.append(token)
        return torch.stack(tokens), logits, cache, counts

    def _decode_chunk_staged(self, n_steps, cache, logits, temp_key, counts, uniforms, ce,
                             conds):
        """The staged variant: super-steps of S decode steps against a fixed
        flushed cache, each followed by one ``flush_pend``, then a flush-less
        remainder whose rows stay in the stage. Returns what _decode_chunk
        does; the cache's length counts flushed and staged rows."""
        S = self.stage_steps
        kv, sc, pend = cache["kv"], cache.get("sc"), cache["pend"]
        f_len, p = cache["length"], 0
        tokens = []
        for t in range(n_steps):
            token, counts = sample_step(
                logits, temp_key, counts, uniforms[t], self.exclude_mask,
                self.ts_range, self.sampling,
            )
            logits, pend = self.model.decode_step_staged(
                token, self._step_ce(ce, conds, t), kv, sc, pend, f_len, p)
            p += 1
            if p == S:
                flush_pend(kv, sc, pend, f_len, self.cfg.n_head)
                f_len, p = f_len + S, 0
            temp_key = token
            tokens.append(token)
        return torch.stack(tokens), logits, {**cache, "length": f_len + p, "pend": pend}, counts

    # ------------------------------------------------------------------
    def _uniforms(self, uniforms, generator, n_total_steps: int, B: int) -> torch.Tensor:
        if uniforms is None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(
                    max(0, self.sampling.seed))
            return torch.rand((n_total_steps, B), generator=generator, device=self.device)
        u_all = torch.as_tensor(np.asarray(uniforms, np.float32), device=self.device)
        if u_all.shape != (n_total_steps, B):
            raise ValueError(f"uniforms {tuple(u_all.shape)} != {(n_total_steps, B)}")
        return u_all

    def _window(self, discrete_prefix_ids):
        """-> (max_input_len left for tokens, prefix ids or None, n_prefix)."""
        max_input_len = self.sampling.max_input_len
        n_prefix = 0
        if self.cfg.mode == "continuous_token":
            max_input_len -= self.cfg.n_conditions
        if discrete_prefix_ids is not None:
            discrete_prefix_ids = np.asarray(discrete_prefix_ids, np.int32)
            n_prefix = discrete_prefix_ids.shape[1]
            max_input_len -= n_prefix
        return max_input_len, discrete_prefix_ids, n_prefix

    def _varying(self, varying_conditions, B: int) -> np.ndarray:
        vc = np.asarray(varying_conditions, np.float32)
        if vc.shape != (B, self.sampling.gen_len, 2):
            raise ValueError(f"varying_conditions must be [B, gen_len, 2] = "
                             f"{(B, self.sampling.gen_len, 2)}, got {vc.shape}")
        return vc

    @torch.inference_mode()
    def generate_exact(
        self,
        primer_ids: np.ndarray,
        continuous_conditions: Optional[np.ndarray] = None,
        discrete_prefix_ids: Optional[np.ndarray] = None,
        generator: Optional[torch.Generator] = None,
        uniforms: Optional[np.ndarray] = None,
        varying_conditions: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Reference-exact generation: a full-window forward per token.

        Same contract as :meth:`generate`. The window is a [B, W] buffer
        right-padded with pad_id (the model's key-pad masking makes the
        padded forward equal the reference's variable-length one), rolled
        once it fills. With ``varying_conditions`` [B, gen_len, 2] (the
        continuous modes), token t (1-indexed) is drawn from a forward
        under condition t-1, as the reference re-embeds its whole window
        under each step's condition. The output head runs at the sampled
        position only."""
        cfg, model, device = self.cfg, self.model, self.device
        primer_ids = np.asarray(primer_ids, np.int32)
        B, P = primer_ids.shape
        W, prefix, n_prefix = self._window(discrete_prefix_ids)
        n_total_steps = self.sampling.gen_len - 1
        u_all = self._uniforms(uniforms, generator, n_total_steps, B)

        if varying_conditions is not None:
            if cfg.mode not in ("continuous_concat", "continuous_token"):
                raise ValueError("per-step conditions apply to the continuous modes only")
            vc = self._varying(varying_conditions, B)
            cond_seq = torch.as_tensor(vc[:, :n_total_steps].transpose(1, 0, 2), device=device)
        else:
            cond = (np.zeros((B, 2), np.float32) if continuous_conditions is None
                    else np.asarray(continuous_conditions, np.float32))
            cond_seq = torch.as_tensor(cond, device=device)[None].expand(n_total_steps, B, 2)

        if P > W:
            raise ValueError(f"primer of {P} tokens exceeds the window {W}")
        buf = torch.full((B, W), self.vocab.pad_id, dtype=torch.long, device=device)
        buf[:, :P] = torch.as_tensor(primer_ids, dtype=torch.long, device=device)
        prefix_t = None if prefix is None else torch.as_tensor(prefix, dtype=torch.long,
                                                               device=device)
        length = P
        counts = torch.zeros((B,), dtype=torch.long, device=device)
        temp_key = torch.as_tensor(primer_ids[:, 0], dtype=torch.long, device=device)
        tokens = []
        for t in range(n_total_steps):
            inp = buf if prefix_t is None else torch.cat([prefix_t, buf], dim=1)
            pos = cfg.seq_prefix + n_prefix + length - 1
            logits = model.fc(model.features(inp, cond_seq[t], deterministic=True)[:, pos])
            token, counts = sample_step(
                logits, temp_key, counts, u_all[t], self.exclude_mask, self.ts_range,
                self.sampling,
            )
            if length >= W:
                buf = torch.cat([buf[:, 1:], token[:, None]], dim=1)
            else:
                buf[:, length] = token
            length = min(length + 1, W)
            temp_key = token
            tokens.append(token)
        sampled = torch.stack(tokens).T.cpu().numpy().astype(np.int32)
        return np.concatenate([primer_ids, sampled], axis=1)

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def generate(
        self,
        primer_ids: np.ndarray,
        continuous_conditions: Optional[np.ndarray] = None,
        discrete_prefix_ids: Optional[np.ndarray] = None,
        generator: Optional[torch.Generator] = None,
        uniforms: Optional[np.ndarray] = None,
        varying_conditions: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Generate a batch of token sequences.

        primer_ids: [B, P] int, e.g. a column of <START> ids; they appear in
        the output. continuous_conditions: [B, 2] (valence, arousal).
        discrete_prefix_ids: [B, C] emotion-token ids prepended to every
        model input but never emitted. generator: a torch.Generator on the
        model's device for the uniforms (default: seeded from
        ``SamplingParams.seed``); its stream differs from JAX's for the same
        seed. uniforms: optional [gen_len-1, B] pre-drawn uniforms, the
        injection hook for cross-framework parity. varying_conditions:
        optional [B, gen_len, 2] per-step (valence, arousal),
        continuous_concat only: each step's condition block is recomputed,
        while cached positions keep the condition they were decoded under
        (the reference re-embeds the whole window each step; use
        :meth:`generate_exact` for that).

        Returns [B, P + gen_len - 1] int32: primer plus sampled tokens.
        """
        cfg, sampling, device = self.cfg, self.sampling, self.device
        primer_ids = np.asarray(primer_ids, np.int32)
        B, P = primer_ids.shape
        max_input_len, discrete_prefix_ids, n_prefix = self._window(discrete_prefix_ids)

        vc = None
        if varying_conditions is not None:
            if cfg.mode != "continuous_concat":
                raise ValueError("per-step conditions require the channel-concat mode; the "
                                 "sequence-prefix modes bake conditions into the KV cache")
            vc = self._varying(varying_conditions, B)
            cond = torch.as_tensor(vc[:, 0], device=device)
        elif continuous_conditions is None:
            cond = torch.zeros((B, 2), dtype=torch.float32, device=device)
        else:
            cond = torch.as_tensor(np.asarray(continuous_conditions, np.float32), device=device)

        n_total_steps = sampling.gen_len - 1
        u_all = self._uniforms(uniforms, generator, n_total_steps, B)

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
        stacked = self.kv_dtype != "native"
        if stacked:
            # the stacked cache is allocated at full width up front: the
            # kernel reads only the live rows, so growth would save nothing
            stage = w_max
        else:
            itemsize = torch.finfo(self.model.dtype).bits // 8
            full_cache_bytes = 2 * cfg.n_layer * B * cfg.n_head * w_max * cfg.d_head * itemsize
            # staged growth holds old and new buffers together at each
            # transition; past this size allocate the full window at once
            if full_cache_bytes > 6.5e9:
                stage = w_max
        staged = self.stage_steps > 0

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
                    w_cur = w_max if stacked else min(
                        _round_up(visible + overhead + n_steps + 1, 128), cfg.max_seq)
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

            # a staged chunk that carries its cache forward runs a multiple
            # of S steps, so the carried cache is fully flushed; chunks whose
            # cache is discarded (the last one, window refreshes) may leave
            # a remainder in the stage
            discard_state = False
            if staged:
                S = self.stage_steps
                will_carry = (song_len + n_steps <= max_input_len
                              and steps_done + n_steps < n_total_steps)
                if will_carry and n_steps % S:
                    if n_steps < S:
                        # too few steps for a flush: run them and re-prefill
                        # next chunk instead of carrying an unflushed cache
                        discard_state = True
                    else:
                        n_steps -= n_steps % S

            conds = None
            if vc is not None:
                # step j decodes the logits of reference iteration j + 2,
                # which uses condition index j + 1
                conds = torch.as_tensor(
                    vc[:, steps_done + 1: steps_done + 1 + n_steps].transpose(1, 0, 2),
                    device=device)
            chunk = (u_all[steps_done: steps_done + n_steps], ce, conds)
            if staged:
                tokens, logits, cache, counts = self._decode_chunk_staged(
                    n_steps, self._to_staged(cache, B), logits, temp_key, counts, *chunk)
            else:
                tokens, logits, cache, counts = self._decode_chunk(
                    n_steps, self._grow_cache(cache, w_cur), logits, temp_key, counts, *chunk)
            device_chunks.append(tokens)
            song_len += n_steps
            temp_key = tokens[-1]
            steps_done += n_steps
            carry = not (song_len > max_input_len or discard_state)
            state = (logits, cache, ce, w_cur) if carry else None

        return fetch_song()
