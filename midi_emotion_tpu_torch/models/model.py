"""Unified Music Transformer, in torch.

Counterpart of ``midi_emotion_tpu/models/model.py``: one module for the
conditioning modes "none", "discrete_token", "continuous_concat",
"continuous_token" and the "regression" head. Module names follow the
reference's ``state_dict`` (``convert/torch_import.py``), so a reference
checkpoint, or a JAX one through ``convert.state_dict_from_jax_params``,
loads with ``load_state_dict``.

Besides ``forward`` the model has two KV caches for the sampler:

  * native: ``prefill`` / ``decode_step`` over ``{"k": [L x [B, W,
    d_model]], "v": same, "length": int}``, one time-major buffer per layer,
    head h in columns [h*dh, (h+1)*dh);
  * stacked (``ops/decode_attention.py``): ``prefill_q`` / ``decode_step_q``
    / ``decode_step_staged`` over ``{"kv": [L, B, W, 2 * d_model] int8 or
    bf16, "sc": [L, B, 2H, W] bf16 (int8 only), "length": int}``, K|V
    merged. It stays int8/bf16 whatever the compute type, as in the JAX
    package. The staged step leaves the cache alone and appends its rows
    into a step-major stage ``[S, L, B, 2 * d_model]`` bf16 that the sampler
    flushes every S steps (``flush_pend``).

Every decode step writes its rows into the buffers in place.

Two dtypes: ``dtype`` is the compute type and ``param_dtype`` (default
``dtype``) the type the parameters are held in. The serving model holds
its weights in the compute type; the training model holds f32 master
parameters and computes in bf16, as Flax's ``Dense(dtype=bf16)`` does: each
Linear, the embedding and the relative table E are cast at each use, so the
gradients land on the f32 parameters. The LayerNorm parameters stay f32
either way (the kernels read them in f32).

In training mode (``model.train()``) with ``dropout > 0`` the forward runs
the reference's 1 + 2 * n_layer dropout sites: the embedding dropout after
the positional add (JAX ``model.py:453``) and ``LN(x + dropout(attn))``,
``LN(out1 + dropout(ffn))`` in each layer (JAX ``model.py:281-297``), through
``ops/fused_dropout.py``. One seed per site is drawn from the ``generator``
passed to ``forward``; a site's forward and backward share it, so their
masks are the same bits.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import decode_rel_attention, relative_attention, resolve_attn_impl
from ..ops.decode_attention import decode_attn_cached, expand_e_rows, merge_self, quantize_rows
from ..ops.fused_dropout import dropout_add_layernorm, fused_dropout
from ..ops.layernorm import LayerNorm
from .config import ModelConfig
from .positional import sinusoid_table

Cache = Dict[str, object]


def resolve_device(device) -> torch.device:
    """The port's entry points run on the card unless the caller asks for
    the CPU. A CUDA device on a machine without CUDA raises; nothing falls
    back to the CPU quietly."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device}: CUDA is not available on this machine; pass "
            "device='cpu' to run on the CPU"
        )
    return device


class Linear(nn.Linear):
    """``nn.Linear`` that computes in its input's dtype: parameters held in
    another type (the training model's f32 masters) are cast at each use."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight, self.bias
        if w.dtype != x.dtype:  # no cast call at all on the serving path
            w, b = w.to(x.dtype), b.to(x.dtype)
        return F.linear(x, w, b)


class RelativeGlobalAttention(nn.Module):
    """Multi-head attention with the learned relative table E [max_seq, dh]."""

    def __init__(self, d_model: int, n_head: int, max_seq: int, dtype, device,
                 attn_impl: str):
        super().__init__()
        self.n_head = n_head
        self.attn_impl = attn_impl
        self.Wq = Linear(d_model, d_model, dtype=dtype, device=device)
        self.Wk = Linear(d_model, d_model, dtype=dtype, device=device)
        self.Wv = Linear(d_model, d_model, dtype=dtype, device=device)
        self.fc = Linear(d_model, d_model, dtype=dtype, device=device)
        self.E = nn.Parameter(torch.empty(max_seq, d_model // n_head, dtype=dtype, device=device))

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, d] -> contiguous [B, H, T, dh]."""
        B, T, _ = x.shape
        return x.view(B, T, self.n_head, -1).transpose(1, 2).contiguous()

    def forward(self, x: torch.Tensor, causal: bool, pad_keys: Optional[torch.Tensor],
                return_kv: bool = False):
        """x [B, T, d]. With ``return_kv`` also returns this layer's K and V
        in the cache layout, time-major [B, T, d]."""
        B, T, d = x.shape
        k_rows, v_rows = self.Wk(x), self.Wv(x)
        out = relative_attention(
            self._heads(self.Wq(x)), self._heads(k_rows), self._heads(v_rows),
            self.E.to(x.dtype), causal=causal, pad_keys=pad_keys, impl=self.attn_impl,
        )
        out = self.fc(out.transpose(1, 2).reshape(B, T, d))
        if return_kv:
            return out, k_rows, v_rows
        return out

    def decode(self, x_t: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
               length: int) -> torch.Tensor:
        """One-token step. x_t [B, d]; caches [B, W, d]; ``length`` counts
        live rows, the current token's included. Writes the token's K and V
        into row length-1 of the caches IN PLACE."""
        B = x_t.shape[0]
        q = self.Wq(x_t).view(B, self.n_head, -1)
        k_cache[:, length - 1] = self.Wk(x_t)  # in place: one row per step
        v_cache[:, length - 1] = self.Wv(x_t)
        out = decode_rel_attention(q, k_cache, v_cache, self.E.to(x_t.dtype), length)
        return self.fc(out.reshape(B, -1))

    def _qkv_row(self, x_t: torch.Tensor):
        """-> (q [B, H, dh], k_t [B, d], v_t [B, d])."""
        return self.Wq(x_t).view(x_t.shape[0], self.n_head, -1), self.Wk(x_t), self.Wv(x_t)

    def decode_q(self, x_t: torch.Tensor, kv8: torch.Tensor, sc: Optional[torch.Tensor],
                 layer_idx: int, length: int) -> torch.Tensor:
        """One-token step against the stacked cache (``sc`` None for bf16).
        ``length`` counts cached rows; the current token is folded in exactly
        by ``merge_self``. Its K|V row (quantized for int8) is then written
        into window row ``length`` of this layer IN PLACE: the JAX package
        defers that append to the next step, which reads the same cache."""
        q, k_t, v_t = self._qkv_row(x_t)
        e = self.E.to(x_t.dtype)
        e_rows = expand_e_rows(e, length + 1, kv8.shape[2])
        acc, m, l = decode_attn_cached(q, kv8, sc, layer_idx, e_rows, length)
        out = merge_self(acc, m, l, q, k_t, v_t, e[-1])
        row = torch.cat([k_t, v_t], dim=-1)
        if sc is None:
            kv8[layer_idx, :, length] = row
        else:
            row8, rsc = quantize_rows(row[:, None, :], 2 * self.n_head)
            kv8[layer_idx, :, length] = row8[:, 0]
            sc[layer_idx, :, :, length] = rsc[:, :, 0]
        return self.fc(out)

    def decode_q_staged(self, x_t: torch.Tensor, kv8: torch.Tensor, sc: Optional[torch.Tensor],
                        pend: torch.Tensor, layer_idx: int, f_len: int, p_cnt: int):
        """decode_q against a cache whose last p_cnt rows are still in the
        stage ``pend [S, L, B, 2d]`` bf16: one kernel call covers the f_len
        flushed rows, the stage tail and the self term, and appends this
        token's row at stage slot (p_cnt, layer_idx) in place. Returns
        (attn_out [B, d], pend)."""
        q, k_t, v_t = self._qkv_row(x_t)
        e = self.E.to(x_t.dtype)
        S = pend.shape[0]
        e_rows = expand_e_rows(e, f_len + p_cnt + 1, kv8.shape[2])
        e_pend = expand_e_rows(e, p_cnt + 1, S + 1)  # row p_cnt is E[max_seq - 1]
        row = torch.cat([k_t, v_t], dim=-1).to(torch.bfloat16)
        out, pend = decode_attn_cached(q, kv8, sc, layer_idx, e_rows, f_len, pend, e_pend,
                                       p_cnt, row)
        return self.fc(out.to(x_t.dtype)), pend


class EncoderLayer(nn.Module):
    """Post-LN block: RGA -> LN(x + dropout(attn)) -> ReLU MLP ->
    LN(. + dropout(mlp)). Dropout runs only when ``drop_seeds`` is given."""

    def __init__(self, d_model: int, d_inner: int, n_head: int, max_seq: int,
                 dropout: float, dtype, device, attn_impl: str):
        super().__init__()
        self.dropout = dropout
        self.rga = RelativeGlobalAttention(d_model, n_head, max_seq, dtype, device, attn_impl)
        self.FFN_pre = Linear(d_model, d_inner, dtype=dtype, device=device)
        self.FFN_suf = Linear(d_inner, d_model, dtype=dtype, device=device)
        self.layernorm1 = LayerNorm(d_model, eps=1e-6, device=device)
        self.layernorm2 = LayerNorm(d_model, eps=1e-6, device=device)

    def _add_norm(self, ln: LayerNorm, res: torch.Tensor, sub: torch.Tensor,
                  seed: Optional[int]) -> torch.Tensor:
        if seed is None:
            return ln(res + sub)
        return dropout_add_layernorm(sub, res, ln.weight, ln.bias, seed, self.dropout, ln.eps)

    def _mlp_block(self, x, attn, drop_seeds=(None, None)):
        out1 = self._add_norm(self.layernorm1, x, attn, drop_seeds[0])
        ffn = self.FFN_suf(F.relu(self.FFN_pre(out1)))
        return self._add_norm(self.layernorm2, out1, ffn, drop_seeds[1])

    def forward(self, x, pad_keys, causal: bool = True, return_kv: bool = False,
                drop_seeds=(None, None)):
        if return_kv:
            attn, k, v = self.rga(x, causal, pad_keys, return_kv=True)
            return self._mlp_block(x, attn), k, v
        return self._mlp_block(x, self.rga(x, causal, pad_keys), drop_seeds)

    def decode(self, x_t, k_cache, v_cache, length: int):
        return self._mlp_block(x_t, self.rga.decode(x_t, k_cache, v_cache, length))

    def decode_q(self, x_t, kv8, sc, layer_idx: int, length: int):
        return self._mlp_block(x_t, self.rga.decode_q(x_t, kv8, sc, layer_idx, length))

    def decode_q_staged(self, x_t, kv8, sc, pend, layer_idx: int, f_len: int, p_cnt: int):
        attn, pend = self.rga.decode_q_staged(x_t, kv8, sc, pend, layer_idx, f_len, p_cnt)
        return self._mlp_block(x_t, attn), pend


class MusicTransformer(nn.Module):
    """The model, on ``device`` (the card unless the caller asks for the
    CPU), computing in ``dtype`` with parameters held in ``param_dtype``
    (default ``dtype``)."""

    def __init__(self, config: ModelConfig, dtype=torch.float32, device="cuda",
                 attn_impl: str = "auto", param_dtype=None):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = dtype
        self.param_dtype = param_dtype or dtype
        self.device = resolve_device(device)
        self.attn_impl = resolve_attn_impl(attn_impl, self.device)
        kw = dict(dtype=self.param_dtype, device=self.device)
        self.embedding = nn.Embedding(cfg.vocab_size, cfg.embed_dim, **kw)
        if cfg.mode == "continuous_concat" and cfg.effective_d_condition > 0:
            self.fc_condition = Linear(2, cfg.effective_d_condition, **kw)
        if cfg.mode == "continuous_token":
            self.fc_condition = nn.ModuleList(
                Linear(1, cfg.d_model, **kw) for _ in range(cfg.n_conditions)
            )
        self.enc_layers = nn.ModuleList(
            EncoderLayer(cfg.d_model, cfg.d_inner, cfg.n_head, cfg.max_seq, cfg.dropout,
                         self.param_dtype, self.device, self.attn_impl)
            for _ in range(cfg.n_layer)
        )
        if cfg.is_regression:
            self.fc = nn.Sequential(Linear(cfg.d_model, cfg.output_size, **kw), nn.Tanh())
        else:
            self.fc = Linear(cfg.d_model, cfg.vocab_size, **kw)
        table = torch.from_numpy(sinusoid_table(cfg.max_seq, cfg.d_model))
        self.register_buffer("pos_table", table.to(dtype=dtype, device=self.device),
                             persistent=False)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "MusicTransformer":
        """Random weights drawn on the CPU from ``generator``: the
        reference's init_weights (uniform +-0.1 for the embedding and the
        output and condition heads, zero biases there, E ~ N(0, 1)) and
        torch's default uniform(+-1/sqrt(fan_in)) for the other Linears.
        LayerNorms keep their ones/zeros."""
        def uniform(p, bound):
            p.copy_(torch.rand(p.shape, generator=generator) * (2 * bound) - bound)

        heads = [self.embedding, self.fc]
        if hasattr(self, "fc_condition"):
            heads.append(self.fc_condition)
        head_params = {id(p) for m in heads for p in m.parameters()}
        for m in self.modules():
            if isinstance(m, nn.Linear) and id(m.weight) not in head_params:
                bound = 1.0 / math.sqrt(m.in_features)
                uniform(m.weight, bound)
                uniform(m.bias, bound)
        for name, p in self.named_parameters():
            if id(p) not in head_params:
                if name.endswith(".E"):
                    p.copy_(torch.randn(p.shape, generator=generator))
            elif name.endswith("weight"):
                uniform(p, 0.1)
            else:
                p.zero_()
        return self

    # ------------------------------------------------------------------
    def _scaled_embedding(self, tokens: torch.Tensor) -> torch.Tensor:
        # embed_dim is d_model in every mode but continuous_concat
        return self.embedding(tokens).to(self.dtype) * math.sqrt(self.config.embed_dim)

    def _embed(self, tokens: torch.Tensor, condition: Optional[torch.Tensor]):
        """Token and condition embedding -> (x [B, T', d_model], causal,
        pad_keys [B, T'] or None); T' includes the continuous_token
        prefix."""
        cfg = self.config
        tokens = tokens.contiguous()  # the pad mask derived below feeds the kernel
        x = self._scaled_embedding(tokens)
        causal = True
        if cfg.mode == "continuous_token":
            # left-pad with -1 so the condition slots never match pad
            padded = F.pad(tokens, (cfg.n_conditions, 0), value=-1)
            pad_keys = padded == cfg.pad_id
            x = torch.cat([self.condition_prefix(condition), x], dim=1)
        elif cfg.is_regression:
            causal, pad_keys = False, None
        else:
            pad_keys = tokens == cfg.pad_id
            if cfg.effective_d_condition > 0:
                ce = self.condition_embedding(condition)
                x = torch.cat([x, ce[:, None, :].expand(-1, x.shape[1], -1)], dim=-1)
        return x + self.pos_table[: x.shape[1]], causal, pad_keys

    def condition_embedding(self, condition: torch.Tensor) -> torch.Tensor:
        """continuous_concat channel block [B, d_condition]."""
        return self.fc_condition(condition.to(self.dtype))

    def condition_prefix(self, condition: torch.Tensor) -> torch.Tensor:
        """continuous_token prefix [B, n_conditions, d_model]."""
        c = condition.to(self.dtype)
        return torch.stack([fc(c[:, i, None]) for i, fc in enumerate(self.fc_condition)], dim=1)

    # ------------------------------------------------------------------
    def forward(self, tokens: torch.Tensor,
                condition: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """tokens [B, T] int; condition [B, 2] float (ignored by none,
        discrete_token and regression). Returns logits [B, T + prefix,
        vocab], or [B, output_size] for regression.

        In training mode with ``dropout > 0`` the dropout seeds are drawn
        from ``generator``, a CPU ``torch.Generator`` (torch's default one
        when None)."""
        x = self.features(tokens, condition, generator)
        if self.config.is_regression:
            return self.fc(x[:, 0, :])
        return self.fc(x)

    def features(self, tokens: torch.Tensor, condition: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 deterministic: bool = False) -> torch.Tensor:
        """The forward pass up to the output head: [B, T + prefix, d_model].
        ``deterministic`` runs no dropout even in training mode."""
        x, causal, pad_keys = self._embed(tokens, condition)
        seeds = None if deterministic else self.dropout_seeds(generator)
        if seeds is not None:
            x = fused_dropout(x, seeds[0], self.config.dropout)
        for i, layer in enumerate(self.enc_layers):
            drop = (None, None) if seeds is None else (seeds[1 + 2 * i], seeds[2 + 2 * i])
            x = layer(x, pad_keys, causal, drop_seeds=drop)
        return x

    def dropout_seeds(self, generator: Optional[torch.Generator]) -> Optional[List[int]]:
        """One 31-bit seed per dropout site (1 + 2 * n_layer of them), or
        None when this forward runs no dropout."""
        if not (self.training and self.config.dropout > 0):
            return None
        n = 1 + 2 * self.config.n_layer
        return torch.randint(0, 2**31 - 1, (n,), generator=generator).tolist()

    def prefill(self, tokens: torch.Tensor, condition: Optional[torch.Tensor],
                window: int) -> Tuple[torch.Tensor, Cache]:
        """Run the prompt through the full path and capture each layer's K/V
        into [B, window, d_model] buffers. Returns (last-position logits
        [B, vocab], cache)."""
        x, causal, pad_keys = self._embed(tokens, condition)
        B, T, d = x.shape
        ks: List[torch.Tensor] = []
        vs: List[torch.Tensor] = []
        for layer in self.enc_layers:
            x, k, v = layer(x, pad_keys, causal, return_kv=True)
            for rows, out in ((k, ks), (v, vs)):
                buf = torch.zeros((B, window, d), dtype=rows.dtype, device=rows.device)
                buf[:, :T] = rows
                out.append(buf)
        return self.fc(x[:, -1, :]), {"k": ks, "v": vs, "length": T}

    def decode_step(self, token_t: torch.Tensor, cond_emb: Optional[torch.Tensor],
                    cache: Cache) -> Tuple[torch.Tensor, Cache]:
        """Advance one token. token_t [B] int; cond_emb: the precomputed
        continuous_concat block [B, d_condition] or None. The cache buffers
        are updated IN PLACE; the returned cache shares them with a length
        one larger. Returns (logits [B, vocab], cache)."""
        length = cache["length"] + 1
        x = self._decode_input(token_t, cond_emb, length - 1)
        for layer, k, v in zip(self.enc_layers, cache["k"], cache["v"]):
            x = layer.decode(x, k, v, length)
        return self.fc(x), {"k": cache["k"], "v": cache["v"], "length": length}

    def _decode_input(self, token_t: torch.Tensor, cond_emb: Optional[torch.Tensor],
                      pos: int) -> torch.Tensor:
        """A decoded token's embedding (with the continuous_concat block)
        plus the positional row ``pos`` -> [B, d_model]."""
        x = self._scaled_embedding(token_t)
        if self.config.effective_d_condition > 0:
            x = torch.cat([x, cond_emb], dim=-1)
        return x + self.pos_table[pos]

    def prefill_q(self, tokens: torch.Tensor, condition: Optional[torch.Tensor],
                  window: int, quantize: bool = True) -> Tuple[torch.Tensor, Cache]:
        """Prefill into the stacked cache: kv [L, B, window, 2d] K|V-merged
        rows, int8 with [L, B, 2H, window] bf16 per-(row, head) scales when
        ``quantize``, bf16 otherwise. Returns (last-position logits, cache)."""
        cfg = self.config
        x, causal, pad_keys = self._embed(tokens, condition)
        B, T, d = x.shape
        L = cfg.n_layer
        kv = torch.zeros((L, B, window, 2 * d), device=x.device,
                         dtype=torch.int8 if quantize else torch.bfloat16)
        cache: Cache = {"kv": kv, "length": T}
        if quantize:
            cache["sc"] = torch.zeros((L, B, 2 * cfg.n_head, window), dtype=torch.bfloat16,
                                      device=x.device)
        for i, layer in enumerate(self.enc_layers):
            x, k, v = layer(x, pad_keys, causal, return_kv=True)
            rows = torch.cat([k, v], dim=-1)  # [B, T, 2d]
            if quantize:
                kv[i, :, :T], cache["sc"][i, :, :, :T] = quantize_rows(rows, 2 * cfg.n_head)
            else:
                kv[i, :, :T] = rows
        return self.fc(x[:, -1, :]), cache

    def decode_step_q(self, token_t: torch.Tensor, cond_emb: Optional[torch.Tensor],
                      cache: Cache) -> Tuple[torch.Tensor, Cache]:
        """Advance one token against the stacked cache: each layer's kernel
        call and exact self-term merge, then the layer's row written at
        window row ``length`` in place. Returns (logits, cache with length
        one larger, sharing the buffers)."""
        length = cache["length"]
        x = self._decode_input(token_t, cond_emb, length)
        for i, layer in enumerate(self.enc_layers):
            x = layer.decode_q(x, cache["kv"], cache.get("sc"), i, length)
        return self.fc(x), {**cache, "length": length + 1}

    def decode_step_staged(self, token_t: torch.Tensor, cond_emb: Optional[torch.Tensor],
                           kv8: torch.Tensor, sc: Optional[torch.Tensor], pend: torch.Tensor,
                           f_len: int, p_cnt: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """One token against the stacked cache WITHOUT touching it: each
        layer's kernel call covers the f_len flushed rows, folds the p_cnt
        staged rows and appends its own row at stage slot (p_cnt, layer).
        The sampler flushes the stage every S steps (``flush_pend``).
        Returns (logits, pend)."""
        x = self._decode_input(token_t, cond_emb, f_len + p_cnt)
        for i, layer in enumerate(self.enc_layers):
            x, pend = layer.decode_q_staged(x, kv8, sc, pend, i, f_len, p_cnt)
        return self.fc(x), pend
