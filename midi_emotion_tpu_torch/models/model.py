"""Unified Music Transformer, in torch.

Counterpart of ``midi_emotion_tpu/models/model.py``: one module for the
conditioning modes "none", "discrete_token", "continuous_concat",
"continuous_token" and the "regression" head. Module names follow the
reference's ``state_dict`` (``convert/torch_import.py``), so a reference
checkpoint, or a JAX one through ``convert.state_dict_from_jax_params``,
loads with ``load_state_dict``.

Besides ``forward`` the model has ``prefill`` / ``decode_step`` for the
KV-cached sampler. The cache is a dict ``{"k": [L x [B, W, d_model]],
"v": same, "length": int}``: one time-major buffer per layer, head h in
columns [h*dh, (h+1)*dh). ``decode_step`` writes its row into each
buffer in place.

Weights are held in the model's dtype, except the LayerNorm parameters,
which stay f32 (the JAX package casts f32 parameters to the compute dtype
at each use; holding them cast gives the same numbers). The serving path
is inference only: dropout and gradients arrive with the training port.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from midi_emotion_tpu.models.config import ModelConfig
from midi_emotion_tpu.models.positional import sinusoid_table

from ..ops.attention import decode_rel_attention, relative_attention, resolve_attn_impl
from ..ops.layernorm import LayerNorm

Cache = Dict[str, object]


class RelativeGlobalAttention(nn.Module):
    """Multi-head attention with the learned relative table E [max_seq, dh]."""

    def __init__(self, d_model: int, n_head: int, max_seq: int, dtype, device,
                 attn_impl: str):
        super().__init__()
        self.n_head = n_head
        self.attn_impl = attn_impl
        self.Wq = nn.Linear(d_model, d_model, dtype=dtype, device=device)
        self.Wk = nn.Linear(d_model, d_model, dtype=dtype, device=device)
        self.Wv = nn.Linear(d_model, d_model, dtype=dtype, device=device)
        self.fc = nn.Linear(d_model, d_model, dtype=dtype, device=device)
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
            self.E, causal=causal, pad_keys=pad_keys, impl=self.attn_impl,
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
        out = decode_rel_attention(q, k_cache, v_cache, self.E, length)
        return self.fc(out.reshape(B, -1))


class EncoderLayer(nn.Module):
    """Post-LN block: RGA -> LN(x + attn) -> ReLU MLP -> LN(. + mlp)."""

    def __init__(self, d_model: int, d_inner: int, n_head: int, max_seq: int, dtype,
                 device, attn_impl: str):
        super().__init__()
        self.rga = RelativeGlobalAttention(d_model, n_head, max_seq, dtype, device, attn_impl)
        self.FFN_pre = nn.Linear(d_model, d_inner, dtype=dtype, device=device)
        self.FFN_suf = nn.Linear(d_inner, d_model, dtype=dtype, device=device)
        self.layernorm1 = LayerNorm(d_model, eps=1e-6, device=device)
        self.layernorm2 = LayerNorm(d_model, eps=1e-6, device=device)

    def _mlp_block(self, x: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
        out1 = self.layernorm1(attn + x)
        return self.layernorm2(out1 + self.FFN_suf(F.relu(self.FFN_pre(out1))))

    def forward(self, x, pad_keys, causal: bool = True, return_kv: bool = False):
        if return_kv:
            attn, k, v = self.rga(x, causal, pad_keys, return_kv=True)
            return self._mlp_block(x, attn), k, v
        return self._mlp_block(x, self.rga(x, causal, pad_keys))

    def decode(self, x_t, k_cache, v_cache, length: int):
        return self._mlp_block(x_t, self.rga.decode(x_t, k_cache, v_cache, length))


class MusicTransformer(nn.Module):
    def __init__(self, config: ModelConfig, dtype=torch.float32, device="cpu",
                 attn_impl: str = "auto"):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = dtype
        self.device = torch.device(device)
        self.attn_impl = resolve_attn_impl(attn_impl, self.device)
        kw = dict(dtype=dtype, device=self.device)
        self.embedding = nn.Embedding(cfg.vocab_size, cfg.embed_dim, **kw)
        if cfg.mode == "continuous_concat" and cfg.effective_d_condition > 0:
            self.fc_condition = nn.Linear(2, cfg.effective_d_condition, **kw)
        if cfg.mode == "continuous_token":
            self.fc_condition = nn.ModuleList(
                nn.Linear(1, cfg.d_model, **kw) for _ in range(cfg.n_conditions)
            )
        self.enc_layers = nn.ModuleList(
            EncoderLayer(cfg.d_model, cfg.d_inner, cfg.n_head, cfg.max_seq, dtype,
                         self.device, self.attn_impl)
            for _ in range(cfg.n_layer)
        )
        if cfg.is_regression:
            self.fc = nn.Sequential(nn.Linear(cfg.d_model, cfg.output_size, **kw), nn.Tanh())
        else:
            self.fc = nn.Linear(cfg.d_model, cfg.vocab_size, **kw)
        table = torch.from_numpy(sinusoid_table(cfg.max_seq, cfg.d_model))
        self.register_buffer("pos_table", table.to(**kw), persistent=False)

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
        return self.embedding(tokens) * math.sqrt(self.config.embed_dim)

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
                condition: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens [B, T] int; condition [B, 2] float (ignored by none,
        discrete_token and regression). Returns logits [B, T + prefix,
        vocab], or [B, output_size] for regression."""
        x, causal, pad_keys = self._embed(tokens, condition)
        for layer in self.enc_layers:
            x = layer(x, pad_keys, causal)
        if self.config.is_regression:
            return self.fc(x[:, 0, :])
        return self.fc(x)

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
        x = self._scaled_embedding(token_t)
        if self.config.effective_d_condition > 0:
            x = torch.cat([x, cond_emb], dim=-1)
        x = x + self.pos_table[length - 1]
        for layer, k, v in zip(self.enc_layers, cache["k"], cache["v"]):
            x = layer.decode(x, k, v, length)
        return self.fc(x), {"k": cache["k"], "v": cache["v"], "length": length}
