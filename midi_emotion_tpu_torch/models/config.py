"""Model configuration.

Replaces the reference's argparse-dict-as-config
(the reference's ``src/models/build_model.py:14-24``) with a typed, frozen
dataclass. ``from_reference_dict`` accepts the exact dict the reference
persists as ``model_config.pt`` (vars(args) from config.py), so converted
PyTorch checkpoints carry their config over unchanged.

A copy of ``midi_emotion_tpu/models/config.py``, unchanged but for this note and
the reference's paths, given from its repository root:
the torch port keeps its own copies and imports nothing of the JAX
package.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

MODES = ("none", "discrete_token", "continuous_concat", "continuous_token")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int
    mode: str = "continuous_concat"  # one of MODES, or "regression"
    n_layer: int = 20
    n_head: int = 16
    d_model: int = 768
    d_inner: int = 3072
    d_condition: int = 192  # used only by continuous_concat
    max_seq: int = 2048
    dropout: float = 0.1
    pad_id: int = 0
    output_size: int = 2  # regression head width
    n_conditions: int = 2  # continuous_token prefix slots
    remat: bool = True  # rematerialize encoder layers in the bwd pass
    # what the bwd pass may keep from the fwd: "full" = keep nothing
    # (recompute the whole layer), "dots" = keep matmul outputs without
    # batch dims (QKV/FFN Dense results) and recompute only the O(T^2)
    # attention internals -- the [T, T] score/prob tensors are the memory
    # problem, the Dense results are the FLOPs, so "dots" buys back most of
    # the remat recompute while still bounding activation memory
    remat_policy: str = "dots"

    @property
    def effective_d_condition(self) -> int:
        """The reference zeroes d_condition outside continuous_concat
        (config.py:120-121, music_multi.py:54)."""
        if self.mode == "continuous_concat":
            return max(0, self.d_condition)
        return 0

    @property
    def embed_dim(self) -> int:
        """Token-embedding width: d_model minus the condition channel block
        (music_multi.py:57-59)."""
        return self.d_model - self.effective_d_condition

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_head

    @property
    def is_regression(self) -> bool:
        return self.mode == "regression"

    @property
    def seq_prefix(self) -> int:
        """Extra sequence positions prepended to the token stream by the
        model itself (continuous_token's condition slots,
        music_continuous_token.py:91-97)."""
        return self.n_conditions if self.mode == "continuous_token" else 0

    def validate(self) -> "ModelConfig":
        assert self.mode in MODES or self.mode == "regression", self.mode
        assert self.d_model % self.n_head == 0
        assert self.remat_policy in ("full", "dots"), self.remat_policy
        return self

    # ---- serialization ---------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "ModelConfig":
        return cls(**json.loads(s)).validate()

    @classmethod
    def from_reference_dict(cls, d: dict, mode: Optional[str] = None) -> "ModelConfig":
        """Build from a reference ``model_config.pt`` dict (vars(args)).

        Mirrors build_model.py:14-41: regression forces the regression
        model (with n_layer from the dict -- config.py:128-130 already set
        it to 8); conditioning selects the mode; max_seq/pad are fixed."""
        if mode is None:
            mode = "regression" if d.get("regression", False) else d["conditioning"]
        return cls(
            vocab_size=d["vocab_size"],
            mode=mode,
            n_layer=d["n_layer"],
            n_head=d["n_head"],
            d_model=d["d_model"],
            d_inner=d["d_inner"],
            d_condition=d.get("d_condition", -1),
            max_seq=2048,
            dropout=d["dropout"],
            pad_id=0,
        ).validate()

    def to_reference_dict(self) -> dict:
        """Inverse of from_reference_dict (subset round-trip)."""
        return {
            "vocab_size": self.vocab_size,
            "conditioning": self.mode if self.mode in MODES else "none",
            "regression": self.is_regression,
            "n_layer": self.n_layer,
            "n_head": self.n_head,
            "d_model": self.d_model,
            "d_inner": self.d_inner,
            "d_condition": self.d_condition,
            "dropout": self.dropout,
            "overwrite_dropout": False,
        }
