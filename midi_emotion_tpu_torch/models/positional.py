"""Positional encoding.

The reference uses a *nonstandard* sinusoid (music_multi.py:137-147): every
channel uses sin (never cos), odd channels get both a frequency tweak
``exp(log(10000)/d * (i % 2))`` and a pi/2 phase shift. Checkpoint parity
requires reproducing it bit-for-bit, so we evaluate the same float64
expression with numpy and cast, exactly like the reference
(DynamicPositionEmbedding, music_multi.py:150-164).

A copy of ``midi_emotion_tpu/models/positional.py``, unchanged but for this note:
the torch port keeps its own copies and imports nothing of the JAX
package.
"""

from __future__ import annotations

import numpy as np


def sinusoid_table(max_seq: int, d: int) -> np.ndarray:
    """[max_seq, d] float32 positional table."""
    pos = np.arange(max_seq, dtype=np.float64)[:, None]
    i = np.arange(d, dtype=np.float64)[None, :]
    parity = i % 2
    rate = np.exp(-np.log(10000.0) * i / d) * np.exp(np.log(10000.0) / d * parity)
    table = np.sin(pos * rate + 0.5 * np.pi * parity)
    return table.astype(np.float32)
