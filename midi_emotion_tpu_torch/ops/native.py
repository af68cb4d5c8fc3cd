"""ctypes bindings for the native (C++) tokenizer core.

Builds ``native/tokenizer.cc`` on first use with g++ (no pybind11 in this
environment; plain C ABI + ctypes). Falls back gracefully: callers check
``available()`` and use the vectorized numpy codec otherwise. Semantics are
cross-checked bit-for-bit against the numpy codec in tests/test_native.py.

A copy of ``midi_emotion_tpu/ops/native.py``, unchanged but for this note:
the torch port keeps its own copies and imports nothing of the JAX
package.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "native", "tokenizer.cc")
_LIB_PATH = os.path.join(os.path.dirname(_SRC), "libmetokenizer.so")
_lock = threading.Lock()
_lib = None
_failed = False


def _load():
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        try:
            if not os.path.exists(_LIB_PATH) or (
                os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC)
            ):
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-o", _LIB_PATH, _SRC],
                    check=True, capture_output=True,
                )
            lib = ctypes.CDLL(_LIB_PATH)
            lib.me_tokenize_events.restype = ctypes.c_int64
            lib.me_tokenize_events.argtypes = [
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int16),
                ctypes.POINTER(ctypes.c_int16),
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_int16),
                ctypes.c_int64,
            ]
            lib.me_tokenize_bars.restype = ctypes.c_int64
            lib.me_tokenize_bars.argtypes = [
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_int16),
                ctypes.POINTER(ctypes.c_int16),
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_int16),
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64,
            ]
            _lib = lib
        except Exception:
            _failed = True
            _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def tokenize_events(
    times_sec: np.ndarray,
    events: np.ndarray,
    values: np.ndarray,
    is_special: np.ndarray,
    max_timeshift: int = 1000,
    timeshift_step: int = 8,
) -> np.ndarray:
    """Native equivalent of codec.timed_events_to_tuples."""
    lib = _load()
    assert lib is not None
    times_ms = np.rint(np.asarray(times_sec, np.float64) * 1000).astype(np.int64)
    events = np.ascontiguousarray(events, np.int16)
    values = np.ascontiguousarray(values, np.int16)
    special = np.ascontiguousarray(is_special, np.uint8)
    n = len(times_ms)
    cap = n * 4 + 16
    while True:
        out = np.empty((cap, 2), np.int16)
        m = lib.me_tokenize_events(
            n, _ptr(times_ms, ctypes.c_int64), _ptr(events, ctypes.c_int16),
            _ptr(values, ctypes.c_int16), _ptr(special, ctypes.c_uint8),
            max_timeshift, timeshift_step, _ptr(out, ctypes.c_int16), cap,
        )
        if m >= 0:
            return out[:m]
        cap *= 4


def tokenize_bars(
    times_sec: np.ndarray,
    events: np.ndarray,
    values: np.ndarray,
    bar_times: np.ndarray,
    max_timeshift: int = 1000,
    timeshift_step: int = 8,
) -> Optional[List[np.ndarray]]:
    """Native bar segmentation (codec.notes_to_bars core). Returns None on
    failure, matching the reference's bare-except behavior."""
    lib = _load()
    assert lib is not None
    times = np.ascontiguousarray(np.round(times_sec, 6), np.float64)
    events = np.ascontiguousarray(events, np.int16)
    values = np.ascontiguousarray(values, np.int16)
    bt = [round(float(b), 6) for b in bar_times]
    if len(bt) < 2:
        return None
    bt.append(bt[-1] + (bt[-1] - bt[-2]))
    bt.append(bt[-1] + (bt[-1] - bt[-2]))
    bt_arr = np.ascontiguousarray(bt, np.float64)
    n = len(times)
    cap = n * 6 + 64
    max_bars = len(bt_arr) + 8
    while True:
        out = np.empty((cap, 2), np.int16)
        lens = np.zeros(max_bars, np.int64)
        r = lib.me_tokenize_bars(
            n, _ptr(times, ctypes.c_double), _ptr(events, ctypes.c_int16),
            _ptr(values, ctypes.c_int16), len(bt_arr),
            _ptr(bt_arr, ctypes.c_double), max_timeshift, timeshift_step,
            _ptr(out, ctypes.c_int16), cap, _ptr(lens, ctypes.c_int64),
            max_bars,
        )
        if r == -2:
            return None  # ran past the bar table (reference: except -> None)
        if r >= 0:
            bars = []
            off = 0
            for i in range(int(r)):
                bars.append(out[off : off + int(lens[i])].copy())
                off += int(lens[i])
            return bars
        cap *= 4
