"""Multi-probe traversal sequence of the pair pipeline.

A numpy copy of `pair_sequence` from pqt_tpu/ops/distseq.py (the sequences
of the parts and BIG pipelines are not ported yet).
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=16)
def pair_sequence(m: int, length: int, key: str = "sqrt") -> np.ndarray:
    """Traversal over rank pairs {0..m-1}^2 in approximately increasing order
    of sqrt(x) + sqrt(y) (or x + y with key="linear"), ties in enumeration
    order.  Returns (length, 2) int32, zero-padded past m*m.
    """
    n = m * m
    i = np.arange(n, dtype=np.int64)
    x = i // m
    y = i % m
    if key == "sqrt":
        score = np.sqrt(x.astype(np.float64)) + np.sqrt(y.astype(np.float64))
    elif key == "linear":
        score = (x + y).astype(np.float64)
    else:
        raise ValueError(f"unknown key {key!r}")
    order = np.argsort(score, kind="stable")
    out = np.zeros((length, 2), dtype=np.int32)
    take = min(n, length)
    out[:take, 0] = x[order[:take]].astype(np.int32)
    out[:take, 1] = y[order[:take]].astype(np.int32)
    out.flags.writeable = False           # shared by the cache
    return out
