"""Multi-probe traversal sequences of the parts and pair pipelines.

Numpy copies of `static_sequence` and `pair_sequence` from
pqt_tpu/ops/distseq.py (the anisotropic family of the BIG pipeline is not
ported yet).
"""

from __future__ import annotations

import functools

import numpy as np


NUM_DISTSEQ = 65536       # longest static sequence (ProTree.hh:9)


@functools.lru_cache(maxsize=32)
def static_sequence(base: int, parts: int, length: int = NUM_DISTSEQ,
                    key: str = "sqrt") -> np.ndarray:
    """Rank tuples of {0..base-1}^parts in approximately increasing order
    of sum(sqrt(rank)) ("sqrt"), sum(rank^2) ("sqnorm") or sum(rank)
    ("linear"), ties in enumeration order (part 0 varies fastest).  base is
    clamped to 16 as in the reference (ProTree.cu:135).  Returns (length,
    parts) int32, zero-padded past base**parts.
    """
    base = min(base, 16)
    n = base ** parts
    idx = np.arange(n, dtype=np.int64)
    digits = np.empty((n, parts), dtype=np.int64)
    denom = 1
    for j in range(parts):
        digits[:, j] = (idx // denom) % base
        denom *= base
    if key == "sqrt":
        score = np.sqrt(digits.astype(np.float64)).sum(axis=1)
    elif key == "sqnorm":
        score = (digits.astype(np.float64) ** 2).sum(axis=1)
    elif key == "linear":
        score = digits.astype(np.float64).sum(axis=1)
    else:
        raise ValueError(f"unknown key {key!r}")
    order = np.argsort(score, kind="stable")
    out = np.zeros((length, parts), dtype=np.int32)
    take = min(n, length)
    out[:take] = digits[order[:take]].astype(np.int32)
    out.flags.writeable = False           # shared by the cache
    return out


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
