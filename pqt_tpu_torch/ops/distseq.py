"""Multi-probe traversal sequences.

Numpy copies of pqt_tpu/ops/distseq.py: `static_sequence` (the parts
pipeline), `pair_sequence` (the pair pipeline), and the anisotropic family
of the reference's BIG path, `aniso_2d_sequences` with its `slope_index`
(numpy or torch), which no pipeline of either package calls.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


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


NUM_ANISO_DIR = 10        # ProTree.hh:12
ANISO_BASE = 1.2          # ProTree.hh:13


@functools.lru_cache(maxsize=8)
def aniso_2d_sequences(base: int, length: int = NUM_DISTSEQ,
                       n_dir: int = NUM_ANISO_DIR,
                       aniso_base: float = ANISO_BASE) -> np.ndarray:
    """The anisotropic 2D traversal family of the reference's BIG path: for
    each of n_dir slopes s = (0.9 * aniso_base)^(d - n_dir // 2), the pairs
    of {0..base-1}^2 sorted by x^0.8 + s * y^0.8, ties in enumeration order.
    Here x = i % base and y = i // base -- the reverse of pair_sequence's
    roles.  No pipeline uses it (the BIG path orders pairs exactly), in
    either package.  Returns (n_dir, length, 2) int32 ([..., 0] = x), zero-
    padded past base^2.
    """
    n = base * base
    i = np.arange(n, dtype=np.int64)
    x = (i % base).astype(np.float64)
    y = (i // base).astype(np.float64)
    out = np.zeros((n_dir, length, 2), dtype=np.int32)
    take = min(n, length)
    for d in range(n_dir):
        s = (0.9 * aniso_base) ** (d - n_dir // 2)
        order = np.argsort(x ** 0.8 + s * y ** 0.8, kind="stable")
        out[d, :take, 0] = x[order[:take]].astype(np.int32)
        out[d, :take, 1] = y[order[:take]].astype(np.int32)
    out.flags.writeable = False           # shared by the cache
    return out


def slope_index(dx, dy, n_dir: int = NUM_ANISO_DIR,
                aniso_base: float = ANISO_BASE):
    """The anisotropic sequence whose slope best matches dy / dx:
    clip(round(log_base(dy / dx)) + n_dir // 2, 0, n_dir - 1) as int32,
    rounding half to even.  Takes numpy arrays or torch tensors (and
    returns the same kind), in their own float type; the constants are
    Python floats, so float32 inputs stay float32, as in the JAX package."""
    log_base = float(np.log(aniso_base))
    if isinstance(dx, torch.Tensor):
        ratio = dy / torch.clamp_min(dx, 1e-12)
        idx = torch.round(torch.log(ratio) / log_base) + n_dir // 2
        return torch.clamp(idx, 0, n_dir - 1).to(torch.int32)
    ratio = dy / np.maximum(dx, 1e-12)
    with np.errstate(divide="ignore"):       # dy = 0: log 0 = -inf, index 0
        idx = np.round(np.log(ratio) / log_base) + n_dir // 2
    return np.clip(idx, 0, n_dir - 1).astype(np.int32)
