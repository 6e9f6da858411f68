"""Bin ids, compaction of probed bins, and candidate positions.

Port of pqt_tpu/ops/binning.py (the parts this slice runs).

  * bin id: per-part codes combined mixed-radix, part 0 most significant,
    when (c1*c2)^p fits the table; otherwise each part's code is mixed with
    an odd multiplier and the sum is Fibonacci-hashed down to log2(hash_size)
    bits.  The JAX package does this in uint32 with wraparound; here it runs
    in int64 masked to 32 bits, with the multiplications split so that no
    product exceeds 2^49 (`mul_u32`), giving the same bits.
  * compaction: a stable partition of the non-empty bins to the front,
    placed by an exclusive prefix sum (kernel B) instead of the TPU's sort.
  * candidate positions: a searchsorted over the inclusive prefix (kernel B)
    of the capped per-bin counts, instead of the TPU's sort-merge; slab
    windows the same way at slab granularity, their rows' positions
    (`slab_positions`, which the line re-rank reads by), and the slab rows
    by the row gather (kernel H) with a span.
"""

from __future__ import annotations

import torch

from pqt_tpu_torch.ops.cuda.gather import gather_rows
from pqt_tpu_torch.ops.cuda.primitives import block_scan

# Knuth multiplicative-hash constants (odd, derived from the golden ratio).
MIX_MULTIPLIERS = (2654435761, 2246822519, 3266489917, 668265263,
                   374761393, 3812015801, 2034678193, 1669595009)
_FINAL_MULTIPLIER = 2654435761
_U32 = 0xFFFFFFFF


def mul_u32(acc: torch.Tensor, m: int) -> torch.Tensor:
    """(acc * m) mod 2^32 for acc in [0, 2^32) held in int64, without
    overflowing int64: m is split into 16-bit halves."""
    lo, hi = m & 0xFFFF, m >> 16
    return (acc * lo + (((acc * hi) & 0xFFFF) << 16)) & _U32


def exact_bin_ids(codes: torch.Tensor, part_radix: int) -> torch.Tensor:
    """Mixed-radix bin id, part 0 most significant; codes (..., p).  Valid
    only when part_radix ** p fits int32."""
    out = codes[..., 0].to(torch.int32)
    for j in range(1, codes.shape[-1]):
        out = out * part_radix + codes[..., j].to(torch.int32)
    return out


def is_exact(part_radix: int, p: int, hash_size: int) -> bool:
    """Whether bin ids are the unhashed mixed-radix ids."""
    return part_radix ** p <= hash_size and part_radix ** p <= 2 ** 31


def finalize_hash(acc: torch.Tensor, hash_size: int) -> torch.Tensor:
    """uint32 pre-image (int64 tensor) -> int32 slot of a power-of-two
    table."""
    shift = 32 - (hash_size.bit_length() - 1)
    return (mul_u32(acc, _FINAL_MULTIPLIER) >> shift).to(torch.int32)


def hashed_bin_ids(codes: torch.Tensor, part_radix: int,
                   hash_size: int) -> torch.Tensor:
    """Bin id reduced into a power-of-two hash table of `hash_size` slots;
    exact (no collisions) when the unhashed space fits."""
    if hash_size & (hash_size - 1):
        raise ValueError("hash_size must be a power of two")
    p = codes.shape[-1]
    if is_exact(part_radix, p, hash_size):
        return exact_bin_ids(codes, part_radix)
    u = codes.to(torch.int64)
    acc = torch.zeros(codes.shape[:-1], dtype=torch.int64, device=codes.device)
    for j in range(p):
        acc = (acc + u[..., j] * MIX_MULTIPLIERS[j % len(MIX_MULTIPLIERS)]) \
            & _U32
    return finalize_hash(acc, hash_size)


def compact_nonempty_bins(bin_ids: torch.Tensor, counts: torch.Tensor,
                          max_bins: int):
    """Keep the first `max_bins` non-empty bins per row, preserving order.

    bin_ids, counts: (B, E).  The non-empty entries move to the front and
    the empty ones follow, each in their original order -- exactly what the
    JAX package's stable sort keyed on (position if non-empty else E) gives.
    Returns (bins (B, max_bins), counts (B, max_bins)).
    """
    B, E = counts.shape
    keep = (counts > 0).to(torch.int32)
    before = block_scan(keep, exclusive=True)        # kept entries before
    total = before[:, -1:] + keep[:, -1:]
    pos = torch.arange(E, dtype=torch.int32, device=counts.device)
    dest = torch.where(keep > 0, before, total + pos - before).to(torch.int64)
    bins_s = torch.empty_like(bin_ids).scatter_(1, dest, bin_ids)
    counts_s = torch.empty_like(counts).scatter_(1, dest, counts)
    return bins_s[:, :max_bins], counts_s[:, :max_bins]


def gather_candidates(prefix_of_bins: torch.Tensor,
                      counts_of_bins: torch.Tensor, max_candidates: int,
                      max_vec_per_bin: int):
    """Flatten per-query probed bins into a fixed-size candidate list.

    prefix_of_bins, counts_of_bins: (B, nb) int32 CSR start and occupancy of
    each probed bin.  Candidate j belongs to the bin whose interval of the
    capped counts' prefix contains j; its CSR position is that bin's start
    plus the offset inside it.  Returns (positions (B, K) int32, valid
    (B, K) bool), K = max_candidates.  Past the last candidate the positions
    repeat the JAX package's values (slot + the last occupied bin's offset;
    the slot itself when no bin is occupied), so the two agree everywhere.
    """
    B, nb = counts_of_bins.shape
    capped = torch.clamp_max(counts_of_bins, max_vec_per_bin)
    ends = block_scan(capped)                                # inclusive
    delta = prefix_of_bins - (ends - capped)                 # prefix - start
    total = ends[:, -1:]
    grid = torch.arange(max_candidates, dtype=torch.int32,
                        device=counts_of_bins.device)[None, :]
    slot = torch.clamp_min(torch.minimum(grid, total - 1), 0)
    owner = torch.searchsorted(ends, slot.expand(B, -1).contiguous(),
                               right=True)
    owner = torch.clamp_max(owner, nb - 1)
    shift = torch.where(total > 0, torch.gather(delta, 1, owner), 0)
    return grid + shift, grid < total


def gather_slabs(prefix_of_bins: torch.Tensor, counts_of_bins: torch.Tensor,
                 n_slabs: int, slab_size: int, max_vec_per_bin: int):
    """Fixed-size slab windows over the probed bins' CSR rows.

    Each probed bin contributes ceil(min(count, cap) / S) windows of S
    consecutive rows, and windows fill in bin order up to `n_slabs`.  Slab t
    belongs to the bin whose interval of the inclusive prefix (kernel B) of
    the per-bin slab counts contains t.  Returns (slab_starts (B, n_slabs)
    int32 CSR positions, slab_valid (B, n_slabs) int32 valid rows in each
    window, in [0, S]); slabs past the last window have start 0 and no
    valid row, as in the JAX package.
    """
    B, nb = counts_of_bins.shape
    S = slab_size
    capped = torch.clamp_max(counts_of_bins, max_vec_per_bin)
    spb = (capped + (S - 1)) // S                            # slabs per bin
    ends = block_scan(spb)                                   # inclusive
    total = ends[:, -1:]
    grid = torch.arange(n_slabs, dtype=torch.int32,
                        device=counts_of_bins.device)[None, :]
    owner = torch.searchsorted(ends, grid.expand(B, -1).contiguous(),
                               right=True)
    owner = torch.clamp_max(owner, nb - 1)
    t_rel = grid - torch.gather(ends - spb, 1, owner)        # slab in its bin
    starts = torch.gather(prefix_of_bins, 1, owner) + t_rel * S
    valid = torch.clamp(torch.gather(capped, 1, owner) - t_rel * S, 0, S)
    in_budget = grid < total
    return (torch.where(in_budget, starts, 0),
            torch.where(in_budget, valid, 0))


def slab_positions(n_rows: int, slab_starts: torch.Tensor,
                   slab_valid: torch.Tensor, slab_size: int):
    """Every row of every slab window, as `fetch_slab_rows` places them:
    (positions (B, T*S) int32 CSR rows, valid (B, T*S) bool).

    A window that would run past the payload's end (n_rows rows) is shifted
    left to end there, and its validity window shifts with it, so the valid
    rows are the same rows.  With a payload shorter than a slab, the rows
    past its end lie outside it and are invalid.
    """
    B, T = slab_starts.shape
    S = slab_size
    eff = torch.clamp_max(slab_starts, max(n_rows - S, 0))
    shift = slab_starts - eff                                # >= 0
    i = torch.arange(S, dtype=torch.int32, device=slab_starts.device)
    valid = (i >= shift[..., None]) & (i < (shift + slab_valid)[..., None])
    return (eff[..., None] + i).reshape(B, T * S), valid.reshape(B, T * S)


def fetch_slab_rows(payload: torch.Tensor, slab_starts: torch.Tensor,
                    slab_valid: torch.Tensor, slab_size: int):
    """The (S, W) payload window of every slab, as rows + validity.

    payload (N, W); slab_starts, slab_valid (B, T).  Returns (rows (B, T*S,
    W), valid (B, T*S) bool), windows placed as `slab_positions` places
    them; a payload shorter than a slab is padded with zero rows.
    """
    B, T = slab_starts.shape
    N, W = payload.shape
    S = slab_size
    eff = torch.clamp_max(slab_starts, max(N - S, 0))
    rows = gather_rows(payload, eff.contiguous(), span=min(S, N)).reshape(
        B, T, min(S, N), W)
    if S > N:                               # a payload shorter than a slab
        rows = torch.nn.functional.pad(rows, (0, 0, 0, S - N))
    _, valid = slab_positions(N, slab_starts, slab_valid, S)
    return rows.reshape(B, T * S, W), valid
