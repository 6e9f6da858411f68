"""Configuration of the PyTorch port of the Product-Quantization-Tree engine.

A field-for-field copy of the JAX package's `PQTConfig` (same validation,
same JSON), so a config written by either package loads in the other.  It is
copied rather than imported because importing the JAX package's config runs
that package's `__init__`, which imports JAX.
"""

from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass(frozen=True)
class PQTConfig:
    """Shape + behavior of a two-level product-quantization tree.

    Mirrors the reference's template/CLI parameters:
      dim, p, c1, c2          -- tool_createdb.cpp:26-35
      line_parts (LP)         -- PerturbationProTree.cu:7665 (16) / test1B.cpp (32)
      hash_size               -- PerturbationProTree.hh:12 (4e8)
      k1_build                -- PerturbationProTree.cu:1237 (16)
      k1_query (W)            -- PerturbationProTree.cu:8185 (8)
      max_bins                -- PerturbationProTree.cu:8218 (4096)
      max_candidates (k2)     -- PerturbationProTree.cu:8185 (4096)
      max_vec_per_bin         -- caps 280/2048/2800 (PerturbationProTree.cu:2451,6208,4970)
    """

    # --- geometry -----------------------------------------------------------
    dim: int = 128          # vector dimensionality
    p: int = 4              # number of coarse parts (segments)
    c1: int = 16            # level-1 centroids per part
    c2: int = 16            # level-2 (refinement) centroids per (part, l1) cell
    line_parts: int = 16    # re-ranking sub-segments (LP); dim % line_parts == 0

    # --- database -----------------------------------------------------------
    hash_size: int = 1 << 22   # inverted-file slots; bin ids are taken mod this
    k1_build: int = 16         # L1 candidates considered while encoding the DB

    # --- query --------------------------------------------------------------
    k1_query: int = 8          # L1 candidates per part at query time (a.k.a. W)
    max_bins: int = 4096       # bins probed per query
    bin_enum_factor: int = 4   # enumerate factor*max_bins traversal entries, keep
                               # the first max_bins non-empty (reference maxTrials)
    max_candidates: int = 4096  # candidate vectors gathered per query (k2)
    max_vec_per_bin: int = 1024  # per-bin candidate cap during gather
    rerank_kernel: str = "auto"  # kept only so a config's JSON round-trips
                                 # with the JAX package; the port never reads
                                 # it (on CUDA the line re-rank always runs
                                 # the hand-written kernel)
    gather_mode: str = "rows"  # candidate collection from probed bins:
                               # "rows"  = per-row positions (one row gather
                               #           per candidate);
                               # "slabs" = contiguous slab_size-row slices
                               #           per bin (both are ported; both
                               #           gather with kernel H)
    slab_size: int = 32        # rows per slab in "slabs" mode
    pair_filter: bool = True   # prefilter enumerated bins with pair-code
                               # occupancy tables before the (expensive)
                               # per-bin count lookup; needs even p and
                               # part_radix**2 <= pair_filter_max_table
    pair_filter_slack: float = 1.5  # keep slack*max_bins pair-passing bins
                                    # before the true occupancy compaction
    pair_filter_max_table: int = 1 << 22  # max entries per pair table
    multidb_rank: str = "occurrence"  # multi-DB candidate ranking:
                                      # "occurrence" = groups-found-in desc,
                                      # then line distance (the reference's
                                      # getMultiKVectorIDs dedup semantics,
                                      # ProTree.cu:3243-3310);
                                      # "distance" = line distance only
    dedup_candidates: bool = False  # drop duplicate candidate ids before
                                    # top-k (hash collisions can probe the
                                    # same bin twice).  The reference's
                                    # getKVectorIDsKernel dedups, its Fast
                                    # production path does not
                                    # (PerturbationProTree.cu:3780,4307).
    # --- pair pipeline (see models/query.py) --------------------------------
    pipeline: str = "pair"     # "pair": exact per-pair ordering + 2D traversal
                               #   (one probe-table gather per bin, compact
                               #   payload) — the default;
                               # "parts": per-part ranks + p-dim traversal,
                               #   shaped like the reference's selectBinKernel
                               #   (ported, with the pair filter; also what
                               #   runs when p is not 2 or 4).
    pair_top_m: int = 256      # pair candidates kept per part-pair (stage 1)
    enum_width: int = 0        # bins enumerated before the occupancy probe
                               # (0 = bin_enum_factor * max_bins)
    enum_width_cap: int = 65536  # hard ceiling on enumerated bins per query
                                 # ((B, E) working arrays scale with it; raise
                                 # it for small batches if a huge single-shard
                                 # probe budget is really wanted)
    # --- payload layout ------------------------------------------------------
    payload_compact: bool = True  # 16-bit line codes (A,B in 4 bits each,
                                  # lambda in 8) when c1 <= 16: 40-byte rows
                                  # instead of 72 — row gathers are byte-priced
    lambda_bits: int = 16      # lambda codec width in the WIDE payload format
                               # (the compact format always uses 8)

    # --- training -----------------------------------------------------------
    kmeans_init: str = "kmeans++"  # "kmeans++" (better coverage) or "lbg"
                                   # (the reference's split ladder)
    kmeans_iters: int = 30       # max Lloyd iterations per LBG level
    kmeans_churn_tol: float = 2e-3   # stop when < this fraction changes assignment
    kmeans_move_tol: float = 5e-3    # ... and centroid movement below this
    split_epsilon: float = 0.02      # LBG split perturbation, RELATIVE to the
                                     # population's per-dim RMS spread (the
                                     # reference's absolute 1e-3 collapses on
                                     # un-normalized data; vectorquantizer.hpp)
    train_subsample: int = 0         # 0 = use all provided training vectors
    seed: int = 1234

    # --- numerics -----------------------------------------------------------
    dtype: str = "float32"       # accumulation dtype for distances
    compute_dtype: str = "float32"  # matmul input dtype ("bfloat16" to use MXU bf16)

    # ------------------------------------------------------------------------
    @property
    def vl(self) -> int:
        """Sub-vector length per coarse part (reference d_vl)."""
        return self.dim // self.p

    @property
    def lvl(self) -> int:
        """Sub-vector length per line (re-rank) part."""
        return self.dim // self.line_parts

    @property
    def lp_per_part(self) -> int:
        """Line-parts per coarse part (LP/P in cpu_version/treequantizer.hpp:901)."""
        return self.line_parts // self.p

    @property
    def n_bins_unhashed(self) -> int:
        """(c1*c2)^p before modulo hashing (ProTree.cu:1491)."""
        return (self.c1 * self.c2) ** self.p

    @property
    def part_radix(self) -> int:
        """Per-part code radix c1*c2."""
        return self.c1 * self.c2

    @property
    def pair_filter_enabled(self) -> bool:
        """Whether the pair-occupancy bin prefilter applies to this shape."""
        return (self.pair_filter and self.p % 2 == 0
                and self.part_radix ** 2 <= self.pair_filter_max_table)

    @property
    def payload_is_compact(self) -> bool:
        """Whether the 16-bit-per-line-part payload layout applies."""
        return self.payload_compact and self.c1 <= 16

    @property
    def effective_lambda_bits(self) -> int:
        return 8 if self.payload_is_compact else self.lambda_bits

    @property
    def pair_pipeline_enabled(self) -> bool:
        """Whether the pair enumeration pipeline applies to this shape."""
        return self.pipeline == "pair" and self.p in (2, 4)

    @property
    def effective_enum_width(self) -> int:
        e = self.enum_width or self.bin_enum_factor * self.max_bins
        if self.pair_pipeline_enabled:
            e = min(e, self.pair_top_m ** 2, self.enum_width_cap)
        return e

    def __post_init__(self):
        if self.dim % self.p != 0:
            raise ValueError(f"dim ({self.dim}) must be divisible by p ({self.p})")
        if self.dim % self.line_parts != 0:
            raise ValueError(
                f"dim ({self.dim}) must be divisible by line_parts ({self.line_parts})")
        if self.line_parts % self.p != 0:
            raise ValueError(
                f"line_parts ({self.line_parts}) must be divisible by p ({self.p})")
        if self.c1 > 256 or self.c2 > 256:
            raise ValueError("c1/c2 must fit in uint8 for line codes / bin codes")
        if self.k1_query > self.c1:
            raise ValueError("k1_query (W) must be <= c1")
        if self.k1_build > self.c1:
            raise ValueError("k1_build must be <= c1")
        if self.pipeline not in ("pair", "parts"):
            raise ValueError(f"unknown pipeline {self.pipeline!r}")
        if self.multidb_rank not in ("occurrence", "distance"):
            raise ValueError(f"unknown multidb_rank {self.multidb_rank!r}")
        if self.gather_mode not in ("rows", "slabs"):
            raise ValueError(f"unknown gather_mode {self.gather_mode!r}")
        if self.rerank_kernel not in ("auto", "xla", "pallas"):
            raise ValueError(f"unknown rerank_kernel {self.rerank_kernel!r}")
        if self.slab_size < 1:
            raise ValueError("slab_size must be positive")
        if self.lambda_bits not in (8, 16):
            raise ValueError("lambda_bits must be 8 or 16")
        if self.pipeline == "pair" and self.p in (2, 4):
            # NO SILENT CAPS: a probe budget the pair pipeline cannot
            # enumerate (pair_top_m**2 stage-1 survivors, enum_width_cap
            # working-set ceiling) must be called out at config time —
            # the r2 SIFT1B config silently served 65,536 of a requested
            # 524,288 bins.  For genuinely huge budgets, shard the database
            # (per-shard budgets add up) or raise pair_top_m/enum_width_cap.
            requested = self.enum_width or self.bin_enum_factor * self.max_bins
            cap = min(self.pair_top_m ** 2, self.enum_width_cap)
            if requested > cap or self.max_bins > cap:
                import warnings
                warnings.warn(
                    f"probe budget truncated: max_bins={self.max_bins}, "
                    f"enum request={requested}, but the pair pipeline can "
                    f"enumerate at most {cap} bins/query "
                    f"(pair_top_m**2={self.pair_top_m ** 2}, "
                    f"enum_width_cap={self.enum_width_cap}); queries will "
                    f"probe at most {min(cap, self.max_bins)} bins",
                    stacklevel=2)
        if (self.part_radix ** self.p > self.hash_size
                and self.hash_size & (self.hash_size - 1) != 0):
            # When bin ids must be hashed down, the table size must be a
            # power of two (ops/binning.py uses shift-based Fibonacci
            # hashing; the reference's `% 4e8` is replaced by this).
            raise ValueError(
                "hash_size must be a power of two when (c1*c2)**p exceeds it")

    # --- (de)serialization --------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "PQTConfig":
        return cls(**json.loads(s))

    def replace(self, **kw) -> "PQTConfig":
        return dataclasses.replace(self, **kw)


# De-facto reference operating points (BASELINE.md).
SIFT1M_CONFIG = PQTConfig(dim=128, p=4, c1=16, c2=16, line_parts=16,
                          k1_build=16, k1_query=8, max_bins=4096,
                          max_candidates=4096, hash_size=1 << 22)

# hash_size: the reference uses HASH_SIZE = 4e8 (PerturbationProTree.hh:12);
# our shift-based hashing needs a power of two, so we use 2^29 ~= 5.4e8.
# Probe budget: the reference's maxBins = 64*8192 on ONE GPU
# (PerturbationProTree.cu:8604-8639) maps to 8192 bins PER SHARD across a
# 64-way hash-range-sharded mesh (parallel/sharded.py) — per-shard budgets
# add up, so the GLOBAL probe budget matches the reference's without any
# single device enumerating half a million bins.  A single-chip SIFT1B run
# should lower hash_size to fit HBM and accept the per-chip budget.
SIFT1B_CONFIG = PQTConfig(dim=128, p=4, c1=16, c2=16, line_parts=32,
                          k1_build=16, k1_query=16, max_bins=8192,
                          max_candidates=8192, pair_top_m=256,
                          enum_width=32768, hash_size=1 << 29)

GIST1M_CONFIG = PQTConfig(dim=960, p=4, c1=16, c2=16, line_parts=32,
                          k1_build=16, k1_query=8, max_bins=4096,
                          max_candidates=4096, hash_size=1 << 22)
