"""Database build: encoding, payload packing, and the CSR inverted file.

Port of the in-memory build of pqt_tpu/models/db.py:

  1. per part, the best (l1, l2) over the k1_build best L1 cells x all c2
     refinements -> per-part code l1*c2 + l2;
  2. the bin id, mixed-radix or hashed into the table;
  3. per (vector, line part) the packed line code, and the t3 term;
  4. the CSR inverted file: a bin histogram, its prefix (kernel B), and a
     stable sort by bin id that lays the payload rows out in CSR order, so
     ids stay ascending inside every bin.

The payload is ONE int32 row per vector in CSR order: column 0 the original
id, column 1 t3's float bits, then the line codes -- wide (one uint32 per
line part, A | B << 8 | lambda_u16 << 16) or, when c1 <= 16, compact (16
bits per line part, A | B << 4 | lambda_u8 << 8, two parts per column).
The chunked and out-of-core builders are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from pqt_tpu_torch.config import PQTConfig
from pqt_tpu_torch.models.tree import (PQTree, level1_tables, level2_tables,
                                       line_tables)
from pqt_tpu_torch.ops import binning, linecodes
from pqt_tpu_torch.ops.cuda.primitives import bitonic_topk, block_scan
from pqt_tpu_torch.utils.device import resolve_device


class PQTDatabase(NamedTuple):
    """Built database: tensors on one device."""
    prefix: torch.Tensor        # (hash_size,) int32 CSR start of each bin
    counts: torch.Tensor        # (hash_size,) int32
    payload: torch.Tensor       # (n, payload_width(cfg)) int32, CSR order
    pair_occ: Optional[torch.Tensor]  # (p//2, part_radix**2) uint8: 1 iff a
                                      # vector carries that (part 2j, 2j+1)
                                      # code pair
    vectors: Optional[torch.Tensor]   # (n, dim) raw vectors by original id
    prefix2: Optional[torch.Tensor] = None    # (hash_size, 2) int32 (start,
                                              # end): the probe table
    vectors_csr: Optional[torch.Tensor] = None  # (n, dim) raw vectors in CSR
                                                # order (out-of-core builds)

    @property
    def n_vectors(self) -> int:
        return self.payload.shape[0]

    @property
    def ids(self) -> torch.Tensor:
        """(n,) int32 original vector id at each CSR position."""
        return self.payload[:, 0]

    @property
    def t3(self) -> torch.Tensor:
        """(n,) float32 query-independent line-code term, CSR order."""
        return self.payload[:, 1].contiguous().view(torch.float32)

    @classmethod
    def from_numpy(cls, prefix, counts, payload, pair_occ=None, vectors=None,
                   prefix2=None, vectors_csr=None,
                   device="cuda") -> "PQTDatabase":
        """A database from numpy arrays (for example the JAX package's
        leaves through np.asarray); prefix2 is derived when absent."""
        dev = resolve_device(device)

        def put(a):
            return None if a is None else torch.as_tensor(np.array(a),
                                                          device=dev)

        prefix, counts = put(prefix), put(counts)
        if prefix2 is None:
            prefix2_t = torch.stack([prefix, prefix + counts], dim=1)
        else:
            prefix2_t = put(prefix2)
        return cls(prefix=prefix, counts=counts, payload=put(payload),
                   pair_occ=put(pair_occ), vectors=put(vectors),
                   prefix2=prefix2_t, vectors_csr=put(vectors_csr))


def payload_width(cfg: PQTConfig) -> int:
    """Number of int32 columns in a payload row under `cfg`'s layout."""
    lp = cfg.line_parts
    return 2 + ((lp + 1) // 2 if cfg.payload_is_compact else lp)


def _as_int32_bits(u: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> int32 tensor of the same bits."""
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32)


def pack_payload_device(cfg: PQTConfig, ids: torch.Tensor,
                        codes: torch.Tensor, t3: torch.Tensor) -> torch.Tensor:
    """ids (n,) int32, codes (n, lp) wide-layout packed codes (int64), t3
    (n,) float32 -> (n, payload_width(cfg)) int32 payload rows."""
    t3_bits = t3.to(torch.float32).contiguous().view(torch.int32)
    if not cfg.payload_is_compact:
        cols = _as_int32_bits(codes)
    else:
        n, lp = codes.shape
        a = codes & 0xF
        b = (codes >> 8) & 0xF
        lam8 = (codes >> 24) & 0xFF
        part16 = a | (b << 4) | (lam8 << 8)
        if lp % 2:
            part16 = torch.cat([part16, torch.zeros_like(part16[:, :1])], 1)
        cols = _as_int32_bits(part16[:, 0::2] | (part16[:, 1::2] << 16))
    return torch.cat([ids.to(torch.int32)[:, None], t3_bits[:, None], cols],
                     dim=1)


def unpack_payload_cfg(cfg: PQTConfig, rows: torch.Tensor):
    """Payload rows -> (ids, a_idx, b_idx (..., lp) int32, lam (..., lp)
    float32, t3) under either layout."""
    return linecodes.unpack_payload_rows(rows, cfg.line_parts,
                                         cfg.payload_is_compact)


def encode_part_codes(cfg: PQTConfig, tree: PQTree,
                      x: torch.Tensor) -> torch.Tensor:
    """Per-part codes l1*c2 + l2 (n, p) int64: per part, the least level-2
    distance over the k1_build best L1 cells and all c2 refinements (first
    minimum on ties)."""
    d2 = level2_tables(cfg, tree, x)                     # (n, p, c1, c2)
    n, p = d2.shape[:2]
    if cfg.k1_build >= cfg.c1:
        cand = d2
        l1_of_cand = torch.arange(cfg.c1, device=x.device).expand(n, p,
                                                                  cfg.c1)
    else:
        d1 = level1_tables(cfg, tree, x)                 # (n, p, c1)
        _, l1_idx = bitonic_topk(d1.reshape(n * p, cfg.c1), cfg.k1_build)
        l1_of_cand = l1_idx.to(torch.int64).reshape(n, p, cfg.k1_build)
        cand = torch.gather(d2, 2, l1_of_cand[..., None].expand(
            n, p, cfg.k1_build, cfg.c2))
    best = torch.argmin(cand.reshape(n, p, -1), dim=-1)  # (n, p)
    best_l1 = torch.gather(l1_of_cand, 2, (best // cfg.c2)[..., None])[..., 0]
    return best_l1 * cfg.c2 + best % cfg.c2


def encode_bins(cfg: PQTConfig, tree: PQTree, x: torch.Tensor) -> torch.Tensor:
    """Bin id (n,) int32 of each vector."""
    return binning.hashed_bin_ids(encode_part_codes(cfg, tree, x),
                                  cfg.part_radix, cfg.hash_size)


def encode_line_codes(cfg: PQTConfig, tree: PQTree, x: torch.Tensor):
    """((n, line_parts) packed codes, (n,) float32 t3), lambda quantized to
    the payload's codec width so t3 agrees with the stored codes."""
    return linecodes.build_line_codes(line_tables(cfg, tree, x),
                                      tree.pair_dists,
                                      lambda_bits=cfg.effective_lambda_bits)


def _encode_chunk(cfg: PQTConfig, tree: PQTree, chunk: torch.Tensor,
                  id_offset: int):
    """Encode one chunk: (bins (C,) int32, part codes (C, p), payload rows
    (C, payload_width))."""
    chunk = chunk.to(torch.float32)
    pc = encode_part_codes(cfg, tree, chunk)
    bins = binning.hashed_bin_ids(pc, cfg.part_radix, cfg.hash_size)
    codes, t3 = encode_line_codes(cfg, tree, chunk)
    ids = id_offset + torch.arange(chunk.shape[0], dtype=torch.int32,
                                   device=chunk.device)
    return bins, pc, pack_payload_device(cfg, ids, codes, t3)


def _assemble_device(cfg: PQTConfig, bins: torch.Tensor,
                     packed: torch.Tensor):
    """CSR assembly: histogram, prefix (kernel B over one long row), stable
    sort by bin, row gather.  Returns (prefix, counts, prefix2, payload)."""
    counts = torch.bincount(bins, minlength=cfg.hash_size).to(torch.int32)
    ends = block_scan(counts[None, :])[0]
    prefix = ends - counts
    order = torch.sort(bins, stable=True).indices
    return prefix, counts, torch.stack([prefix, ends], dim=1), packed[order]


def _pair_occ_device(cfg: PQTConfig, part_codes: torch.Tensor,
                     pair_occ: torch.Tensor) -> torch.Tensor:
    """Mark this chunk's (part 2j, 2j+1) code pairs in the occupancy map
    (in place)."""
    r = cfg.part_radix
    for j in range(cfg.p // 2):
        pair_occ[j, part_codes[:, 2 * j] * r + part_codes[:, 2 * j + 1]] = 1
    return pair_occ


def build_database(cfg: PQTConfig, tree: PQTree, data,
                   keep_vectors: bool = False, encode_chunk: int = 65536,
                   device="cuda") -> PQTDatabase:
    """Single-shot database build on `device` (the tree must live there).

    data: (n, dim) array-like; uint8 data is uploaded raw and cast on the
    device chunk by chunk.  With keep_vectors the raw vectors stay on the
    device, by original id, for exact re-rank.
    """
    dev = resolve_device(device)
    if tree.cb1.device != dev:
        raise ValueError(f"tree is on {tree.cb1.device}, build device is "
                         f"{dev}")
    data = np.asarray(data)
    if data.dtype not in (np.uint8, np.float32):
        data = data.astype(np.float32)
    n = data.shape[0]
    if n > np.iinfo(np.int32).max:
        raise NotImplementedError("CSR positions exceed int32; shard the "
                                  "build")
    pair_occ = (torch.zeros((cfg.p // 2, cfg.part_radix ** 2),
                            dtype=torch.uint8, device=dev)
                if cfg.pair_filter_enabled else None)
    vectors = torch.as_tensor(data, device=dev) if keep_vectors else None
    bins_l, packed_l = [], []
    for s in range(0, n, encode_chunk):
        chunk = (vectors[s:s + encode_chunk] if vectors is not None else
                 torch.as_tensor(data[s:s + encode_chunk], device=dev))
        bins_c, pc_c, packed_c = _encode_chunk(cfg, tree, chunk, s)
        if pair_occ is not None:
            _pair_occ_device(cfg, pc_c, pair_occ)
        bins_l.append(bins_c)
        packed_l.append(packed_c)
    prefix, counts, prefix2, payload = _assemble_device(
        cfg, torch.cat(bins_l), torch.cat(packed_l))
    return PQTDatabase(prefix=prefix, counts=counts, payload=payload,
                       pair_occ=pair_occ, vectors=vectors, prefix2=prefix2)
