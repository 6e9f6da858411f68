"""Database build: encoding, payload packing, and the CSR inverted file.

Port of the in-memory build of pqt_tpu/models/db.py:

  1. per part, the best (l1, l2) over the k1_build best L1 cells x all c2
     refinements -> per-part code l1*c2 + l2;
  2. the bin id, mixed-radix or hashed into the table;
  3. per (vector, line part) the packed line code, and the t3 term: kernel
     L reads the line GEMM's output and the norms and forms the segment
     distances in registers, so the line tables are never written;
  4. the CSR inverted file: a bin histogram, its prefix (kernel B), and a
     stable sort by bin id that lays the payload rows out in CSR order, so
     ids stay ascending inside every bin.

The payload is ONE int32 row per vector in CSR order: column 0 the original
id, column 1 t3's float bits, then the line codes -- wide (one uint32 per
line part, A | B << 8 | lambda_u16 << 16) or, when c1 <= 16, compact (16
bits per line part, A | B << 4 | lambda_u8 << 8, two parts per column).

The out-of-core half (port of pqt_tpu/models/db.py:100-138, 358-666)
encodes chunks on the card and assembles the CSR on the host:
`ChunkedDBBuilder` (in RAM, or spilled to disk with `spill_path`),
`encode_chunk_to_file` + `merge_chunk_files` (the multi-process shape), and
`merge_chunk_files_range` (one hash range; the whole merge is the range [0,
hash_size)).  The merges are one scan of the files (`_scan_chunk_files`)
and one placement loop (`_streaming_merge`): rows are placed in input order
against per-bin cursors (io/native.py), so ids stay ascending inside every
bin and the merged payload equals `build_database`'s for the same bins.  A
spilled build keeps the raw vectors in CSR order (`vectors_csr`), which the
queries read by CSR position.

Every build encodes through `chunk_encoder`, the counterpart of the JAX
package's jitted `_encode_chunk` with `_pair_occ_device` (and, nested in
it, `encode_part_codes`, `encode_bins`, `encode_line_codes` and
`pack_payload_device`): on the card one CUDA graph a key
(utils/graphs.py), the key being cfg, the chunk's shape and dtype, the
tree's tensors and the occupancy map by address, and never the id offset,
which is copied in as a 0-d int32 tensor.  A build of n rows in chunks of
C captures at most two graphs, C rows and the last, shorter chunk, and
replays the rest.  `chunk_codes` is the data-parallel encode's program
(parallel/sharded.py) over the same core.  `_assemble_device` stays eager
by design: a build calls it once, so its graph would be captured and never
replayed, and its pool would hold the sorted payload (n x 72 B at SIFT1B
width) for nothing.

Every build hands the encoder its host rows through one loop,
`_encode_rows` over `_row_chunks`: on a card each chunk is staged in a
ring of pinned host slots and copied up on a side stream, so the copy of
one chunk and the host's fill of the next overlap the encode of the one
before.  `build_database` keeps the chunks' outputs on the device for
`_assemble_device`, the out-of-core encode (`_encode_host`) copies them
into host arrays, and models/multidb.py keeps the part codes and rows for
its groups.

The build marks its stages on the device (utils/tracing.py):
`build.upload` (the allocations and the first chunk's copy),
`build.encode`, `build.assemble` and `build.end` in `build_database`
(which calls `_assemble_device` by this module's name, once a build), and
each chunk's `encode.part_codes`, `encode.payload` and `encode.end` inside
the chunk encoder's graph; the later chunks' copies overlap those.  The
out-of-core encode marks the same stages but the assembly, which the host
does.  On the host, `pqt.build.stage` spans each fill of a slot and
`pqt.build.wait` each wait for one.
"""

from __future__ import annotations

import functools
import os
import threading
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from pqt_tpu_torch.config import PQTConfig
from pqt_tpu_torch.models.tree import PQTree, level1_tables, level2_tables
from pqt_tpu_torch.ops import binning, distance, linecodes
from pqt_tpu_torch.ops.cuda import partcodes
from pqt_tpu_torch.ops.cuda.primitives import bitonic_topk
from pqt_tpu_torch.utils import tracing
from pqt_tpu_torch.utils.device import resolve_device
from pqt_tpu_torch.utils.graphs import graphed


class ChunkFormatError(RuntimeError):
    """An encoded chunk file lacks the arrays the requested merge needs."""


# Rows copied to the device per step from a host array (bounds the host
# copy of a memmap leaf to about 256 MB).
_UPLOAD_BYTES = 1 << 28


def to_device(a, dev: torch.device) -> torch.Tensor:
    """A numpy array (or memmap) as a tensor on `dev`.  On the CPU the
    tensor owns a copy; to a card the rows go in blocks of about 256 MB, so
    a memmap's file is never copied into host RAM whole.  Every byte copied
    is counted in `to_device.bytes_copied`."""
    a = np.asarray(a)
    to_device.bytes_copied += a.nbytes
    if dev.type == "cpu":
        return torch.from_numpy(np.array(a))
    out = torch.empty(a.shape, device=dev,
                      dtype=torch.from_numpy(np.empty(0, a.dtype)).dtype)
    step = max(1, _UPLOAD_BYTES // max(1, a[:1].nbytes))
    with warnings.catch_warnings():
        # read-only arrays (memmaps opened "r", numpy views of JAX arrays):
        # the copy to the card only reads them
        warnings.simplefilter("ignore", UserWarning)
        for s in range(0, a.shape[0], step):
            out[s:s + step].copy_(
                torch.from_numpy(np.ascontiguousarray(a[s:s + step])))
    return out


to_device.bytes_copied = 0


class PQTDatabase(NamedTuple):
    """Built database: tensors on one device (or, from an out-of-core
    merge with to_device=False, numpy arrays and memmaps on the host)."""
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
            return None if a is None else to_device(a, dev)

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


def unpack_payload(rows: torch.Tensor):
    """WIDE (..., 2 + lp) int32 payload rows -> (ids (...,), codes (...,
    lp) uint32 values held in int64, t3 (...,) float32)."""
    return linecodes.payload_columns(rows)


def unpack_payload_cfg(cfg: PQTConfig, rows: torch.Tensor):
    """Payload rows -> (ids, a_idx, b_idx (..., lp) int32, lam (..., lp)
    float32, t3) under either layout."""
    return linecodes.unpack_payload_rows(rows, cfg.line_parts,
                                         cfg.payload_is_compact)


def encode_part_codes(cfg: PQTConfig, tree: PQTree,
                      x: torch.Tensor) -> torch.Tensor:
    """Per-part codes l1*c2 + l2 (n, p) int64: per part, the least level-2
    distance over the k1_build best L1 cells and all c2 refinements (first
    minimum on ties).  With k1_build >= c1 every cell is a candidate and
    the flat index of the least is the code: kernel P (`part_codes`, its
    plain version on the CPU) picks it without writing the tables."""
    if cfg.k1_build >= cfg.c1:
        flat = tree.cb2.reshape(cfg.p, cfg.c1 * cfg.c2, cfg.vl)
        return partcodes.part_codes(*distance.part_norms(x, flat))
    d2 = level2_tables(cfg, tree, x)                     # (n, p, c1, c2)
    n, p = d2.shape[:2]
    d1 = level1_tables(cfg, tree, x)                     # (n, p, c1)
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
    the payload's codec width so t3 agrees with the stored codes.  Kernel L
    takes the line tables' terms (the line GEMM's output and the norms) and
    forms the distances itself, so the tables are never written."""
    return linecodes.build_line_codes(
        *distance.subpart_sqdist_terms(x, tree.centroids_full,
                                       cfg.line_parts),
        tree.pair_dists, cfg.effective_lambda_bits)


def _encode_core(cfg: PQTConfig, tree: PQTree, chunk: torch.Tensor):
    """One chunk's rows, cast to float32 on their device, encoded: (part
    codes (C, p) int64, bins (C,) int32, wide line codes (C, lp), t3 (C,)
    float32)."""
    tracing.mark("encode.part_codes", chunk.device)
    chunk = chunk.to(torch.float32)
    pc = encode_part_codes(cfg, tree, chunk)
    bins = binning.hashed_bin_ids(pc, cfg.part_radix, cfg.hash_size)
    tracing.mark("encode.payload", chunk.device)
    codes, t3 = encode_line_codes(cfg, tree, chunk)
    return pc, bins, codes, t3


def _encode_chunk(cfg: PQTConfig, tree: PQTree, chunk: torch.Tensor,
                  id_offset):
    """Encode one chunk: (bins (C,) int32, part codes (C, p), payload rows
    (C, payload_width)); id_offset an int or a 0-d int32 tensor on the
    chunk's device."""
    pc, bins, codes, t3 = _encode_core(cfg, tree, chunk)
    ids = id_offset + torch.arange(chunk.shape[0], dtype=torch.int32,
                                   device=chunk.device)
    return bins, pc, pack_payload_device(cfg, ids, codes, t3)


def _assemble_device(cfg: PQTConfig, bins: torch.Tensor,
                     packed: torch.Tensor):
    """CSR assembly (`binning.build_csr`), then the payload rows in CSR
    order.  Returns (prefix, counts, prefix2, payload)."""
    inv = binning.build_csr(bins, cfg.hash_size)
    return (inv.prefix, inv.counts,
            torch.stack([inv.prefix, inv.prefix + inv.counts], dim=1),
            packed[inv.order.to(torch.int64)])


def _pair_occ_device(cfg: PQTConfig, part_codes: torch.Tensor,
                     pair_occ: torch.Tensor) -> torch.Tensor:
    """Mark this chunk's (part 2j, 2j+1) code pairs in the occupancy map
    (in place)."""
    r = cfg.part_radix
    for j in range(cfg.p // 2):
        pair_occ[j].index_fill_(
            0, part_codes[:, 2 * j] * r + part_codes[:, 2 * j + 1], 1)
    return pair_occ


@graphed(static_argnums=(0,), inputs=("chunk", "id_offset"))
def chunk_encoder(cfg: PQTConfig, tree: PQTree, chunk: torch.Tensor,
                  id_offset: torch.Tensor,
                  pair_occ: Optional[torch.Tensor] = None):
    """`_encode_chunk`, then, with pair_occ, the chunk's code pairs marked
    in it (in place): one program, a CUDA graph a key on the card (the
    module docstring).  id_offset: 0-d int32 tensor on the chunk's device
    (`_offset`)."""
    bins, pc, rows = _encode_chunk(cfg, tree, chunk, id_offset)
    if pair_occ is not None:
        _pair_occ_device(cfg, pc, pair_occ)
    tracing.mark("encode.end", chunk.device)
    return bins, pc, rows


@graphed(static_argnums=(0,), inputs=("chunk",))
def chunk_codes(cfg: PQTConfig, tree: PQTree, chunk: torch.Tensor):
    """(bins (C,) int32, wide line codes (C, lp), t3 (C,) float32) of one
    chunk: the data-parallel encode's program, a CUDA graph a key on the
    card as `chunk_encoder`."""
    _, bins, codes, t3 = _encode_core(cfg, tree, chunk)
    tracing.mark("encode.end", chunk.device)
    return bins, codes, t3


def _offset(id_offset: int, dev: torch.device) -> torch.Tensor:
    """A chunk's id offset as the 0-d int32 tensor `chunk_encoder` copies
    in (a fill on the device, no host copy)."""
    return torch.full((), id_offset, dtype=torch.int32, device=dev)


# Pinned host slots in the ring that stages a build's rows, and without
# keep_vectors as many device chunk buffers: the host fills one slot while
# the copy engine empties another, with one more in hand so the host need
# not wait on the copy just started.
_RING = 3


@functools.cache
def _copy_stream(dev: torch.device) -> torch.cuda.Stream:
    """The side stream a build's row copies run on, one a device."""
    return torch.cuda.Stream(dev)


def _host_tensor(rows: np.ndarray) -> torch.Tensor:
    """Host rows as a CPU tensor, a view where they are contiguous
    (read-only arrays too: the build only reads them)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(np.ascontiguousarray(rows))


def _row_chunks(data: np.ndarray, vectors: Optional[torch.Tensor],
                rows: int, dev: torch.device):
    """Yield (s, data[s:s + rows] as a tensor on dev), in order: a slice of
    `vectors` where given, which it fills, else of a chunk buffer.  On a
    card each chunk goes through a ring of _RING pinned host slots: the
    host waits for the copy that last used the slot (span
    `pqt.build.wait`), fills it (`pqt.build.stage`) and starts its copy
    to the device on the device's side stream, on which the current
    stream waits before the caller encodes the chunk; so the host fills
    the next slot while the device encodes.  Without vectors the copy
    first waits for the encode that last read its buffer.  Off a card the
    chunks are the host rows themselves.  Counted in
    build_database.chunks_staged and .bytes_staged."""
    n = data.shape[0]
    if dev.type != "cuda":
        for s in range(0, n, rows):
            chunk = _host_tensor(data[s:s + rows])
            if vectors is not None:
                chunk = vectors[s:s + rows].copy_(chunk)
            _staged(chunk)
            yield s, chunk
        return
    cur, side = torch.cuda.current_stream(dev), _copy_stream(dev)
    slots = torch.empty((_RING, min(rows, n)) + data.shape[1:],
                        dtype=_host_tensor(data[:0]).dtype, pin_memory=True)
    bufs = (torch.empty(slots.shape, dtype=slots.dtype, device=dev)
            if vectors is None else None)
    copied = [None] * _RING     # each slot's last copy
    read = [None] * _RING       # each buffer's last encode
    # the destinations were allocated on the current stream
    side.wait_stream(cur)
    for i, s in enumerate(range(0, n, rows)):
        k, m = i % _RING, min(rows, n - s)
        if copied[k] is not None:
            with tracing.span("pqt.build.wait"):
                copied[k].synchronize()
        with tracing.span("pqt.build.stage"):
            slots[k, :m].copy_(_host_tensor(data[s:s + m]))
        chunk = vectors[s:s + m] if bufs is None else bufs[k, :m]
        with torch.cuda.stream(side):
            if read[k] is not None:
                side.wait_event(read[k])
            chunk.copy_(slots[k, :m], non_blocking=True)
            copied[k] = side.record_event()
        cur.wait_event(copied[k])
        _staged(chunk)
        yield s, chunk
        if bufs is not None:
            read[k] = cur.record_event()


def _staged(chunk: torch.Tensor) -> None:
    build_database.chunks_staged += 1
    build_database.bytes_staged += chunk.nbytes


def _device_vectors(data: np.ndarray, dev: torch.device) -> torch.Tensor:
    """An empty tensor on dev for host rows by id, in their dtype, which
    `_row_chunks` fills."""
    return torch.empty(data.shape, dtype=_host_tensor(data[:0]).dtype,
                       device=dev)


def _encode_rows(cfg: PQTConfig, tree: PQTree, data: np.ndarray,
                 encode_chunk: int, id_offset: int = 0,
                 pair_occ: Optional[torch.Tensor] = None,
                 vectors: Optional[torch.Tensor] = None):
    """Encode host rows on the tree's device, `encode_chunk` rows a chunk,
    staged through `_row_chunks` (which fills `vectors` where given): yield
    (s, (bins (C,) int32, part codes (C, p) int64, payload rows (C,
    payload_width) int32)) for the rows from s, their ids from id_offset +
    s; pair_occ, where given, is marked in place.  Marks `build.encode`
    once the first chunk's copy is under way; the caller marks
    `build.upload` before its allocations, and its own end."""
    dev = tree.cb1.device
    for s, chunk in _row_chunks(data, vectors, encode_chunk, dev):
        if s == 0:      # the upload stage holds the first chunk's copy
            tracing.mark("build.encode", dev)
        yield s, chunk_encoder(cfg, tree, chunk, _offset(id_offset + s, dev),
                               pair_occ)


def build_database(cfg: PQTConfig, tree: PQTree, data,
                   keep_vectors: bool = False, encode_chunk: int = 65536,
                   device="cuda") -> PQTDatabase:
    """Single-shot database build on `device` (the tree must live there).

    data: (n, dim) array-like; uint8 data is uploaded raw and cast on the
    device chunk by chunk.  With keep_vectors the raw vectors stay on the
    device, by original id, for exact re-rank.  The rows go up a chunk at
    a time (`_encode_rows`), each copy overlapping the encode of the chunk
    before it.
    """
    dev = _check_tree_device(tree, device)
    data = _host_rows(data)
    tracing.mark("build.upload", dev)
    pair_occ = (torch.zeros((cfg.p // 2, cfg.part_radix ** 2),
                            dtype=torch.uint8, device=dev)
                if cfg.pair_filter_enabled else None)
    vectors = _device_vectors(data, dev) if keep_vectors else None
    bins_l, packed_l = [], []
    for _, (bins_c, _, packed_c) in _encode_rows(
            cfg, tree, data, encode_chunk, pair_occ=pair_occ,
            vectors=vectors):
        bins_l.append(bins_c)
        packed_l.append(packed_c)
    tracing.mark("build.assemble", dev)
    prefix, counts, prefix2, payload = _assemble_device(
        cfg, torch.cat(bins_l), torch.cat(packed_l))
    tracing.mark("build.end", dev)
    return PQTDatabase(prefix=prefix, counts=counts, payload=payload,
                       pair_occ=pair_occ, vectors=vectors, prefix2=prefix2)


# chunks and bytes of host rows the builds have staged (`_row_chunks`)
build_database.chunks_staged = 0
build_database.bytes_staged = 0


# ---------------------------------------------------------------------------
# The out-of-core half: host packers, host CSR assembly, chunked builders.
# ---------------------------------------------------------------------------

def pack_payload(ids: np.ndarray, codes: np.ndarray,
                 t3: np.ndarray) -> np.ndarray:
    """Host packing of (ids, uint32 line codes, t3) into WIDE payload rows."""
    out = np.empty((ids.shape[0], 2 + codes.shape[1]), np.int32)
    out[:, 0] = ids
    out[:, 1] = np.ascontiguousarray(t3, np.float32).view(np.int32)
    out[:, 2:] = np.ascontiguousarray(codes, np.uint32).view(np.int32)
    return out


def pack_payload_compact(ids: np.ndarray, codes: np.ndarray,
                         t3: np.ndarray) -> np.ndarray:
    """Compact rows: 16 bits per line part (A | B << 4 | lambda_u8 << 8), two
    parts per column.  codes: (n, lp) uint32 in the wide bit layout with
    lambda already on the u8 grid (build_line_codes(lambda_bits=8))."""
    n, lp = codes.shape
    codes = codes.astype(np.uint32)
    a = codes & np.uint32(0xF)
    b = (codes >> 8) & np.uint32(0xF)
    lam8 = (codes >> 24) & np.uint32(0xFF)
    part16 = a | (b << 4) | (lam8 << 8)
    if lp % 2:
        part16 = np.concatenate([part16, np.zeros((n, 1), np.uint32)], axis=1)
    merged = part16[:, 0::2] | (part16[:, 1::2] << 16)
    out = np.empty((n, 2 + merged.shape[1]), np.int32)
    out[:, 0] = ids
    out[:, 1] = np.ascontiguousarray(t3, np.float32).view(np.int32)
    out[:, 2:] = np.ascontiguousarray(merged, np.uint32).view(np.int32)
    return out


def pack_payload_cfg(cfg: PQTConfig, ids: np.ndarray, codes: np.ndarray,
                     t3: np.ndarray) -> np.ndarray:
    """Host payload rows under `cfg`'s layout."""
    if cfg.payload_is_compact:
        return pack_payload_compact(ids, codes, t3)
    return pack_payload(ids, codes, t3)


def _csr_database(prefix, counts, payload, pair_occ, vectors, vectors_csr,
                  to_device_: bool, device) -> PQTDatabase:
    """A PQTDatabase of int32 host leaves: moved to `device` (the probe
    table derived there), or kept as numpy arrays and memmaps
    (to_device_=False)."""
    if to_device_:
        return PQTDatabase.from_numpy(prefix, counts, payload,
                                      pair_occ=pair_occ, vectors=vectors,
                                      vectors_csr=vectors_csr, device=device)
    return PQTDatabase(prefix=prefix, counts=counts, payload=payload,
                       pair_occ=pair_occ, vectors=vectors,
                       prefix2=np.stack([prefix, prefix + counts], axis=1),
                       vectors_csr=vectors_csr)


def assemble_database(cfg: PQTConfig, bin_ids: np.ndarray, codes: np.ndarray,
                      t3: np.ndarray, vectors: Optional[np.ndarray] = None,
                      id_offset: int = 0,
                      pair_occ: Optional[np.ndarray] = None,
                      device="cuda") -> PQTDatabase:
    """Host CSR assembly from encoded vectors: a stable counting sort by bin
    id (native), the rows packed in input order, then one row gather into
    CSR order.  codes: (n, lp) uint32 wide-layout line codes; vectors (by
    id) and pair_occ ride along.  The leaves go to `device`."""
    from pqt_tpu_torch.io import native
    dev = resolve_device(device)
    counts, prefix, order = native.build_csr(bin_ids, cfg.hash_size)
    n = bin_ids.shape[0]
    packed = pack_payload_cfg(
        cfg, np.arange(id_offset, id_offset + n, dtype=np.int32), codes, t3)
    return _csr_database(prefix, counts, native.gather_rows(packed, order),
                         pair_occ, vectors, None, True, dev)


def _encode_host(cfg: PQTConfig, tree: PQTree, data: np.ndarray,
                 id_offset: int, encode_chunk: int,
                 pair_occ: Optional[torch.Tensor]):
    """Encode host rows through `_encode_rows`: (bins (n,) int32, payload
    rows (n, payload_width) int32) on the host, each chunk's copied down
    as it is encoded; pair_occ, on the device, is marked in place.  The
    device work is marked as `build_database`'s, but for the assembly,
    which the host does."""
    dev = tree.cb1.device
    tracing.mark("build.upload", dev)
    n = data.shape[0]
    bins = np.empty((n,), np.int32)
    packed = np.empty((n, payload_width(cfg)), np.int32)
    for s, (bins_c, _, packed_c) in _encode_rows(cfg, tree, data,
                                                 encode_chunk, id_offset,
                                                 pair_occ):
        bins[s:s + encode_chunk] = bins_c.cpu().numpy()
        packed[s:s + encode_chunk] = packed_c.cpu().numpy()
    tracing.mark("build.end", dev)
    return bins, packed


def _host_rows(data) -> np.ndarray:
    """A build's host rows: uint8 or float32 as given, any other dtype as
    float32; at most int32's largest number of them."""
    data = np.asarray(data)
    if data.dtype not in (np.uint8, np.float32):
        data = data.astype(np.float32)
    if data.shape[0] > np.iinfo(np.int32).max:
        raise NotImplementedError("CSR positions exceed int32; shard the "
                                  "build")
    return data


def _check_tree_device(tree: PQTree, device) -> torch.device:
    dev = resolve_device(device)
    if tree.cb1.device != dev:
        raise ValueError(f"tree is on {tree.cb1.device}, build device is "
                         f"{dev}")
    return dev


class ChunkedDBBuilder:
    """Out-of-core database builder.

    Feed chunks of any size with `add_chunk`: each is encoded on the device
    in `encode_chunk`-row steps and only its bin ids and payload rows come
    back to the host, while a global bin histogram accumulates.
    `finalize()` is then one streaming counting sort: chunk by chunk, rows
    are placed at their final CSR positions against per-bin cursors, in
    input order.  Host RAM holds the largest chunk, the (hash_size,)
    cursors and the output; with `spill_path` the encoded chunks go to disk
    as they arrive and the output is a payload memmap at `spill_path` (plus
    a CSR-ordered vector memmap `<spill_path>.vecs` with keep_vectors),
    reread once at finalize.  In RAM, kept vectors stay by original id.
    """

    def __init__(self, cfg: PQTConfig, tree: PQTree,
                 keep_vectors: bool = False, encode_chunk: int = 65536,
                 spill_path: Optional[str] = None, device="cuda"):
        self.cfg = cfg
        self.tree = tree
        self.device = _check_tree_device(tree, device)
        self.keep_vectors = keep_vectors
        self.encode_chunk = encode_chunk
        self.spill_path = spill_path
        self._chunks = []      # (bins, packed rows, raw vectors or None), or
                               # the path of a spilled chunk file
        self._vecs = []
        self._vec_meta = None  # (dtype, dim) of the raw vectors
        self._hist = np.zeros((cfg.hash_size,), np.int64)
        self._n = 0
        self._pair_occ = (torch.zeros((cfg.p // 2, cfg.part_radix ** 2),
                                      dtype=torch.uint8, device=self.device)
                          if cfg.pair_filter_enabled else None)

    def add_chunk(self, data) -> None:
        data = _host_rows(data)
        bins, packed = _encode_host(self.cfg, self.tree, data, self._n,
                                    self.encode_chunk, self._pair_occ)
        self._hist += np.bincount(bins, minlength=self.cfg.hash_size)
        if self.spill_path:
            path = f"{self.spill_path}.chunk{len(self._chunks)}.npz"
            arrays = dict(bins=bins, packed=packed)
            if self.keep_vectors:
                arrays["vecs"] = data
            np.savez(path, **arrays)
            self._chunks.append(path)
        else:
            self._chunks.append((bins, packed))
            if self.keep_vectors:
                self._vecs.append(data)
        if self.keep_vectors:
            self._vec_meta = (data.dtype, data.shape[1])
        self._n += data.shape[0]

    def finalize(self, to_device: bool = True, device=None) -> PQTDatabase:
        """The CSR database: leaves on `device` (the builder's by default),
        or, with to_device=False, numpy arrays and memmaps."""
        dev = (resolve_device(self.device if device is None else device)
               if to_device else None)
        occ = self._pair_occ
        if isinstance(occ, torch.Tensor):
            occ = occ.cpu().numpy()
        prefix, counts, payload, vectors_csr = _streaming_merge(
            self.cfg, self._chunks, self._hist, 0,
            self._vec_meta if self.spill_path else None, self.spill_path)
        return _csr_database(
            prefix, counts, payload, occ,
            np.concatenate(self._vecs) if self._vecs else None, vectors_csr,
            to_device, dev)


def _range_mask(bins: np.ndarray, lo: int, hi: int,
                hash_size: int) -> Optional[np.ndarray]:
    """The mask of the bins in [lo, hi), or None when the range is the
    whole table and every bin is in it."""
    if (lo, hi) == (0, hash_size):
        return None
    return (bins >= lo) & (bins < hi)


def _scan_chunk_files(cfg: PQTConfig, paths, lo: int, hi: int,
                      keep_vectors: bool):
    """One pass over encoded chunk files for a merge of hash bins [lo,
    hi): (the bins' histogram (hi - lo,) int64, the raw vectors' (dtype,
    dim) with keep_vectors or None, the OR of the files' pair_occ or
    None)."""
    hist = np.zeros((hi - lo,), np.int64)
    vec_meta = pair_occ = None
    for p in paths:
        with np.load(p) as z:
            if keep_vectors and "vecs" not in z.files:
                raise ChunkFormatError(
                    f"chunk {p} has no raw vectors but keep_vectors=True "
                    "was requested; re-encode it with encode_chunk_to_file("
                    "keep_vectors=True) or merge with keep_vectors=False")
            bins = z["bins"]
            mask = _range_mask(bins, lo, hi, cfg.hash_size)
            hist += np.bincount(bins if mask is None else bins[mask] - lo,
                                minlength=hi - lo)
            if keep_vectors and vec_meta is None:
                # from the first chunk only: reading an npz member loads it
                # whole, so probing every chunk would double the vector I/O
                v = z["vecs"]
                vec_meta = (v.dtype, int(v.shape[1]))
            if "pair_occ" in z.files:
                pair_occ = (z["pair_occ"] if pair_occ is None
                            else pair_occ | z["pair_occ"])
    return hist, vec_meta, pair_occ


def _streaming_merge(cfg: PQTConfig, chunks, hist: np.ndarray, lo: int,
                     vec_meta=None, spill_path=None):
    """Place every chunk's rows of hash bins [lo, lo + len(hist)) at their
    CSR positions, in input order against per-bin cursors (the merge of
    ChunkedDBBuilder.finalize and of both chunk-file merges).  chunks:
    (bins, packed) pairs, or chunk file paths (bins, packed and, when
    vec_meta (dtype, dim) is given, vecs, which are placed too).  The
    outputs are memmaps at spill_path (the vectors at
    `<spill_path>.vecs`), else in RAM.  Returns (prefix rebased to lo,
    counts, payload, vectors in CSR order or None)."""
    from pqt_tpu_torch.io import native
    n = int(hist.sum())
    if n > np.iinfo(np.int32).max:
        raise NotImplementedError("CSR positions exceed int32; shard the "
                                  "build")
    # Host RAM at 2^29 slots: the int64 histogram and cursors (4 GiB each)
    # and the int32 prefix and counts (2 GiB each); the probe table is
    # derived on the device when the leaves go there.
    cursor = np.cumsum(hist)
    cursor -= hist
    prefix = cursor.astype(np.int32)
    counts = hist.astype(np.int32)

    def output(path, dtype, width):
        if spill_path:
            return np.memmap(path, dtype, mode="w+", shape=(n, width))
        return np.empty((n, width), dtype)

    payload = output(spill_path, np.int32, payload_width(cfg))
    vecs = (None if vec_meta is None
            else output(f"{spill_path}.vecs", vec_meta[0], vec_meta[1]))
    for chunk in chunks:
        vecs_chunk = None
        if isinstance(chunk, (str, os.PathLike)):
            with np.load(chunk) as z:
                bins, rows = z["bins"], z["packed"]
                if vecs is not None:
                    vecs_chunk = z["vecs"]
        else:
            bins, rows = chunk
        mask = _range_mask(bins, lo, lo + hist.shape[0], cfg.hash_size)
        if mask is not None:
            bins, rows = bins[mask] - lo, rows[mask]
            if vecs_chunk is not None:
                vecs_chunk = vecs_chunk[mask]
        pos = native.place_positions(bins, cursor)
        native.scatter_rows(rows, pos, payload)
        if vecs_chunk is not None:
            native.scatter_rows(vecs_chunk, pos, vecs)
    del cursor
    return prefix, counts, payload, vecs


_FILE_OCC_LOCK = threading.Lock()


@functools.cache
def _file_pair_occ(shape: tuple, dev: torch.device) -> torch.Tensor:
    """The occupancy map `encode_chunk_to_file` marks on `dev` (zeroed for
    each file, one file at a time): one tensor for the life of the
    process, so the encoder's graphs, which hold its address, serve every
    chunk file."""
    return torch.zeros(shape, dtype=torch.uint8, device=dev)


def encode_chunk_to_file(cfg: PQTConfig, tree: PQTree, data, id_offset: int,
                         path: str, encode_chunk: int = 65536,
                         keep_vectors: bool = False, device="cuda") -> int:
    """Encode ONE out-of-core chunk on the device and write it to `path`
    (npz: bins, packed, and vecs with keep_vectors, pair_occ when the pair
    filter applies) -- the worker half of a multi-process build, in the
    JAX package's chunk format.  Returns the row count."""
    _check_tree_device(tree, device)
    data = _host_rows(data)
    with _FILE_OCC_LOCK:
        pair_occ = (_file_pair_occ((cfg.p // 2, cfg.part_radix ** 2),
                                   tree.cb1.device).zero_()
                    if cfg.pair_filter_enabled else None)
        bins, packed = _encode_host(cfg, tree, data, id_offset, encode_chunk,
                                    pair_occ)
        arrays = dict(bins=bins, packed=packed)
        if keep_vectors:
            arrays["vecs"] = data
        if pair_occ is not None:
            arrays["pair_occ"] = pair_occ.cpu().numpy()
    np.savez(path, **arrays)
    return data.shape[0]


def merge_chunk_files_range(cfg: PQTConfig, paths, lo: int, hi: int,
                            keep_vectors: bool = False):
    """Merge encoded chunk files keeping ONLY hash bins [lo, hi): the
    per-host half of a multi-host build, host RAM bounded by the slice.

    Returns numpy (prefix (hi-lo,) int32 rebased to the slice, counts
    (hi-lo,) int32, payload (n_local, w) int32, vectors_csr or None,
    pair_occ or None -- the OR of the chunks' tables), ids ascending
    inside every bin as in the global merge.
    """
    hist, vec_meta, pair_occ = _scan_chunk_files(cfg, paths, lo, hi,
                                                 keep_vectors)
    return _streaming_merge(cfg, paths, hist, lo, vec_meta) + (pair_occ,)


def merge_chunk_files(cfg: PQTConfig, tree: PQTree, paths,
                      keep_vectors: bool = False,
                      spill_path: Optional[str] = None,
                      to_device: bool = True, device="cuda") -> PQTDatabase:
    """Assemble the global CSR database from `encode_chunk_to_file` chunks
    (made by either package): host work only, the streaming counting sort
    of ChunkedDBBuilder.finalize over the range [0, hash_size).
    keep_vectors=True needs `spill_path` (the vectors merge into a
    CSR-ordered memmap, `vectors_csr`).  The leaves go to `device`, or stay
    numpy arrays and memmaps with to_device=False.  The tree is not used;
    the argument keeps the JAX package's signature."""
    del tree
    if keep_vectors and not spill_path:
        raise ValueError("merge_chunk_files(keep_vectors=True) needs "
                         "spill_path (vectors merge into a CSR memmap)")
    hist, vec_meta, occ = _scan_chunk_files(cfg, paths, 0, cfg.hash_size,
                                            keep_vectors)
    dev = resolve_device(device) if to_device else None
    prefix, counts, payload, vectors_csr = _streaming_merge(
        cfg, paths, hist, 0, vec_meta, spill_path)
    return _csr_database(prefix, counts, payload, occ, None, vectors_csr,
                         to_device, dev)
