"""Tree and database artifacts: the npz format of the JAX package.

Port of pqt_tpu/io/artifacts.py.  Both artifacts are single .npz files
carrying the config JSON (format version 2), so a tree or database that
either package saved loads in the other; loads check the stored geometry
against the requested config.  A database saved out of core keeps its
memmap leaves in raw `<path>.npz.<leaf>.bin` sidecar files with their shape
and dtype in the npz; the port reads them through numpy memmaps and copies
them to the device in row blocks (`load_database`), or leaves every leaf on
the host for sharding (`load_database_host`).
"""

from __future__ import annotations

import json
import os
from typing import Callable

import numpy as np

from pqt_tpu_torch.config import PQTConfig
from pqt_tpu_torch.models.db import PQTDatabase, pack_payload, payload_width
from pqt_tpu_torch.models.tree import PQTree
from pqt_tpu_torch.utils.device import resolve_device

_FORMAT_VERSION = 2


class ArtifactMismatch(RuntimeError):
    """Stored artifact parameters disagree with the requested config."""


def _npz_path(path: str) -> str:
    """np.savez appends .npz to suffix-less paths; normalize once here."""
    return path if path.endswith(".npz") else path + ".npz"


def _check_config(stored_json: str, cfg: PQTConfig, fields) -> None:
    stored = json.loads(stored_json)
    mine = json.loads(cfg.to_json())
    for f in fields:
        if stored.get(f) != mine.get(f):
            raise ArtifactMismatch(
                f"artifact {f} mismatch: stored={stored.get(f)!r} "
                f"requested={mine.get(f)!r}")


_TREE_FIELDS = ("dim", "p", "c1", "c2", "line_parts")
_DB_FIELDS = _TREE_FIELDS + ("hash_size",)


def save_tree(path: str, cfg: PQTConfig, tree: PQTree) -> None:
    np.savez_compressed(
        _npz_path(path), __version__=_FORMAT_VERSION, config=cfg.to_json(),
        cb1=_np(tree.cb1), cb2=_np(tree.cb2))


def load_tree(path: str, cfg: PQTConfig, device="cuda") -> PQTree:
    dev = resolve_device(device)
    with np.load(_npz_path(path), allow_pickle=False) as z:
        _check_config(str(z["config"]), cfg, _TREE_FIELDS)
        cb1, cb2 = z["cb1"], z["cb2"]
    if cb1.shape != (cfg.p, cfg.c1, cfg.vl):
        raise ArtifactMismatch(f"cb1 shape {cb1.shape} != expected")
    if cb2.shape != (cfg.p, cfg.c1, cfg.c2, cfg.vl):
        raise ArtifactMismatch(f"cb2 shape {cb2.shape} != expected")
    return PQTree.from_numpy(cfg, cb1, cb2, dev)


def _np(t):
    """A leaf (tensor, numpy array or memmap) as a host array."""
    if t is None or isinstance(t, np.ndarray):
        return t
    return t.detach().cpu().numpy()


def _stream_to_raw(arr: np.ndarray, out_path: str,
                   rows_per_block: int = 1 << 20) -> None:
    """Copy an array (a memmap, say) to a raw file in row blocks, never
    reading the whole array into host RAM."""
    with open(out_path, "wb") as f:
        for s in range(0, arr.shape[0], rows_per_block):
            f.write(np.ascontiguousarray(arr[s:s + rows_per_block])
                    .tobytes())


def _covers_its_file(leaf: np.memmap) -> bool:
    """Whether a memmap maps its whole backing file from its first byte
    (what a rename can adopt), not a view at an offset or of a part."""
    src = getattr(leaf, "filename", None)
    return bool(src) and os.path.exists(src) and leaf.offset == 0 and \
        leaf.flags.c_contiguous and leaf.nbytes == os.path.getsize(src)


def save_database(path: str, cfg: PQTConfig, db: PQTDatabase,
                  adopt_memmaps: bool = False) -> None:
    """Persist a database.

    In-RAM leaves (tensors, numpy arrays) go into one compressed npz.
    Memmap leaves (an out-of-core build's payload and CSR-ordered vectors)
    go to raw sidecar files `<path>.npz.<leaf>.bin` in row blocks, their
    shape and dtype in the npz, so saving a spilled database never reads it
    into host RAM.  adopt_memmaps=True renames a memmap's backing file into
    place instead of copying it, when the memmap covers that whole file
    from offset 0 (any other view is copied); the caller must be done with
    `db`.  Re-saving a loaded spilled database to its own path leaves its
    sidecars as they are.
    """
    base = _npz_path(path)
    arrays = dict(__version__=_FORMAT_VERSION, config=cfg.to_json(),
                  prefix=_np(db.prefix), counts=_np(db.counts))
    for name in ("payload", "pair_occ", "vectors", "vectors_csr"):
        leaf = getattr(db, name)
        if leaf is None:
            continue
        if not isinstance(leaf, np.memmap):
            arrays[name] = _np(leaf)
            continue
        side = base + f".{name}.bin"
        src = getattr(leaf, "filename", None)
        same_file = bool(src) and os.path.exists(src) and \
            os.path.abspath(src) == os.path.abspath(side)
        if same_file and _covers_its_file(leaf):
            pass    # the sidecar already is the data; streaming would
            #         truncate the file under its own live mapping
        elif adopt_memmaps and _covers_its_file(leaf):
            leaf.flush()
            os.replace(src, side)
        elif same_file:
            raise ValueError(f"save_database: {name} is a partial view of "
                             f"{side}, which saving to this path would "
                             "overwrite")
        else:
            _stream_to_raw(leaf, side)
        arrays[name + "__shape"] = np.asarray(leaf.shape, np.int64)
        arrays[name + "__dtype"] = np.str_(np.dtype(leaf.dtype).str)
    np.savez_compressed(base, **arrays)


def _read_database(path: str, cfg: PQTConfig) -> dict:
    """A database file's leaves as host arrays: the inline ones read from
    the npz, sidecar ones as read-only memmaps; geometry checked."""
    base = _npz_path(path)
    with np.load(base, allow_pickle=False) as z:
        _check_config(str(z["config"]), cfg, _DB_FIELDS)

        def leaf(name):
            """Inline leaf, or raw sidecar read through a memmap."""
            if name in z:
                return z[name]
            if name + "__shape" in z:
                return np.memmap(base + f".{name}.bin",
                                 np.dtype(str(z[name + "__dtype"])),
                                 mode="r", shape=tuple(z[name + "__shape"]))
            return None

        payload = leaf("payload")
        if payload is None:     # format v1 stored ids/codes/t3 apart
            payload = pack_payload(z["ids"], z["codes"], z["t3"])
        leaves = dict(prefix=z["prefix"], counts=z["counts"],
                      payload=payload, pair_occ=leaf("pair_occ"),
                      vectors=leaf("vectors"),
                      vectors_csr=leaf("vectors_csr"))
    if leaves["prefix"].shape[0] != cfg.hash_size:
        raise ArtifactMismatch("hash table size mismatch")
    if payload.shape[1] != payload_width(cfg):
        raise ArtifactMismatch(
            f"payload width {payload.shape[1]} != {payload_width(cfg)} "
            "(line_parts / payload_compact mismatch)")
    return leaves


def load_database(path: str, cfg: PQTConfig, device="cuda") -> PQTDatabase:
    dev = resolve_device(device)
    return PQTDatabase.from_numpy(**_read_database(path, cfg), device=dev)


def load_database_host(path: str, cfg: PQTConfig) -> PQTDatabase:
    """The database's leaves on the host, for sharding
    (`parallel.sharded.shard_database`): numpy arrays, and read-only
    memmaps of a spilled database's sidecars, so no device and no whole
    copy of a sidecar in host RAM.  prefix2 is left None (the shards derive
    their own)."""
    return PQTDatabase(prefix2=None, **_read_database(path, cfg))


def load_or_build(path: str, loader: Callable, builder: Callable,
                  saver: Callable):
    """Load the artifact at `path` if it exists, else build and save it."""
    if os.path.exists(path) or os.path.exists(_npz_path(path)):
        return loader(path)
    obj = builder()
    saver(path, obj)
    return obj
