"""The native host runtime (cpp/pqt_host.cpp) and its NumPy plain versions.

The out-of-core build assembles the CSR database on the host: a stable
counting sort by bin id (`build_csr`), the payload rows moved into CSR order
(`gather_rows`), and, for chunked merges, per-chunk placement against running
per-bin cursors (`place_positions`) and the row scatter (`scatter_rows`).
The TexMex readers strip the per-row headers of xvecs files
(`strip_xvecs`, which refuses a row whose header is not the file's dim) and
widen uint8 vectors to float32 (`u8_to_f32`).
These are host code, not device kernels: each entry point runs the native
library when it loaded and its NumPy plain version (`*_plain`) otherwise,
with the same results.  The library is built with g++ at first use into
`pqt_tpu_torch/_build/host-<hash of source and flags>/`, never next to the
source; `get_lib()` returns None where no compiler is found.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SRC = _PKG / "cpp" / "pqt_host.cpp"
BUILD_ROOT = _PKG / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    "pqt_build_csr": ((_P, _I64, _I64, _P, _P, _P), ctypes.c_int),
    "pqt_gather_rows": ((_P, _P, _I64, _I64, _P), None),
    "pqt_place_positions": ((_P, _I64, _P, _P), None),
    "pqt_scatter_rows": ((_P, _P, _I64, _I64, _P), None),
    "pqt_strip_xvecs": ((_P, _I64, _I64, _I64, _P), ctypes.c_int),
    "pqt_u8_to_f32": ((_P, _I64, _P), None),
    "pqt_num_threads": ((), ctypes.c_int),
}

_lock = threading.Lock()
_state = {"lib": None, "tried": False, "error": None}


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_ROOT / f"host-{h.hexdigest()[:16]}" / "libpqt_host.so"


def _build(lib: Path) -> None:
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.parent / f".libpqt_host.{os.getpid()}.so"
    subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)], check=True,
                   capture_output=True, timeout=300)
    os.replace(tmp, lib)                 # atomic: concurrent builders


def get_lib():
    """The loaded native library, or None when it cannot be built or loaded
    (`load_error()` says why).  Built once per process at first use."""
    with _lock:
        if _state["tried"]:
            return _state["lib"]
        _state["tried"] = True
        lib_path = _lib_path()
        try:
            if not lib_path.exists():
                _build(lib_path)
            lib = ctypes.CDLL(str(lib_path))
        except (OSError, subprocess.SubprocessError) as err:
            _state["error"] = repr(err)
            return None
        for fn, (argtypes, restype) in _SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _state["lib"] = lib
        return lib


def load_error():
    """Why the native library did not load (None when it did, or was not
    tried yet)."""
    return _state["error"]


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def _row_bytes(a: np.ndarray) -> int:
    return int(a.strides[0]) if a.ndim > 1 else a.itemsize


def _check_index(idx: np.ndarray, size: int, what: str) -> None:
    if idx.size and (idx.min() < 0 or idx.max() >= size):
        raise ValueError(f"{what}: index out of range [0, {size})")


def build_csr_plain(bin_ids: np.ndarray, hash_size: int):
    bin_ids = np.ascontiguousarray(bin_ids, np.int32)
    _check_index(bin_ids, hash_size, "build_csr: bin id")
    counts = np.bincount(bin_ids, minlength=hash_size).astype(np.int32)
    prefix = (np.cumsum(counts, dtype=np.int64) - counts).astype(np.int32)
    order = np.argsort(bin_ids, kind="stable").astype(np.int32)
    return counts, prefix, order


def build_csr(bin_ids: np.ndarray, hash_size: int):
    """(counts, prefix, order) int32 of a stable counting sort by bin id:
    order[csr_position] = input index, ids ascending inside every bin."""
    bin_ids = np.ascontiguousarray(bin_ids, np.int32)
    lib = get_lib()
    if lib is None:
        return build_csr_plain(bin_ids, hash_size)
    n = bin_ids.shape[0]
    counts = np.empty(hash_size, np.int32)
    prefix = np.empty(hash_size, np.int32)
    order = np.empty(n, np.int32)
    if lib.pqt_build_csr(_ptr(bin_ids), n, hash_size, _ptr(counts),
                         _ptr(prefix), _ptr(order)) != 0:
        raise ValueError(f"build_csr: bin id out of range [0, {hash_size})")
    return counts, prefix, order


def gather_rows_plain(src: np.ndarray, order: np.ndarray) -> np.ndarray:
    order = np.ascontiguousarray(order, np.int32)
    _check_index(order, src.shape[0], "gather_rows: row")
    return np.ascontiguousarray(src)[order]


def gather_rows(src: np.ndarray, order: np.ndarray) -> np.ndarray:
    """out[i] = src[order[i]] (rows of any dtype and width)."""
    src = np.ascontiguousarray(src)
    order = np.ascontiguousarray(order, np.int32)
    lib = get_lib()
    if lib is None:
        return gather_rows_plain(src, order)
    _check_index(order, src.shape[0], "gather_rows: row")
    out = np.empty((order.shape[0],) + src.shape[1:], src.dtype)
    lib.pqt_gather_rows(_ptr(src), _ptr(order), order.shape[0],
                        _row_bytes(src), _ptr(out))
    return out


def place_positions_plain(bins: np.ndarray,
                          cursor: np.ndarray) -> np.ndarray:
    bins = np.ascontiguousarray(bins, np.int32)
    if bins.shape[0] == 0:
        return np.empty(0, np.int64)
    _check_index(bins, cursor.shape[0], "place_positions: bin")
    order = np.argsort(bins, kind="stable")
    sb = bins[order]
    new = np.r_[True, sb[1:] != sb[:-1]]
    starts = np.flatnonzero(new)
    run_id = np.cumsum(new) - 1
    within = np.arange(sb.shape[0], dtype=np.int64) - starts[run_id]
    pos = np.empty(bins.shape[0], np.int64)
    pos[order] = cursor[sb] + within
    cursor[sb[starts]] += np.diff(np.r_[starts, sb.shape[0]])
    return pos


def place_positions(bins: np.ndarray, cursor: np.ndarray) -> np.ndarray:
    """CSR positions of one merge chunk: pos[i] = cursor[bins[i]]++, in
    input order, so rows of one bin keep their input order.  `cursor`
    (int64, one per bin, contiguous) advances in place."""
    if cursor.dtype != np.int64 or not cursor.flags.c_contiguous:
        raise ValueError("place_positions: cursor must be contiguous int64")
    bins = np.ascontiguousarray(bins, np.int32)
    lib = get_lib()
    if lib is None or bins.shape[0] == 0:
        return place_positions_plain(bins, cursor)
    _check_index(bins, cursor.shape[0], "place_positions: bin")
    pos = np.empty(bins.shape[0], np.int64)
    lib.pqt_place_positions(_ptr(bins), bins.shape[0], _ptr(cursor),
                            _ptr(pos))
    return pos


def scatter_rows_plain(src: np.ndarray, pos: np.ndarray,
                       dst: np.ndarray) -> None:
    pos = np.ascontiguousarray(pos, np.int64)
    _check_index(pos, dst.shape[0], "scatter_rows: row")
    dst[pos] = src


def scatter_rows(src: np.ndarray, pos: np.ndarray, dst: np.ndarray) -> None:
    """dst[pos[i]] = src[i] (distinct positions).  Rows are copied as bytes
    only where that is what NumPy's assignment would do: dst contiguous and
    of src's dtype and row shape; any other pair (a cast, a strided dst)
    takes the plain version."""
    src = np.ascontiguousarray(src)
    pos = np.ascontiguousarray(pos, np.int64)
    lib = get_lib()
    if (lib is None or not dst.flags.c_contiguous or dst.dtype != src.dtype
            or dst.shape[1:] != src.shape[1:] or len(pos) != len(src)):
        scatter_rows_plain(src, pos, dst)
        return
    _check_index(pos, dst.shape[0], "scatter_rows: row")
    lib.pqt_scatter_rows(_ptr(src), _ptr(pos), src.shape[0], _row_bytes(src),
                         _ptr(dst))


def _xvecs_rows(raw: np.ndarray, n: int, dim: int, dtype) -> np.ndarray:
    elem = np.dtype(dtype).itemsize
    raw = np.ascontiguousarray(raw).view(np.uint8).reshape(-1)
    if raw.shape[0] != n * (4 + dim * elem):
        raise ValueError(f"strip_xvecs: {raw.shape[0]} bytes are not {n} "
                         f"rows of dim {dim}")
    return raw


def strip_xvecs_plain(raw: np.ndarray, n: int, dim: int,
                      dtype) -> np.ndarray:
    elem = np.dtype(dtype).itemsize
    rows = _xvecs_rows(raw, n, dim, dtype).reshape(n, 4 + dim * elem)
    if (np.ascontiguousarray(rows[:, :4]).view(np.int32)[:, 0] != dim).any():
        raise ValueError("strip_xvecs: a row's header is not the file's dim")
    return np.ascontiguousarray(rows[:, 4:]).view(dtype).reshape(n, dim)


def strip_xvecs(raw: np.ndarray, n: int, dim: int, dtype) -> np.ndarray:
    """(n, dim) array of `dtype` from the raw bytes of n xvecs rows (an
    int32 dim, then dim elements each); raises on a row whose header is
    not `dim`."""
    raw = _xvecs_rows(raw, n, dim, dtype)
    lib = get_lib()
    if lib is None:
        return strip_xvecs_plain(raw, n, dim, dtype)
    out = np.empty((n, dim), dtype)
    if lib.pqt_strip_xvecs(_ptr(raw), n, dim, np.dtype(dtype).itemsize,
                           _ptr(out)) != 0:
        raise ValueError("strip_xvecs: a row's header is not the file's dim")
    return out


def u8_to_f32_plain(src: np.ndarray) -> np.ndarray:
    return np.asarray(src, np.uint8).astype(np.float32)


def u8_to_f32(src: np.ndarray) -> np.ndarray:
    """uint8 array -> float32 array of the same shape and values."""
    src = np.ascontiguousarray(src, np.uint8)
    lib = get_lib()
    if lib is None:
        return u8_to_f32_plain(src)
    out = np.empty(src.shape, np.float32)
    lib.pqt_u8_to_f32(_ptr(src), src.size, _ptr(out))
    return out
