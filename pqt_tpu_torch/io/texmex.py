"""Readers and writers of TexMex ANN datasets and the .umem/.imem/.fmem format.

Port of pqt_tpu/io/texmex.py (numpy only; the files are byte-equal to the
JAX package's).

  * .fvecs / .ivecs / .bvecs: each vector is a little-endian int32 `dim`
    followed by `dim` elements (float32 / int32 / uint8);
  * .umem / .imem / .fmem: a 20-byte ASCII header "num dim" padded with
    newlines, then the raw rows with no per-vector dim (uint8 / int32 /
    float32).

Every reader takes (count, offset) and maps the file, so a build reads a
chunk at a time.  The xvecs reader strips the row headers with the native
host runtime (`io/native.py`), which refuses a row whose header is not the
file's dim.
"""

from __future__ import annotations

import os

import numpy as np

from pqt_tpu_torch.io import native

_VEC_DTYPES = {".fvecs": np.float32, ".ivecs": np.int32, ".bvecs": np.uint8}
_MEM_DTYPES = {".umem": np.uint8, ".imem": np.int32, ".fmem": np.float32}

HEADER_BYTES = 20


def _xvecs_info(path: str):
    dtype = _VEC_DTYPES[os.path.splitext(path)[1]]
    with open(path, "rb") as f:
        dim = int(np.fromfile(f, np.int32, 1)[0])
    row_bytes = 4 + dim * np.dtype(dtype).itemsize
    return dtype, dim, os.path.getsize(path) // row_bytes, row_bytes


def read_xvecs(path: str, count: int = -1, offset: int = 0) -> np.ndarray:
    """(count, dim) rows of an .fvecs/.ivecs/.bvecs file from row
    `offset`, in the file's dtype (all rows from `offset` when count < 0)."""
    dtype, dim, num, row_bytes = _xvecs_info(path)
    if count < 0:
        count = num - offset
    count = min(count, num - offset)
    raw = np.memmap(path, dtype=np.uint8, mode="r",
                    offset=offset * row_bytes, shape=(count * row_bytes,))
    return native.strip_xvecs(raw, count, dim, dtype)


def xvecs_header(path: str):
    """(num, dim) of an xvecs file without reading its rows."""
    _, dim, num, _ = _xvecs_info(path)
    return num, dim


def write_xvecs(path: str, data: np.ndarray) -> None:
    """Write (n, dim) rows as .fvecs/.ivecs/.bvecs, by the extension."""
    dtype = _VEC_DTYPES[os.path.splitext(path)[1]]
    data = np.ascontiguousarray(data, dtype=dtype)
    n, dim = data.shape
    dims = np.full((n, 1), dim, np.int32)
    np.concatenate([dims.view(np.uint8).reshape(n, 4),
                    data.view(np.uint8).reshape(n, -1)], axis=1).tofile(path)


def _mem_header_bytes(num: int, dim: int) -> bytes:
    header = f"{num} {dim}".encode("ascii")
    return header + b"\n" * (HEADER_BYTES - len(header))


def mem_header(path: str):
    """(num, dim) from a .umem/.imem/.fmem header."""
    with open(path, "rb") as f:
        header = f.read(HEADER_BYTES).decode("ascii", errors="replace")
    parts = header.split()
    return int(parts[0]), int(parts[1])


def read_mem(path: str, count: int = -1, offset: int = 0) -> np.ndarray:
    """(count, dim) rows of a .umem/.imem/.fmem file from row `offset`."""
    dtype = _MEM_DTYPES[os.path.splitext(path)[1]]
    num, dim = mem_header(path)
    if count < 0:
        count = num - offset
    count = min(count, num - offset)
    mm = np.memmap(path, dtype=dtype, mode="r",
                   offset=HEADER_BYTES + offset * dim * np.dtype(dtype).itemsize,
                   shape=(count, dim))
    return np.array(mm)


def write_mem(path: str, data: np.ndarray) -> None:
    """Write (n, dim) rows as .umem/.imem/.fmem, by the extension."""
    data = np.ascontiguousarray(data,
                                dtype=_MEM_DTYPES[os.path.splitext(path)[1]])
    with open(path, "wb") as f:
        f.write(_mem_header_bytes(*data.shape))
        data.tofile(f)


def convert_xvecs_to_mem(src: str, dst: str, chunk: int = 1_000_000):
    """Stream an .fvecs/.bvecs/.ivecs file into .fmem/.umem/.imem, `chunk`
    rows at a time.  Returns (num, dim)."""
    num, dim = xvecs_header(src)
    dtype = _MEM_DTYPES[os.path.splitext(dst)[1]]
    with open(dst, "wb") as f:
        f.write(_mem_header_bytes(num, dim))
        for off in range(0, num, chunk):
            block = read_xvecs(src, min(chunk, num - off), off)
            np.ascontiguousarray(block, dtype=dtype).tofile(f)
    return num, dim


def read_dataset(path: str, count: int = -1, offset: int = 0) -> np.ndarray:
    """Rows of an xvecs or mem file, by the extension."""
    if path.endswith(tuple(_VEC_DTYPES)):
        return read_xvecs(path, count, offset)
    if path.endswith(tuple(_MEM_DTYPES)):
        return read_mem(path, count, offset)
    raise ValueError(f"unknown dataset format: {path}")


def dataset_header(path: str):
    """(num, dim) of an xvecs or mem file."""
    if path.endswith(tuple(_VEC_DTYPES)):
        return xvecs_header(path)
    return mem_header(path)
