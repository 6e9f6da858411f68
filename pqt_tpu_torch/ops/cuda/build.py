"""Build and load the hand-written CUDA kernels of `pqt_tpu_torch/csrc`.

The sources: `topk.cu` (kernel A, row top-k), `scan.cu` (B, row prefix
sums), `rerank.cu` (C, line re-rank by position), `reduce.cu` (D, segment
sums), `lut.cu` (E/F/G, table lookup), `gather.cu` (H, row gather),
`sqdist.cu` (H and D fused for the exact re-rank), `linecodes.cu` (L,
the build's line-code selection, the port's own fusion of what XLA fuses
in the JAX package's encode), `partcodes.cu` (P, the build's part codes:
the level-2 distances and their argmin, likewise) and `mark.cu` (the
stage marks of utils/tracing.py, and the switch of their nodes in a
captured graph).  Each `.cu` source has a
plain C interface and is compiled by `nvcc` into its
own shared library for Hopper (`sm_90a`), then loaded with ctypes.  No
source includes PyTorch's headers, so a build takes seconds.  The libraries
go to `pqt_tpu_torch/_build/<hash of sources and flags>/`, so an edited
source is rebuilt and an unchanged one is reused.  The sources are built
together, one `nvcc` process each, at the first launch of any kernel
(`build_all` does it ahead of time).

There is no fallback: without `nvcc`, or when a source does not compile,
`load` raises `KernelBuildError`.  The kernels' wrappers call `load` only
for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"      # the CUDA toolkit's prefix
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signature of every exported function: (argtypes, restype).
_SIGNATURES = {
    "topk": {"pqt_topk": ((_P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P),
                          _I),
             "pqt_topk_merge": ((_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                                 _P, _P), _I),
             "pqt_topk_cluster": ((_P, _I, _I, _I, _I, _I, _I, _I, _I, _P,
                                   _P, _P), _I)},
    "scan": {"pqt_block_scan_rows": ((_P, _I, _L, _I, _I, _I, _I, _P, _P),
                                     _I),
             "pqt_block_scan_onepass": ((_P, _I, _L, _I, _I, _P,
                                         ctypes.c_uint, _P, _P), _I)},
    "rerank": {"pqt_gather_rerank": ((_P, _I, _I, _P, _P, _I, _I, _P, _I,
                                      _I, _I, _I, _I, _I, _I, _I, _I, _P,
                                      _P, _P), _I)},
    "reduce": {"pqt_segmented_reduce": ((_P, _I, _I, _I, _I, _I, _I, _P, _P),
                                        _I)},
    "lut": {"pqt_lut_gather": ((_P, _L, _I, _P, _L, _P, _P), _I)},
    "gather": {"pqt_gather_rows": ((_P, _L, _I, _P, _I, _I, _I, _I, _P, _P),
                                   _I)},
    "sqdist": {"pqt_gather_sqdist": ((_P, _L, _I, _I, _P, _I, _I, _P, _P,
                                      _P), _I)},
    "linecodes": {"pqt_line_codes": ((_P, _P, _P, _L, _L, _L, _P, _I, _I,
                                      _I, _I, _P, _P, _P), _I)},
    "partcodes": {"pqt_part_codes": ((_P, _P, _P, _P, _L, _I, _I, _I, _P,
                                      _P), _I)},
    "mark": {"pqt_stage_mark": ((_I, _P), _I),
             "pqt_graph_marks": ((_P, _P, _P, _I, _P), _I),
             "pqt_graph_node_set_enabled": ((_P, _P, _I), _I),
             "pqt_graph_node_get_enabled": ((_P, _P, _P), _I)},
}

_lock = threading.Lock()
_libs: dict = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing, or a kernel source did not compile."""


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then CUDA's default prefix."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append(DEFAULT_NVCC)
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, on PATH and in "
        "/usr/local/cuda/bin): the CUDA kernels of pqt_tpu_torch cannot be "
        "built, and CUDA tensors have no other path")


def _build_dir(nvcc: str) -> Path:
    h = hashlib.sha256(" ".join((nvcc,) + NVCC_FLAGS).encode())
    for name in sorted(_SIGNATURES):
        h.update((CSRC / f"{name}.cu").read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> float:
    """Compile every kernel source not yet built, in parallel; load them all.

    Returns the seconds spent compiling (0.0 when all were built already).
    """
    import time
    with _lock:
        if len(_libs) == len(_SIGNATURES):
            return 0.0
        nvcc = find_nvcc()
        out_dir = _build_dir(nvcc)
        out_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        jobs = {}
        for name in _SIGNATURES:
            lib = out_dir / f"lib{name}.so"
            if lib.exists():
                continue
            tmp = out_dir / f".lib{name}.{os.getpid()}.so"
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True), tmp, lib)
        failed = []
        for name, (proc, tmp, lib) in jobs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}.cu:\n{log}")
                continue
            os.replace(tmp, lib)             # atomic: concurrent builders
        if failed:
            raise KernelBuildError("nvcc failed:\n" + "\n".join(failed))
        seconds = time.perf_counter() - t0 if jobs else 0.0
        for name, funcs in _SIGNATURES.items():
            lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
            for fn, (argtypes, restype) in funcs.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[name] = lib
        return seconds


def load(name: str):
    """The loaded library of kernel source `name` (built on first use)."""
    if name not in _libs:
        build_all()
    return _libs[name]


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
