"""Multi-process serving runtime on torch.distributed.

Port of pqt_tpu/parallel/distributed.py.  Every process owns a contiguous
run of hash-range shards in its devices' memory; the queries are given to
every process, and the per-shard top-k lists merge with one all_gather --
the program `parallel/sharded.py` runs in one process, with a process
group.  NCCL carries the collectives between cards, gloo between CPU
processes (the tests).

  * `initialize()` -- `torch.distributed.init_process_group` with the
    coordinator, world size and rank given or taken from the launcher's
    environment (torchrun's MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK and
    LOCAL_RANK);
  * `global_device_mesh()` -- one device a shard over every process,
    rank-major, so each process's shards are a contiguous hash range and a
    contiguous slice of the CSR files;
  * `host_shard_range()`, `build_local_shards()`,
    `place_host_sharded_db()` -- each process builds only its own shards on
    the host (bounded host RAM) and puts them on its own devices; only the
    pad budget crosses processes, never payload or vector bytes;
  * `replicate()` -- a process's own values on each of its devices;
  * `run_with_peer_timeout()`, `peer_barrier()` -- collectives under a
    deadline, so a dead peer gives a typed PeerTimeoutError instead of a
    hang.  After one timeout the runtime is poisoned: the stuck collective
    cannot be cancelled and the group is in an unknown state, so every
    later collective of this module (and of the sharded query and k-means
    step) raises PeerTimeoutError at once; the process must be restarted.
"""

from __future__ import annotations

import datetime
import os
import threading
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from pqt_tpu_torch.config import PQTConfig
from pqt_tpu_torch.parallel.sharded import (ShardedDatabase, _on,
                                            _rank_shards, _stack_shards,
                                            _tree_on, place_sharded_db)
from pqt_tpu_torch.utils.device import resolve_device

# Why the runtime refuses collectives, once a peer timed out (None: it
# does not).  Process-wide, as the process group it guards.
_poisoned: Optional[str] = None


class PeerTimeoutError(RuntimeError):
    """A cross-process collective did not complete in time: a peer process
    is likely dead or unreachable."""


def _peer_timeout_s(default: float = 120.0) -> float:
    return float(os.environ.get("PQT_PEER_TIMEOUT_S", default))


def _whoami() -> str:
    if dist.is_available() and dist.is_initialized():
        return f"process {dist.get_rank()}/{dist.get_world_size()}"
    return "process 0/1"


def refuse_if_poisoned(what: str) -> None:
    """Raise PeerTimeoutError if an earlier collective timed out."""
    if _poisoned is not None:
        raise PeerTimeoutError(
            f"{what} refused: an earlier collective timed out ({_poisoned})."
            " Restart the serving job.")


def run_with_peer_timeout(fn, timeout_s: Optional[float] = None,
                          what: str = "cross-process collective"):
    """Run `fn()`, a blocking cross-process operation, under a watchdog.

    fn runs in a daemon thread joined with a deadline (PQT_PEER_TIMEOUT_S,
    120 s by default); it must wait for its collective to finish, not only
    enqueue it (`_finish`).  Past the deadline this raises PeerTimeoutError
    naming the process and poisons the runtime.  An exception of fn is
    raised here, and its result returned.
    """
    global _poisoned
    refuse_if_poisoned(what)
    if timeout_s is None:
        timeout_s = _peer_timeout_s()
    out, err = [], []

    def run():
        try:
            out.append(fn())
        except Exception as e:            # re-raised in the caller below
            err.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        _poisoned = f"{what} did not complete within {timeout_s:.0f}s"
        raise PeerTimeoutError(
            f"{_poisoned} ({_whoami()}); a peer process is likely dead or "
            "unreachable. Restart the serving job; set PQT_PEER_TIMEOUT_S "
            "to tune the deadline.")
    if err:
        raise err[0]
    return out[0]


def _group_device() -> torch.device:
    """The device the process group's collectives run on: this process's
    card for NCCL, the CPU otherwise."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _finish(work, dev: torch.device) -> None:
    """Wait until an async collective has completed: NCCL's wait() only
    orders the current stream after it, so that stream is synchronised."""
    with _on(dev):
        work.wait()
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()


def _all_reduce_waited(t: torch.Tensor, op) -> torch.Tensor:
    """All-reduce t in place and wait for it (run inside the watchdog)."""
    with _on(t.device):
        _finish(dist.all_reduce(t, op=op, async_op=True), t.device)
    return t


def peer_barrier(timeout_s: Optional[float] = None,
                 name: str = "pqt_peer_barrier") -> None:
    """All-process barrier with a deadline -- the health probe of a serving
    loop (PeerTimeoutError if a peer is gone): an all-reduce every rank
    must join, on the group's device."""
    refuse_if_poisoned(f"peer barrier '{name}'")
    t = torch.ones(1, device=_group_device())
    run_with_peer_timeout(lambda: _all_reduce_waited(t, dist.ReduceOp.SUM),
                          timeout_s, f"peer barrier '{name}'")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               initialization_timeout: Optional[int] = None,
               backend: Optional[str] = None,
               device="cuda") -> torch.device:
    """Join the process group (does nothing when this process already has
    one) and return the device this process serves on.

    The arguments fall back to the launcher's environment: the coordinator
    "host:port" to MASTER_ADDR and MASTER_PORT, the world size to
    WORLD_SIZE, the rank to RANK; on the card the process serves
    cuda:LOCAL_RANK.  backend None is "nccl" for a process serving on
    CUDA and "gloo" on the CPU; a failed NCCL start raises, with no fallback
    to gloo.  initialization_timeout (s) becomes the group's timeout.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in \
            os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    addr = coordinator_address
    if addr is None and "MASTER_ADDR" in os.environ:
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    world = num_processes if num_processes is not None else \
        os.environ.get("WORLD_SIZE")
    rank = process_id if process_id is not None else os.environ.get("RANK")
    if addr is None or world is None or rank is None:
        raise ValueError("initialize needs the coordinator address, the "
                         "number of processes and this process's id (or "
                         "MASTER_ADDR/MASTER_PORT, WORLD_SIZE and RANK)")
    kw = {}
    if initialization_timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=initialization_timeout)
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=f"tcp://{addr}", world_size=int(world), rank=int(rank),
        **kw)
    return dev


def global_device_mesh(local_devices: Sequence) -> list:
    """The device list over every process, rank-major, one device a shard:
    this process's `local_devices` repeated once for each rank, so with D
    local devices shard s lives on rank s // D.  The entries of another
    rank's shards name the devices that rank uses, assumed laid out as
    this one's."""
    local = [resolve_device(d) for d in local_devices]
    world = dist.get_world_size() if dist.is_initialized() else 1
    return local * world


def host_shard_range(cfg: PQTConfig, n_shards: int,
                     shard_ids: Sequence[int]) -> tuple[int, int]:
    """Hash-bin range [lo, hi) covered by these shards -- the bins (and,
    through the global CSR prefix, the payload rows) this process must
    load.  Shard s owns bins [s*span, (s+1)*span)."""
    span = cfg.hash_size // n_shards
    return min(shard_ids) * span, (max(shard_ids) + 1) * span


def local_shard_ids(mesh: Sequence) -> list:
    """Which shards of `mesh` (one device a shard) this process serves:
    once `initialize` ran, its own run of the process group's."""
    return _rank_shards(len(mesh),
                        dist.group.WORLD if dist.is_initialized() else None)


def replicate(devices: Sequence, value) -> dict:
    """{device: value on it} for each distinct device: a tensor, a numpy
    array or a tree, copied from this process's own value (no traffic
    between processes); a value already on a device is not copied."""
    out = {}
    for d in (resolve_device(d) for d in devices):
        if d in out:
            continue
        if isinstance(value, torch.nn.Module):
            out[d] = _tree_on(value, d)
        else:
            out[d] = torch.as_tensor(value).to(d)
    return out


def build_local_shards(cfg: PQTConfig, n_shards: int,
                       shard_ids: Sequence[int],
                       prefix: np.ndarray, counts: np.ndarray,
                       payload: np.ndarray,
                       vectors_csr: Optional[np.ndarray] = None,
                       pad_to_multiple: int = 1024) -> ShardedDatabase:
    """This process's hash-range slice split into its stacked shards, on
    the host.

    Inputs cover bins [lo, hi) = `host_shard_range(...)`, as
    `merge_chunk_files_range` gives them: prefix/counts (hi-lo,) with the
    prefix local (prefix[0] == 0), payload (local_n, w) int32 CSR rows,
    vectors_csr optional (local_n, dim) raw vectors in CSR order.  The
    layout is `shard_database`'s, built without the other processes' data.
    """
    span = cfg.hash_size // n_shards
    if prefix.shape[0] != span * len(shard_ids):
        raise ValueError(
            f"local slice covers {prefix.shape[0]} bins; shards "
            f"{list(shard_ids)} need {span * len(shard_ids)}")
    return _stack_shards(span, prefix, counts, payload, vectors_csr,
                         pad_to_multiple)


def place_host_sharded_db(cfg: PQTConfig, local_sdb: ShardedDatabase,
                          mesh: Sequence, global_max_shard_n: Optional[int]
                          = None, pair_occ: Optional[np.ndarray] = None,
                          ) -> ShardedDatabase:
    """This process's shards (`build_local_shards`, host numpy) padded to
    the global per-shard row budget and placed on its devices of `mesh`.

    Every process must pad to the same budget: when global_max_shard_n is
    None and the world has more than one process, the largest local budget
    is exchanged here by an all-reduce MAX (under the peer deadline).  No
    payload or vector bytes cross processes.  pair_occ, the global table,
    goes to each local device.  cfg is not used; the argument keeps the
    JAX package's signature.
    """
    del cfg
    refuse_if_poisoned("place_host_sharded_db")
    my_shards = local_shard_ids(mesh)
    if local_sdb.n_shards != len(my_shards):
        raise ValueError(
            f"local_sdb has {local_sdb.n_shards} shards; this process's "
            f"devices host {len(my_shards)}")
    local_max = int(local_sdb.payload.shape[1])
    if global_max_shard_n is None:
        global_max_shard_n = local_max
        if dist.is_initialized() and dist.get_world_size() > 1:
            t = torch.tensor([local_max], dtype=torch.int64,
                             device=_group_device())
            global_max_shard_n = int(run_with_peer_timeout(
                lambda: _all_reduce_waited(t, dist.ReduceOp.MAX),
                what="pad-budget all_reduce").item())
    max_n = global_max_shard_n
    if local_max > max_n:
        raise ValueError("global_max_shard_n smaller than a local shard")

    def pad_rows(x, fill=0):
        if x is None or x.shape[1] == max_n:
            return x
        out = np.full((x.shape[0], max_n) + x.shape[2:], fill, x.dtype)
        out[:, :x.shape[1]] = x
        return out

    payload = pad_rows(np.asarray(local_sdb.payload))
    payload[:, local_max:, 0] = -1          # id column: padding
    return place_sharded_db(local_sdb._replace(
        payload=payload, vectors=pad_rows(local_sdb.vectors),
        pair_occ=pair_occ), [mesh[s] for s in my_shards])
