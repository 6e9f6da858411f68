"""One run of one cell: what every kind of cell shares.

A cell's traffic mix names its `entry`, the module
`portbench/entries/<entry>.py`, which runs the cell's set-up, its measured
window and its check (`run`), and reads the check's control and faults
(`control`, for control.py).  Here: the inputs and the tree of a run
(`prepare`), the port's state freed after the window, the reference's
index of a run's rows, the checks of the tree and of the inverted file
that every entry makes, the verdict against the cell's limits, and the
result line.

Set-up makes the inputs from the seed and trains the tree through the
port's own entry point; the entry builds what it serves and warms up the
shapes its window uses, so nothing is captured inside the window.  After
the window the device's peak memory is read, the port's state is freed,
and the plain reference (reference.py) works out the tree, the database
and the answers again and judges the port's.

A cell runs on as many cards as its `chips` says: set-up hands the entry
`devices`, cards 0 to chips - 1, and keeps the inputs and the tree on the
first (`device`).  The result's `device` says which cards the run used:
`count` is the number of cards that hold allocations after the window,
`memory_peak_bytes` the fullest card's peak, and with a trace `busy_s`
the mean of those cards' busy seconds (the trace's `cards`, set here
before the per-layer readers read it).
"""

from __future__ import annotations

import dataclasses
import gc
import os
import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import gen, reference as ref


def _system():
    """The system under test, imported when a run starts."""
    import pqt_tpu_torch as P
    return P


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_devices(device, chips: int) -> list:
    """The cards a cell of `chips` cards runs on: cuda:0 .. cuda:chips-1
    (on the CPU, the CPU once a card, as a test's stand-in)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(chips)]
    return [dev] * chips


def visible(devices) -> list:
    """Every card torch sees, of the run's kind (on the CPU, the run's
    own stand-ins)."""
    if devices[0].type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return list(devices)


def _graph_caches(P) -> list:
    from pqt_tpu_torch.models import db, kmeans
    return [getattr(f, "graphs", {}) for f in (
        P.query_knn, db.chunk_encoder, kmeans._lloyd_converge,
        kmeans._kmeanspp_init)]


def captures(P) -> int:
    """The graphs the port holds (a capture inside the window adds one)."""
    return sum(len(g) for g in _graph_caches(P))


def free_state(P, device) -> None:
    """Drop the port's graphs and cached blocks (after the caller dropped
    its references to the tree and the database)."""
    for g in _graph_caches(P):
        g.clear()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def settle() -> None:
    """Collect set-up's garbage and move what survives out of the
    collector's way, so the window's collections scan only its own."""
    gc.collect()
    gc.freeze()


def peak(devices) -> list:
    """The peak allocated bytes of each card of `devices`, in order (0
    off a card).  Pass `visible(s.devices)`, so that a card the run
    should not have touched shows; reading a card's allocator makes no
    context on it."""
    return [int(torch.cuda.max_memory_allocated(d)) if d.type == "cuda"
            else 0 for d in devices]


def used_cards(devices, peaks: list) -> list:
    """The indices of the cards that hold allocations (on the CPU, the
    run's stand-ins' places)."""
    if devices[0].type == "cuda":
        return [i for i, p in enumerate(peaks) if p > 0]
    return list(range(len(devices)))


def device_info(devices, peaks: list) -> dict:
    """The result's `device`: the number of cards used, the fullest
    card's peak and every card's."""
    cuda = devices[0].type == "cuda"
    return {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": len(used_cards(devices, peaks)),
            "memory_peak_bytes": max(peaks),
            "memory_peak_bytes_by_card": {str(i): p
                                          for i, p in enumerate(peaks)}}


class Setup(SimpleNamespace):
    """A cell's inputs and the port's state after set-up."""


def prepare(bench, cell: str, seed: int, device="cuda") -> Setup:
    """Inputs from the seed, and the tree the port trains on them."""
    P = _system()
    entry = bench.cell(cell)
    config = bench.config(entry["config"])
    traffic = bench.traffic(entry["traffic"])
    devices = run_devices(device, entry["chips"])
    device = devices[0]
    t = time.perf_counter()
    inputs = gen.make_inputs(config, traffic, seed, device)
    parts = {"inputs_s": time.perf_counter() - t}
    pqt = {f.name: config[f.name] for f in dataclasses.fields(P.PQTConfig)}
    cfg = P.PQTConfig(**pqt)
    t = time.perf_counter()
    tree = P.train_tree(cfg, inputs.data[:config["n_train"]], device=device)
    sync(device)
    parts["train_s"] = time.perf_counter() - t
    return Setup(P=P, cell=cell, entry=entry, config=config,
                 traffic=traffic, limits=bench.limits(cell), inputs=inputs,
                 cfg=cfg, pqt=pqt, tree=tree, seed=seed, device=device,
                 devices=devices, setup_parts=parts)


def take_tree(s: Setup):
    """Copies of the port's codebooks; the port's tree is dropped."""
    cb1, cb2 = s.tree.cb1.clone(), s.tree.cb2.clone()
    s.tree = None
    return cb1, cb2


def db_parts(db) -> SimpleNamespace:
    """What the check reads of a database: its probe table and the ids in
    CSR order (copies, so the database itself can be freed)."""
    return SimpleNamespace(prefix2=db.prefix2.clone(),
                           ids=db.payload[:, 0].clone())


# --- the check ---------------------------------------------------------------

class Reference(SimpleNamespace):
    """The reference's view of a run: the rows on the device, its index."""


def reference_index(s: Setup, rows: np.ndarray, cb1, cb2,
                    dtype=torch.float64) -> Reference:
    """The reference's inverted file of `rows` (ids = row numbers) under
    the port's codebooks."""
    ref.exact_products()
    data = torch.from_numpy(rows).to(s.device)
    codes = ref.encode_codes(s.pqt, cb1, cb2, data, dtype=dtype)
    return Reference(data=data, index=ref.build_index(s.pqt, codes))


def check_tree(s: Setup, cb1, cb2) -> dict:
    """tree_excess: how much more the port's tree distorts the training
    rows than a tree the reference trains on them itself."""
    train = torch.from_numpy(s.inputs.data[:s.config["n_train"]]).to(
        s.device)
    mine = ref.train_tree(s.pqt, train, s.seed)
    return {"tree_excess": ref.tree_excess(s.pqt, cb1, cb2, *mine, train)}


def check_database(s: Setup, r: Reference, parts) -> dict:
    """csr_faults: the port's inverted file breaks its own invariants (ids
    not a permutation of the rows, extents not the prefix of their
    counts, ids not ascending inside a bin); bins_differ: the share of
    rows the port files under another bin than the reference."""
    n, H = r.data.shape[0], s.pqt["hash_size"]
    p2 = parts.prefix2.to(torch.int64)
    ids = parts.ids.to(torch.int64)
    counts = p2[:, 1] - p2[:, 0]
    faults = int((counts < 0).sum())
    faults += int((p2[:, 0] != torch.cumsum(counts, 0) - counts).sum())
    if ids.shape[0] != n or int(counts.clamp_min(0).sum()) != n:
        return {"csr_faults": faults + 1 + abs(ids.shape[0] - n),
                "bins_differ": 1.0}
    seen = torch.zeros(n, dtype=torch.int64, device=ids.device)
    inside = (ids >= 0) & (ids < n)
    seen.index_add_(0, ids[inside], torch.ones_like(ids[inside]))
    faults += int((seen != 1).sum())
    bin_of_pos = torch.repeat_interleave(
        torch.arange(H, device=ids.device), counts.clamp_min(0))
    same_bin = bin_of_pos[1:] == bin_of_pos[:-1]
    faults += int((same_bin & (ids[1:] <= ids[:-1])).sum())
    port_bin = torch.full((n,), -1, dtype=torch.int64, device=ids.device)
    port_bin[ids[inside]] = bin_of_pos[inside]
    return {"csr_faults": faults,
            "bins_differ": float((port_bin != r.index.bins).double().mean())}


def verdict(checks: dict, limits: dict):
    """(correct, {name: {value, limit}} of the numbers the cell's limits
    name, {name: value} of the others): correct when every number named
    there is computed and at or under its limit.  A cell leaves out a
    number that cannot separate its sound runs from its control and
    faults (PERF.md says which and why)."""
    compared, ok = {}, True
    for name, limit in limits.items():
        value = checks.get(name)
        compared[name] = {"value": value, "limit": limit}
        ok = ok and value is not None and not (value != value) \
            and value <= limit
    return ok, compared, {k: v for k, v in checks.items()
                          if k not in limits}


# --- the run -----------------------------------------------------------------

def run(bench, cell: str, seed: int, seconds: float, traced: bool,
        device="cuda", t0: float | None = None) -> dict:
    """One run of `cell`: the result line's object (its `checks` last).

    The entry's `run(s, seconds, traced, t0)` returns a dict: `e2e` (the
    end-to-end metrics by name), `record` (what the per-layer readers
    read: `kind`, `trace` and the entry's own fields), `checks`, `peak`
    (`peak(visible(s.devices))`, read after the window), `attempted`,
    `failed` and `info`."""
    t0 = time.perf_counter() if t0 is None else t0
    s = prepare(bench, cell, seed, device)
    out = bench.entry(s.traffic["entry"]).run(s, seconds, traced, t0)
    correct, checks, unjudged = verdict(out["checks"], s.limits)
    trace = out["record"].trace
    if trace is not None:     # busy time over the cards the run used
        trace = out["record"].trace = trace._replace(
            cards=tuple(used_cards(s.devices, out["peak"])))
    metrics = {}
    for m in bench.metrics(cell, traced):
        if traced:
            value = bench.reader(m["name"]).read(out["record"])
            if value is None:
                continue
        else:
            value = out["e2e"][m["name"]]
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    info = device_info(s.devices, out["peak"])
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": info}
    if trace is not None:
        info["busy_s"] = trace.busy_s()
        info["busy_s_by_card"] = {str(c): v for c, v in
                                  trace.busy_s_by_card().items()}
        info["window_s"] = trace.window_s
        out["info"]["trace_sessions"] = trace.attempts
        result["breakdown"] = {"device_ops": trace.device_top(),
                               "idle_gaps": trace.idle_gaps()}
    result["info"] = dict(out["info"], unjudged=unjudged,
                          torch_threads=torch.get_num_threads(),
                          cpus=len(os.sched_getaffinity(0)))
    result["checks"] = checks
    return result
