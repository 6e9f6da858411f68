"""Closed-loop batch serving through `query_knn`, one batch in flight.

A batch is handed to the port as numpy queries and is done when its ids
and distances are in numpy arrays on the host.  The queries go through a
pinned host buffer to the card and the answers come back through pinned
buffers (on a card; plain tensors elsewhere), as a serving process that
keeps its buffers does.  The pool of queries is cycled in batches (batch
b holds pool rows b * batch .. modulo the pool).

Traffic keys: `exact_rerank` (the check assumes true), `k`, `batch`,
`pool`, `warmup` (batches before the window), `check_queries` (answers
checked), `recall_queries` (the distinct answered queries, drawn from the
seed, that `recall_at_10` is taken over; all of them where it is absent),
`trace_seconds`, and gen.py's `query_dist`.
"""

from __future__ import annotations

import contextlib
import math
import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import cells, reference as ref, trace as tr, yardstick


class Staging:
    """The host side of a batch: pinned buffers on a card."""

    def __init__(self, batch: int, dim: int, device):
        self.device = device
        self.cuda = torch.device(device).type == "cuda"
        self.q_host = torch.empty((batch, dim), dtype=torch.float32,
                                  pin_memory=self.cuda)
        self.q_dev = torch.empty((batch, dim), dtype=torch.float32,
                                 device=device)
        self.out = None

    def upload(self, q_np: np.ndarray) -> torch.Tensor:
        self.q_host.numpy()[...] = q_np
        self.q_dev.copy_(self.q_host, non_blocking=True)
        return self.q_dev

    def download(self, r):
        """(ids, dists) of a result as numpy arrays of their own."""
        if not self.cuda:
            return r.indices.numpy().copy(), r.dists.numpy().copy()
        if self.out is None:
            self.out = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                        for t in (r.indices, r.dists)]
        for host, t in zip(self.out, (r.indices, r.dists)):
            host.copy_(t, non_blocking=True)
        torch.cuda.current_stream().synchronize()
        return tuple(host.numpy().copy() for host in self.out)


def distinct_batches(queries: np.ndarray, batch: int) -> list:
    """The batches the pool cycles through: pool // gcd(pool, batch) of
    them, batch b holding rows (b * batch + i) % pool."""
    pool = queries.shape[0]
    return [np.ascontiguousarray(
        queries[(b * batch + np.arange(batch)) % pool])
        for b in range(pool // math.gcd(pool, batch))]


def serve_batch(s, db, stage: Staging, q_np: np.ndarray,
                span=contextlib.nullcontext):
    """One batch as a user serves it: (ids, dists (numpy), n_candidates
    (on the device), host seconds of the call, seconds in all)."""
    t0 = time.perf_counter()
    with span("portbench.upload"):
        q = stage.upload(q_np)
    with span("portbench.call"):
        t1 = time.perf_counter()
        r = s.P.query_knn(s.cfg, s.tree, db, q, s.traffic["k"],
                          s.traffic["exact_rerank"])
        t2 = time.perf_counter()
    with span("portbench.download"):
        ids, dists = stage.download(r)
    return ids, dists, r.n_candidates, t2 - t1, time.perf_counter() - t0


def serve_window(s, db, stage, batches: list, seconds: float,
                 traced: bool = False):
    """Closed-loop serving for `seconds`: every batch's latency and host
    call time, and the last answers of every distinct batch."""
    span = torch.profiler.record_function if traced else \
        contextlib.nullcontext
    cells.settle()
    lat, host, last = [], [], {}
    n_cand = []
    i = 0
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while True:
        b = i % len(batches)
        ids, dists, nc, h, total = serve_batch(s, db, stage, batches[b],
                                               span)
        lat.append(total)
        host.append(h)
        last[b] = (ids, dists, nc)
        if traced:
            n_cand.append(nc)
        i += 1
        if time.perf_counter() >= deadline:
            break
    window_s = time.perf_counter() - t_start
    return SimpleNamespace(batches=i, queries=i * len(batches[0]),
                           window_s=window_s, lat=lat, host=host, last=last,
                           n_cand=n_cand)


def serve_setup(s):
    """The database, built by the port, the staging buffers and the
    warmed-up batch shape."""
    t = time.perf_counter()
    db = s.P.build_database(s.cfg, s.tree, s.inputs.data, keep_vectors=True,
                            device=s.device)
    cells.sync(s.device)
    s.setup_parts["build_s"] = time.perf_counter() - t
    batches = distinct_batches(s.inputs.queries, s.traffic["batch"])
    stage = Staging(s.traffic["batch"], s.inputs.queries.shape[1], s.device)
    for b in range(s.traffic.get("warmup", 4)):
        serve_batch(s, db, stage, batches[b % len(batches)])
    cells.sync(s.device)
    return db, stage, batches


def sample_answers(s, last: dict, batch: int, n_check: int):
    """Answered batches drawn from the seed, n_check queries or more:
    (pool rows, ids, dists, n_candidates) of their last answers."""
    rng = np.random.default_rng(s.seed)
    done = sorted(last)
    pick = rng.choice(len(done), size=min(len(done),
                                          -(-n_check // batch)),
                      replace=False)
    pool = s.inputs.queries.shape[0]
    rows, ids, dists, nc = [], [], [], []
    for j in sorted(pick):
        b = done[j]
        rows.append((b * batch + np.arange(batch)) % pool)
        ids.append(last[b][0])
        dists.append(last[b][1])
        nc.append(last[b][2].cpu().numpy())
    return (np.concatenate(rows), np.concatenate(ids),
            np.concatenate(dists), np.concatenate(nc))


def answered_top(s, last: dict, batch: int, k: int = 10):
    """(pool rows, their answers' first k ids) of the distinct queries
    answered, or of recall_queries of them drawn from the seed."""
    pool = s.inputs.queries.shape[0]
    top = np.full((pool, k), -1, np.int64)
    seen = np.zeros(pool, bool)
    for b, (ids, _, _) in last.items():
        rows = (b * batch + np.arange(batch)) % pool
        top[rows] = ids[:, :k]
        seen[rows] = True
    rows = np.flatnonzero(seen)
    want = s.traffic.get("recall_queries", rows.shape[0])
    if want < rows.shape[0]:
        rng = np.random.default_rng([s.seed, 1])
        rows = np.sort(rng.choice(rows, size=want, replace=False))
    return rows, top[rows]


# --- the check ---------------------------------------------------------------

def reference_answers(s, r, cb1, cb2, rows, dtype=torch.float64):
    """The reference's answers to the pool rows `rows`: ref.Answers."""
    q = torch.from_numpy(s.inputs.queries[rows]).to(s.device)
    return ref.query(s.pqt, cb1, cb2, r.index, r.data, q, s.traffic["k"],
                     dtype)


def check_answers(s, r, want, truth, rows, ids, dists, nc) -> dict:
    """wrong_dists: answers whose distance is not the exact squared
    distance of their id; bad_rows: answers with ids out of range, out of
    distance order, a hole before a valid id, or other than min(k,
    n_candidates) valid ids; ncand_differ / topk_differ: the share of
    queries whose candidate count / ranked answers differ from the
    reference's (`want`); recall_shortfall: 1 - |top-10 ∩ the exact 10
    nearest rows (`truth`)| / 10, the mean over the queries.  An id may
    come twice: two probed bins can hash to one slot, and the
    configuration does not dedup (dedup_candidates off), so the reference
    returns the same repeats."""
    dev, n, k = s.device, r.data.shape[0], s.traffic["k"]
    q = torch.from_numpy(s.inputs.queries[rows]).to(dev)
    recall = yardstick.intersection_at(ids[:, :10], truth, (10,))
    ids = torch.from_numpy(ids).to(dev, torch.int64)
    d = torch.from_numpy(dists).to(dev, torch.float64)
    nc = torch.from_numpy(nc).to(dev, torch.int64)
    valid = ids >= 0
    ok_id = valid & (ids < n)
    exact = ref.exact_sqdist(r.data[torch.where(ok_id, ids, 0)],
                             q[:, None, :])
    wrong = int((ok_id & (exact != d)).sum())
    bad = ~(ok_id | ~valid).all(1)
    bad |= (valid[:, 1:] & ~valid[:, :-1]).any(1)
    bad |= (valid[:, 1:] & (d[:, 1:] < d[:, :-1])).any(1)
    bad |= valid.sum(1) != torch.clamp_max(nc, k)
    return {"wrong_dists": wrong, "bad_rows": int(bad.sum()),
            "ncand_differ": float((want.n_candidates != nc).double().mean()),
            "topk_differ": float(_ranked_differ(ids, d, want).double()
                                 .mean()),
            "recall_shortfall": 1.0 - recall["top10_intersection"]}


def _ranked_differ(ids, d, want) -> torch.Tensor:
    """Per query: do the answers, as (distance, id) pairs in order, differ
    from the reference's (ties ordered by id on both sides)?"""
    def canon(i, dd):
        key = torch.where(i >= 0, dd, float("inf"))
        o = torch.argsort(i, dim=1, stable=True)
        o = torch.gather(o, 1, torch.argsort(torch.gather(key, 1, o),
                                             dim=1, stable=True))
        return torch.gather(i, 1, o), torch.gather(key, 1, o)
    a_i, a_d = canon(ids, d)
    b_i, b_d = canon(want.ids, want.dists)
    return (a_i != b_i).any(1) | (a_d != b_d).any(1)


def exact_truth(s, r, rows) -> np.ndarray:
    """The exact 10 nearest rows of the pool rows `rows`."""
    q = torch.from_numpy(s.inputs.queries[rows]).to(s.device)
    return ref.exact_top(r.data, q, 10).cpu().numpy()


# --- the run -----------------------------------------------------------------

def run(s, seconds: float, traced: bool, t0: float) -> dict:
    db, stage, batches = serve_setup(s)
    held = cells.captures(s.P)
    setup_s = time.perf_counter() - t0
    batch = s.traffic["batch"]
    if traced:
        w, trace = tr.traced(lambda: serve_window(
            s, db, stage, batches, min(seconds, s.traffic["trace_seconds"]),
            traced=True), s.devices)
    else:
        w, trace = serve_window(s, db, stage, batches, seconds), None
    in_window = cells.captures(s.P) - held
    peak = cells.peak(cells.visible(s.devices))
    parts = cells.db_parts(db)
    sample = sample_answers(s, w.last, batch, s.traffic["check_queries"])
    pool = s.inputs.queries.shape[0]
    top_rows, top10 = answered_top(s, w.last, batch)
    valid_cand = (int(sum(int(x.sum()) for x in w.n_cand))
                  if traced else None)
    del db, w.last, stage
    cb1, cb2 = cells.take_tree(s)
    cells.free_state(s.P, s.device)

    t_ref = time.perf_counter()
    r = cells.reference_index(s, s.inputs.data, cb1, cb2)
    checks = cells.check_tree(s, cb1, cb2)
    checks.update(cells.check_database(s, r, parts))
    truth = np.full((pool, 10), -1, np.int64)
    need = np.union1d(top_rows, sample[0])
    truth[need] = exact_truth(s, r, need)
    want = reference_answers(s, r, cb1, cb2, sample[0])
    checks.update(check_answers(s, r, want, truth[sample[0]], *sample))
    recall = yardstick.intersection_at(top10, truth[top_rows], (10,))
    e2e = {"qps": w.queries / w.window_s,
           "batch_p95_ms": float(np.percentile(np.asarray(w.lat) * 1e3, 95)),
           "recall_at_10": recall["top10_intersection"], "setup_s": setup_s}
    record = SimpleNamespace(
        kind="serve", trace=trace, pqt=s.pqt, batch=batch, k=s.traffic["k"],
        queries=w.queries, batches=w.batches, host_s=w.host,
        valid_candidates=valid_cand)
    info = {"captures_in_window": in_window, "batches": w.batches,
            "window_s": w.window_s, "batch_p50_ms":
                float(np.percentile(np.asarray(w.lat) * 1e3, 50)),
            "setup_parts": s.setup_parts,
            "reference_s": time.perf_counter() - t_ref}
    return dict(e2e=e2e, record=record, checks=checks, peak=peak,
                attempted=w.queries, failed=checks["bad_rows"], info=info)


# --- the control and the faults ---------------------------------------------

def control(s) -> dict:
    """Judged readings, at the cell's size, of the port as the window
    drives it ("sound"), of the faults planted in its answers and its tree,
    and of the reference in bfloat16 in the port's place."""
    from portbench import control as ctl
    db, stage, batches = serve_setup(s)
    batch = s.traffic["batch"]
    rng = np.random.default_rng(s.seed)
    pick = sorted(rng.choice(len(batches), size=min(
        len(batches), -(-s.traffic["check_queries"] // batch)),
        replace=False))
    last = {}
    for b in pick:
        ids, dists, nc, _, _ = serve_batch(s, db, stage, batches[b])
        last[b] = (ids, dists, nc)
    cells.sync(s.device)
    parts = cells.db_parts(db)
    del db, stage
    cb1, cb2 = cells.take_tree(s)
    cells.free_state(s.P, s.device)
    rows, ids, dists, nc = sample_answers(s, last, batch,
                                          s.traffic["check_queries"])
    bad_cb = ctl.faulty_tree(s)
    cells.free_state(s.P, s.device)
    r = cells.reference_index(s, s.inputs.data, cb1, cb2)
    tree = cells.check_tree(s, cb1, cb2)
    db_checks = cells.check_database(s, r, parts)
    truth = exact_truth(s, r, rows)
    want = reference_answers(s, r, cb1, cb2, rows)
    out = {}

    def judge(name, ids_, dists_, nc_, base=None):
        c = dict(tree if base is None else base)
        c.update(db_checks)
        c.update(check_answers(s, r, want, truth, rows, ids_, dists_, nc_))
        out[name] = c

    judge("sound", ids, dists, nc)
    altered = ids.copy()
    altered[:, 0] = np.where(altered[:, 0] >= 0,
                             (altered[:, 0] + 1) % r.data.shape[0], -1)
    judge("fault_altered", altered, dists, nc)
    half, hd = ids.copy(), dists.copy()
    for j in range(0, ids.shape[0], batch):
        half[j + batch // 2:j + batch] = -1
        hd[j + batch // 2:j + batch] = np.inf
    judge("fault_half_batch", half, hd, nc)
    judge("fault_stale", np.roll(ids, batch, 0), np.roll(dists, batch, 0),
          np.roll(nc, batch, 0))
    low_index = ref.build_index(s.pqt, ref.encode_codes(
        s.pqt, cb1, cb2, r.data, dtype=torch.bfloat16))
    q = torch.from_numpy(s.inputs.queries[rows]).to(s.device)
    low = ref.query(s.pqt, cb1, cb2, low_index, r.data, q, s.traffic["k"],
                    dtype=torch.bfloat16)
    judge("control_bf16", low.ids.cpu().numpy(),
          low.dists.float().cpu().numpy(), low.n_candidates.cpu().numpy(),
          base=ctl.bf16_tree_check(s))
    out["control_bf16"]["bins_differ"] = float(
        (low_index.bins != r.index.bins).double().mean())
    out["fault_tree_unchanged"] = cells.check_tree(s, *bad_cb)
    return out
