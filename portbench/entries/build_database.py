"""The in-memory build through `build_database`, repeated over the window.

Every build files the run's host-resident rows rotated by an offset of its
own (gen.py's `rows(offset)`, a view: no copy), the offsets a permutation
of 1 .. rotate_rows drawn from the seed, so no two builds in a row are
handed the same rows and a build that returned an earlier result would
file the wrong ids.  The check judges the window's last build against the
reference's index of that build's own rows.

Traffic keys: `keep_vectors`, `encode_chunk`, `warmup` (builds before the
window), `rotate_rows`, `check_rows` (rows whose line codes are checked),
`trace_seconds`.
"""

from __future__ import annotations

import contextlib
import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import cells, reference as ref, trace as tr


def offsets(s) -> np.ndarray:
    """The rotation of every build of the run, in order (cycled)."""
    rng = np.random.default_rng(s.seed)
    return rng.permutation(int(s.traffic["rotate_rows"])) + 1


def build_once(s, offset: int, mark: bool = False):
    if mark:
        tr.mark(s.device)
    db = s.P.build_database(s.cfg, s.tree, s.inputs.rows(offset),
                            keep_vectors=s.traffic["keep_vectors"],
                            encode_chunk=s.traffic["encode_chunk"],
                            device=s.device)
    cells.sync(s.device)
    return db


def build_window(s, rotations, start: int, seconds: float,
                 traced: bool = False):
    """Builds for `seconds` (one at least): the last database, its
    rotation, and every build's seconds."""
    builds, db, times = 0, None, []
    cells.settle()
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while builds == 0 or time.perf_counter() < deadline:
        db = None
        offset = int(rotations[(start + builds) % len(rotations)])
        t = time.perf_counter()
        db = build_once(s, offset, mark=traced)
        times.append(time.perf_counter() - t)
        builds += 1
    return SimpleNamespace(builds=builds, db=db, offset=offset, times=times,
                           window_s=time.perf_counter() - t_start)


def _marked_assembly(P, device):
    """The port's CSR assembly with a marker kernel launched before it, so
    a trace shows where a build's encode ends (models/db.py calls
    `_assemble_device` by its module's name)."""
    from pqt_tpu_torch.models import db as dbm
    original = dbm._assemble_device

    def assemble(*a, **kw):
        tr.mark(device)
        return original(*a, **kw)

    @contextlib.contextmanager
    def patched():
        dbm._assemble_device = assemble
        try:
            yield
        finally:
            dbm._assemble_device = original
    return patched()


def sample_rows(s, parts, payload):
    """Rows drawn from the seed for the line-code check (check_rows of
    them) and their payload rows, found through the database's ids (rows
    of zeros where the ids are not every row once)."""
    n = s.inputs.data.shape[0]
    rng = np.random.default_rng(s.seed)
    row_ids = torch.from_numpy(np.sort(rng.choice(
        n, size=min(n, s.traffic["check_rows"]), replace=False))).to(
        s.device)
    ids = parts.ids.to(torch.int64)
    if ids.shape[0] != n or not bool(((ids >= 0) & (ids < n)).all()):
        return row_ids, torch.zeros((row_ids.shape[0], payload.shape[1]),
                                    dtype=torch.int32, device=s.device)
    pos_of = torch.empty(n, dtype=torch.int64, device=s.device)
    pos_of[ids] = torch.arange(n, device=s.device)
    return row_ids, payload[pos_of[row_ids]].clone()


def check_line_codes(s, r, cb1, rows_payload, row_ids) -> dict:
    """codes_differ: the share of sampled (row, line part) codes whose
    line (A, B) differs from the reference's or whose lambda code is more
    than one step off; t3_rel_err: the largest relative error of the t3
    term (against max(|t3|, 1)) over the sampled rows whose codes all
    equal the reference's."""
    got = ref.unpack_payload(s.pqt, rows_payload)
    x = r.data[row_ids]
    a, b, lam, t3 = [], [], [], []
    for j in range(0, x.shape[0], 4096):
        out = ref.line_codes(s.pqt, cb1, x[j:j + 4096])
        for acc, v in zip((a, b, lam, t3), out):
            acc.append(v)
    a, b, lam, t3 = (torch.cat(v) for v in (a, b, lam, t3))
    differ = ((got[1] != a) | (got[2] != b) | ((got[3] - lam).abs() > 1))
    same = ((got[1] == a) & (got[2] == b) & (got[3] == lam)).all(1) & (
        got[0] == row_ids)
    rel = ((got[4] - t3).abs() / t3.abs().clamp_min(1.0))[same]
    return {"codes_differ": float(differ.double().mean()
                                  + (got[0] != row_ids).double().mean()),
            "t3_rel_err": float(rel.max()) if rel.numel() else 1.0}


def _judge_build(s, r, cb1, parts, row_ids, rows_payload) -> dict:
    c = cells.check_database(s, r, parts)
    c.update(check_line_codes(s, r, cb1, rows_payload, row_ids))
    return c


def _kept(s, db):
    """What the check keeps of a database: (parts, sampled row ids, their
    payload rows)."""
    parts = cells.db_parts(db)
    row_ids, rows_payload = sample_rows(s, parts, db.payload)
    return parts, row_ids, rows_payload


# --- the run -----------------------------------------------------------------

def run(s, seconds: float, traced: bool, t0: float) -> dict:
    rotations = offsets(s)
    warm = s.traffic.get("warmup", 1)
    t = time.perf_counter()
    for i in range(warm):
        build_once(s, int(rotations[i % len(rotations)]))
    s.setup_parts["warmup_builds_s"] = time.perf_counter() - t
    held = cells.captures(s.P)
    setup_s = time.perf_counter() - t0
    n = s.inputs.data.shape[0]
    if traced:
        with _marked_assembly(s.P, s.device):
            w, trace = tr.traced(lambda: build_window(
                s, rotations, warm, min(seconds, s.traffic["trace_seconds"]),
                True), s.devices)
        if len(trace.marks()) != 2 * w.builds:
            raise RuntimeError(
                f"the traced builds left {len(trace.marks())} marks, not "
                f"{2 * w.builds}: the port's build no longer calls "
                f"models.db._assemble_device once a build")
    else:
        w, trace = build_window(s, rotations, warm, seconds), None
    in_window = cells.captures(s.P) - held
    peak = cells.peak(cells.visible(s.devices))
    kept = _kept(s, w.db)
    w.db = None
    cb1, cb2 = cells.take_tree(s)
    cells.free_state(s.P, s.device)

    t_ref = time.perf_counter()
    r = cells.reference_index(s, s.inputs.rows(w.offset), cb1, cb2)
    checks = cells.check_tree(s, cb1, cb2)
    checks.update(_judge_build(s, r, cb1, *kept))
    e2e = {"build_rows_per_s": n * w.builds / w.window_s, "setup_s": setup_s}
    chunk = s.traffic["encode_chunk"]
    record = SimpleNamespace(
        kind="build", trace=trace, pqt=s.pqt, rows=n * w.builds,
        builds=w.builds,
        chunk_rows=[min(chunk, n - c) for c in range(0, n, chunk)])
    info = {"captures_in_window": in_window, "builds": w.builds,
            "window_s": w.window_s, "build_s": w.times,
            "setup_parts": s.setup_parts,
            "reference_s": time.perf_counter() - t_ref}
    return dict(e2e=e2e, record=record, checks=checks, peak=peak,
                attempted=w.builds, failed=0, info=info)


# --- the control and the faults ---------------------------------------------

def control(s) -> dict:
    """Judged readings, at the cell's size, of two builds as the window
    makes them ("sound": the second), of faults (the first build's database
    handed back for the second's rows; half of the rows built; a tree
    whose Lloyd steps keep their centroids), and of the reference in
    bfloat16 in the port's place."""
    from portbench import control as ctl
    n = s.inputs.data.shape[0]
    rot = offsets(s)
    first = _kept(s, build_once(s, int(rot[0])))
    sound = _kept(s, build_once(s, int(rot[1])))
    half_db = s.P.build_database(s.cfg, s.tree, s.inputs.rows(int(rot[1]))
                                 [:n // 2], keep_vectors=False,
                                 device=s.device)
    half = cells.db_parts(half_db)
    del half_db
    cb1, cb2 = cells.take_tree(s)
    cells.free_state(s.P, s.device)
    bad_cb = ctl.faulty_tree(s)
    cells.free_state(s.P, s.device)
    r = cells.reference_index(s, s.inputs.rows(int(rot[1])), cb1, cb2)
    out = {}
    c = cells.check_tree(s, cb1, cb2)
    c.update(_judge_build(s, r, cb1, *sound))
    out["sound"] = c
    out["fault_stale"] = _judge_build(s, r, cb1, *first)
    out["fault_half_batch"] = cells.check_database(s, r, half)
    out["fault_tree_unchanged"] = cells.check_tree(s, *bad_cb)
    low = ref.build_index(s.pqt, ref.encode_codes(s.pqt, cb1, cb2, r.data,
                                                  dtype=torch.bfloat16))
    row_ids = sound[1][:4096]
    lc = ref.line_codes(s.pqt, cb1, r.data[row_ids], dtype=torch.bfloat16)
    a0, b0, lam0, t30 = ref.line_codes(s.pqt, cb1, r.data[row_ids])
    a, b, lam, t3 = lc
    same = ((a == a0) & (b == b0) & (lam == lam0)).all(1)
    rel = ((t3.double() - t30).abs() / t30.abs().clamp_min(1.0))[same]
    out["control_bf16"] = dict(
        ctl.bf16_tree_check(s),
        bins_differ=float((low.bins != r.index.bins).double().mean()),
        codes_differ=float(((a != a0) | (b != b0) | ((lam - lam0).abs() > 1))
                           .double().mean()),
        t3_rel_err=float(rel.max()) if rel.numel() else 1.0)
    return out
