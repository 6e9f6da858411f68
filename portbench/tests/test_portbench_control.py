"""The correctness check fails what it must: the control (the reference
in bfloat16 in the port's place) and faults planted in the port, judged
by a whole run of a tiny cell on the CPU (the look for a card skipped)."""

import numpy as np
import pytest
import torch

import pqt_tpu_torch as P
from pqt_tpu_torch.models import db as dbm
from portbench import cells, common, control


def _run(root, cell, seed=2 ** 31 + 21):
    return cells.run(common.Bench(root), cell, seed, 0.4, False,
                     device="cpu")


@pytest.mark.parametrize("cell", ["tinyb.b32", "tinyb.build"])
def test_control_and_faults_read_over_the_limits(tiny_root, cell):
    bench = common.Bench(tiny_root)
    limits = bench.limits(cell)
    got = control.readings(bench, cell, 2 ** 31 + 3, device="cpu")
    assert cells.verdict(got["sound"], limits)[0], got["sound"]
    assert got["control_bf16"]
    assert {"fault_stale", "fault_half_batch", "fault_tree_unchanged"} <= \
        set(got)
    for name, checks in got.items():
        if name != "sound":     # some number it reads is over its limit
            assert any(k in limits and v > limits[k]
                       for k, v in checks.items()), (name, checks)


def _altered(real):
    def q(*a, **kw):
        r = real(*a, **kw)
        ids = r.indices.clone()
        ids[:, 0] = torch.where(ids[:, 0] >= 0, ids[:, 0] + 1, -1)
        return r._replace(indices=ids)
    return q


def _half(real):
    def q(cfg, tree, db, queries, *a, **kw):
        B = queries.shape[0]
        r = real(cfg, tree, db, queries[:B // 2], *a, **kw)
        pad = B - B // 2
        return r._replace(
            indices=torch.cat([r.indices, torch.full(
                (pad, r.indices.shape[1]), -1, dtype=r.indices.dtype)]),
            dists=torch.cat([r.dists, torch.full(
                (pad, r.dists.shape[1]), float("inf"))]),
            n_candidates=torch.cat([r.n_candidates,
                                    r.n_candidates[:pad]]))
    return q


def _unchanged(real):
    state = {}

    def q(*a, **kw):
        r = real(*a, **kw)
        out = state.get("last", r)
        state["last"] = r
        return out
    return q


@pytest.mark.parametrize("fault", [_altered, _half, _unchanged])
def test_serving_fault_fails_the_run(tiny_root, monkeypatch, fault):
    monkeypatch.setattr(P, "query_knn", fault(P.query_knn))
    assert not _run(tiny_root, "tinyb.b32")["correct"]


def test_build_fault_half_the_rows_fails_the_run(tiny_root, monkeypatch):
    real = P.build_database

    def half(cfg, tree, data, *a, **kw):
        return real(cfg, tree, data[:data.shape[0] // 2], *a, **kw)
    monkeypatch.setattr(P, "build_database", half)
    assert not _run(tiny_root, "tinyb.build")["correct"]


def test_build_fault_altered_bins_fails_the_run(tiny_root, monkeypatch):
    real = dbm._assemble_device

    def shifted(cfg, bins, packed):
        bins = bins.clone()
        bins[::97] = (bins[::97] + 1) % cfg.hash_size
        return real(cfg, bins, packed)
    monkeypatch.setattr(dbm, "_assemble_device", shifted)
    assert not _run(tiny_root, "tinyb.build")["correct"]


def test_build_fault_stale_database_fails_the_run(tiny_root, monkeypatch):
    """A build that hands back the previous build's database."""
    real = P.build_database
    state = {}

    def stale(*a, **kw):
        db = real(*a, **kw)
        out = state.get("last", db)
        state["last"] = db
        return out
    monkeypatch.setattr(P, "build_database", stale)
    out = _run(tiny_root, "tinyb.build")
    assert not out["correct"]
    assert out["checks"]["bins_differ"]["value"] > 0.5


def test_tree_left_unchanged_fails_the_run(tiny_root):
    undo = control.lloyd_unchanged(P)
    try:
        out = _run(tiny_root, "tinyb.build")
    finally:
        undo()
    assert not out["correct"]
    assert out["checks"]["tree_excess"]["value"] > \
        out["checks"]["tree_excess"]["limit"]


def test_degenerate_tree_fails_the_run(tiny_root, monkeypatch):
    """A tree whose centroids all sit on one point of its training rows:
    every number worked out from the port's own codebooks can agree with
    it, so the reference's own tree and the exact neighbours must not."""
    real = P.train_tree

    def collapsed(cfg, data, *a, **kw):
        tree = real(cfg, data, *a, **kw)
        return type(tree).from_codebooks(
            cfg, tree.cb1[:, :1].expand_as(tree.cb1).contiguous(),
            tree.cb2[:, :1, :1].expand_as(tree.cb2).contiguous())
    monkeypatch.setattr(P, "train_tree", collapsed)
    out = _run(tiny_root, "tinyb.b32")
    assert not out["correct"]
    for name in ("tree_excess", "recall_shortfall"):
        assert out["checks"][name]["value"] > out["checks"][name]["limit"]


def test_sound_runs_are_correct(tiny_root):
    for cell in ("tinyb.b32", "tinyb.build"):
        out = _run(tiny_root, cell)
        assert out["correct"], (cell, out["checks"])


@pytest.mark.card
def test_tiny_cell_on_the_card(tiny_root, card):
    out = cells.run(common.Bench(tiny_root), "tinyb.b32", 7, 1.0, True,
                    device=card)
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
    assert np.isfinite(out["metrics"]["device_us_per_query"]["value"])
