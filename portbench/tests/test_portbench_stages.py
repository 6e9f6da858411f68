"""The stage metrics (portbench/stages.py and their readers) on synthetic
traces whose marks are named as the port's mark kernel is named: each
metric's value, a lost first mark dropping only its own call, and None
where a window holds no complete sequence or the program has no marks."""

from types import SimpleNamespace

import pytest

from portbench import common, stages
from portbench import trace as tr
from conftest import REPO

QUERY = ("tables", "pair", "probe", "candidates", "rerank")
BUILD = ("upload", "part_codes", "payload", "assemble")


def _mark(stage: str, t: float):
    from pqt_tpu_torch.utils import tracing
    i = tracing.STAGES.index(stage)
    return (f"void {tracing.MARK_KERNEL}<{i}>()", t, t + 1.0)


def _replay(t0: float, scale: float = 1.0) -> list:
    """One replayed query: its marks and device work from t0 (us).  The
    stages' work: tables 10 (and a pad, left out), pair 30, probe 5,
    candidates 8 and a copy of 1, rerank 4, all times `scale`; then a
    clone of 2 after the end mark, outside every stage."""
    s = scale
    return [
        ("Memcpy DtoD (Device -> Device)", t0 - 5, t0 - 4),     # copy-in
        _mark("query.tables", t0),
        ("void " + tr.PAD_KERNEL + "_kernel()", t0 + 1.5, t0 + 1.8),
        ("tables_kernel", t0 + 2, t0 + 2 + 10 * s),
        _mark("query.pair", t0 + 40),
        ("radix_select_kernel", t0 + 42, t0 + 42 + 30 * s),
        _mark("query.probe", t0 + 80),
        ("gather_rows_kernel", t0 + 82, t0 + 82 + 5 * s),
        _mark("query.candidates", t0 + 90),
        ("gather_rerank_kernel", t0 + 92, t0 + 92 + 8 * s),
        ("Memcpy DtoD (Device -> Device)", t0 + 92 + 8 * s,
         t0 + 93 + 8 * s),
        _mark("query.rerank", t0 + 120),
        ("gather_sqdist_kernel", t0 + 122, t0 + 122 + 4 * s),
        _mark("query.end", t0 + 130),
        ("Memcpy DtoD (Device -> Device)", t0 + 133, t0 + 135),  # clone
    ]


def _serve_trace(replays: list, host=()) -> tr.Trace:
    dev = [e for r in replays for e in r]
    return tr.Trace(dev, [("portbench.window", 0.0, 10000.0)] + list(host),
                    (0.0, 10000.0), 1)


def _serve(trace, batch=4):
    return SimpleNamespace(kind="serve", trace=trace, batch=batch,
                           queries=batch * 3, batches=3)


def _read(name, rec):
    return common.Bench(REPO).reader(name).read(rec)


def test_query_stages_and_idle():
    rec = _serve(_serve_trace([_replay(1000), _replay(2000), _replay(3000)]))
    want = {"tables": 10, "pair": 30, "probe": 5, "candidates": 9,
            "rerank": 4}
    for st in QUERY:
        got = _read(f"stage_us_per_query.{st}", rec)
        assert got == pytest.approx(want[st] * 3 / (3 * 4)), st
    # a span is 131 us (tables' mark to the end of end's); busy: six marks
    # of 1 us and the work (58 us); the pad is left out, as Trace.busy
    # leaves it out
    busy = 6 + 58
    assert _read("replay_idle_pct.serve", rec) == pytest.approx(
        100 * (1 - busy / 131))


def test_a_lost_first_mark_drops_only_its_call():
    """The first call's start mark is lost (a session's first records):
    that call is left out, the others read as before, and its work, ten
    times the others', moves nothing."""
    first = [e for e in _replay(1000, scale=10.0)
             if e != _mark("query.tables", 1000)]
    rec = _serve(_serve_trace([first, _replay(2000), _replay(3000)]))
    assert len(stages.sequences(rec.trace, "query")) == 2
    assert _read("stage_us_per_query.pair", rec) == pytest.approx(
        30 * 2 / (2 * 4))
    assert _read("stage_us_per_query.tables", rec) == pytest.approx(
        10 * 2 / (2 * 4))
    # a start mark inside a call that lost its end starts a new call
    no_end = [e for e in _replay(1000, scale=10.0)
              if e != _mark("query.end", 1130)]
    rec = _serve(_serve_trace([no_end, _replay(2000)]))
    assert len(stages.sequences(rec.trace, "query")) == 1
    assert _read("stage_us_per_query.rerank", rec) == pytest.approx(4 / 4)


def test_no_complete_sequence_gives_none(monkeypatch):
    only_start = [e for e in _replay(1000)
                  if e != _mark("query.end", 1130)]
    bare = [e for e in _replay(2000) if "pqt_stage_mark" not in e[0]]
    for trace in (_serve_trace([only_start]), _serve_trace([bare])):
        rec = _serve(trace)
        for st in QUERY:
            assert _read(f"stage_us_per_query.{st}", rec) is None
        assert _read("replay_idle_pct.serve", rec) is None
    # a program without the port's tracing module (the parent of this
    # metric): nothing is read and nothing raises
    rec = _serve(_serve_trace([_replay(1000)]))
    monkeypatch.setattr(stages, "names", lambda: None)
    stages._cache.clear()
    for st in QUERY:
        assert _read(f"stage_us_per_query.{st}", rec) is None
    assert _read("replay_idle_pct.serve", rec) is None
    stages._cache.clear()


def test_wrapper_spans():
    host = [("pqt.graph.key", 100.0, 120.0), ("pqt.graph.key", 300.0, 330.0),
            ("pqt.graph.key", 20000.0, 20100.0),           # after the window
            ("pqt.graph.count", 130.0, 134.0)]
    rec = _serve(_serve_trace([_replay(1000)], host))
    assert _read("graph_host_us_per_batch.key", rec) == pytest.approx(25.0)
    assert _read("graph_host_us_per_batch.count", rec) == pytest.approx(4.0)
    rec = _serve(_serve_trace([_replay(1000)]))
    assert _read("graph_host_us_per_batch.key", rec) is None


def _build(t0: float, chunks: int = 2) -> list:
    """One build from t0: upload 500, each chunk part codes 40 and
    payload 20 (with an offset fill of 1 between chunks, in neither),
    assembly 50 (the benchmark's own mark left out)."""
    ev = [(f"void {tr.MARK_KERNEL}>(1)", t0 - 3, t0 - 2),   # the benchmark's
          _mark("build.upload", t0),
          ("Memcpy HtoD (Pageable -> Device)", t0 + 2, t0 + 502),
          _mark("build.encode", t0 + 510)]
    t = t0 + 520
    for _ in range(chunks):
        ev += [_mark("encode.part_codes", t), ("argmin_kernel", t + 2, t + 42),
               _mark("encode.payload", t + 50),
               ("line_codes_fixed_kernel", t + 52, t + 72),
               _mark("encode.end", t + 80), ("fill_kernel", t + 82, t + 83)]
        t += 100
    ev += [_mark("build.assemble", t),
           (f"void {tr.MARK_KERNEL}>(1)", t + 2, t + 3),
           ("scan_onepass_kernel", t + 5, t + 55),
           _mark("build.end", t + 60)]
    return ev


def test_build_stages():
    dev = _build(0.0) + _build(2000.0)
    rec = SimpleNamespace(kind="build", rows=2 * 4000, builds=2,
                          trace=tr.Trace(dev, [], (-10.0, 5000.0), 1))
    want = {"upload": 500, "part_codes": 80, "payload": 40, "assemble": 50}
    for st in BUILD:
        assert _read(f"stage_us_per_krow.{st}", rec) == pytest.approx(
            want[st] * 2 / 8.0), st
    # the first build's start lost: the second alone
    dev = [e for e in _build(0.0) if e != _mark("build.upload", 0.0)]
    rec.trace = tr.Trace(dev + _build(2000.0), [], (-10.0, 5000.0), 1)
    assert _read("stage_us_per_krow.upload", rec) == pytest.approx(500 / 4)
    rec.trace = tr.Trace(dev, [], (-10.0, 5000.0), 1)
    for st in BUILD:
        assert _read(f"stage_us_per_krow.{st}", rec) is None
    # serving readers read nothing of a build, and build readers nothing of
    # serving
    assert _read("stage_us_per_query.pair", rec) is None
    assert _read("stage_us_per_krow.upload",
                 _serve(_serve_trace([_replay(1000)]))) is None
