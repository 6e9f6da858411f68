"""The port's tracing (utils/tracing.py): stage marks, the graph layer's
host spans and the switch of a graph's mark nodes, all live exactly while
a torch.profiler session records.

The CPU launches no mark kernel, so what is checked here is the launcher's
calls (hooked): none without a profiler, the stages in order under one,
answers equal to the bit either way; and, through the graph layer's stub
of the capture (tests/test_torch_graphs.py's `on_card`), the spans a
served call opens, the key, and that a replay switches its mark nodes only
when the profiler's state changes.  chip_smoke.py checks the marks on the
card.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import pqt_tpu_torch as T
from pqt_tpu_torch.models import db as DB
from pqt_tpu_torch.ops.cuda import build
from pqt_tpu_torch.utils import tracing

from test_torch_graphs import _StubGraph, _toy, on_card  # noqa: F401

CFG = T.PQTConfig(dim=32, p=4, c1=8, c2=4, line_parts=8, hash_size=1 << 16,
                  k1_build=4, k1_query=4, max_bins=128, bin_enum_factor=4,
                  max_candidates=256, max_vec_per_bin=256, kmeans_iters=4,
                  pair_top_m=32)
QUERY = [s for s in tracing.STAGES if s.startswith("query.")]


@pytest.fixture(scope="module")
def built(clustered_data):
    db_vecs, queries = clustered_data
    data = db_vecs[:1500]
    tree = T.train_tree(CFG, data, device="cpu")
    db = T.build_database(CFG, tree, data, keep_vectors=True, device="cpu")
    return data, tree, db, torch.from_numpy(queries[:6])


@pytest.fixture
def hooked(monkeypatch):
    """The stages the mark launcher is called with, and the names of the
    record_function ranges opened, in order."""
    seen = {"marks": [], "spans": []}
    launch = tracing._launch

    def record_launch(stage_id, device):
        seen["marks"].append(tracing.STAGES[stage_id])
        launch(stage_id, device)

    real = torch.autograd.profiler.record_function

    def record_span(name, *a, **kw):
        seen["spans"].append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(tracing, "_launch", record_launch)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        record_span)
    return seen


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _same(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_nothing_without_a_profiler(built, hooked):
    """No profiler: query_knn (both re-ranks) and build_database call the
    mark launcher nowhere and open no span."""
    data, tree, db, q = built
    assert not tracing.enabled()
    T.query_knn(CFG, tree, db, q, 10, True)
    T.query_knn(CFG, tree, db, q, 10, False)
    T.build_database(CFG, tree, data[:700], keep_vectors=True,
                     encode_chunk=256, device="cpu")
    assert hooked == {"marks": [], "spans": []}


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "line"])
def test_query_marks_in_stage_order(built, hooked, exact):
    """Under a profiler, one eager query_knn of the pair pipeline marks
    every query stage once, in the order of STAGES, the exact path and
    the line path alike; its answers equal those without a profiler to
    the bit."""
    _, tree, db, q = built
    plain = T.query_knn(CFG, tree, db, q, 10, exact)
    with _cpu_profile():
        traced = T.query_knn(CFG, tree, db, q, 10, exact)
    assert hooked["marks"] == QUERY
    _same(traced, plain)


def test_build_marks_each_chunk(built, hooked):
    """Under a profiler, build_database marks its upload and encode, each
    chunk's encode stages once, then its assembly and its end; the
    database equals the one built without a profiler to the bit."""
    data, tree, _, _ = built
    rows = data[:700]
    plain = T.build_database(CFG, tree, rows, keep_vectors=True,
                             encode_chunk=256, device="cpu")
    with _cpu_profile():
        traced = T.build_database(CFG, tree, rows, keep_vectors=True,
                                  encode_chunk=256, device="cpu")
    chunk = ["encode.part_codes", "encode.payload", "encode.end"]
    assert hooked["marks"] == (["build.upload", "build.encode"] + chunk * 3
                               + ["build.assemble", "build.end"])
    for name in ("prefix", "counts", "payload", "prefix2", "vectors"):
        assert torch.equal(getattr(traced, name), getattr(plain, name))


def test_out_of_core_encode_marks_each_step(built, hooked):
    """The out-of-core encode marks its device work as build_database
    does, through the same loop, but for the assembly, which the host
    does: its upload and encode once, then each chunk's encode stages, then
    its end.  The multi-DB build marks its assembly too."""
    data, tree, _, _ = built
    builder = DB.ChunkedDBBuilder(CFG, tree, encode_chunk=512, device="cpu")
    with _cpu_profile():
        builder.add_chunk(data[:700])
    chunk = ["encode.part_codes", "encode.payload", "encode.end"]
    assert hooked["marks"] == (["build.upload", "build.encode"] + chunk * 2
                               + ["build.end"])
    del hooked["marks"][:]
    with _cpu_profile():
        T.build_multi_database(CFG, tree, data[:700], 2, encode_chunk=512,
                               device="cpu")
    assert hooked["marks"] == (["build.upload", "build.encode"] + chunk * 2
                               + ["build.assemble", "build.end"])
    assert not hasattr(tracing, "encode_spans")
    assert not hasattr(tracing, "Seconds")


def _names(prof) -> list:
    return [e.name for e in prof.events() if e.name.startswith("pqt.")]


def test_served_calls_open_the_wrapper_spans(on_card):  # noqa: F811
    """Through the stub of the capture, every served call opens
    `pqt.graph.key` once and every replay `pqt.graph.count` once, both
    around host work only; the key and the graphs held are the same with
    the profiler on and off."""
    toy = _toy()
    table = torch.arange(4.0)
    q = torch.ones((3, 2))
    toy(3, table, q)                        # eager, then captured
    off_key = toy.graph_key(3, table, q)
    with _cpu_profile() as prof:
        on_key = toy.graph_key(3, table, q)
        for i in range(4):
            toy(3, table, q + i)
    names = _names(prof)
    assert names.count("pqt.graph.key") == 4
    assert names.count("pqt.graph.count") == 4
    assert on_key == off_key and len(toy.graphs) == 1
    toy(3, table, q)
    assert len(toy.graphs) == 1 and len(on_card.captures) == 1


def test_mark_nodes_switch_only_when_the_profiler_changes(  # noqa: F811
        on_card, monkeypatch):
    """An entry's mark nodes are switched off once after the capture with
    the profiler off, on at the first replay under a profiler and off
    again at the first replay after it; no other replay switches them."""
    switched = []
    monkeypatch.setattr(tracing, "_nodes_of", lambda g: (
        [("n0", 0), ("n5", 5)] if isinstance(g, _StubGraph) else []))
    monkeypatch.setattr(tracing, "_exec_of", lambda g: "exec")
    monkeypatch.setattr(tracing, "_set_enabled",
                        lambda d, e, n, on: switched.append((n, on)))
    toy = _toy()
    table = torch.arange(4.0)
    q = torch.ones((3, 2))
    toy(3, table, q)
    (entry,) = toy.graphs.values()
    assert [i for *_, i in entry.marks.nodes] == [0, 5]
    assert switched == [("n0", False), ("n5", False)]
    for _ in range(3):
        toy(3, table, q)
    assert len(switched) == 2
    with _cpu_profile():
        for _ in range(3):
            toy(3, table, q)
    assert switched[2:] == [("n0", True), ("n5", True)]
    for _ in range(3):
        toy(3, table, q)
    assert switched[4:] == [("n0", False), ("n5", False)]
    assert entry.replays == 9


def test_stage_names_are_the_kernel_ids():
    """STAGES is indexed by the mark kernel's template id: 13 names, each
    a kind and a stage, every kind ending in `.end`."""
    assert len(tracing.STAGES) == len(set(tracing.STAGES)) == 13
    for kind in ("query", "encode", "build"):
        of_kind = [s for s in tracing.STAGES if s.startswith(kind + ".")]
        assert of_kind[-1] == kind + ".end"
    text = (build.CSRC / "mark.cu").read_text()
    assert f"kStages = {len(tracing.STAGES)};" in text
    assert tracing.MARK_KERNEL in text
