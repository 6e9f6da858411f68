"""The compiled query programs (utils/graphs.py): each serving entry point
served on the card as a CUDA graph a static key, and its eager body.

The CPU has no CUDA graphs, so what is checked here is everything around
them: CPU queries call the eager body (all seven entry points, equal to
`__wrapped__`'s results to the bit), the key, the nesting rule, the launch
counters' bookkeeping and the refusal to fall back when a capture fails
(both with a stub in place of the capture), that every `@jax.jit` query
entry point of the JAX package has a `graphed` counterpart with the same
static arguments, and that the traversal uploads a graph reads are never
evicted.  chip_smoke.py checks the graphs themselves on the card.
"""

import ast
from pathlib import Path

import pytest
import torch

import pqt_tpu_torch as T
from pqt_tpu_torch.models import query as TQ
from pqt_tpu_torch.models.multidb import build_multi_database
from pqt_tpu_torch.models.split import build_split_database
from pqt_tpu_torch.ops.cuda import primitives
from pqt_tpu_torch.utils import graphs

ROOT = Path(__file__).resolve().parents[1]
CFG = T.PQTConfig(dim=32, p=4, c1=8, c2=4, line_parts=8, hash_size=1 << 16,
                  k1_build=4, k1_query=4, max_bins=128, bin_enum_factor=4,
                  max_candidates=256, max_vec_per_bin=256, kmeans_iters=4,
                  pair_top_m=32)
ENTRY_POINTS = ("query_knn", "query_candidates", "query_knn_refine",
                "query_big_knn", "query_big_knn_perfect", "query_knn_split",
                "query_multi_knn")


@pytest.fixture(scope="module")
def built(clustered_data):
    db_vecs, queries = clustered_data
    data = db_vecs[:1500]
    tree = T.train_tree(CFG, data, device="cpu")
    db = T.build_database(CFG, tree, data, keep_vectors=True, device="cpu")
    sdb = build_split_database(CFG, data, 0.3, keep_vectors=True,
                               device="cpu")
    mdb = build_multi_database(CFG, tree, data, 2, keep_vectors=True,
                               device="cpu")
    return tree, db, sdb, mdb, torch.from_numpy(queries[:6])


def _calls(tree, db, sdb, mdb, q):
    """Every entry point with each static setting the serving paths use:
    (name, args)."""
    parts = CFG.replace(pipeline="parts", pair_filter=True)
    return [("query_knn", (CFG, tree, db, q, 10, False)),
            ("query_knn", (CFG, tree, db, q, 10, True)),
            ("query_knn", (parts, tree, db, q, 10, True)),
            ("query_candidates", (CFG, tree, db, q)),
            ("query_knn_refine", (CFG, tree, db, q, 10, 4, None)),
            ("query_big_knn", (CFG, tree, db, q, 10, 64)),
            ("query_big_knn_perfect", (CFG, tree, db, q, 10, 4, 64)),
            ("query_knn_split", (CFG, sdb, q, 10, False, False)),
            ("query_knn_split", (CFG, sdb, q, 10, True, False)),
            ("query_knn_split", (CFG, sdb, q, 10, False, True)),
            ("query_multi_knn", (CFG, tree, mdb, q, 10, False)),
            ("query_multi_knn", (CFG, tree, mdb, q, 10, True))]


def _same(a, b):
    assert type(a) is type(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_cpu_queries_call_the_eager_body(built):
    """On CPU queries every entry point is its eager body: the results
    equal `__wrapped__`'s to the bit and no graph is kept."""
    for name, args in _calls(*built):
        fn = getattr(T, name)
        assert fn.__wrapped__ is not fn
        _same(fn(*args), fn.__wrapped__(*args))
        assert not fn.graphs, name


def test_entry_points_are_graphed():
    for name in ENTRY_POINTS:
        fn = getattr(T, name)
        assert hasattr(fn, "graphs") and hasattr(fn, "graph_key"), name
    from pqt_tpu_torch.tools import query as tool
    import inspect
    # the query tool's runner serves through the graphed names
    assert "from pqt_tpu_torch.models.query import query_knn" in \
        inspect.getsource(tool.load_runner)


def test_key(built):
    """The key changes with each static argument, the queries' shape and
    dtype, and a database or tree leaf's address, and with nothing else."""
    tree, db, _, _, q = built
    key = T.query_knn.graph_key
    base = key(CFG, tree, db, q, 10, False)
    assert key(CFG, tree, db, q, 10) == base                  # a default
    assert key(CFG, tree, db, q, 10, exact_rerank=False) == base
    assert key(CFG, tree, db, q.clone(), 10, False) == base   # values only
    assert key(CFG.replace(), tree, db, q, 10, False) == base  # equal cfg
    assert key(CFG, tree, db._replace(), q, 10, False) == base
    changed = [
        key(CFG.replace(max_bins=64), tree, db, q, 10, False),
        key(CFG, tree, db, q, 11, False),
        key(CFG, tree, db, q, 10, True),
        key(CFG, tree, db, q[:5], 10, False),
        key(CFG, tree, db, q.double(), 10, False),
        key(CFG, tree, db._replace(payload=db.payload.clone()), q, 10, False),
        key(CFG, tree, db._replace(vectors=None), q, 10, False),
        key(CFG, T.PQTree(*(t.clone() for t in (
            tree.cb1, tree.cb2, tree.centroids_full, tree.pair_dists))),
            db, q, 10, False)]
    assert len({base, *changed}) == len(changed) + 1
    refine = T.query_knn_refine.graph_key
    assert refine(CFG, tree, db, q, 10) != refine(CFG, tree, db, q, 10, 4)
    assert refine(CFG, tree, db, q, 10, 8, 40) != refine(CFG, tree, db, q,
                                                         10, 8)


class _StubGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@pytest.fixture
def on_card(monkeypatch):
    """CPU queries take the card's route, with `_record` (the capture)
    replaced by `stub.record`."""
    stub = type("Stub", (), {})()
    stub.captures = []

    def record(fn, args, device):
        out = fn(*args)
        stub.captures.append(args)
        return _StubGraph(), out, 1000

    stub.record = record
    monkeypatch.setattr(graphs, "_on_card", lambda q: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(graphs, "_record", lambda *a: stub.record(*a))
    return stub


def _toy():
    """A graphed function whose body counts launches as kernels do."""
    @graphs.graphed(static_argnums=(0,))
    def toy(n, table, queries):
        primitives.block_scan.launches += n
        primitives.bitonic_topk.mode_launches["select"] += 1
        return queries * 2 + table.sum(), queries[:, :1] + 0
    return toy


def test_launch_counter_bookkeeping(on_card, monkeypatch):
    """The first call counts its eager launches, the capture adds nothing,
    and each replay adds what the capture recorded; replays return fresh
    tensors."""
    monkeypatch.setattr(primitives.block_scan, "launches", 0)
    monkeypatch.setattr(primitives.bitonic_topk, "mode_launches",
                        {"sort": 0, "select": 0, "merge": 0})
    toy = _toy()
    table = torch.arange(4.0)
    q = torch.ones((3, 2))
    first = toy(3, table, q)
    assert len(on_card.captures) == 1
    assert primitives.block_scan.launches == 3
    assert primitives.bitonic_topk.mode_launches["select"] == 1
    (entry,) = toy.graphs.values()
    assert entry.capture_s >= 0 and entry.bytes == 1000 + q.nbytes
    assert entry.launches[(primitives.block_scan, "launches")] == 3
    assert entry.launches[(primitives.bitonic_topk, "mode_launches")] == {
        "sort": 0, "select": 1, "merge": 0}
    for i in range(1, 4):
        out = toy(3, table, q + i)
        assert primitives.block_scan.launches == 3 + 3 * i
        assert primitives.bitonic_topk.mode_launches["select"] == 1 + i
        assert entry.graph.replays == i and entry.replays == i
        # the query buffer holds the last batch; the outputs are clones
        assert torch.equal(entry.queries, q + i)
        assert all(o is not s and o.data_ptr() != s.data_ptr()
                   for o, s in zip(out, entry.outputs))
        _same(out, entry.outputs)
    _same(first, toy.__wrapped__(3, table, q))
    toy(4, table, q)                      # another static value: a new key
    assert len(toy.graphs) == 2 and len(on_card.captures) == 2


def test_failed_capture_raises(on_card, monkeypatch):
    """A capture that fails raises: no entry is kept, nothing falls back to
    the eager body, and the counters keep only the eager call's launches;
    the next call tries to capture again and raises again."""
    monkeypatch.setattr(primitives.block_scan, "launches", 0)
    monkeypatch.setattr(primitives.bitonic_topk, "mode_launches",
                        {"sort": 0, "select": 0, "merge": 0})

    def record(fn, args, device):
        fn(*args)
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    on_card.record = record
    toy = _toy()
    for calls in (1, 2):
        with pytest.raises(RuntimeError, match="capturing"):
            toy(2, torch.arange(4.0), torch.ones((3, 2)))
        assert not toy.graphs
        assert primitives.block_scan.launches == 2 * calls


def test_nested_call_under_capture_captures_nothing(built, monkeypatch):
    """While a capture runs, an entry point calls its body: the split
    query's members and a user's own capture inline, as a nested jit
    does."""
    def refuse(*a):
        raise AssertionError("a nested call captured a graph")

    monkeypatch.setattr(graphs, "_on_card", lambda q: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    monkeypatch.setattr(graphs, "_record", refuse)
    tree, db, sdb, _, q = built
    for name, args in _calls(*built)[:8]:
        fn = getattr(T, name)
        _same(fn(*args), fn.__wrapped__(*args))
        assert not fn.graphs


def test_bodies_call_eager_bodies(built, monkeypatch):
    """The bodies that reuse another entry point call its eager body, so
    `__wrapped__` runs eagerly throughout and a capture records one graph:
    with the route to the card forced, only the outer call captures."""
    captured = []

    def record(fn, args, device):
        captured.append(fn.__name__)
        return _StubGraph(), fn(*args), 0

    monkeypatch.setattr(graphs, "_on_card", lambda q: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(graphs, "_record", record)
    tree, db, sdb, _, q = built
    try:
        T.query_knn_refine(CFG, tree, db, q, 10)
        T.query_big_knn_perfect(CFG, tree, db, q, 10, 4, 64)
        T.query_knn_split(CFG, sdb, q, 10, False, True)
        assert captured == ["query_knn_refine", "query_big_knn_perfect",
                            "query_knn_split"]
        assert not T.query_knn.graphs and not T.query_big_knn.graphs
    finally:
        for name in ENTRY_POINTS:
            getattr(T, name).graphs.clear()


def _jit_static(path: Path, decorator: str) -> dict:
    """{function name: static_argnums} of the functions in `path` whose
    decorator calls `decorator` (jax.jit through functools.partial, or
    graphed) with static_argnums."""
    out = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if not isinstance(node, ast.FunctionDef):
            continue
        for dec in node.decorator_list:
            if not isinstance(dec, ast.Call):
                continue
            names = [ast.unparse(a) for a in dec.args]
            if ast.unparse(dec.func) == decorator or decorator in names:
                kw = {k.arg: ast.literal_eval(k.value) for k in dec.keywords}
                out[node.name] = tuple(kw["static_argnums"])
    return out


@pytest.mark.parametrize("module", ["query", "query_big", "split",
                                    "multidb"])
def test_every_jitted_query_has_a_graphed_counterpart(module):
    jitted = _jit_static(ROOT / "pqt_tpu" / "models" / f"{module}.py",
                         "jax.jit")
    ported = _jit_static(ROOT / "pqt_tpu_torch" / "models" / f"{module}.py",
                         "graphed")
    assert jitted and ported == jitted
    import importlib
    mod = importlib.import_module(f"pqt_tpu_torch.models.{module}")
    for name, static in jitted.items():
        assert getattr(mod, name).static_argnums == static


def test_traversal_uploads_are_never_evicted():
    """A captured graph reads the traversal uploads by address: a
    seventeenth key (the old lru_cache's limit) frees nothing an earlier
    key holds."""
    cpu = torch.device("cpu")
    pair = TQ._pair_sequence_on(64, 256, cpu)
    parts = TQ._parts_sequence_on(16, 4, 512, cpu)
    for i in range(20):
        TQ._pair_sequence_on(8 + i, 40, cpu)
        TQ._parts_sequence_on(4, 2, 1 + i, cpu)
    assert TQ._pair_sequence_on(64, 256, cpu) is pair
    assert TQ._parts_sequence_on(16, 4, 512, cpu) is parts
