"""The sharded query step as a compiled program: `make_sharded_query_fn`
served on the card as CUDA graphs, one a device of the grid and one for
the merge (pqt_tpu_torch/parallel/sharded.py over utils/graphs.py).

The CPU has no CUDA graphs, so what is checked here is everything around
them: CPU queries run the eager body, whose results equal the step as it
was before it was graphed (`_before`, its loop kept here) to the bit; with
a stub in place of the capture (`on_card`): the stages and the order of
their replays (one device's cells, then the merge; across devices, the
events between them, with fake streams), the key, the launch counters'
bookkeeping, the refusal to fall back when a capture fails, the host
checks on every call, and a world of one gloo process whose poisoned
runtime refuses and whose destroyed group makes a replay raise.  A static
test holds the JAX package's jitted sharded query to its graphed
counterpart.  chip_smoke.py checks the graphs themselves on the card.
"""

import ast
import contextlib
import socket
from pathlib import Path

import pytest
import torch

import pqt_tpu_torch as T
from pqt_tpu_torch.models.query import QueryResult, _top_ids
from pqt_tpu_torch.ops.cuda import primitives
from pqt_tpu_torch.parallel import distributed as TD
from pqt_tpu_torch.parallel import sharded as TS
from pqt_tpu_torch.utils import graphs

ROOT = Path(__file__).resolve().parents[1]
CFG = T.PQTConfig(dim=32, p=4, c1=8, c2=4, line_parts=8, hash_size=1 << 16,
                  k1_build=4, k1_query=4, max_bins=128, bin_enum_factor=4,
                  max_candidates=256, max_vec_per_bin=256, kmeans_iters=4)
CPU = torch.device("cpu")
K, N_INT = 10, 64
GRIDS = {"4": (4, 1), "4x2": (4, 2)}


@pytest.fixture(scope="module")
def built(clustered_data):
    """(tree, {grid: placed sharded db}, queries (8, dim))."""
    db_vecs, queries = clustered_data
    data = db_vecs[:2048]
    tree = T.train_tree(CFG, data, device="cpu")
    db = T.build_database(CFG, tree, data, keep_vectors=True, device="cpu")
    host = db._replace(**{f: getattr(db, f).numpy() for f in db._fields
                          if getattr(db, f) is not None})
    shards = TS.shard_database(CFG, host, 4, pad_to_multiple=128)
    placed = {name: TS.place_sharded_db(shards, [CPU] * (s * j))
              for name, (s, j) in GRIDS.items()}
    return tree, placed, torch.from_numpy(queries[:8])


def _step(grid="4", mode="exact", k=K, n_int=N_INT, group=None):
    s, j = GRIDS[grid]
    return TS.make_sharded_query_fn(CFG, [CPU] * (s * j), k, mode=mode,
                                    n_intermediate=n_int, batch_split=j,
                                    group=group)


def _before(tree, sdb, queries, mode, J):
    """The sharded step's body as it was before it was graphed (one
    process, every cell on the CPU)."""
    n_shards = len(sdb.prefix) // J
    span = CFG.hash_size // n_shards
    bs = queries.shape[0] // J
    lists = [TS._serve_cell(CFG, mode, K, N_INT, tree, sdb, c,
                            queries[(c % J) * bs:(c % J + 1) * bs],
                            (c // J) * span)
             for c in range(len(sdb.prefix))]
    local = torch.stack([torch.stack([i, d.contiguous().view(torch.int32)])
                         for i, d, _ in lists])
    kk = local.shape[-1]
    local = local.view(n_shards, J, 2, bs, kk)
    n_local = torch.stack([nc for _, _, nc in lists]).view(
        n_shards, J, bs).sum(0)
    out_ids, out_d = [], []
    for j in range(J):
        ids, dists = _top_ids(
            local[:, j, 1].view(torch.float32).permute(1, 0, 2).reshape(
                bs, n_shards * kk),
            local[:, j, 0].permute(1, 0, 2).reshape(bs, n_shards * kk), K)
        out_ids.append(ids)
        out_d.append(dists)
    return QueryResult(torch.cat(out_ids), torch.cat(out_d),
                       n_local.reshape(J * bs))


def _same(a, b):
    assert type(a) is type(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("mode", ["line", "exact", "big"])
def test_cpu_queries_run_the_eager_body(built, grid, mode):
    """On CPU queries the step is its eager body, equal to the bit to the
    step before it was graphed, and keeps no graph."""
    tree, placed, q = built
    step = _step(grid, mode)
    assert step.__wrapped__ is not step
    got = step(tree, placed[grid], q)
    assert got.indices.shape == (q.shape[0], K)
    _same(got, step.__wrapped__(tree, placed[grid], q))
    _same(got, _before(tree, placed[grid], q, mode, GRIDS[grid][1]))
    assert not step.graphs


class _StubGraph:
    def __init__(self, log, name):
        self.log, self.name = log, name

    def replay(self):
        self.log.append(("replay", self.name))


@pytest.fixture
def on_card(monkeypatch):
    """CPU queries take the card's route, with `_record` (the capture)
    replaced by `stub.record`; `stub.log` gets each stage's replays."""
    stub = type("Stub", (), {})()
    stub.captures, stub.log = [], []

    def record(fn, args, device):
        out = fn(*args)
        stub.captures.append((fn.__name__, device))
        return _StubGraph(stub.log, fn.__name__), out, 1000

    stub.record = record
    monkeypatch.setattr(graphs, "_on_card", lambda q: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(graphs, "_record", lambda *a: stub.record(*a))
    return stub


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_one_graph_a_device_then_the_merge(built, on_card, grid):
    """A grid on one device is two captures, the device's cores and then
    the merge; a replay replays them in that order and returns fresh
    tensors equal to the eager result."""
    tree, placed, q = built
    step = _step(grid)
    first = step(tree, placed[grid], q)
    assert on_card.captures == [("serve_cells", CPU), ("merge", CPU)]
    (entry,) = step.graphs.values()
    assert [d for d, _ in entry.stages] == [CPU, CPU]
    assert entry.bytes == 2000 + q.nbytes and not entry.ready
    out = step(tree, placed[grid], q)
    assert on_card.log == [("replay", "serve_cells"), ("replay", "merge")]
    assert entry.replays == 1 and len(on_card.captures) == 2
    assert all(o.data_ptr() != s.data_ptr()
               for o, s in zip(out, entry.outputs))
    _same(out, first)
    _same(first, step.__wrapped__(tree, placed[grid], q))


def test_cell_groups():
    """One graph a distinct device, in the order of its first cell: a
    device may repeat."""
    c0, c1 = torch.device("cuda", 0), torch.device("cuda", 1)
    assert TS._cell_groups([c0, c1, c0, c1, c1]) == {c0: [0, 2],
                                                     c1: [1, 3, 4]}
    assert TS._cell_groups([CPU] * 4) == {CPU: [0, 1, 2, 3]}


class _FakeStream:
    def __init__(self, log, device):
        self.log, self.device = log, device

    def wait_event(self, ev):
        self.log.append(("wait", self.device, ev.name))


class _FakeEvent:
    names = iter(range(100))

    def __init__(self, log):
        self.log, self.name = log, f"ev{next(self.names)}"

    def record(self, stream):
        self.log.append(("record", stream.device, self.name))


def test_cross_device_stages_wait_on_events(on_card, monkeypatch):
    """Stages on two cards and the merge on the first: the merge is
    captured with the other card's stream joinable, and each replay orders
    the cards by events, with no host sync: the other card's stage waits
    for the last merge, the merge for that stage."""
    c0, c1 = torch.device("cuda", 0), torch.device("cuda", 1)
    log, joined = on_card.log, []
    monkeypatch.setattr(graphs, "_stream", lambda d: _FakeStream(log, d))
    monkeypatch.setattr(graphs, "_event", lambda: _FakeEvent(log))
    monkeypatch.setattr(graphs, "_joinable", lambda devs: joined.append(
        set(devs)) or contextlib.nullcontext())

    def cores(q):
        return q * 2

    def merge(a, b):
        return a + b

    stages = [graphs.Stage(c0, cores, lambda q, _: (q[c0],)),
              graphs.Stage(c1, cores, lambda q, _: (q[c1],)),
              graphs.Stage(c0, merge, lambda q, outs: tuple(outs))]
    q = {c0: torch.ones(2), c1: torch.full((2,), 3.0)}
    entry = graphs.CapturedQuery(stages, q)
    assert joined == [set(), set(), {c1}]     # only the merge joins c1
    assert [(n, d) for n, d in on_card.captures] == [
        ("cores", c0), ("cores", c1), ("merge", c0)]
    assert torch.equal(entry.outputs, torch.full((2,), 8.0))
    ready, done = entry.ready[c1].name, entry.done.name
    for _ in range(2):
        log.clear()
        entry.replay({c0: torch.zeros(2), c1: torch.ones(2)})
        assert log == [("replay", "cores"), ("wait", c1, done),
                       ("replay", "cores"), ("record", c1, ready),
                       ("wait", c0, ready), ("replay", "merge"),
                       ("record", c0, done)]
    assert torch.equal(entry.queries[c1], torch.ones(2))


def test_key(built):
    """The key changes with the queries' shape, the database's tensors,
    mode, k, n_intermediate and batch_split, and not with the queries'
    values or a mapping rebuilt from the same replicas."""
    tree, placed, q = built
    sdb = placed["4"]
    key = _step().graph_key
    base = key(tree, sdb, q)
    assert key(tree, sdb, q.clone()) == base
    assert key(tree, sdb._replace(), q) == base
    trees = TD.replicate([CPU], tree)
    by_map = key(trees, sdb, {CPU: q})
    assert by_map != base                     # the tree given as a mapping
    assert key(dict(trees), sdb, {CPU: q.clone()}) == by_map
    changed = [
        key(tree, sdb, q[:6]),
        key(tree, sdb, q.double()),
        key(tree, sdb._replace(payload=tuple(p.clone() for p in
                                             sdb.payload)), q),
        key(tree, sdb._replace(vectors=tuple(v.clone() for v in
                                             sdb.vectors)), q),
        _step(mode="line").graph_key(tree, sdb, q),
        _step(k=K + 1).graph_key(tree, sdb, q),
        _step(n_int=N_INT * 2).graph_key(tree, sdb, q),
        _step("4x2").graph_key(tree, placed["4x2"], q)]
    assert len({base, *changed}) == len(changed) + 1


def test_rebuilt_mapping_finds_its_graph(built, on_card):
    """The tree and queries as `replicate` mappings: a mapping rebuilt from
    the same replicas replays the graph its first call captured."""
    tree, placed, q = built
    step = _step()
    first = step(TD.replicate([CPU], tree), placed["4"],
                 TD.replicate([CPU], q))
    again = step(dict(TD.replicate([CPU], tree)), placed["4"], {CPU: q})
    assert len(step.graphs) == 1 and len(on_card.captures) == 2
    (entry,) = step.graphs.values()
    assert entry.replays == 1 and torch.equal(entry.queries[CPU], q)
    _same(first, again)


def _count_launches(monkeypatch):
    """Each cell's core counts one kernel B launch, each merge one kernel A
    launch, as the kernels on the card would."""
    monkeypatch.setattr(primitives.block_scan, "launches", 0)
    monkeypatch.setattr(primitives.bitonic_topk, "launches", 0)
    cell, top = TS._serve_cell, TS._top_ids

    def counted_cell(*a, **kw):
        primitives.block_scan.launches += 1
        return cell(*a, **kw)

    def counted_top(*a, **kw):
        primitives.bitonic_topk.launches += 1
        return top(*a, **kw)

    monkeypatch.setattr(TS, "_serve_cell", counted_cell)
    monkeypatch.setattr(TS, "_top_ids", counted_top)


def test_launch_counter_bookkeeping(built, on_card, monkeypatch):
    """The first call counts its eager launches, the captures add nothing,
    and each replay adds what the captures of all stages recorded."""
    _count_launches(monkeypatch)
    tree, placed, q = built
    step = _step("4x2")
    step(tree, placed["4x2"], q)
    scans, tops = (primitives.block_scan.launches,
                   primitives.bitonic_topk.launches)
    assert (scans, tops) == (8, 2)            # 8 cells, 2 batch slices
    (entry,) = step.graphs.values()
    assert entry.launches[(primitives.block_scan, "launches")] == 8
    assert entry.launches[(primitives.bitonic_topk, "launches")] == 2
    for i in range(1, 4):
        step(tree, placed["4x2"], q)
        assert primitives.block_scan.launches == 8 * (i + 1)
        assert primitives.bitonic_topk.launches == 2 * (i + 1)
        assert entry.replays == i


def test_failed_capture_raises(built, on_card, monkeypatch):
    """A capture that fails (here the merge's) raises: no entry is kept,
    nothing falls back to the eager body, and the counters keep only the
    eager call's launches; the next call tries again and raises again."""
    _count_launches(monkeypatch)
    record = on_card.record

    def failing(fn, args, device):
        if fn.__name__ == "merge":
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return record(fn, args, device)

    on_card.record = failing
    tree, placed, q = built
    step = _step()
    for calls in (1, 2):
        with pytest.raises(RuntimeError, match="capturing"):
            step(tree, placed["4"], q)
        assert not step.graphs and not on_card.log
        assert primitives.block_scan.launches == 4 * calls
        assert primitives.bitonic_topk.launches == calls


def test_host_checks_run_on_every_call(built, on_card):
    """With a key captured, exact mode without vectors, a database not on
    the grid's cells and a batch that does not divide into the slices
    still raise, before any replay or capture."""
    tree, placed, q = built
    step, split = _step(), _step("4x2")
    step(tree, placed["4"], q)
    split(tree, placed["4x2"], q)
    captures = len(on_card.captures)
    with pytest.raises(ValueError, match="keep_vectors"):
        step(tree, placed["4"]._replace(vectors=None), q)
    with pytest.raises(ValueError, match="cells"):
        step(tree, placed["4x2"], q)
    with pytest.raises(ValueError, match="divide"):
        split(tree, placed["4x2"], q[:7])
    assert len(on_card.captures) == captures and not on_card.log


def test_call_under_capture_runs_the_body(built, monkeypatch):
    """While a capture runs the step calls its body, as a nested jit
    inlines."""
    def refuse(*a):
        raise AssertionError("a call under a capture captured a graph")

    monkeypatch.setattr(graphs, "_on_card", lambda q: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    monkeypatch.setattr(graphs, "_record", refuse)
    tree, placed, q = built
    step = _step()
    _same(step(tree, placed["4"], q), step.__wrapped__(tree, placed["4"], q))
    assert not step.graphs


def _free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@pytest.fixture
def world_of_one(monkeypatch):
    """This process alone in a gloo process group, destroyed after the
    test; the runtime's poisoned state restored."""
    import torch.distributed as dist
    monkeypatch.setattr(TD, "_poisoned", None)
    TD.initialize(f"localhost:{_free_port()}", 1, 0, 60, device="cpu")
    try:
        yield dist.group.WORLD
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_group_step_replays_and_a_poisoned_runtime_refuses(
        built, on_card, world_of_one, monkeypatch):
    """Through a world of one the step captures its merge with the
    collectives and equals the step without a group; once a collective
    timed out, a call refuses before any replay."""
    tree, placed, q = built
    step = _step(group=world_of_one)
    first = step(tree, placed["4"], q)
    _same(first, _step()(tree, placed["4"], q))
    (entry,) = step.graphs.values()
    assert entry.group is world_of_one
    step(tree, placed["4"], q)
    assert entry.replays == 1
    monkeypatch.setattr(TD, "_poisoned", "a collective did not complete")
    with pytest.raises(TD.PeerTimeoutError, match="refused"):
        step(tree, placed["4"], q)
    assert entry.replays == 1 and len(on_card.log) == 2


def test_replay_after_the_group_is_destroyed_raises(built, on_card,
                                                    world_of_one):
    """A graph captured with a group's collectives never replays once the
    group is gone, nor in a new world: the step refuses the call, and the
    entry itself its replay.  Clearing the graphs frees it."""
    import torch.distributed as dist
    tree, placed, q = built
    step = _step(group=world_of_one)
    step(tree, placed["4"], q)
    (entry,) = step.graphs.values()
    dist.destroy_process_group()
    for world in ("none", "a new one"):
        with pytest.raises(RuntimeError, match="destroyed"):
            step(tree, placed["4"], q)
        with pytest.raises(RuntimeError, match="destroyed"):
            entry.replay({CPU: q})
        if world == "none":
            TD.initialize(f"localhost:{_free_port()}", 1, 0, 60,
                          device="cpu")
    assert not on_card.log and entry.replays == 0
    step.graphs.clear()


def _jitted_in(path: Path, outer: str) -> set:
    """Names of the functions nested in `outer` (or, outer None, anywhere)
    that a jax.jit decorator compiles."""
    found = set()
    for top in ast.parse(path.read_text()).body:
        if not isinstance(top, ast.FunctionDef):
            continue
        for node in ast.walk(top):
            if isinstance(node, ast.FunctionDef) and any(
                    "jax.jit" in ast.unparse(d) for d in node.decorator_list):
                found.add((top.name, node.name))
    return found


def test_every_jitted_sharded_query_has_a_graphed_counterpart(built):
    """The JAX package's sharded module jits one query program,
    make_sharded_query_fn's `query_fn`; the port's step is that body,
    graphed.  Its other jitted programs build the database (still eager,
    ROADMAP queue 1)."""
    jitted = _jitted_in(ROOT / "pqt_tpu" / "parallel" / "sharded.py", None)
    query_path = {(outer, name) for outer, name in jitted
                  if outer == "make_sharded_query_fn"}
    assert query_path == {("make_sharded_query_fn", "query_fn")}
    assert {outer for outer, _ in jitted - query_path} == {
        "make_dp_encode_fn", "make_dp_kmeans_step"}
    port = ast.parse((ROOT / "pqt_tpu_torch" / "parallel" /
                      "sharded.py").read_text())
    (make,) = [n for n in port.body if isinstance(n, ast.FunctionDef)
               and n.name == "make_sharded_query_fn"]
    assert "graphs.replay_or_capture" in ast.unparse(make)
    step = _step()
    assert step.__wrapped__.__name__ == "query_fn"
    assert isinstance(step.graphs, dict) and callable(step.graph_key)
