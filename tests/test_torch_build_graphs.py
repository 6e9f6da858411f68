"""The train and build side as compiled programs: the chunk encoder, the
data-parallel encode and k-means step, the Lloyd loop and the k-means++
picks served on the card as CUDA graphs (pqt_tpu_torch/utils/graphs.py).

The CPU has no CUDA graphs, so what is checked here is everything around
them: CPU inputs run the eager bodies, equal to the bit to the functions
as they were before they were graphed (their loops kept here as `_old_*`);
with a stub in place of the capture whose replays run the captured
function again on the entry's buffers (`on_card`): the encoder's key
(the chunk's shape, never its id offset), the loop form (a step writing
its state back, read once a block), the launch counters' bookkeeping,
the refusal to fall back when a capture fails, calls under a capture and
in `graphs.eager()` running the body; and an AST scan that maps every
compiled program and device loop of the JAX package to its counterpart.
One JAX fixture holds the graphed encoder to the JAX package's encode.
chip_smoke.py checks the graphs themselves on the card.
"""

import ast
import contextlib
import functools
import inspect
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pqt_tpu as P
import pqt_tpu_torch as T
from pqt_tpu.models import db as JDB
from pqt_tpu_torch.models import db as TDB
from pqt_tpu_torch.models import kmeans as TK
from pqt_tpu_torch.ops import binning
from pqt_tpu_torch.ops import distance as TDIST
from pqt_tpu_torch.ops.cuda import primitives
from pqt_tpu_torch.parallel import sharded as TS
from pqt_tpu_torch.utils import graphs

ROOT = Path(__file__).resolve().parents[1]
CFG = T.PQTConfig(dim=32, p=4, c1=8, c2=4, line_parts=8, hash_size=1 << 16,
                  k1_build=4, k1_query=4, max_bins=128, bin_enum_factor=4,
                  max_candidates=256, max_vec_per_bin=256, kmeans_iters=6)
CPU = torch.device("cpu")
CHUNK = 512
NORMS = 3       # kernel D launches a chunk: L1 and L2 tables (k1_build <
                # c1), line tables


@pytest.fixture(scope="module")
def built(clustered_data):
    """(tree trained by the port on the CPU, data (1300, 32) float32)."""
    db_vecs, _ = clustered_data
    data = db_vecs[:1300]
    return T.train_tree(CFG, data, device="cpu"), data


# ---------------------------------------------------------------------------
# the functions as they were before they were graphed
# ---------------------------------------------------------------------------

def _old_encode_chunk(cfg, tree, chunk, id_offset: int):
    chunk = chunk.to(torch.float32)
    pc = TDB.encode_part_codes(cfg, tree, chunk)
    bins = binning.hashed_bin_ids(pc, cfg.part_radix, cfg.hash_size)
    codes, t3 = TDB.encode_line_codes(cfg, tree, chunk)
    ids = id_offset + torch.arange(chunk.shape[0], dtype=torch.int32,
                                   device=chunk.device)
    return bins, pc, TDB.pack_payload_device(cfg, ids, codes, t3)


def _old_pair_occ(cfg, part_codes, pair_occ):
    r = cfg.part_radix
    for j in range(cfg.p // 2):
        pair_occ[j, part_codes[:, 2 * j] * r + part_codes[:, 2 * j + 1]] = 1
    return pair_occ


def _old_build(cfg, tree, data, encode_chunk):
    pair_occ = torch.zeros((cfg.p // 2, cfg.part_radix ** 2),
                           dtype=torch.uint8)
    bins_l, packed_l = [], []
    for s in range(0, data.shape[0], encode_chunk):
        b, pc, rows = _old_encode_chunk(
            cfg, tree, torch.as_tensor(data[s:s + encode_chunk]), s)
        _old_pair_occ(cfg, pc, pair_occ)
        bins_l.append(b)
        packed_l.append(rows)
    prefix, counts, prefix2, payload = TDB._assemble_device(
        cfg, torch.cat(bins_l), torch.cat(packed_l))
    return prefix, counts, payload, pair_occ, prefix2


def _old_lloyd(data, mask, centroids, *, iters, churn_tol, move_tol, chunk):
    P_, n, _ = data.shape
    C = centroids.shape[1]
    fmask = mask.to(torch.float32)
    n_active = torch.clamp_min(torch.sum(fmask, dim=-1), 1.0)
    assign = torch.full((P_, C, n), -1, dtype=torch.int64)
    done = torch.zeros((P_, C), dtype=torch.bool)
    for _ in range(iters):
        if bool(done.all()):
            break
        new, new_assign, churn = TK._e_m_step(data, fmask, centroids, assign,
                                              chunk)
        move = torch.mean(torch.sum((new - centroids) ** 2, dim=-1), dim=-1)
        scale = torch.mean(torch.sum(new ** 2, dim=-1), dim=-1) + 1e-12
        now_done = ((churn / n_active < churn_tol)
                    | (move / scale < move_tol * move_tol))
        active = ~done
        centroids = torch.where(active[..., None, None], new, centroids)
        assign = torch.where(active[..., None], new_assign, assign)
        done = done | now_done
    return centroids, assign


def _old_kmeanspp(data, mask, k, gen):
    P_, n, d = data.shape
    C = mask.shape[1]
    fmask = mask.to(torch.float32)
    rows = torch.arange(P_)[:, None]

    def pick(dmin):
        w = dmin * fmask
        w = torch.where(torch.sum(w, -1, keepdim=True) > 0, w, fmask)
        w = torch.where(torch.sum(w, -1, keepdim=True) > 0, w, 1.0)
        idx = torch.multinomial(w.reshape(P_ * C, n), 1, generator=gen)
        return data[rows, idx.reshape(P_, C)]

    mean0 = (torch.einsum("pcn,pnd->pcd", fmask, data)
             / torch.clamp_min(torch.sum(fmask, -1), 1.0)[..., None])
    first = pick(TK._sqdist_to(data, mean0[:, :, None, :])[..., 0])
    centers = [first]
    dmin = TK._sqdist_to(data, first[:, :, None, :])[..., 0]
    for _ in range(1, k):
        c = pick(dmin)
        centers.append(c)
        dmin = torch.minimum(dmin,
                             TK._sqdist_to(data, c[:, :, None, :])[..., 0])
    return torch.stack(centers, dim=2)


def _old_dp_encode(cfg, tree, data, n_devices, encode_chunk):
    starts = list(range(0, data.shape[0], encode_chunk))
    per = -(-len(starts) // n_devices)
    parts = []
    for i in range(n_devices):
        for s in starts[i * per:(i + 1) * per]:
            x = torch.as_tensor(data[s:s + encode_chunk]).to(torch.float32)
            codes, t3 = TDB.encode_line_codes(cfg, tree, x)
            bins = binning.hashed_bin_ids(TDB.encode_part_codes(cfg, tree, x),
                                          cfg.part_radix, cfg.hash_size)
            parts.append((bins, codes, t3))
    return tuple(torch.cat([p[i] for p in parts]) for i in range(3))


def _old_dp_kmeans_step(data, centroids, n_devices):
    rows = np.array_split(np.arange(data.shape[0]), n_devices)
    partial = []
    for r in rows:
        if not len(r):
            continue
        x = torch.as_tensor(data[r[0]:r[-1] + 1]).to(torch.float32)
        c = torch.as_tensor(centroids).to(torch.float32)
        a = torch.argmin(TDIST.pairwise_sqdist(x, c), dim=-1)
        onehot = (a[:, None] == torch.arange(c.shape[0])).to(torch.float32)
        partial.append((onehot.T @ x, onehot.sum(0)))
    sums = sum(p[0] for p in partial)
    counts = sum(p[1] for p in partial)
    cents = torch.as_tensor(centroids).to(torch.float32)
    return torch.where(counts[:, None] > 0,
                       sums / torch.clamp_min(counts, 1.0)[:, None], cents)


def _same(a, b):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
        return
    assert len(a) == len(b)
    for x, y in zip(a, b):
        _same(x, y)


# ---------------------------------------------------------------------------
# CPU inputs: the eager bodies, equal to the old functions
# ---------------------------------------------------------------------------

def test_cpu_encode_equals_the_old_encode(built):
    """The chunk encoder with a tensor offset, build_database and the
    multi-DB build's encode on the CPU equal the old encode to the bit,
    and keep no graph."""
    tree, data = built
    x = torch.from_numpy(data[:CHUNK])
    occ = torch.zeros((CFG.p // 2, CFG.part_radix ** 2), dtype=torch.uint8)
    got = TDB.chunk_encoder(CFG, tree, x, TDB._offset(700, CPU), occ)
    want = _old_encode_chunk(CFG, tree, x, 700)
    _same(got, want)
    _same(occ, _old_pair_occ(CFG, want[1], torch.zeros_like(occ)))
    _same(TDB._encode_chunk(CFG, tree, x, 700), want)
    db = T.build_database(CFG, tree, data, encode_chunk=CHUNK, device="cpu")
    _same((db.prefix, db.counts, db.payload, db.pair_occ, db.prefix2),
          _old_build(CFG, tree, data, CHUNK))
    assert not TDB.chunk_encoder.graphs and not TDB.chunk_codes.graphs


@pytest.mark.parametrize("init", ["kmeans++", "lbg"])
def test_cpu_train_equals_the_old_loops(built, init, monkeypatch):
    """train_tree on the CPU equals a train through the old Lloyd loop and
    the old k-means++ seeding to the bit, and the generator ends in the
    same state."""
    _, data = built
    cfg = CFG.replace(kmeans_init=init)
    got = T.train_tree(cfg, data, device="cpu")
    new_init, new_lloyd = TK._kmeanspp_init, TK._lloyd_converge
    monkeypatch.setattr(TK, "_lloyd_converge", _old_lloyd)
    monkeypatch.setattr(TK, "_kmeanspp_init", _old_kmeanspp)
    want = T.train_tree(cfg, data, device="cpu")
    for leaf in ("cb1", "cb2", "centroids_full", "pair_dists"):
        _same(getattr(got, leaf), getattr(want, leaf))
    gen_a = torch.Generator().manual_seed(3)
    gen_b = torch.Generator().manual_seed(3)
    x = torch.from_numpy(data[:400]).reshape(400, 4, 8).permute(1, 0, 2)
    mask = torch.ones((4, 2, 400), dtype=torch.bool)
    mask[:, 1, ::3] = False
    x = x.contiguous()
    _same(new_init(x, mask, 5, gen_a), _old_kmeanspp(x, mask, 5, gen_b))
    assert torch.equal(gen_a.get_state(), gen_b.get_state())
    assert not new_lloyd.graphs and not new_init.graphs


@pytest.mark.parametrize("n_devices", [1, 3])
def test_cpu_dp_programs_equal_the_old_ones(built, n_devices):
    """The data-parallel encode and k-means step over CPU entries equal
    the old bodies to the bit and keep no graph."""
    tree, data = built
    enc = TS.make_dp_encode_fn(CFG, [CPU] * n_devices, encode_chunk=CHUNK)
    _same(enc(tree, data), _old_dp_encode(CFG, tree, data, n_devices, CHUNK))
    cents = data[::97][:12].copy()
    step = TS.make_dp_kmeans_step([CPU] * n_devices)
    for d in (data, torch.from_numpy(data)):
        _same(step(d, cents), _old_dp_kmeans_step(data, cents, n_devices))
    assert step.__wrapped__ is not step and not step.graphs


def test_encoder_matches_jax(built):
    """The graphed encoder's eager body against the JAX package's jitted
    `_encode_chunk` and `_pair_occ_device` on one tree: the two frameworks
    sum the distance tables in different orders, so at most 0.1% of the
    vectors (near-ties) may be encoded differently; ids, and the pairs
    of the vectors encoded alike, are equal."""
    tree, data = built
    jcfg = P.PQTConfig.from_json(CFG.to_json())
    jtree = P.PQTree.from_codebooks(jcfg, jnp.asarray(tree.cb1.numpy()),
                                    jnp.asarray(tree.cb2.numpy()))
    jb, jpc, jrows = (np.asarray(a) for a in JDB._encode_chunk(
        jcfg, jtree, jnp.asarray(data), jnp.int32(40)))
    occ = torch.zeros((CFG.p // 2, CFG.part_radix ** 2), dtype=torch.uint8)
    tb, tpc, trows = (a.numpy() for a in TDB.chunk_encoder(
        CFG, tree, torch.from_numpy(data), TDB._offset(40, CPU), occ))
    alike = (tb == jb) & (trows[:, 2:] == jrows[:, 2:]).all(axis=1) & (
        tpc == jpc).all(axis=1)
    assert (~alike).sum() <= max(1, data.shape[0] // 1000)
    np.testing.assert_array_equal(trows[:, 0], jrows[:, 0])
    jocc = np.asarray(JDB._pair_occ_device(
        jcfg, jnp.asarray(tpc[alike]),
        jnp.zeros(tuple(occ.shape), jnp.uint8)))
    mine = _old_pair_occ(CFG, torch.from_numpy(tpc[alike]),
                         torch.zeros_like(occ)).numpy()
    np.testing.assert_array_equal(mine, jocc)
    assert (occ.numpy() >= mine).all()


# ---------------------------------------------------------------------------
# the card's route, with a stub capture
# ---------------------------------------------------------------------------

def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    return []


class _Replaying:
    """A stand-in for a CUDA graph: a replay runs the captured function
    again on the same buffers (the launch counters left as they were) and
    writes its results into the outputs the capture returned."""

    def __init__(self, fn, args, out):
        self.fn, self.args, self.out, self.replays = fn, args, out, 0

    def replay(self):
        self.replays += 1
        before = graphs._counts()
        new = self.fn(*self.args)
        graphs._restore(before)
        for o, n in zip(_tensors(self.out), _tensors(new)):
            o.copy_(n)


@pytest.fixture
def on_card(monkeypatch):
    """CPU inputs take the card's route, with `_record` (the capture)
    replaced by `stub.record`; TK's generator for graphs is a CPU one."""
    stub = type("Stub", (), {})()
    stub.captures = []

    def record(fn, args, device, generators=()):
        states = [g.get_state() for g in generators]
        out = fn(*args)             # a capture draws no random numbers
        for g, state in zip(generators, states):
            g.set_state(state)
        stub.captures.append((fn.__name__, device, tuple(generators)))
        return _Replaying(fn, args, out), out, 1000

    stub.record = record
    monkeypatch.setattr(graphs, "_on_card", lambda x: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(graphs, "_record",
                        lambda *a, **kw: stub.record(*a, **kw))
    yield stub
    _clear()


@pytest.fixture(autouse=True)
def _no_graphs_left():
    """Each test starts and ends with empty graph caches."""
    _clear()
    yield
    _clear()


def _clear():
    for fn in (TDB.chunk_encoder, TDB.chunk_codes, TK._lloyd_converge,
               TK._kmeanspp_init):
        fn.graphs.clear()


def _count_norms(monkeypatch):
    """Each per-part norm counts one kernel D launch, as on the card."""
    monkeypatch.setattr(primitives.segmented_reduce, "launches", 0)
    plain = TDIST.segmented_reduce

    def counted(*a, **kw):
        primitives.segmented_reduce.launches += 1
        return plain(*a, **kw)

    monkeypatch.setattr(TDIST, "segmented_reduce", counted)


def test_encoder_key_holds_the_shape_not_the_offset(built, on_card,
                                                    monkeypatch):
    """Chunks of one shape share one entry whatever their id offset: the
    first call captures, later ones replay with the offset copied in; the
    last, shorter chunk has a key of its own.  Results, counters and the
    occupancy map equal the eager encode's."""
    _count_norms(monkeypatch)
    tree, data = built
    key = TDB.chunk_encoder.graph_key
    x = torch.from_numpy(data[:CHUNK])
    occ = torch.zeros((CFG.p // 2, CFG.part_radix ** 2), dtype=torch.uint8)
    base = key(CFG, tree, x, TDB._offset(0, CPU), occ)
    assert key(CFG, tree, torch.from_numpy(data[CHUNK:2 * CHUNK]),
               TDB._offset(CHUNK, CPU), occ) == base
    assert ("id_offset", (), torch.int32, CPU) in base
    changed = [key(CFG, tree, x[:100], TDB._offset(0, CPU), occ),
               key(CFG, tree, x.double(), TDB._offset(0, CPU), occ),
               key(CFG, tree, x, TDB._offset(0, CPU), occ.clone()),
               key(CFG, tree, x, TDB._offset(0, CPU), None),
               key(CFG.replace(hash_size=1 << 15), tree, x,
                   TDB._offset(0, CPU), occ)]
    assert len({base, *changed}) == len(changed) + 1

    db = T.build_database(CFG, tree, data, encode_chunk=CHUNK, device="cpu")
    assert primitives.segmented_reduce.launches == NORMS * 3
    assert [c[0] for c in on_card.captures] == ["chunk_encoder"] * 2
    entries = list(TDB.chunk_encoder.graphs.values())
    assert [e.replays for e in entries] == [1, 0]
    assert [tuple(e.queries[0].shape) for e in entries] == [
        (CHUNK, 32), (1300 - 2 * CHUNK, 32)]
    assert all(e.launches[(primitives.segmented_reduce, "launches")] ==
               NORMS for e in entries)
    want = _old_build(CFG, tree, data, CHUNK)
    _same((db.prefix, db.counts, db.payload, db.pair_occ, db.prefix2), want)
    # the shared encode loop into one occupancy map twice: another map is
    # another key, and the second pass is all replays, offsets copied in
    occ = torch.zeros_like(occ)
    old = [_old_encode_chunk(CFG, tree, torch.from_numpy(data[s:s + CHUNK]),
                             1000 + s) for s in range(0, 1300, CHUNK)]
    launched = primitives.segmented_reduce.launches
    for replays in ([1, 0], [3, 1]):
        got = [o for _, o in TDB._encode_rows(CFG, tree, data, CHUNK, 1000,
                                              occ)]
        for i in range(3):
            _same(torch.cat([o[i] for o in got]),
                  torch.cat([o[i] for o in old]))
        assert [e.replays for e in TDB.chunk_encoder.graphs.values()][
            2:] == replays
    _same(occ, want[3])
    assert primitives.segmented_reduce.launches - launched == NORMS * 6


def test_inputs_leave_the_entry_points_keys_unchanged(built):
    """With `inputs` defaulting to ("queries",), every query entry point's
    key is the one the single-input wrapper made: static arguments by
    value, ("queries", shape, dtype, device), the rest by `_leaves`."""
    tree, _ = built
    db = T.build_database(CFG, tree, built[1][:600], keep_vectors=True,
                          device="cpu")
    q = torch.from_numpy(built[1][:5])
    for fn, args in ((T.query_knn, (CFG, tree, db, q, 10, True)),
                     (T.query_candidates, (CFG, tree, db, q)),
                     (T.query_knn_refine, (CFG, tree, db, q, 10, 4, None)),
                     (T.query_big_knn, (CFG, tree, db, q, 10, 64)),
                     (T.query_big_knn_perfect, (CFG, tree, db, q, 10, 4,
                                                64))):
        sig = inspect.signature(fn.__wrapped__)
        bound = sig.bind(*args)
        bound.apply_defaults()
        at = list(sig.parameters).index("queries")
        want = tuple(("static", a) if i in fn.static_argnums else
                     ("queries", tuple(a.shape), a.dtype, a.device)
                     if i == at else graphs._leaves(a)
                     for i, a in enumerate(bound.args))
        assert fn.graph_key(*args) == want, fn.__name__


def test_multi_input_wrapper_refuses_a_stray_input(on_card):
    """Every input of a graphed function must be a tensor on the first
    input's device."""
    @graphs.graphed(static_argnums=(), inputs=("a", "b"))
    def add(a, b):
        return a + b

    with pytest.raises(TypeError, match="`b` is not a tensor"):
        add(torch.ones(2), 3)
    out = add(torch.ones(2), torch.full((2,), 2.0))
    again = add(torch.ones(2), torch.full((2,), 5.0))
    assert torch.equal(out, torch.full((2,), 3.0))
    assert torch.equal(again, torch.full((2,), 6.0))
    (entry,) = add.graphs.values()
    assert entry.replays == 1 and entry.bytes == 1000 + 16


def test_failed_encoder_capture_raises(built, on_card, monkeypatch):
    """A capture that fails raises: no entry is kept, nothing falls back,
    the counters keep only the eager call's launches, and the next call
    tries again and raises again."""
    _count_norms(monkeypatch)

    def failing(fn, args, device, generators=()):
        fn(*args)
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    on_card.record = failing
    tree, data = built
    for calls in (1, 2):
        with pytest.raises(RuntimeError, match="capturing"):
            TDB.chunk_encoder(CFG, tree, torch.from_numpy(data[:CHUNK]),
                              TDB._offset(0, CPU))
        assert not TDB.chunk_encoder.graphs
        assert primitives.segmented_reduce.launches == NORMS * calls


def test_calls_under_a_capture_and_in_eager_run_the_body(built, monkeypatch):
    """Under a capture (a nested call inlines) and inside graphs.eager(),
    the encoder, the Lloyd loop, the k-means++ picks and the dp k-means
    step run their bodies and capture nothing."""
    def refuse(*a, **kw):
        raise AssertionError("a graph was captured")

    monkeypatch.setattr(graphs, "_on_card", lambda x: True)
    monkeypatch.setattr(graphs, "_record", refuse)
    tree, data = built
    x = torch.from_numpy(data[:CHUNK])
    want = _old_encode_chunk(CFG, tree, x, 0)
    step = TS.make_dp_kmeans_step([CPU])
    cents = data[:6].copy()
    for capturing in (True, False):
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: capturing)
        with graphs.eager() if not capturing else contextlib.nullcontext():
            _same(TDB.chunk_encoder(CFG, tree, x, TDB._offset(0, CPU)),
                  want)
            got = T.train_tree(CFG, data, device="cpu")
            _same(step(data, cents), _old_dp_kmeans_step(data, cents, 1))
        assert torch.equal(got.cb2, built[0].cb2)
    assert not TDB.chunk_encoder.graphs and not step.graphs
    assert not TK._lloyd_converge.graphs and not TK._kmeanspp_init.graphs


def _problems(seed=0):
    """Lloyd problems that converge at different steps: 3 parts of 2
    masked populations each, blobs of varying spread."""
    rng = np.random.default_rng(seed)
    P_, n, d, k = 3, 600, 4, 5
    centers = rng.normal(0, 4, (P_, k, d))
    spread = np.array([0.2, 1.0, 3.0])[:, None, None]
    which = rng.integers(0, k, (P_, n))
    x = centers[np.arange(P_)[:, None], which] + rng.normal(
        0, 1, (P_, n, d)) * spread
    mask = np.ones((P_, 2, n), bool)
    mask[:, 1, rng.random(n) < 0.5] = False
    init = x[:, rng.choice(n, 2 * k, replace=False)].reshape(P_, 2, k, d)
    return (torch.from_numpy(x.astype(np.float32)),
            torch.from_numpy(mask), torch.from_numpy(init.astype(np.float32)))


KW = dict(iters=40, churn_tol=2e-3, move_tol=5e-3, chunk=256)


def test_lloyd_without_early_exit_equals_the_early_exit_loop():
    """All `iters` steps with the freeze and no read of `done` give the
    early-exit loop's centroids and assignments to the bit, on problems
    that converge at different steps, some well before `iters`."""
    data, mask, init = _problems()
    fmask = mask.to(torch.float32)
    consts = (data, fmask, torch.clamp_min(fmask.sum(-1), 1.0))
    state = (init, torch.full(mask.shape, -1, dtype=torch.int64),
             torch.zeros(mask.shape[:2], dtype=torch.bool))
    step = functools.partial(TK._lloyd_step, churn_tol=KW["churn_tol"],
                             move_tol=KW["move_tol"], chunk=KW["chunk"])
    done_at = torch.full(mask.shape[:2], -1)
    for i in range(KW["iters"]):
        state = step(*state, *consts)
        done_at = torch.where(state[2] & (done_at < 0), i + 1, done_at)
    assert len(set(done_at.flatten().tolist())) >= 3, done_at
    assert 0 < int(done_at.max()) < KW["iters"] // 2
    want = TK._lloyd_converge(data, mask, init, **KW)
    _same(state[:2], want)
    _same(want, _old_lloyd(data, mask, init, **KW))


@pytest.mark.parametrize("block", [1, 2, 3, 5])
def test_replayed_lloyd_reads_done_once_a_block(on_card, monkeypatch, block):
    """The card's route: the first step eager, then replays of one graph,
    `done` read once a block of LLOYD_BLOCK steps; the result equals the
    eager loop's to the bit and the steps run exceed the eager ones by
    less than a block.  A second call of the same shapes replays the
    same entry; another centroid count has its own."""
    monkeypatch.setattr(TK, "LLOYD_BLOCK", block)
    monkeypatch.setattr(TK, "lloyd_steps", {"run": 0, "replayed": 0})
    data, mask, init = _problems()
    reads = []
    real_all = torch.Tensor.all

    def counted_all(self, *a, **kw):
        reads.append(self.shape)
        return real_all(self, *a, **kw)

    with graphs.eager():
        want = TK._lloyd_converge(data, mask, init, **KW)
    eager_steps = TK.lloyd_steps["run"]
    monkeypatch.setattr(torch.Tensor, "all", counted_all)
    got = TK._lloyd_converge(data, mask, init, **KW)
    monkeypatch.setattr(torch.Tensor, "all", real_all)
    _same(got, want)
    run = TK.lloyd_steps["run"] - eager_steps
    assert eager_steps <= run < eager_steps + block
    assert len(reads) == 1 + -(-(run - 1) // block)
    (entry,) = TK._lloyd_converge.graphs.values()
    assert entry.replays == run - 1 == TK.lloyd_steps["replayed"]
    _same(TK._lloyd_converge(data, mask, init, **KW), want)
    assert len(TK._lloyd_converge.graphs) == 1
    TK._lloyd_converge(data, mask, init[:, :, :3], **KW)
    assert len(TK._lloyd_converge.graphs) == 2
    assert [c[0] for c in on_card.captures] == ["step", "step"]


def test_replayed_kmeanspp_draws_the_eager_draws(on_card):
    """The k-means++ picks replayed from one graph (a generator of the
    graphs' own, loaded with the caller's state and handing it back)
    give the eager seeds to the bit and leave the caller's generator
    where the eager picks leave it; the generator is registered with the
    capture."""
    data, mask, _ = _problems(1)
    gens = [torch.Generator().manual_seed(9) for _ in range(3)]
    with graphs.eager():
        want = TK._kmeanspp_init(data, mask, 6, gens[0])
    for gen in gens[1:]:
        _same(TK._kmeanspp_init(data, mask, 6, gen), want)
        assert torch.equal(gen.get_state(), gens[0].get_state())
    (entry,) = TK._kmeanspp_init.graphs.values()
    assert entry.replays == 4 + 5
    (capture,) = on_card.captures
    assert capture[2] == (TK._graph_generator(CPU),)
    _same(_old_kmeanspp(data, mask, 6, torch.Generator().manual_seed(9)),
          want)


def test_replayed_train_equals_the_eager_train(built, on_card):
    """A whole train through the stub's replays (Lloyd steps and picks)
    equals the eager train to the bit, for k-means++ and LBG."""
    _, data = built
    for init in ("kmeans++", "lbg"):
        cfg = CFG.replace(kmeans_init=init)
        with graphs.eager():
            want = T.train_tree(cfg, data, device="cpu")
        got = T.train_tree(cfg, data, device="cpu")
        for leaf in ("cb1", "cb2"):
            _same(getattr(got, leaf), getattr(want, leaf))
    assert TK._lloyd_converge.graphs and TK._kmeanspp_init.graphs


def test_loop_bookkeeping_and_failed_capture(on_card, monkeypatch):
    """A loop entry: the eager first step counts its launches, the
    capture adds nothing, each replay adds the recorded ones and writes
    the state back; a failing capture raises and keeps no entry."""
    monkeypatch.setattr(primitives.block_scan, "launches", 0)

    def step(x, at, const):
        primitives.block_scan.launches += 2
        return x + const, at + 1

    cache = {}
    entry, made = graphs.loop_or_capture(
        cache, "k", step, (torch.zeros(3), torch.zeros((), dtype=torch.int64),
                           torch.ones(3)), 2, CPU)
    assert made == 1 and primitives.block_scan.launches == 2
    assert torch.equal(entry.state[0], torch.ones(3))
    entry.replay(3)
    assert torch.equal(entry.state[0], torch.full((3,), 4.0))
    assert int(entry.state[1]) == 4 and entry.replays == 3
    assert primitives.block_scan.launches == 2 + 2 * 3
    assert entry.launches[(primitives.block_scan, "launches")] == 2
    assert entry.bytes == 1000 + 3 * 4 + 8 + 3 * 4
    again, made = graphs.loop_or_capture(
        cache, "k", step, (torch.zeros(3), torch.zeros((), dtype=torch.int64),
                           torch.full((3,), 2.0)), 2, CPU)
    assert again is entry and made == 0
    assert torch.equal(entry.state[0], torch.zeros(3))

    def failing(fn, args, device, generators=()):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    on_card.record = failing
    with pytest.raises(RuntimeError, match="capturing"):
        graphs.loop_or_capture(cache, "other", step, (
            torch.zeros(3), torch.zeros((), dtype=torch.int64),
            torch.ones(3)), 2, CPU)
    assert list(cache) == ["k"]


def test_dp_programs_replay(built, on_card):
    """The dp encode replays `chunk_codes` a chunk shape; the dp k-means
    step is one stage for the (one) device and the merge, its data read
    by address when it is a tensor there and copied in when it is a host
    array; replays equal the eager body to the bit."""
    tree, data = built
    enc = TS.make_dp_encode_fn(CFG, [CPU] * 2, encode_chunk=CHUNK)
    want = _old_dp_encode(CFG, tree, data, 2, CHUNK)
    _same(enc(tree, data), want)
    _same(enc(tree, data), want)
    assert sorted(e.replays for e in TDB.chunk_codes.graphs.values()) == [
        1, 3]
    step = TS.make_dp_kmeans_step([CPU] * 3)
    cents = torch.from_numpy(data[:8].copy())
    on_tensor = torch.from_numpy(data)
    for d in (on_tensor, data):
        want = _old_dp_kmeans_step(data, cents, 3)
        _same(step(d, cents), want)
        _same(step(d, cents + 0), want)
    assert [e.replays for e in step.graphs.values()] == [1, 1]
    by_address, copied = step.graphs.values()
    assert [len(b) for b in by_address.queries.values()] == [1]
    assert [len(b) for b in copied.queries.values()] == [4]
    assert [d for d, _ in copied.stages] == [CPU, CPU]
    moved = step(on_tensor, cents * 2)
    _same(moved, _old_dp_kmeans_step(data, cents * 2, 3))


# ---------------------------------------------------------------------------
# every compiled program and device loop of the JAX package, mapped
# ---------------------------------------------------------------------------

def _graphed(obj) -> bool:
    return isinstance(getattr(obj, "graphs", None), dict)


def _calls(fn, name) -> bool:
    return name in inspect.getsource(fn)


# Programs the port runs eagerly by design, with the reason.
EAGER_BY_DESIGN = {
    ("models/db.py", "_assemble_device"):
        "a build calls it once: its graph would be captured and never "
        "replayed, and its pool would hold the sorted payload for nothing",
    ("ops/distance.py", "brute_force_knn"):
        "the float64 correctness oracle, independent of the package's "
        "machinery; every caller passes one batch, so a graph would never "
        "be replayed",
}

# (file under pqt_tpu/, enclosing top-level function) -> a check that the
# port's counterpart is a compiled program: a graphed function, a graph
# cache, or (kernel C's jitted Pallas call) the hand-written kernel.
COUNTERPARTS = {
    ("models/db.py", "encode_part_codes"):
        lambda: _graphed(TDB.chunk_encoder) and _calls(TDB._encode_core,
                                                       "encode_part_codes"),
    ("models/db.py", "encode_bins"):
        lambda: _graphed(TDB.chunk_encoder) and _calls(TDB._encode_core,
                                                       "hashed_bin_ids"),
    ("models/db.py", "encode_line_codes"):
        lambda: _graphed(TDB.chunk_encoder) and _calls(TDB._encode_core,
                                                       "encode_line_codes"),
    ("models/db.py", "pack_payload_device"):
        lambda: _graphed(TDB.chunk_encoder) and _calls(
            TDB._encode_chunk, "pack_payload_device"),
    ("models/db.py", "_encode_chunk"):
        lambda: _graphed(TDB.chunk_encoder) and _calls(
            TDB.chunk_encoder.__wrapped__, "_encode_chunk"),
    ("models/db.py", "_pair_occ_device"):
        lambda: _graphed(TDB.chunk_encoder) and _calls(
            TDB.chunk_encoder.__wrapped__, "_pair_occ_device"),
    ("models/kmeans.py", "_lloyd_converge"):
        lambda: _graphed(TK._lloyd_converge) and _calls(
            TK._lloyd_converge, "graphs.loop_or_capture"),
    ("models/kmeans.py", "_kmeanspp_init"):
        lambda: _graphed(TK._kmeanspp_init) and _calls(
            TK._kmeanspp_init, "graphs.loop_or_capture"),
    ("parallel/sharded.py", "make_sharded_query_fn"):
        lambda: _calls(TS.make_sharded_query_fn, "graphs.replay_or_capture"),
    ("parallel/sharded.py", "make_dp_encode_fn"):
        lambda: _graphed(TDB.chunk_codes) and _calls(TS.make_dp_encode_fn,
                                                     "chunk_codes("),
    ("parallel/sharded.py", "make_dp_kmeans_step"):
        lambda: _calls(TS.make_dp_kmeans_step, "graphs.replay_or_capture"),
    ("ops/pallas/rerank.py", "rerank_fused"):
        lambda: hasattr(__import__(
            "pqt_tpu_torch.ops.cuda.rerank", fromlist=["rerank_fused"]
        ).rerank_fused, "launches"),
}
# the query entry points: test_torch_graphs.py holds them to their graphed
# counterparts with the same static arguments
for _module, _names in (("query", ("query_knn", "query_candidates",
                                   "query_knn_refine")),
                        ("query_big", ("query_big_knn",
                                       "query_big_knn_perfect")),
                        ("split", ("query_knn_split",)),
                        ("multidb", ("query_multi_knn",))):
    for _name in _names:
        COUNTERPARTS[(f"models/{_module}.py", _name)] = (
            lambda n=_name: _graphed(getattr(T, n)))


def _compiled_sites() -> set:
    """(file under pqt_tpu/, enclosing top-level function, kind) of every
    jax.jit (decorator or call), lax.while_loop and lax.fori_loop."""
    sites = set()
    for path in sorted((ROOT / "pqt_tpu").rglob("*.py")):
        rel = path.relative_to(ROOT / "pqt_tpu").as_posix()
        for top in ast.parse(path.read_text()).body:
            if not isinstance(top, (ast.FunctionDef, ast.ClassDef)):
                continue
            for node in ast.walk(top):
                texts = []
                if isinstance(node, ast.FunctionDef):
                    texts = [ast.unparse(d) for d in node.decorator_list]
                elif isinstance(node, ast.Call):
                    texts = [ast.unparse(node.func)]
                for text in texts:
                    for kind in ("jax.jit", "while_loop", "fori_loop"):
                        if kind in text:
                            sites.add((rel, top.name, kind))
    return sites


def test_every_compiled_program_has_a_counterpart():
    """Every jax.jit, lax.while_loop and lax.fori_loop of the JAX package
    maps to a compiled counterpart in the port or to the short list of
    programs eager by design; the map names no site that is gone."""
    sites = _compiled_sites()
    found = {(rel, fn) for rel, fn, _ in sites}
    assert {("models/kmeans.py", "_lloyd_converge", "while_loop"),
            ("models/kmeans.py", "_kmeanspp_init", "fori_loop"),
            ("models/db.py", "_encode_chunk", "jax.jit")} <= sites
    unmapped = found - set(COUNTERPARTS) - set(EAGER_BY_DESIGN)
    assert not unmapped, unmapped
    assert set(COUNTERPARTS) | set(EAGER_BY_DESIGN) <= found
    assert not set(COUNTERPARTS) & set(EAGER_BY_DESIGN)
    failing = [site for site, check in COUNTERPARTS.items() if not check()]
    assert not failing, failing
    for (rel, fn), reason in EAGER_BY_DESIGN.items():
        port = ROOT / "pqt_tpu_torch" / rel
        assert f"def {fn}(" in port.read_text() and reason


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def test_dp_kmeans_step_with_a_group(built, on_card, monkeypatch):
    """Through a gloo world of one the step captures its merge with the
    all-reduces, equals the step without a group, refuses a poisoned
    runtime before any replay, and raises once the group is destroyed."""
    import torch.distributed as dist
    from pqt_tpu_torch.parallel import distributed as TD
    monkeypatch.setattr(TD, "_poisoned", None)
    TD.initialize(f"localhost:{_free_port()}", 1, 0, 60, device="cpu")
    try:
        _, data = built
        cents = torch.from_numpy(data[:8].copy())
        step = TS.make_dp_kmeans_step([CPU] * 2, group=dist.group.WORLD)
        want = _old_dp_kmeans_step(data, cents, 2)
        _same(step(data, cents), want)
        _same(step(data, cents), want)
        (entry,) = step.graphs.values()
        assert entry.group is dist.group.WORLD and entry.replays == 1
        monkeypatch.setattr(TD, "_poisoned", "a collective did not complete")
        with pytest.raises(TD.PeerTimeoutError, match="refused"):
            step(data, cents)
        monkeypatch.setattr(TD, "_poisoned", None)
        dist.destroy_process_group()
        with pytest.raises(RuntimeError, match="destroyed"):
            step(data, cents)
        assert entry.replays == 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
