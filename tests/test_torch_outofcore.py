"""The port's out-of-core build (models/db.py), spilled saves
(io/artifacts.py), native host runtime (io/native.py) and queries over a
database that holds only `vectors_csr`, against the JAX package's.

Config: tests/test_query_big.py's (dim 32, p 4, c1 8, c2 4, lp 8, hash
2^16), also with hashed bin ids (2^10) and with the wide payload.  One
JAX-trained tree; the port gets its codebooks.  Merging the same chunk
files gives the same leaves to the bit in both packages, whichever package
encoded them; the port's chunked builds equal its in-memory build to the
bit (same encode steps), and the JAX package's builds in bins, ids and line
codes, with t3 within 1e-4 (a float sum in another order).
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pqt_tpu as P
from pqt_tpu.io import artifacts as JA
from pqt_tpu.io import native as JN
from pqt_tpu.models import db as JDB
from pqt_tpu.models import query as JQ
import pqt_tpu_torch as T
from pqt_tpu_torch.io import artifacts as TA
from pqt_tpu_torch.io import native as TN
from pqt_tpu_torch.models import db as TDB
from test_torch_big import BIG_CFG
from test_torch_query import _assert_same_results

CONFIGS = {"compact": BIG_CFG, "hashed": BIG_CFG.replace(hash_size=1 << 10),
           "wide": BIG_CFG.replace(payload_compact=False)}
LEAVES = ("prefix", "counts", "payload", "pair_occ", "vectors",
          "vectors_csr", "prefix2")
STEP = 1024          # encode steps, and a divisor of every chunk


@pytest.fixture(scope="module")
def tree(clustered_data):
    db_vecs, _ = clustered_data
    return P.train_tree(BIG_CFG, db_vecs)


def _port(cfg, tree):
    tcfg = T.PQTConfig.from_json(cfg.to_json())
    return tcfg, T.PQTree.from_numpy(tcfg, np.asarray(tree.cb1),
                                     np.asarray(tree.cb2), device="cpu")


def _chunks(data):
    return [data[s:s + 2048] for s in range(0, data.shape[0], 2048)]


def _chunk_files(maker, cfg, tree, data, tmp, keep_vectors=True):
    """Encode the data in 2048-row chunk files with `maker`'s
    encode_chunk_to_file."""
    paths, off = [], 0
    tcfg, ttree = _port(cfg, tree)
    for i, c in enumerate(_chunks(data)):
        path = str(tmp / f"{maker}{i}.npz")
        if maker == "jax":
            JDB.encode_chunk_to_file(cfg, tree, c, off, path,
                                     encode_chunk=STEP,
                                     keep_vectors=keep_vectors)
        else:
            TDB.encode_chunk_to_file(tcfg, ttree, c, off, path,
                                     encode_chunk=STEP,
                                     keep_vectors=keep_vectors, device="cpu")
        paths.append(path)
        off += c.shape[0]
    return paths


def _leaf(db, name):
    x = getattr(db, name)
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return None if x is None else np.asarray(x)


def _assert_leaves_equal(got, want, names=LEAVES):
    for name in names:
        g, w = _leaf(got, name), _leaf(want, name)
        assert (g is None) == (w is None), name
        if g is not None:
            np.testing.assert_array_equal(g, w, err_msg=name)


def _assert_payload_matches_jax(got, want):
    """Ids and line codes to the bit, t3 within 1e-4."""
    g, w = _leaf(got, "payload"), _leaf(want, "payload")
    np.testing.assert_array_equal(g[:, [0] + list(range(2, g.shape[1]))],
                                  w[:, [0] + list(range(2, w.shape[1]))])
    np.testing.assert_allclose(g[:, 1].view(np.float32),
                               w[:, 1].view(np.float32), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("maker", ["jax", "port"])
def test_merge_same_chunk_files_equal(clustered_data, tree, tmp_path, name,
                                      maker):
    """Both packages' merge_chunk_files of one set of chunk files (made by
    either package): every leaf equal to the bit, pair_occ the OR of the
    chunks'; the port's leaves on a device equal its host leaves."""
    cfg = CONFIGS[name]
    tcfg, _ = _port(cfg, tree)
    data, _ = clustered_data
    paths = _chunk_files(maker, cfg, tree, data, tmp_path)
    want = JDB.merge_chunk_files(cfg, tree, paths, keep_vectors=True,
                                 spill_path=str(tmp_path / "j"),
                                 to_device=False)
    got = TDB.merge_chunk_files(tcfg, None, paths, keep_vectors=True,
                                spill_path=str(tmp_path / "t"),
                                to_device=False)
    assert isinstance(got.payload, np.memmap)
    assert isinstance(got.vectors_csr, np.memmap)
    _assert_leaves_equal(got, want)
    on_dev = TDB.merge_chunk_files(tcfg, None, paths, device="cpu")
    assert isinstance(on_dev.payload, torch.Tensor)
    _assert_leaves_equal(on_dev, got, ("prefix", "counts", "payload",
                                       "pair_occ", "prefix2"))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_merged_payload_equals_build_database(clustered_data, tree, tmp_path,
                                              name):
    """The port's chunk files, merged, give its in-memory build's leaves to
    the bit (rows placed in input order: ids ascend inside every bin), and
    vectors_csr is the by-id vectors in CSR order."""
    cfg = CONFIGS[name]
    tcfg, ttree = _port(cfg, tree)
    data, _ = clustered_data
    paths = _chunk_files("port", cfg, tree, data, tmp_path)
    got = TDB.merge_chunk_files(tcfg, ttree, paths, keep_vectors=True,
                                spill_path=str(tmp_path / "t"),
                                device="cpu")
    want = T.build_database(tcfg, ttree, data, keep_vectors=True,
                            encode_chunk=STEP, device="cpu")
    _assert_leaves_equal(got, want, ("prefix", "counts", "payload",
                                     "pair_occ", "prefix2"))
    np.testing.assert_array_equal(got.vectors_csr.numpy(),
                                  data[want.ids.numpy()])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_assemble_database_equal(name):
    """The host CSR assembly (counting sort, host packers, row gather) of
    the same encoded rows, ids offset, with vectors and pair_occ: every
    leaf equal to the JAX package's to the bit."""
    cfg = CONFIGS[name]
    tcfg = T.PQTConfig.from_json(cfg.to_json())
    rng = np.random.default_rng(11)
    n, lp = 3000, cfg.line_parts
    bins = rng.integers(0, min(cfg.hash_size, 700), n).astype(np.int32)
    a = rng.integers(0, cfg.c1, (n, lp)).astype(np.uint32)
    b = rng.integers(0, cfg.c1, (n, lp)).astype(np.uint32)
    lam = rng.integers(0, 256, (n, lp)).astype(np.uint32) << 8   # u8 grid
    codes = a | (b << 8) | (lam << 16)
    t3 = rng.normal(0, 1, n).astype(np.float32)
    vecs = rng.integers(0, 255, (n, cfg.dim)).astype(np.uint8)
    occ = (rng.random((cfg.p // 2, cfg.part_radix ** 2)) < 0.3).astype(
        np.uint8)
    want = JDB.assemble_database(cfg, bins, codes, t3, vectors=vecs,
                                 id_offset=500, pair_occ=occ)
    got = TDB.assemble_database(tcfg, bins, codes, t3, vectors=vecs,
                                id_offset=500, pair_occ=occ, device="cpu")
    _assert_leaves_equal(got, want)
    assert got.ids.numpy().min() == 500


@pytest.mark.parametrize("name", ["compact", "hashed"])
@pytest.mark.parametrize("spilled", [False, True])
def test_chunked_builder_matches(clustered_data, tree, tmp_path, name,
                                 spilled):
    """ChunkedDBBuilder in RAM (vectors by id) and spilled (vectors_csr):
    the port's equals its in-memory build to the bit and the JAX package's
    builder in every leaf but t3."""
    cfg = CONFIGS[name]
    tcfg, ttree = _port(cfg, tree)
    data, _ = clustered_data
    spill = dict(spill_path=str(tmp_path / "t")) if spilled else {}
    tb = TDB.ChunkedDBBuilder(tcfg, ttree, keep_vectors=True,
                              encode_chunk=STEP, device="cpu", **spill)
    jb = JDB.ChunkedDBBuilder(
        cfg, tree, keep_vectors=True, encode_chunk=STEP,
        **(dict(spill_path=str(tmp_path / "j")) if spilled else {}))
    for c in _chunks(data):
        tb.add_chunk(c)
        jb.add_chunk(c)
    got = tb.finalize(to_device=False)
    want = jb.finalize(to_device=False)
    assert isinstance(got.payload, np.memmap) == spilled
    _assert_leaves_equal(got, want, ("prefix", "counts", "pair_occ",
                                     "vectors", "vectors_csr", "prefix2"))
    _assert_payload_matches_jax(got, want)
    mem = T.build_database(tcfg, ttree, data, keep_vectors=True,
                           encode_chunk=STEP, device="cpu")
    _assert_leaves_equal(tb.finalize(), mem, ("prefix", "counts", "payload",
                                              "pair_occ", "prefix2"))


@pytest.mark.parametrize("maker", ["jax", "port"])
def test_merge_range_partitions(clustered_data, tree, tmp_path, maker):
    """merge_chunk_files_range over three hash ranges: each range equal to
    the JAX package's to the bit, and the ranges together the global
    merge."""
    cfg = CONFIGS["compact"]
    tcfg, _ = _port(cfg, tree)
    data, _ = clustered_data
    paths = _chunk_files(maker, cfg, tree, data, tmp_path)
    full = TDB.merge_chunk_files(tcfg, None, paths, keep_vectors=True,
                                 spill_path=str(tmp_path / "t"),
                                 to_device=False)
    cuts = (0, 20000, 41000, cfg.hash_size)
    payloads = []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        got = TDB.merge_chunk_files_range(tcfg, paths, lo, hi,
                                          keep_vectors=True)
        want = JDB.merge_chunk_files_range(cfg, paths, lo, hi,
                                           keep_vectors=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(got[0], full.prefix[lo:hi]
                                      - full.prefix[lo])
        np.testing.assert_array_equal(got[1], full.counts[lo:hi])
        payloads.append(got[2])
    np.testing.assert_array_equal(np.concatenate(payloads), full.payload)


def test_chunk_format_error(clustered_data, tree, tmp_path):
    cfg = CONFIGS["compact"]
    tcfg, _ = _port(cfg, tree)
    data, _ = clustered_data
    paths = _chunk_files("port", cfg, tree, data, tmp_path,
                         keep_vectors=False)
    with pytest.raises(T.ChunkFormatError):
        TDB.merge_chunk_files(tcfg, None, paths, keep_vectors=True,
                              spill_path=str(tmp_path / "t"), device="cpu")
    with pytest.raises(T.ChunkFormatError):
        TDB.merge_chunk_files_range(tcfg, paths, 0, 100, keep_vectors=True)
    with pytest.raises(ValueError):
        TDB.merge_chunk_files(tcfg, None, paths, keep_vectors=True,
                              device="cpu")
    # the JAX package agrees on what is missing
    with pytest.raises(JDB.ChunkFormatError):
        JDB.merge_chunk_files(cfg, tree, paths, keep_vectors=True,
                              spill_path=str(tmp_path / "j"))


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_sidecar_save_load_both_ways(clustered_data, tree, tmp_path, saver):
    """A spilled database saved with raw sidecars by one package loads in
    the other with the same leaves; the port's save adopts the memmaps'
    files, and re-saving a loaded database to its own path keeps them."""
    cfg = CONFIGS["compact"]
    tcfg, _ = _port(cfg, tree)
    data, _ = clustered_data
    paths = _chunk_files("jax", cfg, tree, data, tmp_path)
    base = str(tmp_path / "db")
    if saver == "jax":
        db = JDB.merge_chunk_files(cfg, tree, paths, keep_vectors=True,
                                   spill_path=str(tmp_path / "s"),
                                   to_device=False)
        want = {n: _leaf(db, n) for n in LEAVES}
        JA.save_database(base, cfg, db)
        got = TA.load_database(base, tcfg, device="cpu")
    else:
        db = TDB.merge_chunk_files(tcfg, None, paths, keep_vectors=True,
                                   spill_path=str(tmp_path / "s"),
                                   to_device=False)
        want = {n: np.array(_leaf(db, n)) if _leaf(db, n) is not None
                else None for n in LEAVES}
        TA.save_database(base, tcfg, db, adopt_memmaps=True)
        assert not os.path.exists(str(tmp_path / "s"))       # adopted
        assert os.path.exists(base + ".npz.payload.bin")
        got = JA.load_database(base, cfg)
        assert isinstance(got.payload, np.memmap)
        JA.save_database(base, cfg, got)      # its own sidecars, kept
        got = TA.load_database(base, tcfg, device="cpu")
    for name in LEAVES:
        g = _leaf(got, name)
        assert (g is None) == (want[name] is None), name
        if g is not None:
            np.testing.assert_array_equal(g, want[name], err_msg=name)


def test_adopt_memmaps_copies_a_partial_view(clustered_data, tree, tmp_path):
    """adopt_memmaps renames a memmap's file only when the memmap covers it
    whole from offset 0; a view of part of it is copied, and the file stays
    the view's source."""
    cfg = CONFIGS["compact"]
    tcfg, _ = _port(cfg, tree)
    data, _ = clustered_data
    paths = _chunk_files("port", cfg, tree, data, tmp_path)
    db = TDB.merge_chunk_files(tcfg, None, paths, keep_vectors=True,
                               spill_path=str(tmp_path / "s"),
                               to_device=False)
    view = db.payload[5:]
    offset_map = np.memmap(str(tmp_path / "s"), np.int32, mode="r",
                           offset=4 * db.payload.shape[1],
                           shape=(db.payload.shape[0] - 1,
                                  db.payload.shape[1]))
    for i, leaf in enumerate((view, offset_map)):
        base = str(tmp_path / f"db{i}")
        TA.save_database(base, tcfg, db._replace(payload=leaf),
                         adopt_memmaps=True)
        assert os.path.exists(str(tmp_path / "s"))
        side = np.fromfile(base + ".npz.payload.bin", np.int32)
        np.testing.assert_array_equal(side.reshape(leaf.shape), leaf)
    TA.save_database(str(tmp_path / "whole"), tcfg, db, adopt_memmaps=True)
    assert not os.path.exists(str(tmp_path / "s"))
    # a part of a sidecar saved over that same sidecar would truncate the
    # file under its own mapping: refused
    side = np.memmap(str(tmp_path / "whole.npz.payload.bin"), np.int32,
                     mode="r", shape=db.payload.shape)
    with pytest.raises(ValueError):
        TA.save_database(str(tmp_path / "whole"), tcfg,
                         db._replace(payload=side[1:]))


@pytest.fixture(scope="module")
def csr_dbs(clustered_data, tree, tmp_path_factory):
    """The same chunk files merged and saved with sidecars by each package:
    (jax db (vectors_csr only), port db loaded on the CPU, the port's
    in-memory db of the data, with vectors by id)."""
    tmp = tmp_path_factory.mktemp("csr")
    cfg = CONFIGS["compact"]
    tcfg, ttree = _port(cfg, tree)
    data, _ = clustered_data
    paths = _chunk_files("port", cfg, tree, data, tmp)
    jdb = JDB.merge_chunk_files(cfg, tree, paths, keep_vectors=True,
                                spill_path=str(tmp / "j"), to_device=False)
    JA.save_database(str(tmp / "jdb"), cfg, jdb)
    tdb = TDB.merge_chunk_files(tcfg, None, paths, keep_vectors=True,
                                spill_path=str(tmp / "t"), to_device=False)
    TA.save_database(str(tmp / "tdb"), tcfg, tdb, adopt_memmaps=True)
    mem = T.build_database(tcfg, ttree, data, keep_vectors=True,
                           encode_chunk=STEP, device="cpu")
    return (JA.load_database(str(tmp / "jdb"), cfg),
            TA.load_database(str(tmp / "tdb"), tcfg, device="cpu"), mem)


@pytest.mark.parametrize("variant", [dict(), dict(pipeline="parts"),
                                     dict(gather_mode="slabs", slab_size=32)],
                         ids=["pair", "parts", "slabs"])
@pytest.mark.parametrize("mode", ["exact", "refine", "candidates"])
def test_csr_only_queries_equal(clustered_data, tree, csr_dbs, variant,
                                mode):
    """Exact, refine and candidates over a database that holds only
    vectors_csr: the JAX package's results (ids up to ties, distances
    within 1e-5), and the port's own in-memory database's (by id)."""
    jdb, tdb, mem = csr_dbs
    assert tdb.vectors is None and tdb.vectors_csr is not None
    cfg = CONFIGS["compact"].replace(**variant)
    tcfg, ttree = _port(cfg, tree)
    _, queries = clustered_data
    q, tq = jnp.asarray(queries), torch.from_numpy(queries)
    if mode == "candidates":
        want = JQ.query_candidates(cfg, tree, jdb, q)
        for db in (tdb, mem):
            got = T.query_candidates(tcfg, ttree, db, tq)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        return
    if mode == "exact":
        want = P.query_knn(cfg, tree, jdb, q, 10, True)
        got = T.query_knn(tcfg, ttree, tdb, tq, 10, True)
        by_id = T.query_knn(tcfg, ttree, mem, tq, 10, True)
    else:
        want = P.query_knn_refine(cfg, tree, jdb, q, 10)
        got = T.query_knn_refine(tcfg, ttree, tdb, tq, 10)
        by_id = T.query_knn_refine(tcfg, ttree, mem, tq, 10)
    _assert_same_results(want, got)
    assert torch.equal(got.indices, by_id.indices)
    assert torch.equal(got.dists, by_id.dists)


def test_native_library_loads_and_matches_plain():
    """The native runtime builds here and equals its NumPy plain version in
    every entry point (and the JAX package's runtime)."""
    assert TN.get_lib() is not None, TN.load_error()
    rng = np.random.default_rng(3)
    bins = rng.integers(0, 4096, 30000).astype(np.int32)
    got, plain = TN.build_csr(bins, 4096), TN.build_csr_plain(bins, 4096)
    for g, p, j in zip(got, plain, JN.build_csr(bins, 4096)):
        np.testing.assert_array_equal(g, p)
        np.testing.assert_array_equal(g, j)
    src = rng.integers(-99, 99, (30000, 7)).astype(np.int16)
    order = rng.permutation(30000).astype(np.int32)
    np.testing.assert_array_equal(TN.gather_rows(src, order),
                                  TN.gather_rows_plain(src, order))
    cur, cur_plain = np.zeros(4096, np.int64), np.zeros(4096, np.int64)
    for s in range(0, 30000, 7000):
        np.testing.assert_array_equal(
            TN.place_positions(bins[s:s + 7000], cur),
            TN.place_positions_plain(bins[s:s + 7000], cur_plain))
        np.testing.assert_array_equal(cur, cur_plain)
    assert TN.place_positions(np.empty(0, np.int32), cur).shape == (0,)
    pos = rng.permutation(40000)[:30000]
    dst, dst_plain = np.zeros((40000, 7), np.int16), np.zeros((40000, 7),
                                                              np.int16)
    TN.scatter_rows(src, pos, dst)
    TN.scatter_rows_plain(src, pos, dst_plain)
    np.testing.assert_array_equal(dst, dst_plain)
    with pytest.raises(ValueError):
        TN.build_csr(np.array([0, 4096], np.int32), 4096)
    with pytest.raises(ValueError):
        TN.scatter_rows(src[:2], np.array([0, 40000]), dst)


def test_scatter_rows_casts_across_dtypes():
    """Rows of equal byte width but another dtype are assigned as NumPy
    assigns them (a cast), never copied as raw bytes."""
    src = np.array([[1.5], [2.25], [-3.0]], np.float32)
    dst = np.zeros((4, 1), np.int32)
    assert src.strides[0] == dst.strides[0]
    TN.scatter_rows(src, np.array([3, 0, 1]), dst)
    want = np.zeros((4, 1), np.int32)
    want[[3, 0, 1]] = src
    np.testing.assert_array_equal(dst, want)
    # 4-byte rows of another shape: NumPy broadcasts and casts
    wide, want = np.zeros((4, 2), np.int16), np.zeros((4, 2), np.int16)
    TN.scatter_rows(src, np.array([3, 0, 1]), wide)
    want[[3, 0, 1]] = src
    np.testing.assert_array_equal(wide, want)


def test_out_of_core_entry_points_need_a_card(clustered_data, tree, tmp_path,
                                              monkeypatch):
    """Device work defaults to "cuda" and raises without a card; a host
    merge with to_device=False needs none."""
    cfg = CONFIGS["compact"]
    tcfg, ttree = _port(cfg, tree)
    data, _ = clustered_data
    paths = _chunk_files("port", cfg, tree, data[:2048], tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TDB.ChunkedDBBuilder(tcfg, ttree)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TDB.encode_chunk_to_file(tcfg, ttree, data[:16], 0,
                                 str(tmp_path / "x.npz"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TDB.merge_chunk_files(tcfg, ttree, paths)
    host = TDB.merge_chunk_files(tcfg, ttree, paths, to_device=False)
    assert host.payload.shape[0] == 2048
