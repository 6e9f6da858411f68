"""The port's database build against the JAX package's, on one tree, and
the artifact files both ways (including the out-of-core sidecar leaves).

The two frameworks sum the distance tables in different orders, so a vector
whose best bin or best line is a near-tie may be encoded differently; at
most 0.1% of vectors may differ, and everything else is equal to the bit
(t3 within 1e-4 relative: it is a float sum over line parts).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pqt_tpu as P
from pqt_tpu.io import artifacts as JA
from pqt_tpu.models import db as JDB
import pqt_tpu_torch as T
from pqt_tpu_torch.io import artifacts as TA
from pqt_tpu_torch.models import db as TDB

PAIR_CFG = P.PQTConfig(
    dim=32, p=4, c1=4, c2=4, line_parts=8, hash_size=1 << 16,
    k1_build=4, k1_query=4, max_bins=256, max_candidates=1024,
    max_vec_per_bin=256, kmeans_iters=10, pair_top_m=64)
CONFIGS = {
    "exact": PAIR_CFG,
    "hashed": PAIR_CFG.replace(hash_size=1 << 10),
    "wide_k1": PAIR_CFG.replace(payload_compact=False, k1_build=2),
    "sift_width": P.SIFT1M_CONFIG.replace(hash_size=1 << 16,
                                          pair_filter=False),
}


@pytest.fixture(scope="module")
def trees(clustered_data):
    """A JAX-trained tree at PAIR_CFG, and one at SIFT1M width trained on
    uint8 data made from the clustered fixture."""
    db_vecs, _ = clustered_data
    small = P.train_tree(PAIR_CFG, db_vecs)
    rng = np.random.default_rng(1)
    proj = rng.normal(0, 1, (32, 128)).astype(np.float32)
    sift = np.clip(np.round(db_vecs @ proj * 12 + 100), 0, 255).astype(
        np.uint8)
    wide = P.train_tree(CONFIGS["sift_width"].replace(kmeans_iters=4), sift)
    return {"small": (small, db_vecs), "sift": (wide, sift)}


def _port_tree(cfg, tree):
    tcfg = T.PQTConfig.from_json(cfg.to_json())
    return tcfg, T.PQTree.from_numpy(tcfg, np.asarray(tree.cb1),
                                     np.asarray(tree.cb2), device="cpu")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_build_matches_jax(trees, name):
    cfg = CONFIGS[name]
    tree, data = trees["sift" if name == "sift_width" else "small"]
    tcfg, ttree = _port_tree(cfg, tree)
    want = P.build_database(cfg, tree, data, encode_chunk=2048,
                            keep_vectors=True)
    got = T.build_database(tcfg, ttree, data, encode_chunk=1500,
                           keep_vectors=True, device="cpu")
    n = data.shape[0]

    # per-vector encodings, by id
    jb, _, jrows = JDB._encode_chunk(cfg, tree, jnp.asarray(data),
                                     jnp.int32(0))
    tb, _, trows = TDB._encode_chunk(tcfg, ttree, torch.from_numpy(data), 0)
    jb, jrows, tb, trows = (np.asarray(jb), np.asarray(jrows), tb.numpy(),
                            trows.numpy())
    same_bin = tb == jb
    same_codes = (trows[:, 2:] == jrows[:, 2:]).all(axis=1)
    assert (~(same_bin & same_codes)).sum() <= max(1, n // 1000), (
        (~same_bin).sum(), (~same_codes).sum())
    np.testing.assert_array_equal(trows[:, 0], jrows[:, 0])
    t3_j = jrows[:, 1].view(np.float32)[same_codes]
    t3_t = trows[:, 1].view(np.float32)[same_codes]
    # t3 sums terms of both signs: bound the error by their scale
    np.testing.assert_allclose(t3_t, t3_j, rtol=1e-4,
                               atol=1e-6 * np.abs(t3_j).max())

    # the CSR: counts are the histogram of the port's bins, prefix is its
    # exclusive prefix, rows sit in bin order with ids ascending in a bin
    counts = got.counts.numpy()
    np.testing.assert_array_equal(
        counts, np.bincount(tb, minlength=cfg.hash_size))
    np.testing.assert_array_equal(got.prefix.numpy(),
                                  np.cumsum(counts) - counts)
    np.testing.assert_array_equal(got.prefix2.numpy()[:, 1],
                                  np.cumsum(counts))
    ids = got.payload.numpy()[:, 0]
    np.testing.assert_array_equal(ids, np.lexsort((np.arange(n), tb)))
    np.testing.assert_array_equal(got.payload.numpy(), trows[ids])
    if same_bin.all():
        np.testing.assert_array_equal(counts, np.asarray(want.counts))
        np.testing.assert_array_equal(ids, np.asarray(want.payload)[:, 0])
    if cfg.pair_filter_enabled:
        np.testing.assert_array_equal(got.pair_occ.numpy(),
                                      np.asarray(want.pair_occ))
    else:
        assert got.pair_occ is None and want.pair_occ is None
    np.testing.assert_array_equal(got.vectors.numpy(), data)


@pytest.mark.parametrize("name", ["exact", "wide_k1"])
def test_encode_bins_and_payload_views_match_jax(trees, name):
    """encode_bins, unpack_payload_cfg and the database's id / t3 views,
    in both payload layouts, on the JAX package's own build."""
    cfg = CONFIGS[name]
    tree, data = trees["small"]
    tcfg, ttree = _port_tree(cfg, tree)
    want_bins = np.asarray(JDB.encode_bins(cfg, tree, jnp.asarray(data)))
    got_bins = TDB.encode_bins(tcfg, ttree, torch.from_numpy(data)).numpy()
    assert (got_bins != want_bins).sum() <= max(1, data.shape[0] // 1000)

    jdb = P.build_database(cfg, tree, data, encode_chunk=2048)
    tdb = TDB.PQTDatabase.from_numpy(np.asarray(jdb.prefix),
                                     np.asarray(jdb.counts),
                                     np.asarray(jdb.payload), device="cpu")
    assert tdb.n_vectors == jdb.n_vectors
    np.testing.assert_array_equal(tdb.ids.numpy(), np.asarray(jdb.ids))
    np.testing.assert_array_equal(tdb.t3.numpy(), np.asarray(jdb.t3))
    np.testing.assert_array_equal(tdb.prefix2.numpy(),
                                  np.asarray(jdb.prefix2))
    want = JDB.unpack_payload_cfg(cfg, jdb.payload)
    got = TDB.unpack_payload_cfg(tcfg, tdb.payload)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


UPLOAD_CHUNK = 512
DB_LEAVES = ("prefix", "counts", "payload", "pair_occ", "vectors", "prefix2")


def _upload_rows(base, case):
    """The host rows of a chunked-upload case, from the fixture's rows."""
    c = UPLOAD_CHUNK
    if case == "read_only":
        rows = base[:2 * c + 3].copy()
        rows.setflags(write=False)
        return rows
    if case == "rotated":       # portbench/gen.py's rows(offset): a view
        ring = np.concatenate([base, base[:700]])
        return ring[613:613 + base.shape[0]]
    return {"multiple": base[:4 * c], "ragged": base[:4 * c + 37],
            "short": base[:c - 91], "strided": base[::2],
            "float32": base[:3 * c + 5]}[case]


def _staged_leaves(entry, cfg, tree, rows, keep_vectors, chunk, path):
    """What `entry` makes of the host rows encoded `chunk` rows a step, by
    name, as numpy arrays (None where a leaf is absent): a database's
    leaves, a multi-DB's groups' leaves and its own, or a chunk file's
    arrays."""
    if entry == "encode_chunk_to_file":
        T.encode_chunk_to_file(cfg, tree, rows, 0, path, encode_chunk=chunk,
                               keep_vectors=keep_vectors, device="cpu")
        with np.load(path) as z:
            return {name: z[name] for name in z.files}
    if entry == "build_multi_database":
        mdb = T.build_multi_database(cfg, tree, rows, 2, encode_chunk=chunk,
                                     keep_vectors=keep_vectors, device="cpu")
        leaves = {"vectors": mdb.vectors, "pair_occ": mdb.pair_occ}
        for i, db in enumerate(mdb.databases):
            leaves.update({f"{i}.{leaf}": getattr(db, leaf)
                           for leaf in DB_LEAVES})
    else:
        if entry == "add_chunk":
            builder = T.ChunkedDBBuilder(cfg, tree, keep_vectors=keep_vectors,
                                         encode_chunk=chunk, device="cpu")
            builder.add_chunk(rows)
            db = builder.finalize()
        else:
            db = T.build_database(cfg, tree, rows, keep_vectors=keep_vectors,
                                  encode_chunk=chunk, device="cpu")
        leaves = {leaf: getattr(db, leaf) for leaf in DB_LEAVES}
    return {k: None if v is None else v.numpy() for k, v in leaves.items()}


@pytest.mark.parametrize("keep_vectors", [True, False],
                         ids=["vectors", "no_vectors"])
@pytest.mark.parametrize("entry,case", [
    pytest.param("build_database", case, id=case)
    for case in ("multiple", "ragged", "short", "read_only", "strided",
                 "rotated", "float32")] + [
    pytest.param(entry, case, id=f"{entry}-{case}")
    for entry in ("add_chunk", "encode_chunk_to_file",
                  "build_multi_database")
    for case in ("ragged", "short", "strided")])
def test_chunked_upload_matches_one_chunk(trees, tmp_path, entry, case,
                                          keep_vectors):
    """Each staged entry (build_database, ChunkedDBBuilder.add_chunk,
    encode_chunk_to_file, build_multi_database) over host rows in chunks
    of UPLOAD_CHUNK rows (`_encode_rows`) equals, in every leaf to the bit
    (pair_occ and vectors included), the same rows through the same entry
    in one chunk: n a multiple of the chunk, ragged, and shorter than one
    chunk; a read-only array, a strided view, a rotated view of a larger
    array; float32 rows.  Every chunk is counted as staged, with its
    bytes."""
    name = "small" if case == "float32" else "sift"
    tree, base = trees[name]
    cfg = CONFIGS["exact" if name == "small" else "sift_width"]
    tcfg, ttree = _port_tree(cfg.replace(pair_filter=True), tree)
    rows = _upload_rows(base, case)
    assert rows.dtype == (np.float32 if name == "small" else np.uint8)
    n = rows.shape[0]
    want = _staged_leaves(entry, tcfg, ttree, rows, keep_vectors, n,
                          str(tmp_path / "one.npz"))
    chunks, nbytes = (TDB.build_database.chunks_staged,
                      TDB.build_database.bytes_staged)
    got = _staged_leaves(entry, tcfg, ttree, rows, keep_vectors,
                         UPLOAD_CHUNK, str(tmp_path / "chunked.npz"))
    assert TDB.build_database.chunks_staged - chunks == -(-n // UPLOAD_CHUNK)
    assert TDB.build_database.bytes_staged - nbytes == rows.nbytes
    assert got["pair_occ"] is not None
    assert got.keys() == want.keys()
    for leaf, a in got.items():
        b = want[leaf]
        if a is None:
            assert b is None, leaf
            continue
        assert a.dtype == b.dtype and np.array_equal(a, b), leaf
    if keep_vectors:
        np.testing.assert_array_equal(got.get("vectors", got.get("vecs")),
                                      rows)


def test_load_or_build_builds_once(trees, tmp_path):
    tree, _ = trees["small"]
    tcfg, ttree = _port_tree(PAIR_CFG, tree)
    path = str(tmp_path / "tree")
    built = []

    def builder():
        built.append(1)
        return ttree

    def saver(p, t):
        TA.save_tree(p, tcfg, t)

    def loader(p):
        return TA.load_tree(p, tcfg, device="cpu")

    first = TA.load_or_build(path, loader, builder, saver)
    second = TA.load_or_build(path, loader, builder, saver)
    assert first is ttree and len(built) == 1
    np.testing.assert_array_equal(second.cb2.numpy(), ttree.cb2.numpy())
    np.testing.assert_array_equal(second.pair_dists.numpy(),
                                  ttree.pair_dists.numpy())


def test_port_artifacts_load_in_jax(trees, tmp_path):
    tree, data = trees["small"]
    tcfg, ttree = _port_tree(PAIR_CFG, tree)
    db = T.build_database(tcfg, ttree, data, keep_vectors=True, device="cpu")
    TA.save_tree(str(tmp_path / "tree"), tcfg, ttree)
    TA.save_database(str(tmp_path / "db"), tcfg, db)
    jtree = JA.load_tree(str(tmp_path / "tree"), PAIR_CFG)
    jdb = JA.load_database(str(tmp_path / "db"), PAIR_CFG)
    np.testing.assert_array_equal(np.asarray(jtree.cb2), ttree.cb2.numpy())
    for leaf in ("prefix", "counts", "payload", "pair_occ", "vectors",
                 "prefix2"):
        np.testing.assert_array_equal(np.asarray(getattr(jdb, leaf)),
                                      getattr(db, leaf).numpy())
    with pytest.raises(TA.ArtifactMismatch):
        TA.load_database(str(tmp_path / "db"),
                         tcfg.replace(hash_size=1 << 12), device="cpu")


def test_load_database_reads_sidecar_leaves(trees, tmp_path):
    """An out-of-core JAX build keeps payload and vectors_csr in raw .bin
    sidecars; the port loads them and serves exact re-rank from vectors_csr
    alone, with the JAX package's results."""
    tree, data = trees["small"]
    builder = JDB.ChunkedDBBuilder(PAIR_CFG, tree, keep_vectors=True,
                                   encode_chunk=1024,
                                   spill_path=str(tmp_path / "spill"))
    for s in range(0, data.shape[0], 1000):
        builder.add_chunk(data[s:s + 1000])
    jdb = builder.finalize(to_device=False)
    assert isinstance(jdb.payload, np.memmap)
    JA.save_database(str(tmp_path / "db"), PAIR_CFG, jdb)
    tcfg, ttree = _port_tree(PAIR_CFG, tree)
    db = TA.load_database(str(tmp_path / "db"), tcfg, device="cpu")
    np.testing.assert_array_equal(db.payload.numpy(), np.asarray(jdb.payload))
    np.testing.assert_array_equal(db.vectors_csr.numpy(),
                                  np.asarray(jdb.vectors_csr))
    assert db.vectors is None
    want = P.query_knn(PAIR_CFG, tree,
                       JA.load_database(str(tmp_path / "db"), PAIR_CFG),
                       jnp.asarray(data[:4]), 5, True)
    got = T.query_knn(tcfg, ttree, db, torch.from_numpy(data[:4]), 5, True)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists),
                               rtol=1e-5, atol=1e-6)
    line = T.query_knn(tcfg, ttree, db, torch.from_numpy(data[:4]), 5)
    assert (line.indices.numpy() >= 0).all()
