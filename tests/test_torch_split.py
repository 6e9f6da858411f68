"""The port's split-tree engine against the JAX package's, on the CPU.

tests/test_split_training.py's CFG on `clustered_data`.  Given the same
inputs the dense masks (`mark_dense_vectors` on one L1 assignment, many
bins tied on count among them; `mark_dense_vectors_for` on the JAX tree)
and the members' inverted files are equal to the bit (the port's own encode
differs only in t3's last bits).  `query_knn_split` over the JAX package's
split database, in line, exact and refine modes: ids equal up to ties in
distance, distances within rtol 1e-5, atol 1e-4, candidate counts equal.
The port's split training draws other random numbers than the JAX
package's, so it is held to the JAX trees' quality (tests/test_torch_train.py's
contract): the two-level quantization error of the training vectors, each
by its own member's tree, within 5%, and exact recall within 0.03.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pqt_tpu as P
from pqt_tpu.models import db as JDB
from pqt_tpu.models import split as JS
from pqt_tpu.models import tree as JT
from pqt_tpu.ops.distance import brute_force_knn
from pqt_tpu.utils import metrics
import pqt_tpu_torch as T
from pqt_tpu_torch.models import db as TDB
from pqt_tpu_torch.models import split as TS
from pqt_tpu_torch.models import tree as TT

CFG = P.PQTConfig(dim=32, p=4, c1=8, c2=4, line_parts=8, hash_size=1 << 16,
                  k1_build=4, k1_query=4, max_bins=256, max_candidates=1024,
                  max_vec_per_bin=256, kmeans_iters=8)
TCFG = T.PQTConfig.from_json(CFG.to_json())
RTOL, ATOL = 1e-5, 1e-4


def _cb(tree):
    return np.asarray(tree.cb1), np.asarray(tree.cb2)


def _db_arrays(db):
    return dict(prefix=np.asarray(db.prefix), counts=np.asarray(db.counts),
                payload=np.asarray(db.payload),
                pair_occ=np.asarray(db.pair_occ),
                vectors=np.asarray(db.vectors))


@pytest.fixture(scope="module")
def jax_split(clustered_data):
    """The JAX package's split database (kept vectors) and the port's copy
    of it, with the exact neighbours."""
    db_vecs, queries = clustered_data
    sdb = JS.build_split_database(CFG, db_vecs, keep_vectors=True,
                                  encode_chunk=2048)
    tsdb = TS.SplitDatabase.from_numpy(
        TCFG, _cb(sdb.dense_tree), _cb(sdb.sparse_tree),
        _db_arrays(sdb.dense_db), _db_arrays(sdb.sparse_db),
        np.asarray(sdb.dense_ids), np.asarray(sdb.sparse_ids), device="cpu")
    _, gt = brute_force_knn(jnp.asarray(queries), jnp.asarray(db_vecs), 10)
    return sdb, tsdb, np.asarray(gt)


def _assignments(kind, jax_split, clustered_data):
    if kind == "trained":
        # the L1 assignment under the JAX package's trained split L1
        d1 = JT.level1_tables(CFG, jax_split[0].dense_tree,
                              jnp.asarray(clustered_data[0]))
        return np.asarray(jnp.argmin(d1, axis=-1), np.int32)
    rng = np.random.default_rng(5)
    if kind == "ties":
        # 3000 vectors over 4^4 = 256 bins: counts of about 12, many equal
        return rng.integers(0, 4, (3000, 4)).astype(np.int32)
    # every occupied bin holds exactly 3 vectors: all counts tie
    combos = np.stack(np.meshgrid(*[np.arange(8)] * 4, indexing="ij"),
                      -1).reshape(-1, 4)[rng.permutation(4096)[:500]]
    return rng.permutation(np.repeat(combos, 3, axis=0)).astype(np.int32)


@pytest.mark.parametrize("percent", [0.3, 0.5])
@pytest.mark.parametrize("kind", ["trained", "ties", "all_tied"])
def test_mark_dense_vectors_is_bit_equal(jax_split, clustered_data, kind,
                                        percent):
    assign1 = _assignments(kind, jax_split, clustered_data)
    want = np.asarray(JT.mark_dense_vectors(CFG, jnp.asarray(assign1),
                                            percent))
    got = TT.mark_dense_vectors(TCFG, torch.tensor(assign1), percent)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert percent <= want.mean() < 1.0


def test_mark_dense_vectors_for_is_bit_equal(jax_split, clustered_data):
    db_vecs, _ = clustered_data
    sdb, tsdb, _ = jax_split
    want = np.asarray(JT.mark_dense_vectors_for(CFG, sdb.dense_tree, db_vecs,
                                                chunk=1000))
    got = TT.mark_dense_vectors_for(TCFG, tsdb.dense_tree, db_vecs,
                                    chunk=1000)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("member", ["dense", "sparse"])
def test_members_match_jax(jax_split, clustered_data, member):
    """Each member over the JAX tree and population: assembled from the
    JAX package's encodings, equal to its member to the bit; the port's
    own build equal but for t3's rounding."""
    db_vecs, _ = clustered_data
    sdb, tsdb, _ = jax_split
    jtree, jdb = getattr(sdb, member + "_tree"), getattr(sdb, member + "_db")
    ids = np.asarray(getattr(sdb, member + "_ids"))
    np.testing.assert_array_equal(getattr(tsdb, member + "_ids").numpy(), ids)
    data = db_vecs[ids]
    bins, _, rows = JDB._encode_chunk(CFG, jtree, jnp.asarray(data),
                                      jnp.int32(0))
    prefix, counts, prefix2, payload = TDB._assemble_device(
        TCFG, torch.from_numpy(np.array(bins)),
        torch.from_numpy(np.array(rows)))
    for got, want in ((prefix, jdb.prefix), (counts, jdb.counts),
                      (prefix2, jdb.prefix2), (payload, jdb.payload)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    own = T.build_database(TCFG, getattr(tsdb, member + "_tree"), data,
                           keep_vectors=True, device="cpu")
    for leaf in ("prefix", "counts", "pair_occ", "vectors"):
        np.testing.assert_array_equal(getattr(own, leaf).numpy(),
                                      np.asarray(getattr(jdb, leaf)))
    gp, wp = own.payload.numpy(), np.asarray(jdb.payload)
    np.testing.assert_array_equal(np.delete(gp, 1, axis=1),
                                  np.delete(wp, 1, axis=1))
    t3_w = wp[:, 1].view(np.float32)
    np.testing.assert_allclose(gp[:, 1].view(np.float32), t3_w, rtol=1e-4,
                               atol=1e-6 * np.abs(t3_w).max())


@pytest.mark.parametrize("mode", ["line", "exact", "refine"])
def test_query_knn_split_matches_jax(jax_split, clustered_data, mode):
    _, queries = clustered_data
    sdb, tsdb, gt = jax_split
    exact, refine = mode == "exact", mode == "refine"
    want = JS.query_knn_split(CFG, sdb, jnp.asarray(queries), 10, exact,
                              refine)
    got = TS.query_knn_split(TCFG, tsdb, torch.from_numpy(queries), 10,
                             exact, refine)
    assert got.indices.dtype == torch.int32 and got.indices.shape == (64, 10)
    wid, wd = np.asarray(want.indices), np.asarray(want.dists)
    gid, gd = got.indices.numpy(), got.dists.numpy()
    np.testing.assert_allclose(gd, wd, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.n_candidates.numpy(),
                                  np.asarray(want.n_candidates))
    for b, s in zip(*np.nonzero(gid != wid)):
        tie = np.isclose(wd[b], wd[b, s], rtol=RTOL, atol=ATOL)
        assert tie.sum() > 1 or s == wd.shape[1] - 1, (b, s)
    assert metrics.recall_at(gid, gt) == metrics.recall_at(wid, gt)


def _quantization_error(tree, data):
    """Mean squared error of the two-level reconstruction of `data`."""
    x = torch.from_numpy(data)
    codes = TDB.encode_part_codes(TCFG, tree, x)
    parts = torch.arange(TCFG.p)[None, :]
    recon = tree.cb2[parts, codes // TCFG.c2, codes % TCFG.c2]
    return float(((x.reshape(len(x), TCFG.p, TCFG.vl) - recon) ** 2)
                 .sum((1, 2)).mean())


def test_split_training_quality_matches_jax(jax_split, clustered_data):
    """train_tree_split: one shared L1, two refinement sets; each member's
    two-level error on its population within 5% of the JAX tree's, and the
    exact union recall within 0.03 of the JAX split's."""
    db_vecs, queries = clustered_data
    sdb, tsdb, gt = jax_split
    dense_t, sparse_t, dense = TT.train_tree_split(TCFG, db_vecs,
                                                   device="cpu")
    assert torch.equal(dense_t.cb1, sparse_t.cb1)
    assert not torch.equal(dense_t.cb2, sparse_t.cb2)
    assert 0.3 <= float(dense.float().mean()) < 0.95
    # the same draws again: the training is seeded
    again = TT.train_tree_split(TCFG, db_vecs, device="cpu")
    assert torch.equal(again[0].cb2, dense_t.cb2)
    # each training vector reconstructed by its own member's tree
    dm = dense.numpy()
    err_t = (_quantization_error(dense_t, db_vecs[dm]) * dm.sum()
             + _quantization_error(sparse_t, db_vecs[~dm]) * (~dm).sum())
    err_j = sum(_quantization_error(getattr(tsdb, m + "_tree"),
                                    db_vecs[getattr(tsdb, m + "_ids").numpy()])
                * len(getattr(tsdb, m + "_ids")) for m in ("dense", "sparse"))
    assert err_t <= 1.05 * err_j, (err_t, err_j)
    own = TS.build_split_database(TCFG, db_vecs, keep_vectors=True,
                                  encode_chunk=2048, device="cpu")
    ids = np.sort(np.concatenate([own.dense_ids.numpy(),
                                  own.sparse_ids.numpy()]))
    np.testing.assert_array_equal(ids, np.arange(db_vecs.shape[0]))
    q = torch.from_numpy(queries)
    r_t = metrics.recall_at(
        TS.query_knn_split(TCFG, own, q, 10, True).indices.numpy(), gt)
    r_j = metrics.recall_at(np.asarray(JS.query_knn_split(
        CFG, sdb, jnp.asarray(queries), 10, True).indices), gt)
    assert r_t["R@1"] >= r_j["R@1"] - 0.03, (r_t, r_j)


def test_subsample_training_routes_every_vector(clustered_data):
    """train_data: the split tree trains on a subsample and the whole
    dataset is routed through mark_dense_vectors_for."""
    db_vecs, queries = clustered_data
    sdb = TS.build_split_database(TCFG, db_vecs, encode_chunk=2048,
                                  train_data=db_vecs[:2048], device="cpu")
    dense = TT.mark_dense_vectors_for(TCFG, sdb.dense_tree, db_vecs)
    np.testing.assert_array_equal(sdb.dense_ids.numpy(),
                                  np.flatnonzero(dense.numpy()))
    assert sdb.dense_ids.shape[0] + sdb.sparse_ids.shape[0] == len(db_vecs)
    res = TS.query_knn_split(TCFG, sdb, torch.from_numpy(queries), 5)
    assert int(res.indices.max()) < len(db_vecs)
    assert (res.indices[:, 0] >= 0).all()


def test_split_artifacts_load_both_ways(jax_split, clustered_data, tmp_path):
    """The port's split artifacts load in the JAX package leaf for leaf,
    and the JAX package's load in the port and serve its results."""
    _, queries = clustered_data
    sdb, tsdb, _ = jax_split
    base = str(tmp_path / "port")
    TS.save_split_database(base, TCFG, tsdb)
    back = JS.load_split_database(base, CFG)
    for name in ("dense", "sparse"):
        np.testing.assert_array_equal(
            np.asarray(getattr(back, name + "_ids")),
            np.asarray(getattr(sdb, name + "_ids")))
        np.testing.assert_array_equal(
            np.asarray(getattr(back, name + "_tree").cb2),
            np.asarray(getattr(sdb, name + "_tree").cb2))
        for leaf in ("prefix", "counts", "payload", "pair_occ", "vectors"):
            np.testing.assert_array_equal(
                np.asarray(getattr(getattr(back, name + "_db"), leaf)),
                np.asarray(getattr(getattr(sdb, name + "_db"), leaf)))
    jbase = str(tmp_path / "jax")
    JS.save_split_database(jbase, CFG, sdb)
    loaded = TS.load_split_database(jbase, TCFG, device="cpu")
    q = torch.from_numpy(queries)
    for exact in (False, True):
        a = TS.query_knn_split(TCFG, loaded, q, 10, exact)
        b = TS.query_knn_split(TCFG, tsdb, q, 10, exact)
        assert torch.equal(a.indices, b.indices)
        assert torch.equal(a.dists, b.dists)


def test_split_entry_points_refuse_missing_card(monkeypatch, clustered_data,
                                                tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    db_vecs, _ = clustered_data
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.train_tree_split(TCFG, db_vecs[:256])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.build_split_database(TCFG, db_vecs[:256])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.load_split_database(str(tmp_path / "none"), TCFG)
