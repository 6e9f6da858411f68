"""The port's BIG two-stage query (models/query_big.py) and the anisotropic
traversal family (ops/distseq.py) against the JAX package's.

Config: tests/test_query_big.py's (dim 32, p 4, c1 8, c2 4, lp 8, hash
2^16), and the same with hashed bin ids (hash 2^10).  The JAX package
trains the tree and builds the database, and the port loads both
(`_carry_across`).  Given the same sorted part lists, the stage-1 pair
codes, the stage-2 bins and counts (with and without a shard's bin_offset),
candidate positions and ids are equal to the bit; distances agree within
1e-5 relative, and result ids may differ only inside a run of equal
distances.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pqt_tpu as P
from pqt_tpu.models import query as JQ
from pqt_tpu.models import query_big as JB
from pqt_tpu.ops import binning as JBIN
from pqt_tpu.ops import distseq as JD
from pqt_tpu.ops.distance import brute_force_knn
from pqt_tpu.utils.metrics import recall_at
import pqt_tpu_torch as T
from pqt_tpu_torch.models import query as TQ
from pqt_tpu_torch.models import query_big as TB
from pqt_tpu_torch.ops import binning as TBIN
from pqt_tpu_torch.ops import distseq as TD
from test_torch_query import _assert_same_results, _carry_across

BIG_CFG = P.PQTConfig(
    dim=32, p=4, c1=8, c2=4, line_parts=8, hash_size=1 << 16,
    k1_build=4, k1_query=4, max_bins=256, bin_enum_factor=4,
    max_candidates=1024, max_vec_per_bin=256, kmeans_iters=10)
CONFIGS = {"exact": BIG_CFG, "hashed": BIG_CFG.replace(hash_size=1 << 10)}
# a shard of the occupancy table: global slots [OFFSET, OFFSET + SPAN)
OFFSET, SPAN = 300, 700


@pytest.fixture(scope="module")
def built(clustered_data, tmp_path_factory):
    """{name: (jax cfg, tree, db, port cfg, tree, db)}, db vectors,
    queries; one JAX-trained tree."""
    db_vecs, queries = clustered_data
    tree = P.train_tree(BIG_CFG, db_vecs)
    out = {}
    for name, cfg in CONFIGS.items():
        db = P.build_database(cfg, tree, db_vecs, keep_vectors=True,
                              encode_chunk=2048)
        out[name] = (cfg, tree, db) + _carry_across(
            tmp_path_factory.mktemp(name), cfg, tree, db)
    return out, db_vecs, queries


def _lists(setting, queries):
    cfg, tree, _, tcfg, ttree, _ = setting
    sd2, scodes = JQ._sorted_part_lists(cfg, tree, jnp.asarray(queries))
    tsd2, tscodes = TQ._sorted_part_lists(tcfg, ttree,
                                          torch.from_numpy(queries))
    np.testing.assert_array_equal(tscodes.numpy(), np.asarray(scodes))
    np.testing.assert_allclose(tsd2.numpy(), np.asarray(sd2), rtol=1e-5)
    return (sd2, scodes), (tsd2, tscodes)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("n_int", [16, 64])
def test_pair_merge_equal(built, name, n_int):
    sets, _, queries = built
    (sd2, scodes), (tsd2, tscodes) = _lists(sets[name], queries)
    d, codes = JB._pair_merge(sets[name][0], sd2, scodes, n_int)
    td, tcodes = TB._pair_merge(sets[name][3], tsd2, tscodes, n_int)
    assert tcodes.shape == (queries.shape[0], 2, n_int, 2)
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(codes))
    np.testing.assert_allclose(td.numpy(), np.asarray(d), rtol=1e-5)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("offset", [None, OFFSET])
def test_final_bins_and_candidates_equal(built, name, offset):
    """Stage 2 over the whole table, or over one shard of it: bins,
    counts, then the candidate positions and ids of query_big_core."""
    sets, _, queries = built
    cfg, tree, db, tcfg, ttree, tdb = sets[name]
    (sd2, scodes), (tsd2, tscodes) = _lists(sets[name], queries)
    d, codes = JB._pair_merge(cfg, sd2, scodes, 64)
    td, tcodes = TB._pair_merge(tcfg, tsd2, tscodes, 64)
    lo, hi = (0, cfg.hash_size) if offset is None else (offset,
                                                          offset + SPAN)
    counts, prefix = db.counts[lo:hi], db.prefix[lo:hi]
    tcounts = tdb.counts[lo:hi].contiguous()
    tprefix = tdb.prefix[lo:hi].contiguous()
    bins, cnt = JB._final_bins(cfg, d, codes, counts, offset)
    tbins, tcnt = TB._final_bins(tcfg, td, tcodes, tcounts, offset)
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(cnt))
    np.testing.assert_array_equal(tbins.numpy(), np.asarray(bins))
    assert (np.asarray(cnt) > 0).any()
    pos, valid = JBIN.gather_candidates(prefix[bins], cnt,
                                        cfg.max_candidates,
                                        cfg.max_vec_per_bin)
    tpos, tvalid = TBIN.gather_candidates(
        tprefix[tbins.long()], tcnt, tcfg.max_candidates,
        tcfg.max_vec_per_bin)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(valid))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(pos))
    ids = np.asarray(db.payload)[np.where(valid, pos, 0), 0]
    tids = tdb.payload[torch.where(tvalid, tpos, 0).long(), 0]
    np.testing.assert_array_equal(tids.numpy(), ids)
    want = JB.query_big_core(cfg, tree, prefix, counts, db.payload,
                             jnp.asarray(queries), 10, 64, offset)
    got = TB.query_big_core(tcfg, ttree, tprefix, tcounts, tdb.payload,
                            torch.from_numpy(queries), 10, 64, offset)
    _assert_same_results(JQ.QueryResult(*want), T.QueryResult(*got))


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("mode", ["line", "perfect"])
def test_big_knn_equal(built, name, mode):
    sets, db_vecs, queries = built
    cfg, tree, db, tcfg, ttree, tdb = sets[name]
    q, tq = jnp.asarray(queries), torch.from_numpy(queries)
    if mode == "line":
        want = JB.query_big_knn(cfg, tree, db, q, 10, 64)
        got = T.query_big_knn(tcfg, ttree, tdb, tq, 10, 64)
    else:
        want = JB.query_big_knn_perfect(cfg, tree, db, q, 10, 16, 64)
        got = T.query_big_knn_perfect(tcfg, ttree, tdb, tq, 10, 16, 64)
    assert got.indices.dtype == torch.int32
    _assert_same_results(want, got)
    _, gt = brute_force_knn(q, jnp.asarray(db_vecs), 10)
    assert (recall_at(got.indices.numpy(), np.asarray(gt), (1, 10))
            == recall_at(np.asarray(want.indices), np.asarray(gt), (1, 10)))


def test_big_pads_k_past_the_budget(built):
    sets, _, queries = built
    cfg, tree, db, tcfg, ttree, tdb = sets["exact"]
    k = cfg.max_candidates + 3
    want = JB.query_big_knn(cfg, tree, db, jnp.asarray(queries[:4]), k, 64)
    got = T.query_big_knn(tcfg, ttree, tdb, torch.from_numpy(queries[:4]),
                          k, 64)
    assert got.indices.shape == (4, k)
    assert (got.indices[:, -3:] == -1).all()
    _assert_same_results(want, got)


def test_big_refuses_odd_parts_and_missing_vectors(built):
    sets, db_vecs, queries = built
    _, _, _, tcfg, ttree, tdb = sets["exact"]
    tq = torch.from_numpy(queries[:4])
    with pytest.raises(ValueError):
        T.query_big_knn_perfect(tcfg, ttree, tdb._replace(vectors=None), tq,
                                5)
    cfg3 = T.PQTConfig(dim=33, p=3, c1=8, c2=4, line_parts=3,
                       hash_size=1 << 12, k1_build=4, k1_query=4,
                       max_bins=64, max_candidates=256, max_vec_per_bin=64,
                       kmeans_iters=3)
    data = np.concatenate([db_vecs, db_vecs[:, :1]], axis=1)[:512]
    tree3 = T.train_tree(cfg3, data, device="cpu")
    db3 = T.build_database(cfg3, tree3, data, device="cpu")
    with pytest.raises(ValueError):
        T.query_big_knn(cfg3, tree3, db3, torch.from_numpy(data[:4]), 5, 16)


@pytest.mark.parametrize("base,length", [(4, 64), (16, 65536), (40, 1000)])
def test_aniso_2d_sequences_bit_equal(base, length):
    want = JD.aniso_2d_sequences(base, length)
    got = TD.aniso_2d_sequences(base, length)
    assert got.dtype == np.int32 and got.shape == (10, length, 2)
    np.testing.assert_array_equal(got, want)
    # x = i % base, y = i // base, the reverse of pair_sequence's roles: at
    # slope 1, (1, 0) and (0, 1) tie and i = 1 comes first
    assert got[5, 1].tolist() == [1, 0]


def test_slope_index_bit_equal():
    """numpy and torch inputs give the JAX package's indices, in float32,
    clipped at both ends; the rounding is half to even in all three."""
    rng = np.random.default_rng(5)
    dx = rng.uniform(0.0, 3.0, 4096).astype(np.float32)
    dy = rng.uniform(0.0, 3.0, 4096).astype(np.float32)
    dx[:4] = [0.0, 1.0, 1.0, 2.0]
    dy[:4] = [1.0, 0.0, 1.0, 3.0]
    want = np.asarray(JD.slope_index(dx, dy))
    got_np = TD.slope_index(dx, dy)
    got_t = TD.slope_index(torch.from_numpy(dx), torch.from_numpy(dy))
    assert got_np.dtype == np.int32 and got_t.dtype == torch.int32
    np.testing.assert_array_equal(got_np, want)
    np.testing.assert_array_equal(got_t.numpy(), want)
    assert want.min() == 0 and want.max() == 9
    half = np.array([0.5, 1.5, 2.5, -0.5], np.float32)
    np.testing.assert_array_equal(np.round(half), [0, 2, 2, 0])
    np.testing.assert_array_equal(torch.round(torch.from_numpy(half)),
                                  np.asarray(jnp.round(jnp.asarray(half))))
