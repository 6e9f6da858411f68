"""The port's sharded serving layer (pqt_tpu_torch/parallel/sharded.py)
against the JAX package's on conftest's virtual 8-device CPU mesh.

tests/test_parallel.py's config and fixture; the JAX package trains the
tree and builds the database, which the port loads (on the host for
sharding, `load_database_host`).

  * `shard_database` equals the JAX function's arrays to the bit, for 4
    and 8 shards, with raw vectors by id or already in CSR order; so does
    `build_local_shards` for a two-process split of the same bins;
  * the sharded query in line, exact and big mode on 4 and 8 shards and on
    a (4, 2) grid with the batch split: ids equal to the JAX package's
    wherever the distances are untied by more than 1e-6, distances within
    rtol = atol = 1e-5, n_candidates equal (tests/test_parallel.py:127-132);
    the split batch gives the unsplit result to the bit;
  * duplicate masking leaves unique ids; exact mode without raw vectors
    raises;
  * the data-parallel encode equals the port's one-device encode to the bit
    and the JAX package's up to near-ties; the data-parallel k-means step
    matches the one-device step, the JAX package's and a numpy oracle
    within 1e-4.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

import pqt_tpu as P
from pqt_tpu.io import artifacts as JA
from pqt_tpu.parallel import distributed as JD
from pqt_tpu.parallel import sharded as JS
import pqt_tpu_torch as T
from pqt_tpu_torch.io import artifacts as TA
from pqt_tpu_torch.models import db as TDB
from pqt_tpu_torch.parallel import distributed as TD
from pqt_tpu_torch.parallel import sharded as TS

CFG = P.PQTConfig(
    dim=32, p=4, c1=8, c2=4, line_parts=8, hash_size=1 << 16,
    k1_build=4, k1_query=4, max_bins=256, bin_enum_factor=4,
    max_candidates=1024, max_vec_per_bin=256, kmeans_iters=10)
TCFG = T.PQTConfig.from_json(CFG.to_json())
CPU = torch.device("cpu")
LEAVES = ("prefix", "counts", "prefix2", "payload", "n_per_shard",
          "pair_occ", "vectors")
# (db shards, batch slices)
MESHES = {"4": (4, 1), "8": (8, 1), "4x2": (4, 2)}


@pytest.fixture(scope="module")
def built(clustered_data, tmp_path_factory):
    """(JAX tree, JAX db with raw vectors, port tree, port host db, db
    vectors, queries)."""
    db_vecs, queries = clustered_data
    tree = P.train_tree(CFG, db_vecs)
    db = P.build_database(CFG, tree, db_vecs, encode_chunk=2048,
                          keep_vectors=True)
    d = tmp_path_factory.mktemp("sharded")
    JA.save_tree(str(d / "tree"), CFG, tree)
    JA.save_database(str(d / "db"), CFG, db)
    ttree = TA.load_tree(str(d / "tree"), TCFG, device="cpu")
    return (tree, db, ttree, TA.load_database_host(str(d / "db"), TCFG),
            db_vecs, queries)


def _csr_only(jdb, tdb):
    """Both databases with the raw vectors in CSR order only."""
    vec = np.asarray(jdb.vectors)[np.asarray(jdb.ids)]
    return (jdb._replace(vectors=None, vectors_csr=jnp.asarray(vec)),
            tdb._replace(vectors=None, vectors_csr=vec))


def _assert_leaves_equal(got, want):
    for name in LEAVES:
        g, w = getattr(got, name), getattr(want, name)
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == np.asarray(w).dtype, name
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)


@pytest.mark.parametrize("n_shards", [4, 8])
@pytest.mark.parametrize("vectors", ["by_id", "csr"])
def test_shard_database_equals_jax(built, n_shards, vectors):
    _, jdb, _, tdb, _, _ = built
    if vectors == "csr":
        jdb, tdb = _csr_only(jdb, tdb)
    got = TS.shard_database(TCFG, tdb, n_shards)
    want = JS.shard_database(CFG, jdb, n_shards)
    assert got.n_shards == want.n_shards == n_shards
    _assert_leaves_equal(got, want)


def test_shard_database_refuses_uneven_split_and_card_leaves(built):
    _, _, _, tdb, _, _ = built
    with pytest.raises(ValueError, match="divide"):
        TS.shard_database(TCFG, tdb, 3)
    with pytest.raises(TypeError, match="host leaves"):
        TS.shard_database(TCFG, tdb._replace(
            payload=torch.empty((4, 6), dtype=torch.int32, device="meta")),
            4)


def test_build_local_shards_equals_jax(built):
    """A two-process split of 4 shards: each process's slice of the global
    CSR (prefix rebased, its payload and CSR-ordered vectors) gives the
    JAX function's shards to the bit, and both halves together are
    shard_database's."""
    _, jdb, _, tdb, _, _ = built
    jdb, tdb = _csr_only(jdb, tdb)
    whole = TS.shard_database(TCFG, tdb, 4, pad_to_multiple=128)
    prefix, counts = tdb.prefix, tdb.counts
    n = tdb.payload.shape[0]
    for ids in ([0, 1], [2, 3]):
        lo, hi = TD.host_shard_range(TCFG, 4, ids)
        assert (lo, hi) == JD.host_shard_range(CFG, 4, ids)
        a, b = int(prefix[lo]), int(prefix[hi]) if hi < len(prefix) else n
        args = (prefix[lo:hi] - a, counts[lo:hi], tdb.payload[a:b])
        got = TD.build_local_shards(TCFG, 4, ids, *args,
                                    vectors_csr=tdb.vectors_csr[a:b],
                                    pad_to_multiple=128)
        want = JD.build_local_shards(CFG, 4, ids, *args,
                                     vectors_csr=tdb.vectors_csr[a:b],
                                     pad_to_multiple=128)
        _assert_leaves_equal(got, want)
        for name in ("prefix", "counts", "prefix2", "n_per_shard"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(whole, name)[ids])
        for i, s in enumerate(ids):
            m = got.n_per_shard[i]
            np.testing.assert_array_equal(got.payload[i, :m],
                                          whole.payload[s, :m])
    with pytest.raises(ValueError, match="need"):
        TD.build_local_shards(TCFG, 4, [0, 1], prefix[:100], counts[:100],
                              tdb.payload[:10])


def _jax_sharded(cfg, jdb, mesh_name, mode, k=10, n_int=64):
    n_db, n_q = MESHES[mesh_name]
    devs = np.array(jax.devices()[:n_db * n_q])
    if n_q == 1:
        mesh, batch_axis = Mesh(devs, ("db",)), None
    else:
        mesh, batch_axis = Mesh(devs.reshape(n_db, n_q), ("db", "q")), "q"
    sdb = JS.place_sharded_db(JS.shard_database(cfg, jdb, n_db), mesh)
    fn = JS.make_sharded_query_fn(cfg, mesh, k=k, batch_axis=batch_axis,
                                  mode=mode, n_intermediate=n_int)
    return fn, sdb


def _port_sharded(tcfg, tdb, mesh_name, mode, k=10, n_int=64):
    n_db, n_q = MESHES[mesh_name]
    devices = [CPU] * (n_db * n_q)
    sdb = TS.place_sharded_db(TS.shard_database(tcfg, tdb, n_db), devices)
    fn = TS.make_sharded_query_fn(tcfg, devices, k, mode=mode,
                                  n_intermediate=n_int, batch_split=n_q)
    return fn, sdb


def _assert_matches(want, got):
    """tests/test_parallel.py:127-132's rule, and n_candidates equal."""
    got_d, want_d = got.dists.numpy(), np.asarray(want.dists)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=1e-5)
    got_i, want_i = got.indices.numpy(), np.asarray(want.indices)
    untied = np.ones_like(want_d, bool)
    untied[:, :-1] &= np.diff(want_d, axis=1) > 1e-6
    untied[:, 1:] &= np.diff(want_d, axis=1) > 1e-6
    np.testing.assert_array_equal(got_i[untied], want_i[untied])
    np.testing.assert_array_equal(got.n_candidates.numpy(),
                                  np.asarray(want.n_candidates))
    assert got.indices.dtype == torch.int32


def _serve_both(built, cfg, mesh_name, mode):
    tree, jdb, ttree, tdb, _, queries = built
    jfn, jsdb = _jax_sharded(cfg, jdb, mesh_name, mode)
    want = jfn(tree, jsdb, jnp.asarray(queries))
    fn, sdb = _port_sharded(T.PQTConfig.from_json(cfg.to_json()), tdb,
                            mesh_name, mode)
    return want, fn(ttree, sdb, torch.from_numpy(queries))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("mode", ["line", "exact", "big"])
def test_sharded_query_matches_jax(built, mesh_name, mode):
    want, got = _serve_both(built, CFG, mesh_name, mode)
    assert got.indices.shape == (built[5].shape[0], 10)
    _assert_matches(want, got)


@pytest.mark.parametrize("mode", ["line", "exact", "big"])
def test_batch_split_equals_unsplit_to_the_bit(built, mode):
    _, _, ttree, tdb, _, queries = built
    q = torch.from_numpy(queries)
    fn, sdb = _port_sharded(TCFG, tdb, "4", mode)
    fn2, sdb2 = _port_sharded(TCFG, tdb, "4x2", mode)
    a, b = fn(ttree, sdb, q), fn2(ttree, sdb2, q)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_sharded_dedup_unique_results(built):
    """With dedup_candidates=True the merged ids are unique in each row
    (and still the JAX package's)."""
    cfg = CFG.replace(dedup_candidates=True)
    want, got = _serve_both(built, cfg, "4", "line")
    _assert_matches(want, got)
    for row in got.indices.numpy():
        real = row[row >= 0]
        assert len(real) == len(np.unique(real))


def test_sharded_exact_requires_vectors(built):
    _, _, ttree, tdb, _, queries = built
    bare = tdb._replace(vectors=None, vectors_csr=None)
    fn, sdb = _port_sharded(TCFG, bare, "4", "exact")
    with pytest.raises(ValueError, match="keep_vectors"):
        fn(ttree, sdb, torch.from_numpy(queries))


def test_sharded_query_checks_its_grid(built):
    _, _, ttree, tdb, _, queries = built
    fn, sdb = _port_sharded(TCFG, tdb, "4", "line")
    with pytest.raises(ValueError, match="cells"):
        fn(ttree, sdb._replace(prefix=sdb.prefix[:2]),
           torch.from_numpy(queries))
    fn2, _ = _port_sharded(TCFG, tdb, "4x2", "line")
    with pytest.raises(ValueError, match="cells"):
        fn2(ttree, sdb, torch.from_numpy(queries))
    with pytest.raises(ValueError, match="mode"):
        TS.make_sharded_query_fn(TCFG, [CPU] * 4, 10, mode="nope")
    with pytest.raises(ValueError, match="grid"):
        TS.place_sharded_db(TS.shard_database(TCFG, tdb, 4), [CPU] * 6)


def test_place_sharded_db_shares_a_shard_on_one_device(built):
    """A (4, 2) grid on one device holds each shard once, and pair_occ
    once; replicate() copies nothing that already lies on its device."""
    _, _, ttree, tdb, _, _ = built
    sdb = TS.place_sharded_db(TS.shard_database(TCFG, tdb, 4), [CPU] * 8)
    assert len(sdb.payload) == 8 and sdb.n_shards == 4
    for s in range(4):
        assert sdb.payload[2 * s] is sdb.payload[2 * s + 1]
    assert sdb.pair_occ is None or all(o is sdb.pair_occ[0]
                                       for o in sdb.pair_occ)
    assert TD.replicate([CPU, CPU], ttree)[CPU] is ttree


def test_dp_encode_matches_single_and_jax(built):
    tree, _, ttree, _, db_vecs, _ = built
    data = db_vecs[:1024]
    enc = TS.make_dp_encode_fn(TCFG, [CPU] * 8, encode_chunk=96)
    bins, codes, t3 = enc(ttree, data)
    x = torch.from_numpy(data)
    want_codes, want_t3 = TDB.encode_line_codes(TCFG, ttree, x)
    assert torch.equal(bins, TDB.encode_bins(TCFG, ttree, x))
    assert torch.equal(codes, want_codes)
    np.testing.assert_allclose(t3.numpy(), want_t3.numpy(), rtol=1e-5,
                               atol=1e-5)
    # the JAX package's data-parallel encode, up to argmin near-ties
    mesh = Mesh(np.array(jax.devices()[:8]), ("dp",))
    jb, jc, jt = JS.make_dp_encode_fn(CFG, mesh)(tree, jnp.asarray(data))
    same = ((bins.numpy() == np.asarray(jb)) &
            (codes.numpy().astype(np.uint32) == np.asarray(jc)).all(1))
    assert (~same).sum() <= max(1, data.shape[0] // 1000)
    np.testing.assert_allclose(t3.numpy()[same], np.asarray(jt)[same],
                               rtol=1e-4, atol=1e-6 * np.abs(jt).max())


def test_dp_kmeans_step_matches(built, rng):
    _, _, _, _, db_vecs, _ = built
    data = db_vecs[:2048]
    cents = rng.normal(0, 1, (8, 32)).astype(np.float32)
    got = TS.make_dp_kmeans_step([CPU] * 8)(data, cents).numpy()
    one = TS.make_dp_kmeans_step([CPU])(data, cents).numpy()
    mesh = Mesh(np.array(jax.devices()[:8]), ("dp",))
    jax_got = np.asarray(JS.make_dp_kmeans_step(mesh)(jnp.asarray(data),
                                                      jnp.asarray(cents)))
    d = ((data[:, None, :].astype(np.float64) - cents[None]) ** 2).sum(-1)
    a = d.argmin(1)
    want = cents.copy()
    for c in range(8):
        if (a == c).any():
            want[c] = data[a == c].mean(0)
    for other in (one, jax_got, want):
        np.testing.assert_allclose(got, other, rtol=1e-4, atol=1e-4)
