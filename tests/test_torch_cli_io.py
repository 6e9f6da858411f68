"""The port's dataset IO, command-line tools and diagnostics against the JAX
package's, on the CPU.

  * xvecs and mem files: written byte-equal both ways, and each package
    reads the other's; `convert` streams the JAX package's bytes;
    `strip_xvecs` and `u8_to_f32` native, plain and the JAX package's agree,
    and a row whose header is not the file's dim is refused;
  * the `create_db` and `query` mains with `--device cpu` on
    tests/test_cli.py's fixture: the artifacts they write load in the JAX
    package, the JAX package's build over the port's tree equals the saved
    database up to near-ties (at most 0.1% of vectors, as in
    tests/test_torch_build.py), and the port's `query` over JAX-made
    artifacts prints the JAX `query`'s recall;
  * `query --sharded 4 --exact-rerank` over the JAX package's artifacts
    prints the JAX `query --sharded 4`'s recall, with the JAX package's
    sharded ids up to ties; `--refine --sharded` fails loudly; a spilled
    database is sharded from its sidecar memmaps, its bytes moved to the
    device shard by shard and never whole;
  * diagnostics: `ground_truth_bins` and `gt_bin_probe_positions` equal to
    the bit, `quantization_stats` within float32 rounding.
"""

import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

import pqt_tpu as P
from pqt_tpu.io import artifacts as JA
from pqt_tpu.io import native as JN
from pqt_tpu.io import texmex as JX
from pqt_tpu.models import tree as JT
from pqt_tpu.ops.distance import brute_force_knn
from pqt_tpu.parallel import sharded as JS
from pqt_tpu.tools import create_db as j_create_db
from pqt_tpu.tools import query as j_query
from pqt_tpu.utils import diagnostics as JD
import pqt_tpu_torch as T
from pqt_tpu_torch.io import artifacts as TA
from pqt_tpu_torch.io import native as TN
from pqt_tpu_torch.models import db as TDB
from pqt_tpu_torch.io import texmex as TX
from pqt_tpu_torch.tools import convert, create_db, query
from pqt_tpu_torch.utils import diagnostics as TD

COMMON = ["--p", "4", "--c1", "8", "--c2", "4", "--lineparts", "8",
          "--hashsize", str(1 << 14)]
QUERY_ARGS = ["--dim", "32", "--k", "10", "--k1", "4", "--maxbins", "256",
              "--candidates", "1024", "--batch", "64"] + COMMON
CLI_CFG = P.PQTConfig(dim=32, p=4, c1=8, c2=4, line_parts=8,
                      hash_size=1 << 14, kmeans_iters=8, k1_build=8,
                      k1_query=8)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """tests/test_cli.py's fixture: 4096 clustered float32 vectors, 64
    queries and their exact top-10 as .fvecs / .ivecs."""
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(7)
    dim, n = 32, 4096
    centers = rng.normal(0, 1.0, (32, dim)).astype(np.float32)
    base = (centers[rng.integers(0, 32, n)] +
            rng.normal(0, 0.4, (n, dim))).astype(np.float32)
    queries = (centers[rng.integers(0, 32, 64)] +
               rng.normal(0, 0.4, (64, dim))).astype(np.float32)
    d2 = ((queries ** 2).sum(1)[:, None] + (base ** 2).sum(1)[None, :]
          - 2.0 * queries @ base.T)
    gt = np.argsort(d2, axis=1)[:, :10].astype(np.int32)
    TX.write_xvecs(str(d / "base.fvecs"), base)
    TX.write_xvecs(str(d / "query.fvecs"), queries)
    TX.write_xvecs(str(d / "gt.ivecs"), gt)
    return d, base, queries, gt


def _data(ext, rng):
    if ext in (".bvecs", ".umem"):
        return rng.integers(0, 256, (300, 12)).astype(np.uint8)
    if ext in (".ivecs", ".imem"):
        return rng.integers(-2 ** 31, 2 ** 31 - 1, (300, 7)).astype(np.int32)
    return rng.normal(size=(300, 16)).astype(np.float32)


@pytest.mark.parametrize("ext", [".fvecs", ".ivecs", ".bvecs", ".fmem",
                                 ".imem", ".umem"])
def test_files_are_byte_equal_both_ways(tmp_path, ext):
    data = _data(ext, np.random.default_rng(3))
    ours, theirs = str(tmp_path / f"t{ext}"), str(tmp_path / f"j{ext}")
    is_vecs = ext.endswith("vecs")
    (TX.write_xvecs if is_vecs else TX.write_mem)(ours, data)
    (JX.write_xvecs if is_vecs else JX.write_mem)(theirs, data)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    header = TX.xvecs_header if is_vecs else TX.mem_header
    assert header(theirs) == data.shape
    for count, offset in ((-1, 0), (40, 250), (1000, 17)):
        got = TX.read_dataset(theirs, count, offset)
        want = (JX.read_xvecs if is_vecs else JX.read_mem)(ours, count,
                                                           offset)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src_ext,dst_ext", [(".fvecs", ".fmem"),
                                             (".bvecs", ".umem"),
                                             (".ivecs", ".imem")])
def test_convert_matches_jax(tmp_path, capsys, src_ext, dst_ext):
    data = _data(src_ext, np.random.default_rng(4))
    src = str(tmp_path / f"src{src_ext}")
    JX.write_xvecs(src, data)
    ours, theirs = str(tmp_path / f"t{dst_ext}"), str(tmp_path / f"j{dst_ext}")
    convert.main(["--src", src, "--dst", ours, "--chunk", "70", "--verify"])
    out = capsys.readouterr().out
    assert f"converted 300 vectors of dim {data.shape[1]}" in out
    assert "verified OK" in out
    assert JX.convert_xvecs_to_mem(src, theirs, 128) == data.shape
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


def _xvecs_bytes(data):
    n, dim = data.shape
    return np.concatenate(
        [np.full((n, 1), dim, np.int32).view(np.uint8).reshape(n, 4),
         data.view(np.uint8).reshape(n, -1)], axis=1).ravel()


@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.int32])
def test_strip_xvecs_native_plain_and_jax_agree(dtype):
    assert TN.get_lib() is not None, TN.load_error()
    data = _data({np.uint8: ".bvecs", np.float32: ".fvecs",
                  np.int32: ".ivecs"}[dtype], np.random.default_rng(5))
    n, dim = data.shape
    raw = _xvecs_bytes(data)
    for got in (TN.strip_xvecs(raw, n, dim, dtype),
                TN.strip_xvecs_plain(raw, n, dim, dtype),
                JN.strip_xvecs(raw, n, dim, dtype)):
        assert got.dtype == dtype
        np.testing.assert_array_equal(got, data)
    bad = raw.copy()
    bad[(4 + dim * data.itemsize) * 7] += 1        # row 7's header
    for fn in (TN.strip_xvecs, TN.strip_xvecs_plain):
        with pytest.raises(ValueError, match="header"):
            fn(bad, n, dim, dtype)


def test_u8_to_f32_native_plain_and_jax_agree():
    data = np.random.default_rng(6).integers(0, 256, (333, 17)).astype(
        np.uint8)
    want = np.asarray(JN.u8_to_f32(data))
    for got in (TN.u8_to_f32(data), TN.u8_to_f32_plain(data)):
        assert got.dtype == np.float32 and got.shape == data.shape
        np.testing.assert_array_equal(got, want)


def test_read_xvecs_refuses_a_bad_header(tmp_path):
    data = np.arange(40, dtype=np.float32).reshape(10, 4)
    path = str(tmp_path / "bad.fvecs")
    TX.write_xvecs(path, data)
    with open(path, "r+b") as f:
        f.seek(3 * 20)                            # row 3's header
        f.write(np.int32(5).tobytes())
    with pytest.raises(ValueError, match="header"):
        TX.read_xvecs(path)
    np.testing.assert_array_equal(TX.read_xvecs(path, 3), data[:3])


def _recall(out):
    m = re.search(r"recall: (\{.*\})", out)
    assert m, out
    return m.group(1)


def _bins_by_id(db):
    """Each vector's bin, by id, from a database's CSR."""
    counts = np.asarray(db.counts)
    bins = np.repeat(np.arange(counts.shape[0]), counts)
    return bins[np.argsort(np.asarray(db.payload)[:, 0])]


def test_create_db_and_query_mains(dataset, capsys):
    """create_db (full, in RAM) and query (exact) on the CPU; the saved
    artifacts load in the JAX package and equal its build over the saved
    tree up to near-ties."""
    d, base, _, _ = dataset
    create_db.main(["--dataset", str(d / "base.fvecs"),
                    "--basename", str(d / "port"), "--chunksize", "1500",
                    "--train-size", "4096", "--kmeans-iters", "8",
                    "--keep-vectors", "--device", "cpu"] + COMMON)
    out = capsys.readouterr().out
    assert "built database of 4096 vectors" in out and "saved" in out
    stem = str(d / "port") + "_32_4_8_4"
    jtree = JA.load_tree(stem + ".tree.npz", CLI_CFG)
    jdb = JA.load_database(stem + ".db.npz", CLI_CFG)
    ref = P.build_database(CLI_CFG, jtree, base, keep_vectors=True)
    np.testing.assert_array_equal(np.asarray(jdb.vectors), base)
    same = _bins_by_id(jdb) == _bins_by_id(ref)
    assert (~same).sum() <= max(1, base.shape[0] // 1000)
    if same.all():
        np.testing.assert_array_equal(np.asarray(jdb.counts),
                                      np.asarray(ref.counts))
        np.testing.assert_array_equal(np.asarray(jdb.payload)[:, 0],
                                      np.asarray(ref.payload)[:, 0])

    query.main(["--basename", str(d / "port"),
                "--queries", str(d / "query.fvecs"),
                "--groundtruth", str(d / "gt.ivecs"), "--exact-rerank",
                "--device", "cpu"] + QUERY_ARGS)
    out = capsys.readouterr().out
    assert "database: 4096 vectors" in out and "QPS" in out
    assert float(re.search(r"'R@1': ([0-9.]+)", out).group(1)) >= 0.9, out
    # a second run loads the tree instead of training it again
    create_db.main(["--dataset", str(d / "base.fvecs"),
                    "--basename", str(d / "port"), "--chunksize", "4096",
                    "--device", "cpu"] + COMMON)
    assert "loading tree from" in capsys.readouterr().out


def _jax_artifacts(d):
    """The JAX package's create_db output over the fixture (made once)."""
    if not (d / "jax_32_4_8_4.db.npz").exists():
        j_create_db.main(["--dataset", str(d / "base.fvecs"),
                          "--basename", str(d / "jax"), "--chunksize",
                          "1500", "--train-size", "4096", "--kmeans-iters",
                          "8", "--keep-vectors"] + COMMON)


@pytest.mark.parametrize("mode", ["exact", "line"])
def test_query_main_over_jax_artifacts_prints_jax_recall(dataset, capsys,
                                                         mode):
    d, *_ = dataset
    _jax_artifacts(d)
    args = ["--basename", str(d / "jax"), "--queries", str(d / "query.fvecs"),
            "--groundtruth", str(d / "gt.ivecs")] + QUERY_ARGS + (
        ["--exact-rerank"] if mode == "exact" else [])
    capsys.readouterr()
    j_query.main(args)
    want = _recall(capsys.readouterr().out)
    query.main(args + ["--device", "cpu"])
    assert _recall(capsys.readouterr().out) == want


def test_sharded_query_main_matches_jax(dataset, capsys):
    """--sharded 4 --exact-rerank on the CPU: the JAX tool's printed recall,
    and the JAX package's sharded ids (the JAX tool's own code path) up to
    ties."""
    d, _, queries, _ = dataset
    _jax_artifacts(d)
    args = ["--basename", str(d / "jax"), "--queries", str(d / "query.fvecs"),
            "--groundtruth", str(d / "gt.ivecs"), "--exact-rerank",
            "--sharded", "4"] + QUERY_ARGS
    capsys.readouterr()
    j_query.main(args)
    want = _recall(capsys.readouterr().out)
    query.main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "database: 4096 vectors" in out
    assert _recall(out) == want

    cfg = P.PQTConfig(dim=32, p=4, c1=8, c2=4, line_parts=8,
                      hash_size=1 << 14, k1_query=4, k1_build=8,
                      max_bins=256, max_candidates=1024)
    stem = str(d / "jax") + "_32_4_8_4"
    mesh = Mesh(np.array(jax.devices()[:4]), ("db",))
    sdb = JS.place_sharded_db(JS.shard_database(
        cfg, JA.load_database(stem + ".db.npz", cfg), 4), mesh)
    ref = JS.make_sharded_query_fn(cfg, mesh, 10, mode="exact")(
        JA.load_tree(stem + ".tree.npz", cfg), sdb, jnp.asarray(queries))
    _, run = query.load_runner(query.parse_args(args + ["--device", "cpu"]),
                               torch.device("cpu"))
    got = run(torch.from_numpy(queries)).numpy()
    want_d, want_i = np.asarray(ref.dists), np.asarray(ref.indices)
    for b, s in zip(*np.nonzero(got != want_i)):
        assert np.isclose(want_d[b], want_d[b, s], rtol=1e-5).sum() > 1


def test_query_refine_sharded_conflict_errors(dataset):
    d, *_ = dataset
    with pytest.raises(SystemExit, match="refine"):
        query.main(["--basename", str(d / "port"), "--queries",
                    str(d / "query.fvecs"), "--refine", "--sharded", "2",
                    "--device", "cpu"] + QUERY_ARGS)


def test_sharded_spilled_database_from_memmaps(dataset, capsys):
    """A spilled database (payload and CSR-ordered vectors in sidecars) is
    loaded on the host as memmaps and sharded from them: the bytes moved to
    the device are exactly the shards' and the pair table's, so no
    whole-database tensor is ever made; exact recall as unsharded."""
    d, *_ = dataset
    create_db.main(["--dataset", str(d / "base.fvecs"), "--basename",
                    str(d / "shd"), "--chunksize", "1500", "--train-size",
                    "4096", "--kmeans-iters", "8", "--keep-vectors",
                    "--spill", str(d / "shd_spill"), "--device", "cpu"]
                   + COMMON)
    capsys.readouterr()
    tcfg = T.PQTConfig.from_json(CLI_CFG.to_json())
    stem = str(d / "shd") + "_32_4_8_4.db.npz"
    host = TA.load_database_host(stem, tcfg)
    assert isinstance(host.payload, np.memmap)
    assert isinstance(host.vectors_csr, np.memmap) and host.vectors is None
    from pqt_tpu_torch.parallel.sharded import shard_database
    shards = shard_database(tcfg, host, 4)
    want = sum(getattr(shards, f).nbytes for f in
               ("prefix", "counts", "prefix2", "payload", "vectors"))
    want += 0 if host.pair_occ is None else host.pair_occ.nbytes
    args = ["--basename", str(d / "shd"), "--queries",
            str(d / "query.fvecs"), "--groundtruth", str(d / "gt.ivecs"),
            "--exact-rerank", "--device", "cpu"] + QUERY_ARGS
    before = TDB.to_device.bytes_copied
    query.load_runner(query.parse_args(args + ["--sharded", "4"]),
                      torch.device("cpu"))
    assert TDB.to_device.bytes_copied - before == want
    recall = {}
    for extra in ([], ["--sharded", "4"]):
        query.main(args + extra)
        recall[len(extra)] = float(re.search(
            r"'R@1': ([0-9.]+)", capsys.readouterr().out).group(1))
    assert recall[2] >= recall[0] - 1e-9 and recall[2] >= 0.9, recall


def test_encode_merge_and_spill_modes(dataset, capsys):
    """--mode encode (a chunk file per worker) and --mode merge (host-only
    CSR assembly with raw sidecars), and the spilled full build; both serve
    --refine from their sidecars."""
    d, *_ = dataset
    args = ["--dataset", str(d / "base.fvecs"), "--basename", str(d / "wrk"),
            "--chunksize", "1500", "--train-size", "4096", "--kmeans-iters",
            "8", "--keep-vectors", "--device", "cpu"] + COMMON
    for i in range(3):                 # 4096 rows / 1500 -> 3 chunks
        create_db.main(args + ["--mode", "encode", "--chunk-id", str(i)])
    assert capsys.readouterr().out.count("encoded chunk") == 3
    with pytest.raises(SystemExit, match="chunk-id"):
        create_db.main(args + ["--mode", "encode", "--chunk-id", "3"])
    create_db.main(args + ["--mode", "merge"])
    assert "merged 3 chunks / 4096 vectors" in capsys.readouterr().out
    assert (d / "wrk_32_4_8_4.db.npz.payload.bin").exists()
    spill_args = [a if a != str(d / "wrk") else str(d / "ooc") for a in args]
    create_db.main(spill_args + ["--spill", str(d / "ooc_spill")])
    assert "built database of 4096 vectors" in capsys.readouterr().out
    assert (d / "ooc_32_4_8_4.db.npz.vectors_csr.bin").exists()
    assert not list(d.glob("ooc_spill.chunk*.npz"))
    for name in ("wrk", "ooc"):
        query.main(["--basename", str(d / name), "--queries",
                    str(d / "query.fvecs"), "--groundtruth",
                    str(d / "gt.ivecs"), "--refine", "--device", "cpu"]
                   + QUERY_ARGS)
        out = capsys.readouterr().out
        assert float(re.search(r"'R@1': ([0-9.]+)", out).group(1)) >= 0.85


def test_mains_refuse_missing_card(dataset, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d, *_ = dataset
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_db.main(["--dataset", str(d / "base.fvecs"), "--basename",
                        str(d / "nocard")] + COMMON)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        query.main(["--basename", str(d / "port"), "--queries",
                    str(d / "query.fvecs")] + QUERY_ARGS)


DIAG_CFG = P.PQTConfig(
    dim=32, p=4, c1=4, c2=4, line_parts=8, hash_size=1 << 16,
    k1_build=4, k1_query=4, max_bins=256, max_candidates=1024,
    max_vec_per_bin=256, kmeans_iters=10, pair_top_m=64)


@pytest.fixture(scope="module")
def diag(clustered_data):
    """One tree in both packages (trained by the port: the JAX package's
    training would add its compile to tests of no training) and the
    queries' exact nearest vectors."""
    db_vecs, queries = clustered_data
    ttree = T.train_tree(T.PQTConfig.from_json(DIAG_CFG.to_json()), db_vecs,
                         device="cpu")
    tree = JT.PQTree.from_codebooks(DIAG_CFG, jnp.asarray(ttree.cb1.numpy()),
                                    jnp.asarray(ttree.cb2.numpy()))
    _, gt = brute_force_knn(jnp.asarray(queries), jnp.asarray(db_vecs), 1)
    return tree, db_vecs[np.asarray(gt)[:, 0]]


def _port(cfg, tree):
    tcfg = T.PQTConfig.from_json(cfg.to_json())
    return tcfg, T.PQTree.from_numpy(tcfg, np.asarray(tree.cb1),
                                     np.asarray(tree.cb2), device="cpu")


def test_ground_truth_bins_and_cache(diag, tmp_path):
    tree, gt_vecs = diag
    tcfg, ttree = _port(DIAG_CFG, tree)
    want = JD.ground_truth_bins(DIAG_CFG, tree, gt_vecs)
    path = str(tmp_path / "gt.npy")
    got = TD.ground_truth_bins(tcfg, ttree, gt_vecs, path)
    np.testing.assert_array_equal(got, want)
    # the cache is read back (even past a changed tree) while its rows fit
    np.testing.assert_array_equal(
        TD.ground_truth_bins(tcfg, None, gt_vecs, path), want)


@pytest.mark.parametrize("pipeline", ["pair", "parts"])
def test_gt_bin_probe_positions_are_bit_equal(diag, clustered_data,
                                              pipeline):
    _, queries = clustered_data
    tree, gt_vecs = diag
    cfg = DIAG_CFG.replace(pipeline=pipeline)
    tcfg, ttree = _port(cfg, tree)
    gt_bins = JD.ground_truth_bins(cfg, tree, gt_vecs)
    want = JD.gt_bin_probe_positions(cfg, tree, queries, gt_bins)
    got = TD.gt_bin_probe_positions(tcfg, ttree, queries, gt_bins)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).mean() > 0.8


def test_quantization_stats_agree(diag, clustered_data):
    db_vecs, _ = clustered_data
    tree, _ = diag
    tcfg, ttree = _port(DIAG_CFG, tree)
    want = JD.quantization_stats(DIAG_CFG, tree, db_vecs[:256])
    got = TD.quantization_stats(tcfg, ttree, db_vecs[:256])
    assert got.keys() == want.keys() and got["n_sample"] == 256
    for key, v in want.items():
        np.testing.assert_allclose(got[key], v, rtol=1e-5, atol=1e-6,
                                   err_msg=key)
