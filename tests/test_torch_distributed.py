"""The port's multi-process serving runtime (pqt_tpu_torch/parallel/
distributed.py) on the CPU, over gloo.

The harness plays the offline build: the JAX package trains the tree, the
port encodes the data into chunk files (`encode_chunk_to_file`), and the
single-process references are computed: the port's sharded exact query over
the merged database, and the JAX package's on 4 virtual devices.  Then this
file runs twice more as a script, two real OS processes joined by
`initialize` over gloo; each merges ONLY its hash range from the chunk
files (`merge_chunk_files_range`, fewer rows than the whole), builds its
two shards (`build_local_shards`), places them after exchanging the pad
budget (`place_host_sharded_db`), passes a `peer_barrier` and serves the
sharded exact query through the group.  Both processes' merged results must
equal the single-process port's to the bit, and so the JAX package's ids
up to ties.

Also the fault cases of tests/test_fault.py for the port, and that a
timeout poisons the runtime: every later collective raises at once.
"""

import os
import re
import socket
import subprocess
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SHARDS, PAD, K = 4, 128, 10
CHUNK_ROWS, N_DB, N_Q = 700, 2048, 16


def _cfgs():
    import pqt_tpu as P
    import pqt_tpu_torch as T
    cfg = P.PQTConfig(
        dim=32, p=4, c1=8, c2=4, line_parts=8, hash_size=1 << 12,
        k1_build=4, k1_query=4, max_bins=128, bin_enum_factor=4,
        max_candidates=512, max_vec_per_bin=128, kmeans_iters=6)
    return cfg, T.PQTConfig.from_json(cfg.to_json())


def _chunks(work):
    return sorted(os.path.join(work, f) for f in os.listdir(work)
                  if f.startswith("chunk") and f.endswith(".npz"))


def worker():
    """One process of the two-process serving chain (run as a script)."""
    import torch.distributed as dist
    from pqt_tpu_torch.io import artifacts
    from pqt_tpu_torch.models.db import merge_chunk_files_range
    from pqt_tpu_torch.parallel import distributed as D
    from pqt_tpu_torch.parallel.sharded import make_sharded_query_fn
    _, tcfg = _cfgs()
    work, rank = os.environ["DIST_DIR"], int(os.environ["PROC_ID"])
    dev = D.initialize(coordinator_address=os.environ["COORD"],
                       num_processes=2, process_id=rank, device="cpu",
                       initialization_timeout=60)
    mesh = D.global_device_mesh([dev, dev])
    my = D.local_shard_ids(mesh)
    assert len(mesh) == N_SHARDS and len(my) == 2, (mesh, my)
    lo, hi = D.host_shard_range(tcfg, N_SHARDS, my)
    prefix, counts, payload, vec_csr, pair_occ = merge_chunk_files_range(
        tcfg, _chunks(work), lo, hi, keep_vectors=True)
    local = D.build_local_shards(tcfg, N_SHARDS, my, prefix, counts,
                                 payload, vectors_csr=vec_csr,
                                 pad_to_multiple=PAD)
    sdb = D.place_host_sharded_db(tcfg, local, mesh, pair_occ=pair_occ)
    D.peer_barrier(timeout_s=60)
    tree = artifacts.load_tree(os.path.join(work, "tree"), tcfg, "cpu")
    queries = torch.from_numpy(np.load(os.path.join(work, "queries.npy")))
    fn = make_sharded_query_fn(tcfg, mesh, K, mode="exact",
                               group=dist.group.WORLD)
    res = fn(tree, sdb, queries)
    np.savez(os.path.join(work, f"rank{rank}.npz"),
             ids=res.indices.numpy(), dists=res.dists.numpy(),
             ncand=res.n_candidates.numpy())
    print(f"DIST_OK rank={rank} local_rows={payload.shape[0]} "
          f"local_budget={local.payload.shape[1]} "
          f"placed_budget={sdb.payload[0].shape[0]}", flush=True)
    dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _prepare(work):
    """Tree, chunk files, queries; the single-process port and JAX sharded
    exact results over the merged database."""
    import pqt_tpu as P
    from pqt_tpu.io import artifacts as JA
    from pqt_tpu.parallel import sharded as JS
    import pqt_tpu_torch as T
    from pqt_tpu_torch.parallel import sharded as TS
    cfg, tcfg = _cfgs()
    rng = np.random.default_rng(42)
    centers = rng.normal(0, 1.0, (32, cfg.dim)).astype(np.float32)
    db_vecs = (centers[rng.integers(0, 32, N_DB)] +
               rng.normal(0, 0.4, (N_DB, cfg.dim))).astype(np.float32)
    queries = (centers[rng.integers(0, 32, N_Q)] +
               rng.normal(0, 0.4, (N_Q, cfg.dim))).astype(np.float32)
    tree = P.train_tree(cfg, db_vecs)
    JA.save_tree(os.path.join(work, "tree"), cfg, tree)
    ttree = T.load_tree(os.path.join(work, "tree"), tcfg, device="cpu")
    for i, s in enumerate(range(0, N_DB, CHUNK_ROWS)):
        T.encode_chunk_to_file(tcfg, ttree, db_vecs[s:s + CHUNK_ROWS], s,
                               os.path.join(work, f"chunk{i}.npz"),
                               encode_chunk=512, keep_vectors=True,
                               device="cpu")
    np.save(os.path.join(work, "queries.npy"), queries)

    host = T.merge_chunk_files(tcfg, None, _chunks(work), keep_vectors=True,
                               spill_path=os.path.join(work, "spill"),
                               to_device=False)
    cpu = [torch.device("cpu")] * N_SHARDS
    sdb = TS.place_sharded_db(TS.shard_database(tcfg, host, N_SHARDS,
                                                pad_to_multiple=PAD), cpu)
    port = TS.make_sharded_query_fn(tcfg, cpu, K, mode="exact")(
        ttree, sdb, torch.from_numpy(queries))

    jdb = P.PQTDatabase(
        prefix=jnp.asarray(host.prefix), counts=jnp.asarray(host.counts),
        payload=jnp.asarray(np.asarray(host.payload)),
        pair_occ=jnp.asarray(host.pair_occ), vectors=None,
        vectors_csr=jnp.asarray(np.asarray(host.vectors_csr)))
    mesh = Mesh(np.array(jax.devices()[:N_SHARDS]), ("db",))
    jsdb = JS.place_sharded_db(JS.shard_database(cfg, jdb, N_SHARDS,
                                                 pad_to_multiple=PAD), mesh)
    want = JS.make_sharded_query_fn(cfg, mesh, k=K, mode="exact")(
        tree, jsdb, jnp.asarray(queries))
    return port, want, tcfg, ttree, sdb, queries, host


def _assert_ids_up_to_ties(want, got_ids, got_d):
    want_d, want_i = np.asarray(want.dists), np.asarray(want.indices)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=1e-5)
    untied = np.ones_like(want_d, bool)
    untied[:, :-1] &= np.diff(want_d, axis=1) > 1e-6
    untied[:, 1:] &= np.diff(want_d, axis=1) > 1e-6
    np.testing.assert_array_equal(got_ids[untied], want_i[untied])


def test_two_process_serving_equals_single_process(tmp_path):
    work = str(tmp_path)
    port, want, *_ = _prepare(work)
    _assert_ids_up_to_ties(want, port.indices.numpy(), port.dists.numpy())
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "MASTER_ADDR", "MASTER_PORT", "RANK",
                        "WORLD_SIZE", "LOCAL_RANK")}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO, OMP_NUM_THREADS="2",
               COORD=f"localhost:{_free_port()}", DIST_DIR=work)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__)],
        env=dict(env, PROC_ID=str(rank)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, cwd=REPO) for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    budgets = set()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
        m = re.search(r"DIST_OK rank=\d local_rows=(\d+) local_budget=\d+ "
                      r"placed_budget=(\d+)", out)
        assert m, f"rank {rank}:\n{out[-4000:]}"
        # each process merged only its own hash range
        assert int(m.group(1)) < N_DB, out
        budgets.add(int(m.group(2)))
        got = np.load(os.path.join(work, f"rank{rank}.npz"))
        np.testing.assert_array_equal(got["ids"], port.indices.numpy())
        np.testing.assert_array_equal(got["dists"], port.dists.numpy())
        np.testing.assert_array_equal(got["ncand"],
                                      port.n_candidates.numpy())
        _assert_ids_up_to_ties(want, got["ids"], got["dists"])
    assert len(budgets) == 1       # both padded to the exchanged budget


# ---------------------------------------------------------------------------
# fault cases (tests/test_fault.py:18-33) and the poisoned runtime
# ---------------------------------------------------------------------------

@pytest.fixture
def D(monkeypatch):
    """The runtime module, its poisoned state restored after the test."""
    from pqt_tpu_torch.parallel import distributed
    monkeypatch.setattr(distributed, "_poisoned", None)
    return distributed


def test_peer_timeout_raises_typed_error(D):
    with pytest.raises(D.PeerTimeoutError, match="did not complete"):
        D.run_with_peer_timeout(lambda: time.sleep(30), timeout_s=0.2,
                                what="test collective")


def test_peer_timeout_propagates_inner_error(D):
    def boom():
        raise ValueError("inner")
    with pytest.raises(ValueError, match="inner"):
        D.run_with_peer_timeout(boom, timeout_s=5)


def test_peer_timeout_returns_value(D):
    assert D.run_with_peer_timeout(lambda: 42, timeout_s=5) == 42


def test_initialize_needs_an_address_and_a_card(D, monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        D.initialize(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.initialize(coordinator_address="localhost:1", num_processes=1,
                     process_id=0)


def test_timeout_poisons_every_later_collective(D, tmp_path):
    """In a world of one gloo process the group path serves the single-
    process result to the bit; after one timeout, every collective of the
    runtime, the sharded query's and the k-means step's refuse at once."""
    import torch.distributed as dist
    from pqt_tpu_torch.parallel import sharded as S
    port, _, tcfg, tree, sdb, queries, host = _prepare(str(tmp_path))
    cpu = torch.device("cpu")
    mesh = [cpu] * N_SHARDS
    D.initialize(f"localhost:{_free_port()}", 1, 0, 60, device="cpu")
    try:
        group = dist.group.WORLD
        fn = S.make_sharded_query_fn(tcfg, mesh, K, mode="exact",
                                     group=group)
        res = fn(tree, sdb, torch.from_numpy(queries))
        for a, b in zip(res, port):
            assert torch.equal(a, b)
        D.peer_barrier(timeout_s=30)
        step = S.make_dp_kmeans_step(mesh, group=group)
        cents = np.zeros((4, tcfg.dim), np.float32)
        step(queries, cents)

        with pytest.raises(D.PeerTimeoutError):
            D.run_with_peer_timeout(lambda: time.sleep(30), timeout_s=0.2)
        local = S.shard_database(tcfg, host, N_SHARDS)
        t0 = time.perf_counter()
        for call in (lambda: D.run_with_peer_timeout(lambda: 42, 5),
                     lambda: D.peer_barrier(timeout_s=5),
                     lambda: D.place_host_sharded_db(tcfg, local, mesh),
                     lambda: fn(tree, sdb, torch.from_numpy(queries)),
                     lambda: step(queries, cents)):
            with pytest.raises(D.PeerTimeoutError, match="refused"):
                call()
        assert time.perf_counter() - t0 < 5.0
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    worker()
