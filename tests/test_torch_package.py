"""pqt_tpu_torch as a package: imports, config parity, devices, kernel build.

The port must import neither JAX nor the JAX package, its config must
round-trip through JSON with the JAX package's, its entry points must refuse
to run on a missing card unless asked for the CPU, and its CUDA kernels must
fail loudly, never fall back, when they cannot be built or launched.
"""

import ast
import dataclasses
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import pqt_tpu.config as jcfg
import pqt_tpu_torch as T
from pqt_tpu_torch.io import artifacts as TA
from pqt_tpu_torch.ops.cuda import build, gather, primitives, rerank

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "pqt_tpu_torch"


def test_import_loads_neither_jax_nor_pqt_tpu():
    code = ("import sys, pqt_tpu_torch, pqt_tpu_torch.io.artifacts, "
            "pqt_tpu_torch.utils.metrics, pqt_tpu_torch.models.split, "
            "pqt_tpu_torch.models.multidb, pqt_tpu_torch.io.texmex, "
            "pqt_tpu_torch.tools.convert, pqt_tpu_torch.tools.create_db, "
            "pqt_tpu_torch.tools.query, pqt_tpu_torch.utils.diagnostics, "
            "pqt_tpu_torch.parallel.sharded, "
            "pqt_tpu_torch.parallel.distributed\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'pqt_tpu' or "
            "m.startswith('pqt_tpu.')]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)))
def test_no_module_imports_jax_or_pqt_tpu(path):
    for mod in _imported_modules(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "pqt_tpu"), (path, mod)


CONFIGS = [
    dict(),
    dict(dim=32, p=4, c1=4, c2=4, line_parts=8, hash_size=1 << 10,
         k1_build=4, k1_query=4, pair_top_m=64, payload_compact=False,
         lambda_bits=8),
    dict(dim=960, p=4, line_parts=32, kmeans_init="lbg", seed=7),
]


@pytest.mark.parametrize("kw", CONFIGS)
def test_config_json_round_trips_both_ways(kw):
    j = jcfg.PQTConfig(**kw)
    t = T.PQTConfig(**kw)
    assert T.PQTConfig.from_json(j.to_json()) == t
    assert jcfg.PQTConfig.from_json(t.to_json()) == j
    assert json.loads(j.to_json()) == json.loads(t.to_json())
    assert ({f.name for f in dataclasses.fields(j)}
            == {f.name for f in dataclasses.fields(t)})
    assert (j.vl, j.lvl, j.part_radix, j.effective_enum_width,
            j.payload_is_compact, j.pair_filter_enabled) == (
        t.vl, t.lvl, t.part_radix, t.effective_enum_width,
        t.payload_is_compact, t.pair_filter_enabled)


@pytest.mark.parametrize("bad", [
    dict(dim=30, p=4), dict(line_parts=12), dict(dim=32, p=4, line_parts=2),
    dict(c1=300), dict(k1_query=20), dict(k1_build=20),
    dict(pipeline="nope"), dict(multidb_rank="x"), dict(gather_mode="x"),
    dict(rerank_kernel="x"), dict(slab_size=0), dict(lambda_bits=4),
    dict(hash_size=1000)])
def test_same_invalid_configs_raise_in_both(bad):
    with pytest.raises(ValueError):
        jcfg.PQTConfig(**bad)
    with pytest.raises(ValueError):
        T.PQTConfig(**bad)


def test_entry_points_refuse_missing_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = T.PQTConfig(dim=8, p=2, c1=2, c2=2, line_parts=2, k1_build=2,
                      k1_query=2, hash_size=1 << 8)
    data = np.zeros((16, 8), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.train_tree(cfg, data)
    tree = T.train_tree(cfg, data, device="cpu")
    TA.save_tree(str(tmp_path / "tree"), cfg, tree)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.load_tree(str(tmp_path / "tree"), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.build_database(cfg, tree, data)
    db = T.build_database(cfg, tree, data, device="cpu")
    TA.save_database(str(tmp_path / "db"), cfg, db)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.load_database(str(tmp_path / "db"), cfg)


def test_kernel_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build, "DEFAULT_NVCC", "/nonexistent/bin/nvcc")
    monkeypatch.setattr(build, "_libs", {})
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.find_nvcc()
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.load("topk")


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is neither on the CPU nor on a card is refused, not
    routed to the plain version."""
    x = torch.empty((4, 16), device="meta")
    with pytest.raises(ValueError):
        primitives.bitonic_topk(x, 2)
    with pytest.raises(ValueError):
        primitives.block_scan(x.to(torch.int32))
    with pytest.raises(ValueError):
        rerank.rerank_fused(torch.empty((1, 4, 10), dtype=torch.int32,
                                        device="meta"),
                            torch.empty((1, 16, 16), device="meta"))
    with pytest.raises(ValueError):
        primitives.segmented_reduce(x, 4)
    idx = torch.zeros((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        gather.lut_gather(torch.empty(64, dtype=torch.int32, device="meta"),
                          idx)
    with pytest.raises(ValueError):
        gather.gather_rows(x, idx)


def test_paths_of_later_slices_raise(clustered_data):
    """The paths of earlier slices' "later" list are all served now: the
    parts pipeline, slab gathers, and exact and refine queries over a
    database that holds only vectors_csr (raw vectors in CSR order), which
    equal the in-RAM database's results.  Only a database without raw
    vectors refuses them."""
    from pqt_tpu_torch.models.db import PQTDatabase
    db_vecs, queries = clustered_data
    cfg = T.PQTConfig(dim=32, p=4, c1=4, c2=4, line_parts=8,
                      hash_size=1 << 16, k1_build=4, k1_query=4,
                      max_bins=64, max_candidates=128, kmeans_iters=3,
                      pair_top_m=16)
    tree = T.train_tree(cfg, db_vecs[:512], device="cpu")
    db = T.build_database(cfg, tree, db_vecs[:512], device="cpu",
                          keep_vectors=True)
    q = torch.from_numpy(queries[:4])
    # the parts pipeline and slab gathers are served now
    for cfg_now in (cfg.replace(pipeline="parts"),
                    cfg.replace(gather_mode="slabs")):
        res = T.query_knn(cfg_now, tree, db, q, 5)
        assert res.indices.shape == (4, 5) and (res.indices[:, 0] >= 0).all()
    csr_only = PQTDatabase(*db[:4], vectors=None, prefix2=db.prefix2,
                           vectors_csr=db.vectors[db.ids.long()])
    for got, want in (
            (T.query_knn(cfg, tree, csr_only, q, 5, exact_rerank=True),
             T.query_knn(cfg, tree, db, q, 5, exact_rerank=True)),
            (T.query_knn_refine(cfg, tree, csr_only, q, 5),
             T.query_knn_refine(cfg, tree, db, q, 5))):
        assert torch.equal(got.indices, want.indices)
        assert torch.equal(got.dists, want.dists)
        assert (got.indices[:, 0] >= 0).all()
    bare = csr_only._replace(vectors_csr=None)
    with pytest.raises(ValueError):
        T.query_knn(cfg, tree, bare, q, 5, exact_rerank=True)
    with pytest.raises(ValueError):
        T.query_knn_refine(cfg, tree, bare, q, 5)
