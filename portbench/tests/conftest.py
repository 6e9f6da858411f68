"""Fixtures of the benchmark's own tests: a benchmark root with tiny cells
added as new files and new BENCHMARK.json entries, as a later change adds
a cell (the throwaway cells of these tests), and the `card` marker.

Run them from the root of the repository: `python -m pytest
portbench/tests -q`.  Tests marked `card` run only where torch sees a CUDA
card (decided inside the test, never at import)."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

TINY = {"n": 20000, "n_train": 5000, "n_coarse": 64, "subs_per_coarse": 8,
        "hash_size": 1 << 14, "max_bins": 64, "max_candidates": 256,
        "pair_top_m": 32, "enum_width": 64, "kmeans_iters": 30}
TINY_B = {"n": 30000, "n_train": 5000, "n_coarse": 96, "hash_size": 1 << 14,
          "max_bins": 128, "max_candidates": 512, "pair_top_m": 32,
          "enum_width": 256, "kmeans_iters": 30,
          "train_subsample": 5000}
SERVE = {"entry": "query_knn", "exact_rerank": True, "k": 10, "batch": 32,
         "pool": 500, "warmup": 2, "check_queries": 128,
         "trace_seconds": 2}
BUILD = {"entry": "build_database", "keep_vectors": True,
         "encode_chunk": 8192, "warmup": 1, "rotate_rows": 512,
         "check_rows": 2000, "trace_seconds": 4}
CELLS = {"tiny.b32": ("tiny", "tiny_b32", "sift1m.exact_b256"),
         "tinyb.b32": ("tinyb", "tiny_b32", "sift1m.exact_b256"),
         "tinyb.build": ("tinyb", "tiny_build", "sift1b_shard8.build")}


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skipped without one")


def add_cells(root: Path) -> Path:
    """Add the tiny configurations, traffic, limits and cells to the
    benchmark under `root` (new files, new entries only)."""
    d = root / "portbench"
    for name, base, over in (("tiny", "sift1m", TINY),
                             ("tinyb", "sift1b_shard8", TINY_B)):
        cfg = json.loads((d / "configs" / f"{base}.json").read_text())
        cfg.update(over, name=name)
        (d / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    (d / "traffic" / "tiny_b32.json").write_text(json.dumps(SERVE))
    (d / "traffic" / "tiny_build.json").write_text(json.dumps(BUILD))
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"] += [{"name": n, "source": "https://example.org/tiny",
                      "file": f"portbench/configs/{n}.json", "reduced": [],
                      "why": "a CPU test's size"} for n in ("tiny", "tinyb")]
    for cell, (config, traffic, like) in CELLS.items():
        b["workloads"].append({"name": cell, "config": config,
                               "traffic": traffic, "chips": 1,
                               "why": "a CPU test's size"})
        (d / "limits" / f"{cell}.json").write_text(
            (d / "limits" / f"{like}.json").read_text())
        for m in b["end_to_end"] + b["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(b, indent=1))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    return add_cells(root)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
