"""BENCHMARK.json against the contract's shape, every name resolving to
its files, and a throwaway cell added as new files and entries only."""

import json
import subprocess
import sys

import pytest

from portbench import cells, common
from conftest import REPO

B = json.loads((REPO / "BENCHMARK.json").read_text())
CELL_NAMES = [w["name"] for w in B["workloads"]]
METRICS = B["end_to_end"] + B["per_layer"]


def test_top_level_keys_and_limits():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["paths"] == ["portbench"]
    assert B["command"][1].startswith("portbench/")
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(B["configs"]) <= 24 and 1 <= len(B["workloads"]) <= 24
    assert sum(w["chips"] == 4 for w in B["workloads"]) <= max(
        1, len(B["workloads"]) // 4)


@pytest.mark.parametrize("entry", B["configs"] + B["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_units_and_text(entry):
    assert common.NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
    if "unit" in entry:
        assert common.UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in entry.get("reduced", []):
        assert common.NAME.match(key)


def test_metrics_by_cell():
    e2e = {m["name"]: m for m in B["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e[
        "setup_s"]
    for m in B["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    bench = common.Bench(REPO)
    for cell in CELL_NAMES:
        names = {m["name"] for m in bench.metrics(cell, False)}
        assert "setup_s" in names and len(names) >= 2
        layer = bench.metrics(cell, True)
        assert layer
        for m in layer:
            assert m["moves"] in names


@pytest.mark.parametrize("cell", CELL_NAMES)
def test_cell_resolves(cell):
    bench = common.Bench(REPO)
    w = bench.cell(cell)
    config = bench.config(w["config"])
    assert config["name"] == w["config"]
    entry = common.Bench._by_name(B["configs"], w["config"], "config")
    assert entry["file"].startswith("portbench/configs/")
    assert set(entry["reduced"]) <= set(config)
    traffic = bench.traffic(w["traffic"])
    entry = bench.entry(traffic["entry"])
    assert callable(entry.run) and callable(entry.control)
    limits = bench.limits(cell)
    assert all(isinstance(v, (int, float)) for v in limits.values())


@pytest.mark.parametrize("metric", [m["name"] for m in B["per_layer"]])
def test_reader_resolves(metric):
    reader = common.Bench(REPO).reader(metric)
    assert reader.read(type("R", (), {"kind": "none", "trace": None})()) \
        is None


def test_throwaway_cell_runs(tiny_root):
    """A cell added as new files and entries runs with no edit to any
    existing file: the run's line on the CPU, correct, checks last."""
    out = cells.run(common.Bench(tiny_root), "tiny.b32", 2 ** 31 + 7, 0.5,
                    False, device="cpu")
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"qps", "batch_p95_ms", "recall_at_10",
                                   "setup_s"}
    assert list(out)[-1] == "checks"
    assert out["metrics"]["recall_at_10"]["value"] > 0.9


def test_forbidden_modules():
    assert common.forbidden_modules(
        {"jax.numpy": 0, "pqt_tpu_torch.ops": 0, "numpy": 0}) == ["jax"]
    assert common.forbidden_modules({"pqt_tpu.config": 0}) == ["pqt_tpu"]
    assert common.forbidden_modules({"pqt_tpu_torch": 0, "flaxx": 0}) == []


def test_harness_imports_no_jax():
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.cells, portbench.control, portbench.run; "
            "import pqt_tpu_torch; from portbench import common; "
            "print(common.forbidden_modules())" % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _run_cell(cwd):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL_NAMES[0],
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=cwd)


def test_run_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = _run_cell(REPO)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_refuses_without_the_program(tmp_path):
    """No result line in a directory holding only BENCHMARK.json and
    portbench/."""
    import shutil
    shutil.copytree(REPO / "portbench", tmp_path / "portbench")
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    out = _run_cell(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_throwaway_metric_is_files_and_an_entry(tiny_root, tmp_path):
    """A per-layer metric added as its reader's file and one entry."""
    import shutil
    root = tmp_path / "root"
    shutil.copytree(tiny_root, root)
    (root / "portbench/metrics/batches_seen.serve.py").write_text(
        "def read(rec):\n    return float(rec.batches) if rec.kind == "
        "'serve' else None\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["per_layer"].append({"name": "batches_seen.serve", "unit": "batches",
                           "better": "higher", "source": "host_clock",
                           "layer": "entry points and graph cache",
                           "moves": "qps", "workloads": ["tiny.b32"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    bench = common.Bench(root)
    names = [m["name"] for m in bench.metrics("tiny.b32", True)]
    assert "batches_seen.serve" in names
    rec = type("R", (), {"kind": "serve", "batches": 7})()
    assert bench.reader("batches_seen.serve").read(rec) == 7.0


def test_throwaway_kind_of_cell_is_files_and_an_entry(tiny_root, tmp_path):
    """A new kind of cell: its entry module, its traffic mix and limits as
    new files, and its cell as a new entry; no existing file is edited."""
    import shutil
    root = tmp_path / "root"
    shutil.copytree(tiny_root, root)
    (root / "portbench/entries/serve_twice.py").write_text(
        "import importlib.util, pathlib\n"
        "spec = importlib.util.spec_from_file_location(\n"
        "    'base', pathlib.Path(__file__).with_name('query_knn.py'))\n"
        "base = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(base)\n"
        "control = base.control\n\n"
        "def run(s, seconds, traced, t0):\n"
        "    out = base.run(s, seconds, traced, t0)\n"
        "    out['info']['kind'] = 'serve_twice'\n"
        "    return out\n")
    traffic = json.loads((root / "portbench/traffic/tiny_b32.json")
                         .read_text())
    traffic["entry"] = "serve_twice"
    (root / "portbench/traffic/tiny_twice.json").write_text(
        json.dumps(traffic))
    (root / "portbench/limits/tiny.twice.json").write_text(
        (root / "portbench/limits/tiny.b32.json").read_text())
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "tiny.twice", "config": "tiny",
                           "traffic": "tiny_twice", "chips": 1,
                           "why": "a CPU test's size"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    out = cells.run(common.Bench(root), "tiny.twice", 2 ** 31 + 9, 0.3,
                    False, device="cpu")
    assert out["info"]["kind"] == "serve_twice"
    assert out["correct"], out["checks"]
