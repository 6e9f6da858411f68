"""The manifest, the names and the files of the benchmark.

A cell (an entry of `workloads` in BENCHMARK.json) names a configuration
and a traffic mix.  The configuration's file is the one its `configs`
entry names; the traffic mix is `portbench/traffic/<traffic>.json`, whose
`entry` names the module `portbench/entries/<entry>.py` that runs and
checks the cell; the limits of the cell's correctness check are
`portbench/limits/<cell>.json`; a per-layer metric's reader is
`portbench/metrics/<metric>.py`, a module with `read(record) -> float |
None`.  So a later cell, configuration, kind of cell or metric is new
files and new entries, and no edit of a file here.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
REPO = BENCH_DIR.parent

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")

# top-level module names no process of the benchmark may hold: JAX, its
# libraries and the JAX package (compared whole: pqt_tpu_torch passes)
FORBIDDEN = ("jax", "jaxlib", "flax", "pqt_tpu")


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among the loaded modules."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None
                                          else modules)}
    return sorted(names & set(FORBIDDEN))


class Bench:
    """BENCHMARK.json and the files it leads to, under `root`."""

    def __init__(self, root=REPO):
        self.root = Path(root)
        self.dir = self.root / "portbench"
        self.manifest = json.loads((self.root / "BENCHMARK.json").read_text())
        self._modules = {}

    @staticmethod
    def _by_name(entries, name, what):
        for e in entries:
            if e["name"] == name:
                return e
        raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")

    def cell(self, name: str) -> dict:
        return self._by_name(self.manifest["workloads"], name, "workload")

    def config(self, name: str) -> dict:
        entry = self._by_name(self.manifest["configs"], name, "config")
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def limits(self, cell: str) -> dict:
        return json.loads((self.dir / "limits" / f"{cell}.json").read_text())

    def metrics(self, cell: str, trace: bool) -> list:
        """The metric entries a run of `cell` reports: its end-to-end ones
        untraced, its per-layer ones traced."""
        entries = self.manifest["per_layer" if trace else "end_to_end"]
        return [m for m in entries
                if "workloads" not in m or cell in m["workloads"]]

    def _module(self, kind: str, name: str):
        """The module `portbench/<kind>/<name>.py`, loaded from its path
        (names may hold dots), once a process."""
        key = (kind, name)
        if key not in self._modules:
            path = self.dir / kind / f"{name}.py"
            if not path.is_file():
                raise KeyError(f"no {path.relative_to(self.root)}")
            spec = importlib.util.spec_from_file_location(
                f"portbench_{kind}_" + re.sub(r"\W", "_", name), path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[key] = mod
        return self._modules[key]

    def reader(self, metric: str):
        """A per-layer metric's reader, `portbench/metrics/<metric>.py`."""
        return self._module("metrics", metric)

    def entry(self, name: str):
        """A kind of cell, `portbench/entries/<name>.py`: `run(setup,
        seconds, traced, t0)` and `control(setup)`."""
        return self._module("entries", name)
