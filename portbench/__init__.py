"""The benchmark of pqt_tpu_torch, the PyTorch and CUDA port.

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once and prints one JSON
line.  Everything a cell needs is found by name: its configuration in the
file `BENCHMARK.json` names, its traffic in `portbench/traffic/`, the
kind of cell its traffic names in `portbench/entries/`, the limits of its
correctness check in `portbench/limits/`, and each per-layer metric's
reader in `portbench/metrics/`.  Nothing here imports JAX or the
JAX package; the plain reference (`reference.py`) imports nothing of the
port either.
"""
