"""A cell on several cards: the trace's busy time card by card, the
result's `device` from the cards that hold allocations, and the cards a
cell's `chips` hands its entry (throwaway two-card cells added as new
files and entries only: on the CPU, and on two cards, where an entry that
leaves its second card alone has to be reported on one, traced or not)."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import cells, common, trace as tr

# (name, start_us, end_us, card): two cards overlap on the timeline, so
# their union differs from either card's
EVENTS = [("k_a", 0.0, 100.0, 0), ("k_b", 50.0, 150.0, 0),
          ("k_c", 300.0, 400.0, 0), ("k_d", 0.0, 200.0, 1),
          ("k_e", 500.0, 520.0, 1), ("k_f", 120.0, 180.0, 2),
          (tr.PAD_KERNEL + ">(x)", 0.0, 900.0, 3),
          ("k_g", 900.0, 1100.0, 3)]
WINDOW = (10.0, 1000.0)
# each card's own union inside the window, in us
OWN = {0: (150 - 10) + 100, 1: (200 - 10) + 20, 2: 60, 3: 1000 - 900}


def four_cards() -> tr.Trace:
    return tr.Trace([e[:3] for e in EVENTS], [], WINDOW, 1,
                    tuple(e[3] for e in EVENTS), cards=(0, 1, 2, 3))


def union_us(intervals) -> float:
    return sum(e - s for s, e in intervals)


@pytest.mark.parametrize("card", sorted(OWN))
def test_busy_on_one_card_is_its_own_union(card):
    t = four_cards()
    assert union_us(t.busy(card)) == pytest.approx(OWN[card])
    assert t.busy_s_by_card()[card] == pytest.approx(OWN[card] / 1e6)


def test_busy_s_is_the_mean_over_the_cards():
    t = four_cards()
    assert t.busy_s() == pytest.approx(sum(OWN.values()) / 4 / 1e6)
    two = t._replace(cards=(0, 2))
    assert two.busy_s() == pytest.approx((OWN[0] + OWN[2]) / 2 / 1e6)
    assert list(two.busy_s_by_card()) == [0, 2]
    # the union over every card at once is wider than the mean
    assert union_us(t.busy()) / 1e6 > t.busy_s()


def test_one_card_busy_is_the_union():
    """A trace without cards (one card) reads as before: busy_s is the
    union of every device event but the pads, clipped to the window."""
    ops = [e[:3] for e in EVENTS]
    t = tr.Trace(ops, [], WINDOW, 1)
    lo, hi = WINDOW
    merged = []
    for _, s, e in sorted((o for o in ops if tr.PAD_KERNEL not in o[0]),
                          key=lambda o: o[1]):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    assert t.cards == (0,)
    assert t.busy() == merged == t.busy(0)
    assert t.busy_s() == pytest.approx(union_us(merged) / 1e6)
    assert t.busy_s_by_card() == {0: t.busy_s()}


def test_device_info_counts_the_cards_holding_allocations(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    cards = cells.run_devices("cuda", 4)
    assert cards == [torch.device("cuda", i) for i in range(4)]
    peaks = [5, 0, 7, 0]
    info = cells.device_info(cards, peaks)
    assert info == {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                    "count": 2, "memory_peak_bytes": 7,
                    "memory_peak_bytes_by_card":
                        {"0": 5, "1": 0, "2": 7, "3": 0}}
    assert cells.used_cards(cards, peaks) == [0, 2]
    one = cells.device_info(cards[:1], [47007586304])
    assert (one["count"], one["memory_peak_bytes"]) == (1, 47007586304)


ENTRY = '''import importlib.util, pathlib
spec = importlib.util.spec_from_file_location(
    'base', pathlib.Path(__file__).with_name('query_knn.py'))
base = importlib.util.module_from_spec(spec)
spec.loader.exec_module(base)
control = base.control

def run(s, seconds, traced, t0):
    out = base.run(s, seconds, traced, t0)
    out['info']['devices'] = [str(d) for d in s.devices]
    out['info']['device'] = str(s.device)
    return out
'''


# the same, with a block held on every card of the cell but the first
ENTRY_ALL = ENTRY.replace("""    out = base.run(s, seconds, traced, t0)""",
                          """    import torch
    held = [torch.ones(1 << 20, device=d) for d in s.devices[1:]]
    out = base.run(s, seconds, traced, t0)
    del held""")


def add_card_cell(tiny_root, root, entry: str, chips: int) -> str:
    """Copy the tiny benchmark to `root` and add the `chips`-card serving
    cell `tiny.cards` whose entry is `entry` (new files and entries)."""
    shutil.copytree(tiny_root, root)
    d = root / "portbench"
    (d / "entries/serve_cards.py").write_text(entry)
    traffic = json.loads((d / "traffic/tiny_b32.json").read_text())
    traffic["entry"] = "serve_cards"
    (d / "traffic/tiny_cards.json").write_text(json.dumps(traffic))
    (d / "limits/tiny.cards.json").write_text(
        (d / "limits/tiny.b32.json").read_text())
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "tiny.cards", "config": "tiny",
                           "traffic": "tiny_cards", "chips": chips,
                           "why": "a test's size"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "tiny.b32" in m.get("workloads", ()):
            m["workloads"].append("tiny.cards")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return "tiny.cards"


def test_two_card_cell_gets_two_devices(tiny_root, tmp_path):
    """A `chips: 2` cell added as new files and an entry: its entry is
    handed two devices through `s.devices`, and the result's `device`
    reports them."""
    root = tmp_path / "root"
    add_card_cell(tiny_root, root, ENTRY, 2)
    out = cells.run(common.Bench(root), "tiny.cards", 2 ** 31 + 11, 0.3,
                    False, device="cpu")
    assert out["correct"], out["checks"]
    assert out["info"]["devices"] == ["cpu", "cpu"]
    assert out["info"]["device"] == "cpu"
    dev = out["device"]
    assert dev["count"] == 2
    assert dev["memory_peak_bytes"] == 0
    assert dev["memory_peak_bytes_by_card"] == {"0": 0, "1": 0}
    assert out["info"]["torch_threads"] >= 1 and out["info"]["cpus"] >= 1
    assert list(out)[-1] == "checks"


def test_pads_go_to_the_cards_holding_bytes(monkeypatch):
    """The trace's pads and throwaway session run only on the cards whose
    allocator holds bytes as the window starts, so that they never make
    a card the run left alone read as used."""
    devices = [torch.device("cuda", i) for i in range(4)]
    held = {0: 4096, 1: 0, 2: 512, 3: 0}
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda d: held[torch.device(d).index])
    pads, thrown = [], []

    def session(body, devs, pad_cards):
        assert devs == devices
        pads.append(list(pad_cards))
        return body(), [("k", 0.0, 1.0)], (0,), [], (0.0, 1.0)

    monkeypatch.setattr(tr, "_session", session)
    monkeypatch.setattr(tr, "_throwaway", lambda p: thrown.append(list(p)))
    out, t = tr.traced(lambda: "done", devices)
    assert out == "done" and t.op_cards == (0,)
    assert tr.held(devices) == [devices[0], devices[2]]
    assert pads == [[devices[0], devices[2]]] * 2
    assert thrown == [[devices[0], devices[2]]]


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")


@pytest.mark.card
@pytest.mark.parametrize("traced", (0, 1))
@pytest.mark.parametrize("entry, count", ((ENTRY, 1), (ENTRY_ALL, 2)),
                         ids=("first_card_only", "both_cards"))
def test_cards_used_on_two_cards(two_cards, tiny_root, tmp_path, traced,
                                 entry, count):
    """On two cards, through run.py as the driver starts it: a `chips: 2`
    cell is reported with the cards its entry put bytes on, traced or
    not; an entry that leaves its second card alone reads count 1 (the
    trace's pads do not count), and a card outside the cell holds none."""
    root = tmp_path / "root"
    cell = add_card_cell(tiny_root, root, entry, 2)
    env = dict(os.environ, PYTHONPATH=str(common.BENCH_DIR.parent))
    run = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 29), "--seconds", "1", "--trace", str(traced)],
        cwd=root, env=env, capture_output=True, text=True, timeout=900)
    assert run.returncode == 0, run.stderr[-3000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    dev = out["device"]
    by_card = dev["memory_peak_bytes_by_card"]
    assert dev["count"] == count
    assert len(by_card) == torch.cuda.device_count()
    assert [c for c, p in by_card.items() if p > 0] == \
        [str(i) for i in range(count)]
    assert dev["memory_peak_bytes"] == max(by_card.values())
    if traced:
        assert list(dev["busy_s_by_card"]) == [str(i) for i in range(count)]
        assert dev["busy_s"] == pytest.approx(
            sum(dev["busy_s_by_card"].values()) / count)
        assert 0 < dev["busy_s"] <= dev["window_s"]
