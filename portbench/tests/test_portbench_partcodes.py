"""partcodes_roofline_pct on synthetic build traces: its bound at the
SIFT1B chunk, its share where each chunk launched kernel P once, and
nothing where the program has no kernel P or a launch is missing."""

from types import SimpleNamespace

import pytest

from portbench import common
from portbench import trace as tr
from conftest import REPO

PQT = {"p": 4, "c1": 16, "c2": 16, "dim": 128}


def _reader():
    return common.Bench(REPO).reader("partcodes_roofline_pct")


def _build(chunk_rows, us, kernel="part_codes_kernel<true>", builds=2):
    dev, t = [], 0.0
    for _ in range(builds):
        for _ in chunk_rows:
            dev.append((f"void (anonymous namespace)::{kernel}(float const*)",
                        t, t + us))
            dev.append(("void line_codes_fixed_kernel<16>()", t + us,
                        t + us + 50))
            t += 1000.0
    return SimpleNamespace(kind="build", pqt=PQT, builds=builds,
                           chunk_rows=chunk_rows,
                           trace=tr.Trace(dev, [], (-1.0, t), 1))


def test_bound_at_the_sift1b_chunk():
    # operations bind: 2 * 65536 * 4 * 256 * 32 / 67e12 = 64.1 us
    assert _reader().bound_s(65536, 4, 256, 32) == pytest.approx(
        2 * 65536 * 4 * 256 * 32 / 67e12)
    assert _reader().bound_s(65536, 4, 256, 32) == pytest.approx(
        6.41e-5, rel=1e-3)


def test_share_of_the_launches():
    rows = [65536, 65536, 1000]
    least = sum(_reader().bound_s(r, 4, 256, 32) for r in rows)
    got = _reader().read(_build(rows, 128.0))
    assert got == pytest.approx(100.0 * least / (3 * 128e-6))


def test_nothing_without_the_kernel():
    assert _reader().read(_build([65536], 100.0, kernel="other_kernel")) \
        is None
    rec = _build([65536, 65536], 100.0)
    rec.trace.device_ops.pop(0)                 # a launch lost
    assert _reader().read(rec) is None
    rec.kind = "serve"
    assert _reader().read(rec) is None
