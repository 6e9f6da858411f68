"""Kernel B's (block_scan) launch plan, a numpy model of its onepass
protocol (csrc/scan.cu), and kernel E's (lut_gather) plain version at
ragged lengths.

The CUDA kernels themselves run only on the card (chip_smoke.py holds them
against their plain versions there).  What the CPU can check is the
arithmetic around them: the plan's modes, shapes and limits at every shape
chip_smoke.py times, that the tiles and chunks of a plan cover every
element of ragged and misaligned rows, and that the decoupled look-back --
tile ids in scheduling order, an aggregate then an inclusive prefix per
tile, epochs that make an earlier call's status words stale -- gives the
prefix sums whatever order the tiles finish in.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pqt_tpu_torch.ops.cuda import gather as ga
from pqt_tpu_torch.ops.cuda import primitives as prim

MASK = 0xFFFFFFFF
AGGREGATE, PREFIX = 1, 2


def _word(epoch, flag, value):
    return ((epoch << 2 | flag) << 32) | (value & MASK)


def _span(t, n, tiles_per_row, chunk):
    """Tile t's row, index in the row and flat elements [a, b), as
    csrc/scan.cu places it: vectors of 4 at multiples of 4, a tile of
    `chunk` vectors from its row's first vector on."""
    row, tile = divmod(t, tiles_per_row)
    lo, hi = row * n, row * n + n
    v0 = (lo >> 2) + tile * chunk
    return tile, max(lo, 4 * v0), min(hi, 4 * (v0 + chunk))


def _small_plan(rows, n):
    """A onepass plan with tiles of one warp of two vectors (256 elements),
    so that rows of a few thousand span many tiles and a look-back walks
    several windows of 32 (the kernel's tile is 8192 elements)."""
    tiles = -(-prim._scan_vectors(n) // (1 * 2 * 32))
    return prim.ScanPlan("onepass", 1, 2, 1, tiles, rows * tiles)


def _local(vals, exclusive):
    inc = np.cumsum(vals.astype(np.int64))
    return (inc - vals) if exclusive else inc


def _onepass_model(x, exclusive, plan, state, epoch, rng):
    """Onepass mode on numpy.  state: the status buffer (the tile counter,
    then a word a tile), as the previous call left it.  Blocks are launched
    in turn, take their tile id from the counter (atomicInc, wrapping at
    the grid), then publish, look back and write in a seeded random
    interleaving; a look-back step reads 32 words and waits while any of
    them is not of this epoch.  Returns the output (int64, wrapped to
    int32)."""
    rows, n = x.shape
    flat = x.reshape(-1).astype(np.int64)
    chunk = plan.warps * plan.vecs * 32
    tiles = plan.blocks
    assert tiles == rows * plan.tiles and state[0] == 0
    out = np.full(rows * n, np.iinfo(np.int64).min, np.int64)
    live, launched, done, stalled = {}, 0, 0, 0

    def finish(t, base):
        _, a, b = live.pop(t)["span"]
        out[a:b] = base + _local(flat[a:b], exclusive)

    while done < tiles:
        picks = list(live) + (["launch"] if launched < tiles else [])
        pick = picks[rng.integers(len(picks))]
        if pick == "launch":
            t = int(state[0])
            state[0] = 0 if t >= tiles - 1 else t + 1
            launched += 1
            tile, a, b = _span(t, n, plan.tiles, chunk)
            live[t] = {"span": (tile, a, b), "phase": "publish",
                       "agg": int(flat[a:b].sum()) & MASK}
            continue
        t, st = pick, live[pick]
        tile = st["span"][0]
        if st["phase"] == "publish":
            state[1 + t] = _word(epoch, PREFIX if tile == 0 else AGGREGATE,
                                 st["agg"])
            if tile == 0:
                finish(t, 0)
                done += 1
            else:
                st.update(phase="look", p=t - 1, prefix=0)
            stalled = 0
            continue
        first = t - tile
        words = [_word(epoch, PREFIX, 0) if q < first else int(state[1 + q])
                 for q in range(st["p"], st["p"] - 32, -1)]
        flags = [(w >> 32) & 3 if (w >> 32) >> 2 == epoch else 0
                 for w in words]
        if 0 in flags:                        # a predecessor not yet published
            stalled += 1
            assert stalled < 100_000, "no tile can make progress"
            continue
        stalled = 0
        stop = flags.index(PREFIX) if PREFIX in flags else 31
        st["prefix"] = (st["prefix"] + sum(w & MASK for w in words[:stop + 1])
                        ) & MASK
        if PREFIX in flags:
            state[1 + t] = _word(epoch, PREFIX, st["prefix"] + st["agg"])
            finish(t, st["prefix"])
            done += 1
        else:
            st["p"] -= 32
    assert state[0] == 0, "the tile counter did not wrap back to 0"
    assert (out != np.iinfo(np.int64).min).all(), "an element was not written"
    return ((out + 2 ** 31) % 2 ** 32 - 2 ** 31).reshape(rows, n)


def _stale_state(rng, tiles, epoch):
    """A status buffer as earlier calls leave it: the counter at 0, and
    words of earlier epochs (or never written) with any flag and value."""
    state = np.zeros(1 + tiles, dtype=object)
    for i in range(1, 1 + tiles):
        e = int(rng.integers(0, epoch))
        state[i] = _word(e, int(rng.integers(1, 3)),
                         int(rng.integers(0, 2 ** 32)))
    return state


def _want(x, exclusive):
    s = np.cumsum(x.astype(np.int64), axis=1)
    return s - x if exclusive else s


@pytest.mark.parametrize("rows,n", [(1, 5000), (3, 1001), (2, 70001),
                                    (4, 257), (5, 1), (2, 4096), (1, 20002),
                                    (6, 8193)])
@pytest.mark.parametrize("exclusive", [False, True])
def test_onepass_model_matches_cumsum(rows, n, exclusive):
    """Small tiles (_small_plan), so rows of a few thousand span many tiles
    and look-backs walk several windows; odd n puts every row after the
    first off a 16-byte boundary."""
    rng = np.random.default_rng(rows * n + exclusive)
    x = rng.integers(0, 9, (rows, n)).astype(np.int32)
    plan = _small_plan(rows, n)
    epoch = 7
    state = _stale_state(rng, plan.blocks, epoch)
    got = _onepass_model(x, exclusive, plan, state, epoch, rng)
    np.testing.assert_array_equal(got, _want(x, exclusive))
    np.testing.assert_array_equal(
        got, prim.block_scan_plain(torch.from_numpy(x), exclusive).numpy())


def test_onepass_model_back_to_back_calls():
    """Calls on one buffer with increasing epochs, of different lengths, with
    no reset between them: each sees the words of the ones before as
    stale."""
    rng = np.random.default_rng(11)
    state = np.zeros(1 + 400, dtype=object)
    for epoch, (rows, n) in enumerate([(2, 30001), (1, 2049), (3, 9999),
                                       (1, 40000), (2, 513)], start=1):
        x = rng.integers(0, 5, (rows, n)).astype(np.int32)
        plan = _small_plan(rows, n)
        assert plan.blocks + 1 <= state.size
        got = _onepass_model(x, epoch % 2 == 1, plan, state, epoch, rng)
        np.testing.assert_array_equal(got, _want(x, epoch % 2 == 1))


def test_onepass_model_replays_of_one_captured_launch():
    """A CUDA graph replays a launch with the arguments it was captured
    with.  With the eager scheme (the persistent words, a new epoch a call)
    the epoch is frozen in the graph: the second replay reads the words of
    the first as current and sums stale aggregates into its prefixes.  The
    scheme captured launches take (`_scan_status`: words of the graph's
    own, zeroed by the node before the launch on every replay, epoch 1)
    gives the prefix sums on every replay."""
    rows, n = 2, 30001
    plan = _small_plan(rows, n)
    rng = np.random.default_rng(12)
    inputs = [rng.integers(0, 9, (rows, n)).astype(np.int32)
              for _ in range(3)]
    frozen = _stale_state(rng, plan.blocks, 7)
    outs = [_onepass_model(x, False, plan, frozen, 7, rng) for x in inputs]
    np.testing.assert_array_equal(outs[0], _want(inputs[0], False))
    assert not all(np.array_equal(o, _want(x, False))
                   for o, x in zip(outs[1:], inputs[1:]))
    words = np.zeros(1 + plan.blocks, dtype=object)
    for x in inputs:
        words[:] = 0                            # the zeroing node
        np.testing.assert_array_equal(
            _onepass_model(x, False, plan, words, 1, rng), _want(x, False))


def test_scan_status_under_capture(monkeypatch):
    """The wrapper's bookkeeping: a captured launch gets zeroed words of
    its own and epoch 1, and neither reads nor replaces the persistent
    buffer; an eager launch takes the buffer of its (device, stream) with
    the next epoch, as before."""
    x = torch.zeros((2, 3), dtype=torch.int32)
    monkeypatch.setattr(prim, "_scan_states", {})
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 7}))
    buf, e1 = prim._scan_status(x, 10)
    buf2, e2 = prim._scan_status(x, 10)
    assert buf2 is buf and (e1, e2) == (1, 2) and len(prim._scan_states) == 1
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    a, ea = prim._scan_status(x, 40)
    b, eb = prim._scan_status(x, 40)
    assert (ea, eb) == (1, 1) and a is not b
    assert a.dtype == torch.int64 and a.numel() == 40 and not a.any()
    # the persistent buffer, too short for 40 words, was not replaced
    assert prim._scan_states[(None, 7)][0] is buf and buf.numel() == 10
    assert prim._scan_states[(None, 7)][1] == 2


def test_onepass_model_row_sum_at_int32_max():
    """A row summing to exactly 2^31 - 1, and all-zero rows."""
    n = 4096
    x = np.full((3, n), (2 ** 31) // n, np.int32)
    x[0, -1] -= 1
    x[1] = 0
    x[2, -1] -= 1
    plan = _small_plan(3, n)
    rng = np.random.default_rng(31)
    got = _onepass_model(x, False, plan, _stale_state(rng, plan.blocks, 3),
                         3, rng)
    assert got[0, -1] == 2 ** 31 - 1 and (got[1] == 0).all()
    np.testing.assert_array_equal(got, _want(x, False))


@pytest.mark.parametrize("rows,n", [(256, 512), (256, 768), (3, 65535),
                                    (2, 31), (5, 1), (7, 16383)])
def test_rows_plan_covers_every_row(rows, n):
    """Rows mode: a group walks its row chunk by chunk, carrying the total;
    the plan's chunks cover every element of every row, aligned or not,
    and the blocks hold every row.  The shapes take both of the kernel's
    chunk widths: 2 vectors a lane up to SCAN_ROWS_SHORT elements, 8
    above."""
    rng = np.random.default_rng(n)
    x = rng.integers(0, 9, (rows, n)).astype(np.int32)
    plan = prim._scan_plan(rows, n, "rows")
    assert plan.vecs == (2 if n <= prim.SCAN_ROWS_SHORT else 8)
    assert plan.blocks * (plan.warps // plan.group) >= rows
    chunk = plan.group * plan.vecs * 32
    out = np.full((rows, n), -1, np.int64)
    flat = out.reshape(-1)
    for r in range(rows):
        carry = 0
        for c in range(plan.tiles):
            _, a, b = _span(r * plan.tiles + c, n, plan.tiles, chunk)
            flat[a:b] = carry + x.reshape(-1)[a:b].cumsum()
            carry += int(x.reshape(-1)[a:b].sum())
    np.testing.assert_array_equal(out, _want(x, False))


def test_scan_vectors_bounds_every_alignment():
    """Row r of a (rows, n) array starts at flat index r * n: every row
    touches at most _scan_vectors(n) 16-byte vectors, exactly n / 4 when
    n % 4 == 0 (every row then starts on a multiple of 4)."""
    for n in range(1, 70):
        for r in range(8):
            m = (r * n) % 4
            touched = (m + n - 1) // 4 + 1
            assert touched <= prim._scan_vectors(n)
        if n % 4 == 0:
            assert prim._scan_vectors(n) == n // 4


# (rows, n): mode, for every block_scan shape chip_smoke.py times or holds
SCAN_SHAPES = {
    "candidate_prefix": ((256, 512), "rows"),
    "survivor_compaction": ((256, 768), "rows"),
    "filter_compaction": ((256, 2048), "rows"),
    "csr_prefix": ((1, 1 << 20), "onepass"),
    "sift1b_candidate_prefix": ((256, 8192), "rows"),
    "sift1b_compaction": ((256, 32768), "rows"),
    "sift1b_csr_prefix": ((1, 1 << 29), "onepass"),
    "look-back rows": ((3, 5_000_011), "onepass"),
    "several long rows": ((4, 100_003), "onepass"),
    "ragged width": ((3, 70_001), "onepass"),
    "short rows": ((3, 5000), "rows"),
    "shorter than a warp": ((2, 31), "rows"),
    "one element": ((5, 1), "rows"),
    "all zero, long": ((2, 1 << 20), "onepass"),
    "row sum at 4096": ((2, 4096), "rows"),
    # chip_sweep.py's ladder, which places the cut between the modes
    "ladder 256 x 1024": ((256, 1024), "rows"),
    "ladder 256 x 65536": ((256, 1 << 16), "rows"),
    "ladder 1 x 16384": ((1, 1 << 14), "rows"),
    "ladder 1 x 65536": ((1, 1 << 16), "onepass"),
    "ladder 1 x 2^18": ((1, 1 << 18), "onepass"),
}


@pytest.mark.parametrize("name", sorted(SCAN_SHAPES))
def test_scan_plan_picks_the_mode(name):
    (rows, n), mode = SCAN_SHAPES[name]
    plan = prim._scan_plan(rows, n)
    assert plan.mode == mode
    # the chunk widths and block sizes csrc/scan.cu takes
    assert plan.vecs in (2, 8) and 1 <= plan.warps <= 32
    assert plan.warps % plan.group == 0
    chunk = plan.group * plan.vecs * 32
    assert plan.tiles * chunk >= prim._scan_vectors(n)
    if mode == "onepass":
        assert plan.blocks == rows * plan.tiles <= prim.SCAN_TILES_MAX
        assert plan.group == plan.warps
    else:
        assert plan.blocks * (plan.warps // plan.group) >= rows
    # the other mode, where it takes the shape
    other = "rows" if mode == "onepass" else "onepass"
    if other == "rows" and n > prim.SCAN_ROWS_WALK_MAX:
        with pytest.raises(NotImplementedError):
            prim._scan_plan(rows, n, other)
    else:
        assert prim._scan_plan(rows, n, other).mode == other


def test_scan_plan_limits():
    """Rows mode walks rows of at most SCAN_ROWS_WALK_MAX; many long rows
    stay in rows mode up to it; onepass refuses more than SCAN_TILES_MAX
    tiles; empty shapes and unknown modes are refused."""
    walk = prim.SCAN_ROWS_WALK_MAX
    assert prim._scan_plan(prim.SCAN_MANY_ROWS, walk).mode == "rows"
    assert prim._scan_plan(prim.SCAN_MANY_ROWS - 1, walk).mode == "onepass"
    assert prim._scan_plan(1, prim.SCAN_ROWS_MAX).mode == "rows"
    assert prim._scan_plan(1, prim.SCAN_ROWS_MAX + 1).mode == "onepass"
    with pytest.raises(NotImplementedError):
        prim._scan_plan(1, walk + 1, "rows")
    with pytest.raises(NotImplementedError):
        prim._scan_plan(1 << 20, 1 << 24)
    with pytest.raises(ValueError):
        prim._scan_plan(4, 1000, "three-pass")
    for rows, n in ((0, 10), (4, 0)):
        with pytest.raises(ValueError):
            prim._scan_plan(rows, n)


@pytest.mark.parametrize("dtype", [np.int32, np.uint8])
def test_lut_gather_ragged_lengths(dtype):
    """lut_gather's plain version (what it runs on CPU tensors) at lengths
    1 to 9 and on indices that start 4 bytes into their buffer, against
    the JAX package's lookup (jnp.take).  The kernel is held against the
    plain version at these on the card by chip_smoke.py."""
    rng = np.random.default_rng(9)
    table = rng.integers(0, 200, 1001).astype(dtype)
    flat = rng.integers(0, 1001, 4097).astype(np.int32)
    cases = [flat[1:1 + k] for k in range(1, 10)] + [flat[1:]]
    for idx in cases:
        t_idx = torch.from_numpy(flat)[1:1 + idx.size]
        assert t_idx.data_ptr() % 16 == (torch.from_numpy(flat).data_ptr()
                                         + 4) % 16
        got = ga.lut_gather(torch.from_numpy(table), t_idx)
        want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(idx)))
        np.testing.assert_array_equal(got.numpy(), want)
