"""Kernels H (`gather_rows`) and D (`segmented_reduce`): their plain
versions against the Pallas kernels in interpret mode and against numpy,
and numpy models of their launch plans (csrc/gather.cu, csrc/reduce.cu).

The CUDA kernels run only on the card (chip_smoke.py holds them against
their plain versions there).  What the CPU can check is the arithmetic
around them: that a plan's thread -> (item, unit) or lane -> segment
mapping, as the kernel walks it, covers every output element exactly once
at every row width, alignment and ragged count; that the rows mode's
window of in-table units is the rows inside the table; that the shuffle
tree of a reduction gives the plain sums; and that D's square mode is what
the distance tables call, with nothing squared before it.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pqt_tpu.ops.pallas import primitives as PP
from pqt_tpu_torch.ops import distance as TDIST
from pqt_tpu_torch.ops.cuda import gather as ga
from pqt_tpu_torch.ops.cuda import primitives as prim
from test_torch_kernels import micro_gather, pallas_interpret  # noqa: F401


# --------------------------------------------------------------------------
# kernel H
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,width", [(np.int32, 18), (np.int32, 2),
                                         (np.uint8, 128), (np.uint8, 1),
                                         (np.uint8, 3), (np.uint8, 5),
                                         (np.uint8, 13)])
def test_gather_rows_matches_pallas_dma_gather(micro_gather,
                                               pallas_interpret, dtype,
                                               width):
    """72-byte payload rows, 8-byte extent rows, SIFT vectors and odd
    widths of 1, 3, 5 and 13 bytes, with rows N - 1 and 0 among the
    positions."""
    rng = np.random.default_rng(width)
    info = np.iinfo(dtype)
    n = 700
    tab = rng.integers(info.min, info.max, (n, width)).astype(dtype)
    pos = rng.integers(0, n, (2, 16)).astype(np.int32)
    pos[0, :3] = (n - 1, 0, n - 1)
    pos[1, -2:] = (0, n - 1)
    want = np.asarray(micro_gather["micro_gather2"].pallas_dma_gather(
        jnp.asarray(tab), jnp.asarray(pos), inflight=4))
    got = ga.gather_rows(torch.from_numpy(tab), torch.from_numpy(pos))
    plain = ga.gather_rows_plain(torch.from_numpy(tab), torch.from_numpy(pos))
    assert got.shape == (2, 16, width) and got.numpy().dtype == dtype
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(want, tab[pos])


@pytest.mark.parametrize("span", [1, 8, 32])
@pytest.mark.parametrize("dtype,width,offset", [
    (np.int32, 18, 0), (np.int32, 18, 1), (np.int32, 18, 2),
    (np.int32, 10, 1), (np.int32, 2, 2), (np.uint8, 13, 4),
    (np.uint8, 128, 8), (np.uint8, 5, 0)])
def test_gather_rows_spans_and_offset_tables(span, dtype, width, offset):
    """Slabs of 1, 8 and 32 rows from a table whose first element lies
    `offset` elements past an aligned address (4 and 8 bytes for int32, 4
    and 8 for uint8), starting at row 0 and at the last start N - span."""
    rng = np.random.default_rng(span * 1000 + width + offset)
    n = 300
    info = np.iinfo(dtype)
    flat = rng.integers(info.min, info.max, n * width + offset).astype(dtype)
    tab = flat[offset:].reshape(n, width)
    pos = rng.integers(0, n - span + 1, (3, 9)).astype(np.int32)
    pos[0, :2] = (0, n - span)
    pos[2, -1] = n - span
    t = torch.from_numpy(flat)[offset:].view(n, width)
    got = ga.gather_rows(t, torch.from_numpy(pos), span)
    want = tab[pos[..., None] + np.arange(span)]
    if span == 1:
        want = want[..., 0, :]
    np.testing.assert_array_equal(got.numpy(), want)


def _gather_model(plan, pos, span, upr, n_rows):
    """csrc/gather.cu walked on numpy: every store as (item, unit, in-table),
    in-table from the kernel's window arithmetic."""
    warps = plan.blocks * (ga.GATHER_THREADS // 32)
    lane = np.arange(32)
    if plan.mode == "rows":
        units = plan.units
        group, u = lane // units, lane % units
        live = group < 32 // units
        warp = np.arange(warps)[:, None, None]
        r = np.arange(plan.rows)[None, :, None]
        item = warp * (32 // units) * plan.rows + r * (32 // units) + group
        unit = np.broadcast_to(u, item.shape)
        keep = np.broadcast_to(live, item.shape) & (item < pos.size)
        item, unit = item[keep], unit[keep]
    else:
        units, stride = plan.units, warps
        # warp w copies items w, w + stride, ...; unit u0 + 32 r of a round
        steps = -(-pos.size // stride)
        item = (np.arange(warps)[:, None] + stride * np.arange(steps)[None])
        item = item[item < pos.size]
        u0 = np.arange(0, units, 32 * plan.rows)
        unit = (u0[:, None, None] + 32 * np.arange(plan.rows)[None, :, None]
                + lane[None, None, :]).reshape(-1)
        unit = unit[unit < units]
        item, unit = np.repeat(item, unit.size), np.tile(unit, item.size)
    p = pos.reshape(-1)[item].astype(np.int64)
    lo = np.minimum(np.where(p < 0, -p, 0), span) * upr
    hi = np.clip(n_rows - p, 0, span) * upr
    return item, unit, (unit >= lo) & (unit < hi)


@pytest.mark.parametrize("span", [1, 8, 32])
def test_gather_plan_covers_every_output_unit(span):
    """For every row width of 1 to 160 bytes and every alignment of the
    table (0 to 15 bytes past 16), and ragged item counts: the unit is the
    widest of 16, 8, 4, 2, 1 bytes that divides the row and the address;
    the kernel's stores cover each unit of the output exactly once; and a
    unit reads the table exactly when its row lies inside it (positions
    before the table, at its last rows and past it)."""
    n_rows = 50
    for row_bytes in range(1, 161):
        for offset in range(16):
            for n_pos in (1, 37):
                plan = ga._gather_plan(n_pos, row_bytes, span, 4096 + offset)
                unit = next(v for v in (16, 8, 4, 2, 1)
                            if row_bytes % v == 0 and offset % v == 0)
                assert plan.unit == unit
                assert plan.units * unit == span * row_bytes
                assert (plan.mode == "rows") == (plan.units <= 32)
                pos = np.arange(n_pos, dtype=np.int64) % (n_rows + 8) - 4
                # long mode at its grid cap: a grid-stride loop of 2 blocks
                for p in (plan, plan._replace(blocks=2)) \
                        if plan.mode == "long" and n_pos > 16 else (plan,):
                    item, u, inside = _gather_model(p, pos, span,
                                                    row_bytes // unit, n_rows)
                    cover = np.bincount(item * plan.units + u,
                                        minlength=n_pos * plan.units)
                    assert (cover == 1).all(), (row_bytes, offset, n_pos)
                    row = pos[item] + u // (row_bytes // unit)
                    assert (inside == ((row >= 0) & (row < n_rows))).all()


def test_gather_plan_picks_the_shapes_of_the_paths():
    """8-byte extent rows: one lane a row; 72-byte payload rows: 9 lanes of
    8 bytes; SIFT vectors: 8 lanes of 16 bytes; 32-row slabs of 40-byte
    payload rows: long mode."""
    plan = ga._gather_plan(64 * 32768, 8, 1, 0)
    assert plan == ga.GatherPlan("rows", 8, 1, 4, 64 * 32768 // 1024)
    plan = ga._gather_plan(64 * 8192, 72, 1, 0)
    assert plan == ga.GatherPlan("rows", 8, 9, 4, -(-64 * 8192 // 96))
    assert ga._gather_plan(256 * 1024, 128, 1, 0)[:3] == ("rows", 16, 8)
    assert ga._gather_plan(256 * 1024, 40, 1, 0)[:3] == ("rows", 8, 5)
    plan = ga._gather_plan(256 * 32, 40, 32, 0)
    assert plan == ga.GatherPlan("long", 8, 160, 4, 256 * 32 // 8)
    assert ga._gather_plan(10 ** 8, 40, 32, 0).blocks == \
        ga.GATHER_LONG_BLOCKS
    with pytest.raises(ValueError):
        ga._gather_plan(0, 8, 1, 0)
    with pytest.raises(NotImplementedError):
        ga._gather_plan(ga.GATHER_ITEMS_MAX + 1, 8, 1, 0)


# --------------------------------------------------------------------------
# kernel D
# --------------------------------------------------------------------------

@pytest.mark.parametrize("first", range(1, 131, 10))
def test_segmented_reduce_square_matches_pallas(first):
    """Square mode at every segment length of 1 to 130: equal to the bit to
    the Pallas segmented_reduce of x * x (interpret mode) and to
    jnp.sum(x ** 2, -1) on integer-valued inputs (every sum below 2^24)."""
    rng = np.random.default_rng(first)
    for seg in range(first, first + 10):
        parts = 1 + seg % 3
        x = rng.integers(-255, 256, (8, parts * seg)).astype(np.float32)
        got = prim.segmented_reduce(torch.from_numpy(x), parts, square=True)
        pallas = PP.segmented_reduce(jnp.asarray(x * x), parts,
                                     interpret=True)
        fused = jnp.sum(jnp.asarray(x).reshape(8, parts, seg) ** 2, -1)
        np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
        np.testing.assert_array_equal(got.numpy(), np.asarray(fused))


def test_segmented_reduce_square_is_the_old_expression():
    """Square mode on the CPU is the plain sum of x * x, bit for bit, on
    fractional inputs too; plain mode is unchanged."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(0, 30, (64, 96)).astype(np.float32))
    for parts in (1, 4, 32):
        assert torch.equal(prim.segmented_reduce(x, parts, square=True),
                           prim.segmented_reduce_plain(x * x, parts))
        assert torch.equal(prim.segmented_reduce_plain(x, parts, True),
                           prim.segmented_reduce_plain(x * x, parts))
        assert torch.equal(prim.segmented_reduce(x, parts),
                           x.reshape(64, parts, -1).sum(-1))


def _shuffle_tree(partial, xor):
    """A group's shuffle reduction over the last axis (its lanes' partial
    sums, float32): __shfl_xor_sync or __shfl_down_sync steps, a lane with
    no source lane keeping its own value; lane 0's result."""
    s = partial.astype(np.float32)
    g = s.shape[-1]
    idx = np.arange(g)
    o = g // 2
    while o:
        src = idx ^ o if xor else np.where(idx + o < g, idx + o, idx)
        s = (s + s[..., src]).astype(np.float32)
        o //= 2
    return s[..., 0]


def _reduce_model(plan, x):
    """csrc/reduce.cu walked on numpy over (n_segments, seg) float32 x:
    (the segment sums lane 0 of each group writes, as written, and the
    count of reads of every element)."""
    n, seg = x.shape
    g, rows = plan.group, plan.rows
    groups = prim.REDUCE_THREADS // g
    full = (plan.blocks, groups, g, rows)
    block = np.arange(plan.blocks)[:, None, None, None]
    grp = np.arange(groups)[None, :, None, None]
    lane = np.arange(g)[None, None, :, None]
    r = np.arange(rows)[None, None, None, :]
    if plan.mode == "vec4":
        i = np.broadcast_to(block * groups * rows + r * groups + grp, full)
        steps = -(-(seg // 4) // g)
        v = lane[..., None] + g * np.arange(steps)          # (1,1,g,1,K)
        elem = np.broadcast_to(4 * v[..., None] + np.arange(4),
                               full + (steps, 4))
        ok = np.broadcast_to(v[..., None] < seg // 4, elem.shape)
    else:
        i = np.broadcast_to(block * groups + grp + 0 * r, full)
        steps = -(-seg // g)
        elem = np.broadcast_to(lane[..., None] + g * np.arange(steps),
                               full + (steps,))
        ok = elem < seg
    ii = np.broadcast_to(i.reshape(full + (1,) * (ok.ndim - 4)), ok.shape)
    ok = ok & (ii < n)
    reads = np.zeros(x.shape, np.int64)
    np.add.at(reads, (ii[ok], elem[ok]), 1)
    vals = np.where(ok, x[np.minimum(ii, n - 1), np.where(ok, elem, 0)], 0)
    partial = vals.reshape(ok.shape[:4] + (-1,)).sum(-1, dtype=np.float32)
    # (blocks, groups, g, rows) -> shuffle over the lanes of each group
    sums = _shuffle_tree(np.moveaxis(partial, 2, -1), plan.mode == "vec4")
    first = i[:, :, 0, :]
    written = np.zeros(n, np.int64)
    np.add.at(written, first[first < n], 1)
    assert (written == 1).all()
    out = np.zeros(n, np.float32)
    out[first[first < n]] = sums[first < n]
    return out, reads


@pytest.mark.parametrize("seg_range", [(1, 44), (44, 88), (88, 131)])
def test_reduce_plan_covers_every_element(seg_range):
    """For every segment length of 1 to 130, an aligned and a misaligned
    input, and ragged segment counts: vec4 mode exactly where seg % 4 == 0
    and the input is 16-byte aligned, groups of a power of two lanes inside
    a warp, every element read exactly once and each segment written once,
    and the lanes' sums through the shuffle tree equal the plain sums to the
    bit on integer-valued inputs."""
    rng = np.random.default_rng(seg_range[0])
    for seg in range(*seg_range):
        for addr in (4096, 4100):
            for n in (1, 3, 67):
                plan = prim._reduce_plan(n, seg, addr)
                vec = seg % 4 == 0 and addr % 16 == 0
                assert plan.mode == ("vec4" if vec else "scalar")
                g = plan.group
                assert g & (g - 1) == 0 and 32 % g == 0
                if vec:
                    assert g == min(32, 1 << (seg // 4 - 1).bit_length())
                else:
                    assert g <= seg and (2 * g > min(seg, 32))
                x = rng.integers(-255, 256, (n, seg)).astype(np.float32)
                out, reads = _reduce_model(plan, x)
                assert (reads == 1).all(), (seg, addr, n)
                np.testing.assert_array_equal(out, x.sum(-1))


def test_reduce_plan_picks_the_shapes_of_the_paths():
    """The encode norms (65536, 128) -> 4 and -> 32 and the query norms
    take vec4 mode; a misaligned input takes scalar mode."""
    assert prim._reduce_plan(65536 * 4, 32, 0) == prim.ReducePlan(
        "vec4", 8, 4, 65536 * 4 // 128)
    assert prim._reduce_plan(65536 * 32, 4, 0) == prim.ReducePlan(
        "vec4", 1, 4, 65536 * 32 // 1024)
    assert prim._reduce_plan(256 * 16, 8, 0)[:2] == ("vec4", 2)
    assert prim._reduce_plan(256, 128, 0)[:2] == ("vec4", 32)
    assert prim._reduce_plan(256, 128, 4)[:3] == ("scalar", 32, 1)
    assert prim._reduce_plan(5, 7, 0)[:2] == ("scalar", 4)
    with pytest.raises(ValueError):
        prim._reduce_plan(0, 32, 0)
    with pytest.raises(NotImplementedError):
        prim._reduce_plan(prim.REDUCE_SEGMENTS_MAX + 1, 4, 0)


@pytest.mark.parametrize("table", ["part", "subpart"])
def test_distance_tables_square_inside_kernel_d(table, monkeypatch):
    """The tables' norms go to kernel D in square mode, with the float
    input itself: no x * x pass before it."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, 256, (6, 32)).astype(np.uint8))
    seen = []

    def recorder(xx, parts, square=False):
        seen.append((xx, parts, square))
        return prim.segmented_reduce(xx, parts, square=square)

    monkeypatch.setattr(TDIST, "segmented_reduce", recorder)
    if table == "part":
        cb = torch.from_numpy(rng.normal(0, 50, (4, 16, 8)).astype(np.float32))
        out = TDIST.part_sqdist_tables(x, cb)
        want = ((x.float().reshape(6, 4, 1, 8) - cb[None]) ** 2).sum(-1)
    else:
        cents = torch.from_numpy(rng.normal(0, 50, (16, 32)).astype(np.float32))
        out = TDIST.subpart_sqdist_tables(x, cents, 8)
        want = ((x.float().reshape(6, 1, 8, 4)
                 - cents.reshape(1, 16, 8, 4)) ** 2).sum(-1).transpose(1, 2)
    assert len(seen) == 1
    xx, parts, square = seen[0]
    assert square and parts == (4 if table == "part" else 8)
    assert torch.equal(xx, x.float())
    torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-1)
