"""Row top-k, row prefix sum, segment sums and the exact re-rank's
distances: hand-written CUDA kernels and plain versions.

`bitonic_topk` (kernel A, csrc/topk.cu), `block_scan` (kernel B,
csrc/scan.cu) and `segmented_reduce` (kernel D, csrc/reduce.cu) replace the
TPU kernels of the same names in pqt_tpu/ops/pallas/primitives.py.
`gather_sqdist` (csrc/sqdist.cu) is kernels H and D redesigned for the job
the exact re-rank gives them together: each candidate's raw row read once
through its position and its squared distance to the query written.  On a
CPU tensor each wrapper runs its plain PyTorch version; on a CUDA tensor it
launches its kernel or raises.
Each wrapper counts its launches in its `launches` attribute.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from pqt_tpu_torch.ops.cuda import build

# Kernel A's limits and its choice between modes (csrc/topk.cu).  One block
# sorts at most TOPK_SORT_MAX (value, index) pairs in shared memory (8 bytes
# a pair, 128 KB): the whole row in sort mode, the k survivors in select
# mode.  Select mode takes rows up to TOPK_SELECT_MAX_ROW elements, held in
# registers up to TOPK_SELECT_ITEMS[-1] x TOPK_SELECT_THREADS = 16384 and,
# on the one-block route, read again on every pass above that.  Merge mode
# keeps more than TOPK_SORT_MAX, up to TOPK_MERGE_MAX: on the one-block
# route the select's survivors (or the whole row) sorted in runs of
# TOPK_SORT_MAX, then merged in device memory, TOPK_MERGE_TILE outputs a
# block.  Longer rows take the cluster route below.
TOPK_SORT_MAX = 16384
TOPK_SELECT_MAX_ROW = 1 << 30
TOPK_MERGE_MAX = 1 << 20
TOPK_MERGE_TILE = 4096
TOPK_SELECT_THREADS = 512
TOPK_SELECT_ITEMS = (4, 8, 16, 32)
TOPK_DIGIT_BITS = 8
# Rows of at most TOPK_SORT_ROW elements, and k above n / 2, sort the whole
# row: on the H100 the full sort beat the select's passes there, and lost
# to them on longer rows with k <= n / 2 (chip_smoke.py times both modes at
# every top-k shape; PERF.md).
TOPK_SORT_ROW = 512
# The cluster route (csrc/topk.cu, pqt_topk_cluster) of select and merge
# mode: one thread-block cluster of C blocks of TOPK_CLUSTER_THREADS a row,
# C the smallest of TOPK_CLUSTER_SIZES that holds the row (8 at most, the
# portable cluster size).  A block keeps a slice of ceil(n / C) elements,
# rounded up to a multiple of TOPK_CLUSTER_THREADS, in registers, 16 or 32 a
# thread (TOPK_SELECT_ITEMS[-2:]), so the row is read once.  Select mode
# selects each slice's k smallest and sorts the C x k candidates in one
# block (at most TOPK_SORT_MAX); merge mode sorts ceil(k / C) pairs a
# block, rounded up likewise, at most TOPK_CLUSTER_RUN, in the cluster's
# shared memory.
TOPK_CLUSTER_THREADS = 512
TOPK_CLUSTER_SIZES = (4, 8)
TOPK_CLUSTER_RUN = 8192
# The cut between the routes, from chip_sweep.py's timings of both on the
# H100 (`--only topk`: chip_smoke.py's shapes, a ladder of k at (256, 65536)
# and a ladder of row lengths from 20000 to 131072; PERF.md): rows of more
# than TOPK_SORT_MAX and at most TOPK_CLUSTER_MAX_ROW elements take the
# cluster route in merge mode (faster at every length and k measured), and
# in select mode up to k = TOPK_CLUSTER_SELECT_MAX_K (from k = 512 on, the
# sort of C x k candidates in one block made it slower than the one-block
# select).  Longer rows and larger selects keep the one-block route.
TOPK_CLUSTER_MAX_ROW = (TOPK_CLUSTER_SIZES[-1] * TOPK_SELECT_ITEMS[-1]
                        * TOPK_CLUSTER_THREADS)
TOPK_CLUSTER_SELECT_MAX_K = 256
# Kernel B's modes (csrc/scan.cu): rows of at most SCAN_ROWS_MAX elements,
# and rows of at most SCAN_ROWS_WALK_MAX when there are SCAN_MANY_ROWS rows
# or more, are scanned in rows mode, up to SCAN_ROWS_WARPS warps a block, a
# group of warps a row (several rows a block when rows are short), 2 16-byte
# vectors a lane a chunk for rows up to SCAN_ROWS_SHORT elements and 8
# above; rows mode walks rows of at most SCAN_ROWS_WALK_MAX.  Other rows
# take onepass mode: tiles of SCAN_TILE_WARPS warps x SCAN_TILE_VECS
# vectors x 32 lanes x 4 elements (fixed in csrc/scan.cu), one block each,
# scanned with a decoupled look-back.  The cut comes from chip_sweep.py's
# ladder of row lengths on the H100, the shapes from sweeps of launch
# shapes there (PERF.md).
SCAN_ROWS_MAX = 16384
SCAN_ROWS_SHORT = 2048
SCAN_ROWS_WALK_MAX = 1 << 16
SCAN_MANY_ROWS = 128
SCAN_ROWS_WARPS = 8
SCAN_TILE_WARPS = 8
SCAN_TILE_VECS = 8
SCAN_TILES_MAX = (1 << 31) - 1
# Onepass status words carry a 30-bit epoch (csrc/scan.cu).
SCAN_EPOCH_MAX = (1 << 30) - 1
# Kernel D's launch shape (csrc/reduce.cu): vec4 mode (16-byte loads) keeps
# REDUCE_ROWS segments in flight a group of lanes (fixed in csrc/reduce.cu).
# Segment indices are 32-bit.
REDUCE_THREADS = 256
REDUCE_ROWS = 4
REDUCE_SEGMENTS_MAX = (1 << 31) - 1 - (1 << 20)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _on_cpu(table: torch.Tensor, index: torch.Tensor, what: str) -> bool:
    """Check what a table kernel takes, on any device (so the CPU runs catch
    a caller that would fail on the card); True for CPU tensors, which run
    the plain version."""
    if (not table.is_contiguous() or not index.is_contiguous()
            or index.dtype != torch.int32):
        raise ValueError(f"{what}: expected a contiguous table and contiguous "
                         f"int32 indices, got {table.dtype} (contiguous: "
                         f"{table.is_contiguous()}) and {index.dtype} "
                         f"(contiguous: {index.is_contiguous()})")
    if table.device.type == "cpu" and index.device.type == "cpu":
        return True
    if table.device.type != "cuda" or index.device != table.device:
        raise ValueError(f"{what}: expected CPU tensors or tensors on one "
                         f"CUDA device, got {table.device} and "
                         f"{index.device}")
    return False


def _check_input(x: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: expected a CPU or CUDA tensor, got "
                         f"{x.device}")
    if x.dtype != dtype or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous 2-D {dtype} tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")


def bitonic_topk_plain(x: torch.Tensor, k: int):
    """Per-row k smallest values, ascending, ties lowest index first."""
    vals, idx = torch.sort(x, dim=-1, stable=True)
    return vals[:, :k], idx[:, :k].to(torch.int32)


class TopkPlan(NamedTuple):
    """How kernel A runs a (rows, n) -> k call."""
    mode: str       # "sort" (the whole row), "select" (radix select +
                    # sort) or "merge" (select + a sort of k > 16384 pairs)
    items: int      # keys a select thread holds per tile (0 in sort mode)
    threads: int    # threads of a (select) block, one block per row, or of
                    # each block of a row's cluster
    sort_len: int   # pairs the block sorts: n or k, up to a power of two;
                    # merge mode: pairs of a scratch row, whole runs, or on
                    # the cluster route the pairs each block sorts
    cluster: int = 0    # blocks of a row's cluster (0: one block a row)


def _pow2_at_least(v: int) -> int:
    return 1 << max(1, (v - 1).bit_length())


def _round_up(v: int, step: int) -> int:
    return -(-v // step) * step


def _select_shape(n: int):
    """(items, threads) of a select block over rows of n elements."""
    items = next((i for i in TOPK_SELECT_ITEMS
                  if n <= i * TOPK_SELECT_THREADS), TOPK_SELECT_ITEMS[-1])
    needed = -(-n // items)                   # threads that hold the row
    return items, min(TOPK_SELECT_THREADS, 32 * -(-needed // 32))


def _cluster_plan(n: int, k: int, mode: str,
                  blocks: Optional[int] = None) -> Optional[TopkPlan]:
    """The cluster route's plan for rows of n elements, k kept, in select
    or merge mode: the smallest cluster size (or `blocks`) whose blocks
    hold a slice of the row in registers and, in select mode, whose
    candidates (each block's k smallest) block 0 sorts in shared memory
    (at most TOPK_SORT_MAX), in merge mode whose blocks hold their share of
    the k pairs in shared memory; None where none does."""
    T = TOPK_CLUSTER_THREADS
    for c in (blocks,) if blocks else TOPK_CLUSTER_SIZES:
        piece = _round_up(-(-n // c), T)
        items = next((i for i in TOPK_SELECT_ITEMS[-2:] if piece <= i * T),
                     None)
        if items is None:
            continue
        if mode == "select":
            # block 0 sorts every block's k smallest of its slice
            sort_len = _pow2_at_least(min(n, c * k))
            if sort_len <= TOPK_SORT_MAX:
                return TopkPlan("select", items, T, sort_len, c)
            continue
        per_block = _round_up(-(-k // c), T)
        if per_block <= TOPK_CLUSTER_RUN:
            return TopkPlan("merge", items, T, per_block, c)
    return None


def _topk_plan(n: int, k: int, mode: Optional[str] = None,
               cluster: Optional[int] = None) -> TopkPlan:
    """Kernel A's mode, route and launch shape for rows of n elements, k
    kept.

    Sort mode for rows of at most TOPK_SORT_ROW elements and for k above
    n / 2 (rows of at most TOPK_SORT_MAX), select mode for other k up to
    TOPK_SORT_MAX, merge mode for k above it; `mode` forces one.  Merge,
    and select up to k = TOPK_CLUSTER_SELECT_MAX_K, take the cluster route
    for rows of more than TOPK_SORT_MAX and at most TOPK_CLUSTER_MAX_ROW
    elements where a cluster holds them, one block a row otherwise;
    `cluster` forces the one-block route (0) or a cluster of that many
    blocks.  Raises NotImplementedError for what no mode takes: a sort of
    more than TOPK_SORT_MAX elements, a select of more than TOPK_SORT_MAX,
    a merge of more than TOPK_MERGE_MAX, a row longer than
    TOPK_SELECT_MAX_ROW, or a cluster that does not hold the row.
    """
    if not 1 <= k <= n:
        raise ValueError(f"bitonic_topk: k={k} outside [1, {n}]")
    if mode is None:
        short = n <= TOPK_SORT_ROW or 2 * k > n
        if short and n <= TOPK_SORT_MAX:
            mode = "sort"
        else:
            mode = "select" if k <= TOPK_SORT_MAX else "merge"
    if mode == "sort":
        if n > TOPK_SORT_MAX or cluster:
            raise NotImplementedError(
                f"bitonic_topk: a sort of rows of {n} > {TOPK_SORT_MAX} "
                "elements, or on a cluster")
        sort_len = _pow2_at_least(n)
        return TopkPlan("sort", 0, min(1024, sort_len // 2), sort_len)
    if mode not in ("select", "merge"):
        raise ValueError(f"bitonic_topk: unknown mode {mode!r}")
    cap = TOPK_SORT_MAX if mode == "select" else TOPK_MERGE_MAX
    if k > cap or n > TOPK_SELECT_MAX_ROW:
        raise NotImplementedError(
            f"bitonic_topk: k={k} of rows of {n} elements ({mode} mode keeps "
            f"k <= {cap} of rows up to {TOPK_SELECT_MAX_ROW})")
    if cluster is None:
        faster = TOPK_SORT_MAX < n <= TOPK_CLUSTER_MAX_ROW and (
            mode == "merge" or k <= TOPK_CLUSTER_SELECT_MAX_K)
        plan = _cluster_plan(n, k, mode) if faster else None
        if plan is not None:
            return plan
    elif cluster:
        plan = _cluster_plan(n, k, mode, cluster)
        if plan is None or cluster > TOPK_CLUSTER_SIZES[-1]:
            raise NotImplementedError(
                f"bitonic_topk: no cluster of {cluster} blocks holds "
                f"rows of {n} elements, k={k}, in {mode} mode")
        return plan
    if mode == "select":
        return TopkPlan("select", *_select_shape(n), _pow2_at_least(k))
    # the merge mode's select runs the row tile by tile (32 keys a thread)
    return TopkPlan("merge", TOPK_SELECT_ITEMS[-1], _select_shape(n)[1],
                    max(TOPK_SORT_MAX, _pow2_at_least(k)))


def _topk_launch(x: torch.Tensor, k: int, plan: TopkPlan):
    """Launch kernel A on a contiguous (B, N) float32 CUDA tensor."""
    B, N = x.shape
    out_v = torch.empty((B, k), dtype=torch.float32, device=x.device)
    out_i = torch.empty((B, k), dtype=torch.int32, device=x.device)
    if B == 0:
        return out_v, out_i
    lib = build.load("topk")
    with torch.cuda.device(x.device):
        if plan.cluster:
            err = lib.pqt_topk_cluster(_ptr(x), B, N, k, plan.cluster,
                                       plan.items, plan.threads,
                                       plan.sort_len,
                                       int(plan.mode == "merge"),
                                       _ptr(out_v), _ptr(out_i), _stream(x))
        elif plan.mode == "merge":
            scratch = [torch.empty((B, plan.sort_len), dtype=dt,
                                   device=x.device)
                       for dt in (torch.float32, torch.int32) * 2]
            err = lib.pqt_topk_merge(_ptr(x), B, N, k, plan.threads,
                                     plan.sort_len,
                                     *(_ptr(t) for t in scratch),
                                     _ptr(out_v), _ptr(out_i), _stream(x))
        else:
            err = lib.pqt_topk(_ptr(x), B, N, k, int(plan.mode == "select"),
                               plan.items, plan.threads, plan.sort_len,
                               _ptr(out_v), _ptr(out_i), _stream(x))
    build.check(err, "bitonic_topk")
    bitonic_topk.launches += 1
    bitonic_topk.mode_launches[plan.mode] += 1
    bitonic_topk.cluster_launches += bool(plan.cluster)
    return out_v, out_i


def bitonic_topk(x: torch.Tensor, k: int):
    """Per-row smallest-k (values, int32 indices) of a (B, N) float32 array.

    Values come out ascending and ties lowest index first, like `lax.top_k`
    of the negated row and a stable ascending sort (-0.0 and +0.0 equal, as
    in the sort).  Inputs must not be NaN.  On the card the kernel runs in
    the mode and on the route `_topk_plan` picks; any N up to
    TOPK_SELECT_MAX_ROW, with k up to TOPK_MERGE_MAX.
    `bitonic_topk.mode_launches` counts the launches by mode,
    `bitonic_topk.cluster_launches` those on the cluster route.
    """
    _, N = x.shape
    plan = _topk_plan(N, k)
    if x.device.type == "cpu":
        return bitonic_topk_plain(x, k)
    _check_input(x, torch.float32, "bitonic_topk")
    return _topk_launch(x, k, plan)


bitonic_topk.launches = 0
bitonic_topk.mode_launches = {"sort": 0, "select": 0, "merge": 0}
bitonic_topk.cluster_launches = 0


def block_scan_plain(x: torch.Tensor, exclusive: bool = False):
    """Per-row int32 prefix sum (inclusive, or exclusive)."""
    s = torch.cumsum(x, dim=-1, dtype=torch.int32)
    return s - x if exclusive else s


class ScanPlan(NamedTuple):
    """How kernel B runs a (rows, n) call."""
    mode: str     # "rows" (a group of warps walks a row) or "onepass"
    warps: int    # warps of a block
    vecs: int     # 16-byte vectors (4 int32) a lane holds per chunk
    group: int    # warps that scan one row together (= warps in onepass)
    tiles: int    # chunks of a row: walked in turn (rows), tiles (onepass)
    blocks: int   # blocks of the grid


def _scan_vectors(n: int) -> int:
    """16-byte vectors a row of n int32 touches at most: a row that does not
    start on a multiple of 4 elements spans one more (csrc/scan.cu)."""
    return n // 4 if n % 4 == 0 else (n + 6) // 4


def _scan_plan(rows: int, n: int, mode: Optional[str] = None) -> ScanPlan:
    """Kernel B's mode and launch shape for `rows` rows of n elements.

    Rows mode for n <= SCAN_ROWS_MAX, and for n <= SCAN_ROWS_WALK_MAX with
    at least SCAN_MANY_ROWS rows; onepass mode otherwise; `mode` forces
    one.  Raises ValueError for an empty shape or an unknown mode and
    NotImplementedError for a call the mode does not take: rows mode beyond
    SCAN_ROWS_WALK_MAX elements a row, onepass mode beyond SCAN_TILES_MAX
    tiles.
    """
    if rows < 1 or n < 1:
        raise ValueError(f"block_scan: empty shape ({rows}, {n})")
    if mode is None:
        many = rows >= SCAN_MANY_ROWS and n <= SCAN_ROWS_WALK_MAX
        mode = "rows" if n <= SCAN_ROWS_MAX or many else "onepass"
    if mode not in ("rows", "onepass"):
        raise ValueError(f"block_scan: unknown mode {mode!r}")
    nvec = _scan_vectors(n)
    if mode == "rows":
        if n > SCAN_ROWS_WALK_MAX:
            raise NotImplementedError(
                f"block_scan: rows mode walks rows of at most "
                f"{SCAN_ROWS_WALK_MAX} elements, not {n}")
        vecs = 2 if n <= SCAN_ROWS_SHORT else 8
        group = min(SCAN_ROWS_WARPS, -(-nvec // (32 * vecs)))
        per_block = max(1, min(rows, SCAN_ROWS_WARPS // group))
        tiles = -(-nvec // (group * 32 * vecs))
        return ScanPlan("rows", group * per_block, vecs, group, tiles,
                        -(-rows // per_block))
    tiles = -(-nvec // (SCAN_TILE_WARPS * 32 * SCAN_TILE_VECS))
    if rows * tiles > SCAN_TILES_MAX:
        raise NotImplementedError(
            f"block_scan: ({rows}, {n}) makes {rows * tiles} tiles in "
            f"onepass mode, above {SCAN_TILES_MAX}")
    return ScanPlan("onepass", SCAN_TILE_WARPS, SCAN_TILE_VECS,
                    SCAN_TILE_WARPS, tiles, rows * tiles)


# Onepass mode's status words, kept from call to call by eager launches:
# (device, stream) -> [int64 tensor (the tile counter, then one word a
# tile), last epoch].  A launch captured into a CUDA graph never uses them
# (`_scan_status`).
_scan_states: dict = {}


def _scan_state(x: torch.Tensor, words: int):
    """The persistent status buffer of x's device and current stream, at
    least `words` long, and the next epoch.  A new buffer (zeroed) replaces
    one that is too short or whose epochs are used up."""
    key = (x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    state = _scan_states.get(key)
    if state is None or state[0].numel() < words or \
            state[1] >= SCAN_EPOCH_MAX:
        state = [torch.zeros(words, dtype=torch.int64, device=x.device), 0]
        _scan_states[key] = state
    state[1] += 1
    return state[0], state[1]


def _scan_status(x: torch.Tensor, words: int):
    """Onepass mode's status words and epoch for a launch on x's device and
    current stream.

    Eager: the persistent buffer and its next epoch (`_scan_state`).  Under
    CUDA graph capture the epoch would be baked into the graph, and a
    replay would read the words the previous replay left as current; so a
    captured launch gets words of its own, zeroed by a node of the same
    graph before every replay, and epoch 1.  They come from the graph's
    private pool, which the graph keeps, and the persistent buffer is
    neither read nor replaced by a capture."""
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(words, dtype=torch.int64, device=x.device), 1
    return _scan_state(x, words)


def _scan_launch(x: torch.Tensor, exclusive: bool,
                 plan: ScanPlan) -> torch.Tensor:
    """Launch kernel B on a contiguous (B, N) int32 CUDA tensor.  In onepass
    mode the status words and epoch come from `_scan_status`."""
    B, N = x.shape
    out = torch.empty((B, N), dtype=torch.int32, device=x.device)
    lib = build.load("scan")
    with torch.cuda.device(x.device):
        if plan.mode == "rows":
            err = lib.pqt_block_scan_rows(_ptr(x), B, N, int(exclusive),
                                          plan.warps, plan.group, plan.vecs,
                                          _ptr(out), _stream(x))
        else:
            state, epoch = _scan_status(x, 1 + B * plan.tiles)
            err = lib.pqt_block_scan_onepass(
                _ptr(x), B, N, int(exclusive), plan.tiles, _ptr(state),
                epoch, _ptr(out), _stream(x))
    build.check(err, "block_scan")
    block_scan.launches += 1
    return out


def block_scan(x: torch.Tensor, exclusive: bool = False):
    """Per-row prefix sums of a (B, N) int32 array, int32 out.

    The sum of each row must fit in int32.  On the card the kernel runs in
    the mode `_scan_plan` picks: rows mode for short rows (and for many
    rows up to SCAN_ROWS_WALK_MAX), onepass mode (a decoupled look-back,
    one read and one write of the row) for the others, such as the build's
    CSR prefix.
    """
    if x.device.type == "cpu":
        return block_scan_plain(x, exclusive)
    _check_input(x, torch.int32, "block_scan")
    B, N = x.shape
    if B == 0 or N == 0:
        return torch.empty_like(x)
    return _scan_launch(x, exclusive, _scan_plan(B, N))


block_scan.launches = 0


def segmented_reduce_plain(x: torch.Tensor, parts: int,
                           square: bool = False) -> torch.Tensor:
    """Per-row sums over `parts` equal contiguous segments (of x * x with
    `square`)."""
    if square:
        return segmented_reduce_plain(x * x, parts)
    B, D = x.shape
    return x.reshape(B, parts, D // parts).sum(-1)


class ReducePlan(NamedTuple):
    """How kernel D runs a sum over n_segments segments of seg elements."""
    mode: str     # "vec4" (16-byte loads) or "scalar" (4-byte loads)
    group: int    # lanes that sum one segment
    rows: int     # segments a group has in flight (1 in scalar mode)
    blocks: int   # blocks of REDUCE_THREADS threads


def _reduce_plan(n_segments: int, seg: int, addr: int) -> ReducePlan:
    """Kernel D's mode and launch shape; `addr` is the input's address.
    vec4 mode where seg % 4 == 0 and the input is 16-byte aligned, a group
    of the smallest power of two >= seg / 4 lanes (at most 32) a segment
    and REDUCE_ROWS segments in flight a group; scalar mode otherwise, a
    group of the largest power of two <= min(seg, 32) lanes a segment.
    Raises ValueError for an empty shape, NotImplementedError beyond
    REDUCE_SEGMENTS_MAX segments."""
    if n_segments < 1 or seg < 1:
        raise ValueError(f"segmented_reduce: empty shape ({n_segments} "
                         f"segments of {seg})")
    if n_segments > REDUCE_SEGMENTS_MAX:
        raise NotImplementedError(
            f"segmented_reduce: {n_segments} segments, above "
            f"{REDUCE_SEGMENTS_MAX}")
    if seg % 4 == 0 and addr % 16 == 0:
        group = min(32, _pow2_at_least(seg // 4)) if seg > 4 else 1
        per_block = REDUCE_THREADS // group * REDUCE_ROWS
        return ReducePlan("vec4", group, REDUCE_ROWS,
                          -(-n_segments // per_block))
    group = 1 << (min(seg, 32).bit_length() - 1)
    return ReducePlan("scalar", group, 1,
                      -(-n_segments // (REDUCE_THREADS // group)))


def segmented_reduce(x: torch.Tensor, parts: int,
                     square: bool = False) -> torch.Tensor:
    """(B, D) float32 -> (B, parts) float32: the sum of each of the `parts`
    equal contiguous segments of every row (D % parts == 0, any D); with
    `square`, the sums of x * x, x read once.  On the card the kernel runs
    in the mode `_reduce_plan` picks."""
    B, D = x.shape
    if parts < 1 or D % parts:
        raise ValueError(f"segmented_reduce: D={D} is not a multiple of "
                         f"parts={parts}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("segmented_reduce: expected a contiguous float32 "
                         f"tensor, got {x.dtype}")
    if x.device.type == "cpu":
        return segmented_reduce_plain(x, parts, square)
    _check_input(x, torch.float32, "segmented_reduce")
    if B == 0 or D == 0:
        return torch.zeros((B, parts), dtype=torch.float32, device=x.device)
    out = torch.empty((B, parts), dtype=torch.float32, device=x.device)
    plan = _reduce_plan(B * parts, D // parts, x.data_ptr())
    lib = build.load("reduce")
    with torch.cuda.device(x.device):
        err = lib.pqt_segmented_reduce(_ptr(x), B * parts, D // parts,
                                       int(square), int(plan.mode == "vec4"),
                                       plan.group, plan.blocks, _ptr(out),
                                       _stream(x))
    build.check(err, "segmented_reduce")
    segmented_reduce.launches += 1
    return out


segmented_reduce.launches = 0


def gather_sqdist_plain(tab: torch.Tensor, pos: torch.Tensor,
                        q: torch.Tensor) -> torch.Tensor:
    return ((tab[pos.long()].to(torch.float32) - q[:, None, :]) ** 2).sum(-1)


def gather_sqdist(tab: torch.Tensor, pos: torch.Tensor,
                  q: torch.Tensor) -> torch.Tensor:
    """The exact re-rank's squared distances, kernels H and D fused
    (csrc/sqdist.cu): tab (N, dim) uint8 or float32 rows, pos (B, K) int32
    rows of tab, every one in [0, N), q (B, dim) float32 queries -> (B, K)
    float32, out[b, k] = sum_j (float(tab[pos[b, k], j]) - q[b, j])^2.

    Validity stays with the caller: map an invalid slot to row 0 and mask
    its distance.  With uint8 rows and integer-valued queries at dim 128
    the result is exact and equals the plain version to the bit; otherwise
    they differ by the order of the additions.
    """
    if tab.dim() != 2 or tab.dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"gather_sqdist: expected a 2-D uint8 or float32 "
                         f"table, got {tab.dtype} {tuple(tab.shape)}")
    if (pos.dim() != 2 or q.dtype != torch.float32 or not q.is_contiguous()
            or tuple(q.shape) != (pos.shape[0], tab.shape[1])):
        raise ValueError(f"gather_sqdist: expected (B, K) positions and "
                         f"contiguous (B, {tab.shape[1]}) float32 queries, "
                         f"got {tuple(pos.shape)} and {q.dtype} "
                         f"{tuple(q.shape)}")
    if _on_cpu(tab, pos, "gather_sqdist"):
        if q.device.type != "cpu":
            raise ValueError(f"gather_sqdist: queries on {q.device}, rows on "
                             "the CPU")
        return gather_sqdist_plain(tab, pos, q)
    if q.device != tab.device:
        raise ValueError(f"gather_sqdist: queries on {q.device}, rows on "
                         f"{tab.device}")
    B, K = pos.shape
    out = torch.empty((B, K), dtype=torch.float32, device=tab.device)
    if out.numel() == 0:
        return out
    lib = build.load("sqdist")
    with torch.cuda.device(tab.device):
        err = lib.pqt_gather_sqdist(_ptr(tab), tab.shape[0], tab.shape[1],
                                    tab.element_size(), _ptr(pos), B, K,
                                    _ptr(q), _ptr(out), _stream(tab))
    build.check(err, "gather_sqdist")
    gather_sqdist.launches += 1
    return out


gather_sqdist.launches = 0
