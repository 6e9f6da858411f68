"""The port's tracing: stage marks on the device and spans on the host.

Marks and spans follow torch.profiler: they are live exactly while a
profiler session records (`enabled()`, the profiler's own state, one C
call).  Otherwise each costs that one check and nothing on the device.
There is no switch of the port's own.

Stage marks (`mark`).  A mark is one launch of the one-thread kernel
`pqt_stage_mark_kernel<id>` (csrc/mark.cu), which does nothing; the id is
part of the kernel's name in a trace, and STAGES maps it to the stage's
name.  Each stage gets one mark where it starts, and each entry one where
it ends (`*.end`); the device work between two marks belongs to the first
of them.  Inside a CUDA graph capture a mark is always recorded, and the
graph layer (utils/graphs.py) keeps its node with the entry and enables it
on a replay only while the profiler records (`GraphMarks`): a replay with
the profiler off runs no mark, and the profiler never changes a graph's
key.  Outside a capture a mark is launched only while the profiler
records, and never for a tensor that is not on a card.

The stages, in the order one call marks them:

  * `query.tables`, `query.pair`, `query.probe`, `query.candidates`,
    `query.rerank`, `query.end` (models/query.py): the distance tables and
    the L1 top-k; the rest of the pair stage (kernel A's pair select);
    the bins' enumeration and probe (H's extent rows, B's compaction); the
    candidates' positions and C's line distances; the exact re-rank or the
    line top-k, and the padding of the answers;
  * `encode.part_codes`, `encode.payload`, `encode.end` (models/db.py, one
    chunk): the part codes and the bin hash; the line codes (kernel L),
    the packing and the pair marks;
  * `build.upload`, `build.encode`, `build.assemble`, `build.end`
    (models/db.py `build_database`; the out-of-core encode and
    models/multidb.py's build mark them too, the out-of-core encode
    without `build.assemble`): the allocations and the first chunk's
    copy (the later chunks' copies overlap the encodes); the chunk
    encodes; the CSR assembly.

Host spans (`span`) are record_function ranges, live only while the
profiler records, around host work that launches nothing: the profiler
mirrors a range that encloses a launch onto the device's timeline, where
it would read as device work.  No range of the port encloses a launch.
The spans: `pqt.graph.key` and `pqt.graph.count` (utils/graphs.py), and
`pqt.build.stage` and `pqt.build.wait` (models/db.py `_row_chunks`), a
build's fill of a pinned slot with host rows and its wait for a slot.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

STAGES = ("query.tables", "query.pair", "query.probe", "query.candidates",
          "query.rerank", "query.end",
          "encode.part_codes", "encode.payload", "encode.end",
          "build.upload", "build.encode", "build.assemble", "build.end")
# the mark kernel's name, a part of the name a trace gives each mark
MARK_KERNEL = "pqt_stage_mark_kernel"
_ID = {name: i for i, name in enumerate(STAGES)}

enabled = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()


def span(name: str):
    """A record_function range named `name` while the profiler records;
    a context that does nothing otherwise.  It must enclose no launch."""
    if enabled():
        return torch.autograd.profiler.record_function(name)
    return _NULL


def mark(stage: str, device: torch.device) -> None:
    """Mark where `stage` starts (or, for `*.end`, where its entry ends) on
    `device`'s current stream: always under a capture, and otherwise only
    while the profiler records."""
    if enabled() or (device.type == "cuda"
                     and torch.cuda.is_current_stream_capturing()):
        _launch(_ID[stage], device)


def _launch(stage_id: int, device: torch.device) -> None:
    """One mark kernel on `device`'s current stream (nothing off a card)."""
    if device.type != "cuda":
        return
    from pqt_tpu_torch.ops.cuda import build
    lib = build.load("mark")
    with torch.cuda.device(device):
        err = lib.pqt_stage_mark(stage_id, ctypes.c_void_p(
            torch.cuda.current_stream(device).cuda_stream))
    build.check(err, "stage mark")


def _nodes_of(graph) -> list:
    """The mark nodes of a captured torch.cuda.CUDAGraph kept with
    keep_graph=True: [(node handle, stage id)] in the graph's node order
    (none for anything else)."""
    if not isinstance(graph, torch.cuda.CUDAGraph):
        return []
    from pqt_tpu_torch.ops.cuda import build
    lib = build.load("mark")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_int(0)
    cap = 64
    while True:
        nodes = (ctypes.c_void_p * cap)()
        ids = (ctypes.c_int * cap)()
        build.check(lib.pqt_graph_marks(raw, nodes, ids, cap,
                                        ctypes.byref(count)),
                    "finding a graph's mark nodes")
        if count.value <= cap:
            return [(nodes[i], ids[i]) for i in range(count.value)]
        cap = count.value


def _exec_of(graph) -> int:
    return graph.raw_cuda_graph_exec()


def _set_enabled(device: torch.device, graph_exec: int, node,
                 on: bool) -> None:
    from pqt_tpu_torch.ops.cuda import build
    with torch.cuda.device(device):
        err = build.load("mark").pqt_graph_node_set_enabled(
            ctypes.c_void_p(graph_exec), ctypes.c_void_p(node), int(on))
    build.check(err, "switching a mark node")


def node_enabled(graph_exec: int, node) -> bool:
    """Whether a node of an instantiated graph is enabled
    (cudaGraphNodeGetEnabled)."""
    from pqt_tpu_torch.ops.cuda import build
    on = ctypes.c_int(0)
    build.check(build.load("mark").pqt_graph_node_get_enabled(
        ctypes.c_void_p(graph_exec), ctypes.c_void_p(node),
        ctypes.byref(on)), "reading a mark node")
    return bool(on.value)


class GraphMarks:
    """The mark nodes of an entry's instantiated graphs, enabled exactly
    while the profiler records: `sync()` before each replay compares the
    profiler's state with the nodes' and switches them only when the two
    differ.  `graphs`: [(device, graph)]; `nodes`: [(device, graph exec
    handle, node handle, stage id)]."""

    def __init__(self, graphs):
        self.nodes = [(d, _exec_of(g), node, i) for d, g in graphs
                      for node, i in _nodes_of(g)]
        self.on = True                  # as captured
        self.sync()

    def sync(self) -> None:
        if not self.nodes:
            return
        on = enabled()
        if on != self.on:
            for d, graph_exec, node, _ in self.nodes:
                _set_enabled(d, graph_exec, node, on)
            self.on = on
