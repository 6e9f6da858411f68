"""Compiled query programs: each serving entry point captured once per
static key as a CUDA graph, then replayed.

`graphed(static_argnums=...)` is the port's counterpart of the JAX
package's `functools.partial(jax.jit, static_argnums=...)` on its query
entry points.  A jitted JAX query is one executable, traced once per value
of its static arguments and per input shape.  Here the eager body -- a few
hundred PyTorch ops and kernel launches issued from Python -- is captured
once per key into a CUDA graph, and every later batch is one replay.

On queries that are not on a CUDA device the wrapper calls the body, so
the CPU runs the eager code.  On CUDA queries it keys the call by

  * the static arguments, by value (`cfg` is a frozen dataclass);
  * the queries' shape, dtype and device;
  * every tensor leaf of the other arguments (tree, database) by address,
    shape, strides, dtype and device, and their other leaves (None,
    numbers) by value.  JAX traces the database as an argument; a graph
    bakes its addresses in, so the same database at other addresses gets a
    graph of its own.  The entry does not keep those tensors alive.

The first call with a key runs the body eagerly and returns that result.
The eager run builds the kernels, sets their per-device attributes and
fills the traversal uploads (models/query.py keeps those for the life of
the process).  The call then captures the body on torch.cuda.graph's side
stream, with the queries read from a buffer of the entry's own, and keeps
the graph.  A later call copies its queries into that buffer on the
current stream, replays the graph there and returns clones of the graph's
outputs: a result never changes when the next batch replays, as a JAX
result is a new array.  A call made while a capture runs calls the body,
as a nested jit inlines; the entry points' bodies call each other's eager
bodies (`__wrapped__`) for the same reason.

A capture or a replay that fails raises; nothing falls back to the eager
body.  Captures use capture-error mode CAPTURE_ERROR_MODE ("thread_local"):
a call that a capture forbids -- a host-to-device copy, a synchronisation,
`.item()` -- raises when this thread makes it, while other threads may
keep using the card.

Memory: each entry keeps its graph and with it the graph's private memory
pool, which holds every intermediate of the capture (the onepass scan's
status words among them, ops/cuda/primitives.py), the static outputs, and
the query buffer.  Graphs never share a pool: a pool shared by graphs
replayed in any order could hand one graph's live output to another's
intermediate.  `wrapper.graphs` maps each key to its entry (capture
seconds, bytes held, replays); clearing it frees them.

Kernel launch counters (`<wrapper>.launches` and the counts by mode): the
capture adds nothing to them, and each replay adds what the capture
recorded, so the counts stay the launches that ran on the card.
"""

from __future__ import annotations

import functools
import inspect
import threading
import time
from typing import Callable, Sequence

import torch

CAPTURE_ERROR_MODE = "thread_local"


def kernel_wrappers():
    """Every kernel wrapper; each counts its launches in `launches`, and
    kernel A and C also by mode and route."""
    from pqt_tpu_torch.ops.cuda import gather, primitives, rerank
    return (primitives.bitonic_topk, primitives.block_scan,
            rerank.rerank_fused, primitives.segmented_reduce,
            gather.lut_gather, gather.gather_rows, primitives.gather_sqdist)


def _counts() -> dict:
    """{(wrapper, attribute): count, or a copy of a dict of counts}."""
    return {(w, name): dict(v) if isinstance(v, dict) else v
            for w in kernel_wrappers() for name, v in vars(w).items()
            if isinstance(v, (int, dict))}


def _difference(after: dict, before: dict) -> dict:
    return {key: ({m: n - before[key][m] for m, n in v.items()}
                  if isinstance(v, dict) else v - before[key])
            for key, v in after.items()}


def _restore(counts: dict) -> None:
    for (w, name), v in counts.items():
        setattr(w, name, dict(v) if isinstance(v, dict) else v)


def _add(recorded: dict) -> None:
    for (w, name), d in recorded.items():
        if isinstance(d, dict):
            counts = getattr(w, name)
            for m, n in d.items():
                counts[m] += n
        else:
            setattr(w, name, getattr(w, name) + d)


def _leaves(x):
    """A hashable description of an argument: its tensors by address."""
    if isinstance(x, torch.Tensor):
        return ("tensor", x.data_ptr(), tuple(x.shape), x.stride(), x.dtype,
                x.device)
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, torch.nn.Module):
        return (type(x).__name__,) + tuple(
            (name, _leaves(t)) for name, t in
            list(x.named_buffers()) + list(x.named_parameters()))
    if isinstance(x, (tuple, list)):
        return (type(x).__name__,) + tuple(_leaves(v) for v in x)
    return (type(x).__name__, id(x))       # a host array: by identity


def _clone(out):
    """Fresh tensors in the structure of `out` (a tensor, or a tuple or
    NamedTuple of them)."""
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, tuple):
        cloned = [_clone(v) for v in out]
        return type(out)(*cloned) if hasattr(out, "_fields") else \
            tuple(cloned)
    return out


def _on_card(queries) -> bool:
    return isinstance(queries, torch.Tensor) and queries.device.type == "cuda"


def _record(fn: Callable, args: tuple, device: torch.device):
    """Capture fn(*args) on `device` into a CUDA graph with a private pool:
    (graph, outputs, device bytes the pool reserved)."""
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()        # so the pool's growth is what it holds
    reserved = torch.cuda.memory_reserved(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(device), torch.cuda.graph(
            graph, capture_error_mode=CAPTURE_ERROR_MODE):
        out = fn(*args)
    return graph, out, torch.cuda.memory_reserved(device) - reserved


class CapturedQuery:
    """One key's graph, with the buffer its queries are read from, its
    outputs, and the kernel launches one replay makes."""

    def __init__(self, fn: Callable, args: tuple, queries_at: int):
        queries = args[queries_at]
        self.queries = torch.empty_like(
            queries, memory_format=torch.contiguous_format).copy_(queries)
        args = args[:queries_at] + (self.queries,) + args[queries_at + 1:]
        before = _counts()
        t0 = time.perf_counter()
        try:
            self.graph, self.outputs, pool_bytes = _record(
                fn, args, queries.device)
        finally:
            self.launches = _difference(_counts(), before)
            _restore(before)
        self.capture_s = time.perf_counter() - t0
        self.bytes = pool_bytes + self.queries.nbytes
        self.replays = 0

    def replay(self, queries: torch.Tensor):
        self.queries.copy_(queries)
        self.graph.replay()
        _add(self.launches)
        self.replays += 1
        return _clone(self.outputs)


def graphed(static_argnums: Sequence[int]):
    """Serve the decorated function as a CUDA graph a key on CUDA queries
    (the module docstring); `static_argnums` as jax.jit's.  The function
    must take an argument named `queries`: it is the one argument copied
    into the graph on every call.  The wrapper's `__wrapped__` is the
    eager body, `graphs` its entries by key and `graph_key(*args,
    **kwargs)` the key of a call."""
    static = frozenset(static_argnums)

    def decorate(fn: Callable) -> Callable:
        sig = inspect.signature(fn)
        names = list(sig.parameters)
        if "queries" not in names:
            raise TypeError(f"graphed: {fn.__name__} takes no `queries`")
        queries_at = names.index("queries")
        if queries_at in static:
            raise TypeError(f"graphed: {fn.__name__}'s queries are static")
        graphs: dict = {}
        lock = threading.Lock()

        def positional(args, kwargs) -> tuple:
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            return bound.args

        def key_of(args: tuple) -> tuple:
            return tuple(
                ("static", a) if i in static else
                ("queries", tuple(a.shape), a.dtype, a.device)
                if i == queries_at else _leaves(a)
                for i, a in enumerate(args))

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            args = positional(args, kwargs)
            queries = args[queries_at]
            if not _on_card(queries) or \
                    torch.cuda.is_current_stream_capturing():
                return fn(*args)
            key = key_of(args)
            entry = graphs.get(key)
            if entry is not None:
                return entry.replay(queries)
            with lock:
                out = fn(*args)
                if key not in graphs:
                    graphs[key] = CapturedQuery(fn, args, queries_at)
            return out

        wrapper.graphs = graphs
        wrapper.graph_key = lambda *a, **kw: key_of(positional(a, kw))
        wrapper.static_argnums = tuple(sorted(static))
        return wrapper

    return decorate
