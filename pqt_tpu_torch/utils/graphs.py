"""Compiled programs: each serving entry point, and the train and build
side's steps, captured once per static key as a CUDA graph, then replayed.

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

Tracing (utils/tracing.py).  A capture keeps its cudaGraph_t
(`torch.cuda.CUDAGraph(keep_graph=True)`, then `instantiate()`), so the
entry can find the stage marks the body recorded: each mark is one
kernel node, found by its kernel function (`tracing.GraphMarks`).  A
replay compares the profiler's state with the state of the entry's mark
nodes and calls cudaGraphNodeSetEnabled on them only when the two differ:
with the profiler off a replay runs no mark, and no graph is captured
again for the profiler's sake, since the key never holds its state.  The
wrapper opens two host spans, live only while the profiler records and
around host work that launches nothing: `pqt.graph.key`, from the call's
entry through the binding of its arguments, the key and the lookup of the
entry, and `pqt.graph.count`, the launch counters a replay adds.  A
loop's step (`CapturedLoop`, below) marks nothing.

An entry is a list of stages, each one graph on one device
(`CapturedQuery`).  An entry point is one stage.  The sharded query step
(parallel/sharded.py, the counterpart of jax.jit over shard_map) is one
stage a distinct device of its grid, serving the cells there, and a last
stage, the merge, on the first cell's device, which reads the other
stages' outputs.  A replay replays the stages in order, each on its
device's current stream; where the merge lies on another device than a
stage, the merge's stream waits on an event recorded after that stage,
and the stage, before its next replay, on an event recorded after the
merge, so no host sync is made.  The merge is captured with every other
device's current stream set to a capture stream of its own, so the copies
of the lists onto the merge's device join the capture as peer copies.
An entry whose merge runs collectives of a process group records the
group, and a replay raises once that group is destroyed.

`graphed(..., inputs=(names))` copies more than one argument into the
graph: the chunk encoder (models/db.py) takes the chunk's rows and its id
offset, a 0-d int32 tensor, so one graph serves every chunk of a shape, as
the JAX package traces `id_offset` as an array.  The key holds each
input's shape, dtype and device, never its values.

A loop (`CapturedLoop`, `loop_or_capture`) is one step captured with its
state and constants read from buffers of the entry's own, and the step's
new state written back into the state buffers inside the graph, so
replays chain on the card with no copy through the host: the Lloyd
iterations and the k-means++ picks (models/kmeans.py), the counterparts of
the JAX package's `lax.while_loop` and `lax.fori_loop`.  Its key is
shapes and static values only, since every tensor it reads is copied in
once a run.  A step that draws random numbers captures with its
generator registered.

`with eager():` makes every graphed program called on that thread run its
eager body on the card (to hold a replay against the body it was captured
from); it is a choice of the caller, never a fallback.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import threading
import time
from collections.abc import Mapping
from typing import Callable, NamedTuple, Sequence

import torch

from pqt_tpu_torch.utils import tracing

CAPTURE_ERROR_MODE = "thread_local"


def kernel_wrappers():
    """Every kernel wrapper; each counts its launches in `launches`, and
    kernel A and C also by mode and route."""
    from pqt_tpu_torch.ops.cuda import (gather, linecodes, partcodes,
                                        primitives, rerank)
    return (primitives.bitonic_topk, primitives.block_scan,
            rerank.rerank_fused, primitives.segmented_reduce,
            gather.lut_gather, gather.gather_rows, primitives.gather_sqdist,
            linecodes.line_codes, partcodes.part_codes)


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
    if x is None or isinstance(x, (bool, int, float, str, torch.device)):
        return x
    if isinstance(x, Mapping):      # e.g. {device: replica}: by its items
        return ("mapping",) + tuple(sorted(
            ((_leaves(k), _leaves(v)) for k, v in x.items()),
            key=lambda item: repr(item[0])))
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


def _on_card(x) -> bool:
    """Whether x, a tensor or a device, is on a CUDA device."""
    if isinstance(x, torch.Tensor):
        x = x.device
    return isinstance(x, torch.device) and x.type == "cuda"


_mode = threading.local()


@contextlib.contextmanager
def eager():
    """Within it, every graphed program called on this thread runs its
    eager body."""
    before = getattr(_mode, "eager", False)
    _mode.eager = True
    try:
        yield
    finally:
        _mode.eager = before


def _served(x) -> bool:
    """Whether a call on x (a tensor or a device) is served by a graph: on
    a card, not under a capture (a nested call inlines) and not in
    `eager()`."""
    return _on_card(x) and not torch.cuda.is_current_stream_capturing() \
        and not getattr(_mode, "eager", False)


@functools.cache
def _capture_stream(device: torch.device):
    """The side stream captures on `device` run on (torch.cuda.graph's own
    default is one stream, on the device that first captured)."""
    return torch.cuda.Stream(device)


def _record(fn: Callable, args: tuple, device: torch.device,
            generators=()):
    """Capture fn(*args) on `device` into a CUDA graph with a private pool,
    `generators` (torch.Generator) registered with it, and instantiate it;
    the graph keeps its cudaGraph_t (keep_graph), whose mark nodes the
    entry switches: (graph, outputs, device bytes the pool reserved)."""
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()        # so the pool's growth is what it holds
    reserved = torch.cuda.memory_reserved(device)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    for gen in generators:
        graph.register_generator_state(gen)
    with torch.cuda.device(device), torch.cuda.graph(
            graph, stream=_capture_stream(device),
            capture_error_mode=CAPTURE_ERROR_MODE):
        out = fn(*args)
    graph.instantiate()
    return graph, out, torch.cuda.memory_reserved(device) - reserved


def _joinable(devices) -> contextlib.ExitStack:
    """Each device's current stream set to its capture stream, so work that
    a capture hands to it (a peer copy) joins the capture: the legacy
    default stream cannot."""
    stack = contextlib.ExitStack()
    for d in devices:
        stack.enter_context(torch.cuda.stream(_capture_stream(d)))
    return stack


def _stream(device: torch.device):
    return torch.cuda.current_stream(device)


def _event():
    return torch.cuda.Event()


def _group_alive(group) -> bool:
    """Whether a torch.distributed process group still exists."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return False
    try:
        dist.get_rank(group)
    except ValueError:              # destroyed, or from an earlier world
        return False
    return True


def _buffer(x):
    """A contiguous copy of x on its device: of each tensor of a tuple, and
    of each entry of a mapping {device: ...}."""
    if isinstance(x, Mapping):
        return {d: _buffer(v) for d, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_buffer(v) for v in x)
    return torch.empty_like(x, memory_format=torch.contiguous_format
                            ).copy_(x)


def _copy_in(buffer, x) -> None:
    if isinstance(buffer, dict):
        for d, b in buffer.items():
            _copy_in(b, x[d])
    elif isinstance(buffer, tuple):
        for b, v in zip(buffer, x):
            _copy_in(b, v)
    else:
        buffer.copy_(x)


def _flat(buffer) -> list:
    """The tensors of a buffer."""
    if isinstance(buffer, dict):
        return [t for b in buffer.values() for t in _flat(b)]
    if isinstance(buffer, tuple):
        return [t for b in buffer for t in _flat(b)]
    return [buffer]


class Stage(NamedTuple):
    """One graph of an entry: fn(*args(query buffer, earlier stages'
    outputs)) captured on `device`."""
    device: torch.device
    fn: Callable
    args: Callable


class CapturedQuery:
    """One key's graphs, one a stage, with the buffer its queries are read
    from (a tensor, or one a device), the last stage's outputs, and the
    kernel launches one replay makes, summed over the stages.  Every stage
    but the last reads only the queries; the last reads the others'
    outputs (the module docstring).  `group`: the process group whose
    collectives the stages captured, or None."""

    def __init__(self, stages: Sequence[Stage], queries, group=None):
        self.queries = _buffer(queries)
        self.group = group
        last = stages[-1].device
        others = {st.device for st in stages[:-1]} - {last}
        before = _counts()
        t0 = time.perf_counter()
        outs, self.stages, pool_bytes = [], [], 0
        try:
            for st in stages:
                with _joinable(others if st is stages[-1] else ()):
                    graph, out, nbytes = _record(
                        st.fn, st.args(self.queries, outs), st.device)
                outs.append(out)
                self.stages.append((st.device, graph))
                pool_bytes += nbytes
        finally:
            self.launches = _difference(_counts(), before)
            _restore(before)
        self.capture_s = time.perf_counter() - t0
        self.outputs = outs[-1]
        self.held = outs[:-1]           # read by the last stage's graph
        self.bytes = pool_bytes + sum(b.nbytes for b in _flat(self.queries))
        self.replays = 0
        # cross-device order: one event a device the last stage waits on,
        # and one after the last stage that those devices wait on
        self.ready = {d: _event() for d, _ in self.stages[:-1] if d != last}
        self.done = _event() if self.ready else None
        self.marks = tracing.GraphMarks(self.stages)

    @property
    def graph(self):
        """The last stage's graph (an entry point's only one)."""
        return self.stages[-1][1]

    def replay(self, queries):
        if self.group is not None and not _group_alive(self.group):
            raise RuntimeError("this graph runs collectives of a process "
                               "group that has been destroyed; clear the "
                               "graphs before destroying their group")
        self.marks.sync()
        _copy_in(self.queries, queries)
        *firsts, (last, graph) = self.stages
        for d, g in firsts:
            if d in self.ready:
                _stream(d).wait_event(self.done)
            g.replay()
            if d in self.ready:
                self.ready[d].record(_stream(d))
        for ev in self.ready.values():
            _stream(last).wait_event(ev)
        graph.replay()
        if self.done is not None:
            self.done.record(_stream(last))
        with tracing.span("pqt.graph.count"):
            _add(self.launches)
        self.replays += 1
        return _clone(self.outputs)


def replay_or_capture(graphs: dict, lock: threading.Lock, key, queries,
                      eager: Callable, stages: Callable, group=None):
    """A call on the card: replay the entry of `key`, or run `eager()`,
    capture `stages()` under `key` and return the eager result."""
    entry = graphs.get(key)
    if entry is not None:
        return entry.replay(queries)
    with lock:
        out = eager()
        if key not in graphs:
            graphs[key] = CapturedQuery(stages(), queries, group)
    return out


def graphed(static_argnums: Sequence[int],
            inputs: Sequence[str] = ("queries",)):
    """Serve the decorated function as a CUDA graph a key when its first
    input is on a card (the module docstring); `static_argnums` as
    jax.jit's.  `inputs` names the arguments copied into the graph on
    every call: tensors on one device, keyed by shape and dtype.  The
    wrapper's `__wrapped__` is the eager body, `graphs` its entries by key
    and `graph_key(*args, **kwargs)` the key of a call."""
    static = frozenset(static_argnums)

    def decorate(fn: Callable) -> Callable:
        sig = inspect.signature(fn)
        names = list(sig.parameters)
        for name in inputs:
            if name not in names:
                raise TypeError(f"graphed: {fn.__name__} takes no `{name}`")
        at = tuple(names.index(name) for name in inputs)
        if static & set(at):
            raise TypeError(f"graphed: {fn.__name__}'s inputs are static")
        graphs: dict = {}
        lock = threading.Lock()

        def positional(args, kwargs) -> tuple:
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            return bound.args

        def key_of(args: tuple) -> tuple:
            return tuple(
                ("static", a) if i in static else
                (names[i], tuple(a.shape), a.dtype, a.device)
                if i in at else _leaves(a)
                for i, a in enumerate(args))

        def with_inputs(args: tuple, buffers) -> tuple:
            args = list(args)
            for i, b in zip(at, buffers if len(at) > 1 else (buffers,)):
                args[i] = b
            return tuple(args)

        def lookup(args, kwargs):
            """(positional args, inputs, key, entry); key None where the
            call is not served by a graph."""
            args = positional(args, kwargs)
            ins = tuple(args[i] for i in at)
            if not _served(ins[0]):
                return args, ins, None, None
            dev = ins[0].device
            for name, x in zip(inputs, ins):
                if not isinstance(x, torch.Tensor) or x.device != dev:
                    raise TypeError(f"{fn.__name__}: `{name}` is not a "
                                    f"tensor on {dev}")
            key = key_of(args)
            return args, ins, key, graphs.get(key)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with tracing.span("pqt.graph.key"):
                args, ins, key, entry = lookup(args, kwargs)
            if key is None:
                return fn(*args)
            queries = ins if len(at) > 1 else ins[0]
            if entry is not None:
                return entry.replay(queries)
            dev = ins[0].device
            return replay_or_capture(
                graphs, lock, key, queries, lambda: fn(*args),
                lambda: [Stage(dev, fn, lambda q, _: with_inputs(args, q))])

        wrapper.graphs = graphs
        wrapper.graph_key = lambda *a, **kw: key_of(positional(a, kw))
        wrapper.static_argnums = tuple(sorted(static))
        return wrapper

    return decorate


class CapturedLoop:
    """One step of a loop, fn(*state, *constants) -> new state, captured on
    `device` with every input read from a buffer of the entry's own and the
    new state written back into the state buffers inside the graph: after
    `load`, each replay makes one more step on the card.  `state` is the
    state buffers; `launches`, `capture_s`, `bytes` and `replays` as
    CapturedQuery's."""

    def __init__(self, fn: Callable, inputs: tuple, n_state: int,
                 device: torch.device, generators=()):
        self.buffers = _buffer(tuple(inputs))
        self.n_state = n_state

        def step(*buffers):
            for b, new in zip(buffers[:n_state], fn(*buffers)):
                b.copy_(new)

        before = _counts()
        t0 = time.perf_counter()
        try:
            self.graph, _, pool_bytes = _record(step, self.buffers, device,
                                                generators)
        finally:
            self.launches = _difference(_counts(), before)
            _restore(before)
        self.capture_s = time.perf_counter() - t0
        self.bytes = pool_bytes + sum(b.nbytes for b in self.buffers)
        self.replays = 0

    @property
    def state(self) -> tuple:
        return self.buffers[:self.n_state]

    def load(self, inputs) -> None:
        _copy_in(self.buffers, tuple(inputs))

    def replay(self, steps: int = 1) -> None:
        for _ in range(steps):
            self.graph.replay()
            _add(self.launches)
            self.replays += 1


def loop_or_capture(graphs: dict, key, fn: Callable, inputs: tuple,
                    n_state: int, device: torch.device, generators=()):
    """The loop entry of `key` (CapturedLoop) loaded with `inputs` (the
    state, then the constants), and the steps already made: 0 with an
    entry of the key; else 1, the step run eagerly before the capture
    (it builds the kernels, as an entry point's first call does), whose
    new state the new entry is loaded with."""
    entry = graphs.get(key)
    made = 0
    if entry is None:
        inputs = tuple(fn(*inputs)) + tuple(inputs[n_state:])
        made = 1
        entry = CapturedLoop(fn, inputs, n_state, device, generators)
        graphs[key] = entry
    entry.load(inputs)
    return entry, made
