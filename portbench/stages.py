"""The port's stage marks in a traced window, as the stage metrics read
them (portbench/metrics/stage_us_per_*.py, replay_idle_pct.serve.py).

The port marks where each stage of a call starts, on the device, with a
one-thread kernel whose name holds `pqt_stage_mark_kernel<id>`
(pqt_tpu_torch/utils/tracing.py, csrc/mark.cu); its tracing module maps
each id to the stage's name (`STAGES`).  A program without that module
gives nothing here: every function returns None or nothing, and none
raises.

A sequence is one call's marks of one kind: from its start mark
(`query.tables`; `build.upload`) through the next end mark of its kind
(`query.end`; `build.end`), the chunk encoder's `encode.*` marks counted
with the build's.  A start mark met inside a sequence starts it anew (the
earlier one lost its end), and marks met outside a sequence are passed
over (their start was lost: a profiler session drops its first records),
so only complete sequences are read.  A stage's interval runs from its
mark's start to the next mark's start; its time is the summed durations of
the device operations (kernels, copies, sets) that start in the interval,
the port's marks and the benchmark's pads and marks left out.
"""

from __future__ import annotations

import bisect
import re

from portbench import trace as tr

KINDS = {"query": (("query.",), "query.tables", "query.end"),
         "build": (("build.", "encode."), "build.upload", "build.end")}
_ID = re.compile(r"<(\d+)>")
_cache: dict = {}


def names():
    """(the port's stage names by id, the mark kernel's name), or None
    where the program has no tracing module."""
    try:
        from pqt_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.STAGES, tracing.MARK_KERNEL


def _memo(key: str, trace, compute):
    """compute() once a trace (the readers of one run share it)."""
    held = _cache.get(key)
    if held is None or held[0] is not trace:
        held = _cache[key] = (trace, compute())
    return held[1]


def marks(trace) -> list:
    """(stage, start_us, end_us) of every mark of the trace, in start
    order."""
    def compute():
        found = names()
        if found is None:
            return []
        stages, kernel = found
        out = []
        for name, s, e in trace.device_ops:
            if kernel not in name:
                continue
            m = _ID.search(name[name.index(kernel):])
            if m and int(m.group(1)) < len(stages):
                out.append((stages[int(m.group(1))], s, e))
        return sorted(out, key=lambda x: x[1])
    return _memo("marks", trace, compute)


def sequences(trace, kind: str) -> list:
    """The complete sequences of `kind` ("query" or "build"): lists of
    (stage, start_us, end_us), start mark first and end mark last."""
    prefixes, start, end = KINDS[kind]

    def compute():
        out, cur = [], None
        for m in marks(trace):
            if not m[0].startswith(prefixes):
                continue
            if m[0] == start:
                cur = [m]
            elif cur is not None:
                cur.append(m)
                if m[0] == end:
                    out.append(cur)
                    cur = None
        return out
    return _memo("sequences." + kind, trace, compute)


def _work(trace) -> tuple:
    """(start_us of each device operation that is work, in order; the
    running sum of their durations)."""
    def compute():
        found = names()
        kernel = found[1] if found else None
        ops = sorted((s, e - s) for name, s, e in trace.device_ops
                     if tr.PAD_KERNEL not in name
                     and tr.MARK_KERNEL not in name
                     and not (kernel and kernel in name))
        starts, cum = [], [0.0]
        for s, d in ops:
            starts.append(s)
            cum.append(cum[-1] + d)
        return starts, cum
    return _memo("work", trace, compute)


def stage_us(trace, kind: str) -> dict:
    """{stage: device microseconds} summed over the complete sequences of
    `kind` (the end mark has no interval)."""
    def compute():
        starts, cum = _work(trace)
        out = {}
        for seq in sequences(trace, kind):
            for (stage, lo, _), (_, hi, _) in zip(seq, seq[1:]):
                a = bisect.bisect_left(starts, lo)
                b = bisect.bisect_left(starts, hi)
                out[stage] = out.get(stage, 0.0) + cum[b] - cum[a]
        return out
    return _memo("stage_us." + kind, trace, compute)


def per_query(rec, stage: str):
    """A query stage's device microseconds over the queries of the
    complete sequences, or None."""
    t = rec.trace
    if rec.kind != "serve" or t is None or not getattr(rec, "batch", 0):
        return None
    seqs = sequences(t, "query")
    us = stage_us(t, "query")
    if not seqs or stage not in us:
        return None
    return us[stage] / (len(seqs) * rec.batch)


def per_krow(rec, stage: str):
    """A build stage's device microseconds over the thousands of rows of
    the complete build sequences, or None."""
    t = rec.trace
    if rec.kind != "build" or t is None or not getattr(rec, "builds", 0):
        return None
    seqs = sequences(t, "build")
    us = stage_us(t, "build")
    if not seqs or stage not in us:
        return None
    return us[stage] / (len(seqs) * rec.rows / rec.builds / 1e3)


def idle_share(rec):
    """The share, in percent, of the complete query sequences' spans (a
    start mark's start to its end mark's end) in which no device operation
    ran, or None."""
    t = rec.trace
    if rec.kind != "serve" or t is None:
        return None
    seqs = sequences(t, "query")
    if not seqs:
        return None
    busy = t.busy()
    ends = [e for _, e in busy]
    total = covered = 0.0
    for seq in seqs:
        lo, hi = seq[0][1], seq[-1][2]
        total += hi - lo
        for s, e in busy[bisect.bisect_right(ends, lo):]:
            if s >= hi:
                break
            covered += min(e, hi) - max(s, lo)
    return 100.0 * (1.0 - covered / total) if total > 0 else None


def host_span_us(rec, name: str):
    """The mean duration, in microseconds, of the port's host span `name`
    inside the traced window, or None."""
    t = rec.trace
    if rec.kind != "serve" or t is None:
        return None
    lo, hi = t.window
    spans = [e - s for n, s, e in t.host_ops if n == name and lo <= s < hi]
    return sum(spans) / len(spans) if spans else None
