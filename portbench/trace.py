"""The traced window: torch.profiler over the window, and what it recorded.

A profiler session now and then records no device events (chip_smoke.py
`device_ms`, whose retry this copies): a throwaway session runs first, and
a session that recorded none is repeated after another throwaway, up to
ATTEMPTS times.  A session late in a process has lost the records of its
first few kernels, so each traced window starts with PAD float64 fills,
which nothing reads.  Nothing here falls back to CUDA events: a window
whose sessions all came back empty has no device records, and the
per-layer metrics that need them are left out.
"""

from __future__ import annotations

import bisect
import time
from typing import NamedTuple

import torch

ATTEMPTS = 3
PAD = 32
# kernels are named in full ("void at::native::..._kernel<4,
# at::native::FillFunctor<double>, ...>(...)"), so these are parts of names
PAD_KERNEL = "FillFunctor<double>"
# a fill of a complex128 tensor, launched by the benchmark to mark a point
# of a build on the device's timeline; nothing of the port launches one
MARK_KERNEL = "FillFunctor<c10::complex<double>"
WINDOW = "portbench.window"


def mark(device) -> None:
    """Launch one marker kernel (MARK_KERNEL) on the current stream."""
    torch.empty(1, dtype=torch.complex128, device=device).fill_(1.0)


class Trace(NamedTuple):
    device_ops: list    # (name, start_us, end_us) of every device event
    host_ops: list      # (name, start_us, end_us) of every host event
    window: tuple       # (start_us, end_us) of the traced window
    attempts: int

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def kernels(self) -> list:
        """Device events that are kernels (no copies, sets, pads or
        marks), in start order."""
        return [e for e in self.device_ops
                if not e[0].startswith(("Memcpy", "Memset"))
                and PAD_KERNEL not in e[0] and MARK_KERNEL not in e[0]]

    def marks(self) -> list:
        return [e for e in self.device_ops if MARK_KERNEL in e[0]]

    def busy(self) -> list:
        """The union of device events inside the window: merged
        (start_us, end_us) intervals."""
        lo, hi = self.window
        out = []
        for _, s, e in sorted((x for x in self.device_ops
                               if PAD_KERNEL not in x[0]),
                              key=lambda x: x[1]):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e6

    def idle_gaps(self, top: int = 10) -> list:
        """Idle seconds of the device summed by what the host was doing at
        the middle of each gap: the innermost benchmark span and the
        innermost host operation inside it ("python" where none)."""
        lo, hi = self.window
        edges = [lo] + [x for iv in self.busy() for x in iv] + [hi]
        host = sorted(self.host_ops, key=lambda x: x[1])
        starts = [h[1] for h in host]
        totals = {}
        for s, e in zip(edges[0::2], edges[1::2]):
            if e <= s:
                continue
            m = (s + e) / 2
            span, op = None, None
            j = bisect.bisect_right(starts, m) - 1
            for k in range(j, max(-1, j - 200), -1):
                name, hs, he = host[k]
                if he < m or name == WINDOW:
                    continue
                if name.startswith("portbench."):
                    span = span or name
                    break
                op = op or name
            label = f"{span or WINDOW}/{op or 'python'}"
            totals[label] = totals.get(label, 0.0) + (e - s) / 1e6
        return sorted(([k, v] for k, v in totals.items()),
                      key=lambda kv: -kv[1])[:top]

    def device_top(self, top: int = 10) -> list:
        totals = {}
        for name, s, e in self.device_ops:
            if PAD_KERNEL not in name:
                totals[name] = totals.get(name, 0.0) + (e - s) / 1e6
        return sorted(([k[:200], v] for k, v in totals.items()),
                      key=lambda kv: -kv[1])[:top]


def _session(body):
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pad = torch.empty(1, dtype=torch.float64, device="cuda")
        for _ in range(PAD):
            pad.fill_(1.0)
        torch.cuda.synchronize()
        with torch.profiler.record_function(WINDOW):
            out = body()
            torch.cuda.synchronize()
    dev, host, window = [], [], None
    for e in prof.events():
        item = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # the profiler mirrors the benchmark's spans on the device's
            # timeline; they are no device work
            if not e.name.startswith("portbench."):
                dev.append(item)
        else:
            host.append(item)
            if e.name == WINDOW:
                window = item[1:]
    return out, dev, host, window


def traced(body):
    """(body's result, Trace) of body() run under the profiler, repeated
    when a session records no device events."""
    for attempt in range(1, ATTEMPTS + 1):
        _session(lambda: torch.ones(8, device="cuda") + 1)   # throwaway
        t0 = time.perf_counter()
        out, dev, host, window = _session(body)
        if window is None:      # the window's own span was not recorded
            wall = (time.perf_counter() - t0) * 1e6
            real = [d for d in dev if PAD_KERNEL not in d[0]]
            window = ((min(d[1] for d in real), max(d[2] for d in real))
                      if real else (0.0, wall))
        if dev or attempt == ATTEMPTS:
            return out, Trace(dev, host, window, attempt)
