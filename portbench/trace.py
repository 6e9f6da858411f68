"""The traced window: torch.profiler over the window, and what it recorded.

A profiler session now and then records no device events (chip_smoke.py
`device_ms`, whose retry this copies): a throwaway session runs first, and
a session that recorded none is repeated after another throwaway, up to
ATTEMPTS times.  A session late in a process has lost the records of its
first few kernels, so each traced window starts with PAD float64 fills,
which nothing reads.  Nothing here falls back to CUDA events: a window
whose sessions all came back empty has no device records, and the
per-layer metrics that need them are left out.

A run on several cards traces them all: every device event keeps the card
it ran on (`op_cards`), so the busy time is taken card by card over the
cards the run used (`cards`, which `cells.run` sets from the cards'
peaks).  The pads and the throwaway session run only on the cards whose
allocator already holds bytes (`held`), so that they never make a card
the run left alone read as used.
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
    # the card of each device event, item by item of device_ops (empty:
    # every event on card 0)
    op_cards: tuple = ()
    # the cards the run used (cells.used_cards), over which busy_s is taken
    cards: tuple = (0,)

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

    def card_of(self, i: int) -> int:
        """The card device event i ran on."""
        return self.op_cards[i] if self.op_cards else 0

    def busy(self, card: int | None = None) -> list:
        """The union of device events inside the window, on `card` (None:
        on every card at once): merged (start_us, end_us) intervals."""
        lo, hi = self.window
        ops = (x for i, x in enumerate(self.device_ops)
               if PAD_KERNEL not in x[0]
               and (card is None or self.card_of(i) == card))
        out = []
        for _, s, e in sorted(ops, key=lambda x: x[1]):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s_by_card(self) -> dict:
        """{card: seconds in which an operation ran on it} over the
        cards the run used."""
        return {c: sum(e - s for s, e in self.busy(c)) / 1e6
                for c in self.cards}

    def busy_s(self) -> float:
        """The used cards' busy seconds, their mean; on one card its
        union's seconds."""
        by_card = self.busy_s_by_card()
        return sum(by_card.values()) / len(by_card)

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


def _sync_all(devices) -> None:
    for d in devices:
        torch.cuda.synchronize(d)


def held(devices) -> list:
    """The cards of `devices` whose allocator holds bytes: those the run
    has put its state on."""
    return [d for d in devices if torch.cuda.memory_allocated(d) > 0]


def _session(body, devices, pads):
    from torch.profiler import ProfilerActivity, profile
    _sync_all(devices)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for d in pads:
            pad = torch.empty(1, dtype=torch.float64, device=d)
            for _ in range(PAD):
                pad.fill_(1.0)
        _sync_all(devices)
        with torch.profiler.record_function(WINDOW):
            out = body()
            _sync_all(devices)
    dev, op_cards, host, window = [], [], [], None
    for e in prof.events():
        item = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # the profiler mirrors the benchmark's spans on the device's
            # timeline; they are no device work
            if not e.name.startswith("portbench."):
                dev.append(item)
                op_cards.append(int(e.device_index))
        else:
            host.append(item)
            if e.name == WINDOW:
                window = item[1:]
    return out, dev, tuple(op_cards), host, window


def _throwaway(pads):
    for d in pads:
        torch.ones(8, device=d) + 1


def traced(body, devices):
    """(body's result, Trace) of body() run under the profiler on the
    run's cards `devices`, repeated when a session records no device
    events.  The pads and the throwaway session go to the cards that
    hold bytes as the window starts (`held`)."""
    devices = [torch.device(d) for d in devices]
    pads = held(devices)
    for attempt in range(1, ATTEMPTS + 1):
        _session(lambda: _throwaway(pads), devices, pads)
        t0 = time.perf_counter()
        out, dev, op_cards, host, window = _session(body, devices, pads)
        if window is None:      # the window's own span was not recorded
            wall = (time.perf_counter() - t0) * 1e6
            real = [d for d in dev if PAD_KERNEL not in d[0]]
            window = ((min(d[1] for d in real), max(d[2] for d in real))
                      if real else (0.0, wall))
        if dev or attempt == ATTEMPTS:
            return out, Trace(dev, host, window, attempt, op_cards)
