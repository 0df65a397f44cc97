"""Reduce a ``torch.profiler`` trace of the measured window to numbers.

The window is the benchmark's own span ``cardbench.window``; the device's
work is every kernel, memcpy and memset the profiler saw on the card,
clipped to the window.  What the host was doing in an idle gap is read from
the benchmark's spans (``cardbench.*``: a submit, a wait for results) and
from the program's longest top-level operation on the host that overlaps
the gap.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

WINDOW = "cardbench.window"
NAME_CHARS = 160  # device-op names are cut to this length in the breakdown
# the CUDA runtime's names of the copies and fills it does without a kernel
NOT_KERNELS = ("Memcpy ", "Memset ")


@dataclass
class Trace:
    window_s: float
    busy_s: float
    device_s: dict = field(default_factory=dict)  # op name -> seconds
    gaps: list = field(default_factory=list)  # [label, seconds], longest first

    def kernel_s(self) -> float:
        """Seconds of every device kernel in the window, whatever its name:
        all device ops but the runtime's copies and fills."""
        return sum(s for n, s in self.device_s.items()
                   if not n.startswith(NOT_KERNELS))

    def breakdown(self) -> dict:
        ops = sorted(self.device_s.items(), key=lambda kv: -kv[1])[:10]
        return {
            "device_ops": [[n[:NAME_CHARS], s] for n, s in ops],
            "idle_gaps": self.gaps[:10],
        }


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _most_overlapping(spans, starts, max_len, lo, hi):
    """Name of the span in ``spans`` (sorted by start) overlapping
    ``[lo, hi]`` the most, or None."""
    best, name = 0.0, None
    i = bisect.bisect_left(starts, lo - max_len)
    while i < len(spans) and spans[i][0] < hi:
        s, e, n = spans[i]
        ov = min(e, hi) - max(s, lo)
        if ov > best:
            best, name = ov, n
        i += 1
    return name


def _is_device(event) -> bool:
    return str(getattr(event, "device_type", "")).endswith("CUDA")


def reduce(events) -> Trace | None:
    """The window's numbers from a profiler's ``events()``; None when the
    trace holds no window or no device work in it."""
    win = [e for e in events if e.name == WINDOW and not _is_device(e)]
    if not win:
        return None
    w0, w1 = win[0].time_range.start, win[0].time_range.end  # microseconds
    device, ours, host = [], [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if _is_device(e):
            if e.name.startswith("cardbench."):
                continue  # the device-side copy of one of our spans
            s, t = max(s, w0), min(t, w1)
            if t > s:
                device.append((s, t, e.name))
        elif e.name.startswith("cardbench."):
            if e.name != WINDOW:
                ours.append((s, t, e.name[len("cardbench."):]))
        elif getattr(e, "cpu_parent", None) is None:
            host.append((s, t, e.name))
    if not device:
        return None
    busy = _merge([(s, t) for s, t, _ in device])
    device_s: dict[str, float] = {}
    for s, t, n in device:
        device_s[n] = device_s.get(n, 0.0) + (t - s) * 1e-6
    gaps = []
    prev = w0
    for s, t in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    gaps.sort(key=lambda g: g[0] - g[1])
    labelled = []
    for spans in (ours, host):
        spans.sort()
    ours_starts = [s for s, _, _ in ours]
    host_starts = [s for s, _, _ in host]
    ours_max = max((t - s for s, t, _ in ours), default=0.0)
    host_max = max((t - s for s, t, _ in host), default=0.0)
    for lo, hi in gaps[:10]:
        a = _most_overlapping(ours, ours_starts, ours_max, lo, hi) or "none"
        b = _most_overlapping(host, host_starts, host_max, lo, hi) or "none"
        labelled.append([f"{a} / {b}", (hi - lo) * 1e-6])
    return Trace(
        window_s=(w1 - w0) * 1e-6,
        busy_s=sum(t - s for s, t in busy) * 1e-6,
        device_s=device_s,
        gaps=labelled,
    )
