"""The program's host spans against a ``torch.profiler`` trace of the window.

``repro_torch``'s ``TraceCollector`` records host spans at the serving
path's boundaries (``host_spans``: name, ``perf_counter_ns`` start and end,
thread, batch) and opens each as a profiler range of its name too.  The
profiler records only the thread that started it, so the serving engine's
drain thread, started during warm-up, leaves no range; the callers' thread
does (``serve.admit``).  ``profiler_offset_us`` reads the offset between
the two clocks from those pairs, and the drain thread's spans then land on
the device trace's timeline.

From there: the device's busy intervals in the window (the union
``idle_share`` reads), the device-idle seconds each drain-thread span name
overlaps, the host work of each batch dispatched in the window, the queue
wait of the requests dispatched in it (``serve.request``: admission to its
batch's dispatch), and the trace's idle gaps labelled with the drain
thread's spans among the host's operations.  Everything is None where the
program records no host span (a program without them, or a run without a
collector).
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from types import SimpleNamespace

import numpy as np

from cardbench import trace as tr

# the drain thread's spans, which tile its loop; runner.replay nests in
# serve.dispatch and is not among them
DRAIN_SPANS = ("serve.form", "serve.pad", "serve.pin", "serve.h2d",
               "serve.dispatch", "serve.sync", "serve.sentinel",
               "serve.record", "frontend.wait")
# the drain thread's own host work: all of it but waiting on the device
# (serve.sync) and waiting for requests (frontend.wait)
HOST_WORK = ("serve.form", "serve.pad", "serve.pin", "serve.h2d",
             "serve.dispatch", "serve.sentinel", "serve.record")
NESTED = ("runner.replay",)  # read beside DRAIN_SPANS, inside one of them
# finding the mirrored pairs (profiler_offset_us): the profiler ranges
# sampled, the window of start differences that finds their twins, and how
# far from that shift a twin may start
OFFSET_SAMPLE = 32
OFFSET_BIN_US = 10.0
OFFSET_MATCH_US = 100.0


@dataclass
class ProgramTrace:
    offset_us: float  # profiler's clock minus the program's
    window_s: float
    idle_s: float  # device idle in the window
    idle_by_span: dict = field(default_factory=dict)  # name -> idle s overlapped
    batches: int = 0  # batches whose serve.dispatch began in the window
    host_s: float = 0.0  # those batches' HOST_WORK seconds
    drain_s: dict = field(default_factory=dict)  # name -> s of the window
    # the drain thread's time between two spans ("a>b"), and the idle in it
    glue_s: dict = field(default_factory=dict)
    idle_in_glue_s: dict = field(default_factory=dict)
    # admission to dispatch of each request dispatched in the window, ms
    queue_wait_ms: list = field(default_factory=list)
    trace: tr.Trace | None = None  # the reduction, gaps labelled by spans

    @property
    def idle_under_host_s(self) -> float:
        return sum(self.idle_by_span.get(n, 0.0) for n in HOST_WORK)

    def summary(self) -> dict:
        """What a traced run prints of it."""
        return {
            "offset_us": self.offset_us,
            "batches": self.batches,
            "idle_s": self.idle_s,
            "idle_by_span_s": dict(sorted(self.idle_by_span.items(),
                                          key=lambda kv: -kv[1])),
            "drain_share_of_window": {
                n: s / self.window_s for n, s in self.drain_s.items()},
            "drain_cover": sum(s for n, s in self.drain_s.items()
                               if n in DRAIN_SPANS) / self.window_s,
            "glue_share_of_window": {
                k: s / self.window_s for k, s in sorted(
                    self.glue_s.items(), key=lambda kv: -kv[1])},
            "idle_in_glue_s": dict(sorted(self.idle_in_glue_s.items(),
                                          key=lambda kv: -kv[1])),
            "queue_wait_ms": _quantiles(self.queue_wait_ms),
            "idle_gaps": self.trace.gaps[:10] if self.trace else [],
        }


def _quantiles(ms) -> dict:
    if not ms:
        return {"n": 0}
    p50, p95 = np.percentile(ms, (50, 95))
    return {"n": len(ms), "mean": float(np.mean(ms)), "p50": float(p50),
            "p95": float(p95)}


def profiler_offset_us(events, spans) -> float | None:
    """The profiler's clock minus the program's, in microseconds: a host
    span's ``start_ns / 1e3`` plus this is its start on the timeline of
    ``events`` (a ``torch.profiler`` profile's ``events()``).

    Pairs each profiler range named like a host span with its twin — the
    host span of that name whose shifted start lies nearest, within
    ``OFFSET_MATCH_US`` — and returns the median of the pairs' start
    differences (``None`` when no pair is found).  The shift that finds the
    twins is the densest ``OFFSET_BIN_US`` window of the differences
    between a sample of ``OFFSET_SAMPLE`` ranges and every host span of
    their name: ranges and their twins share one difference, other pairs
    spread theirs.  Spans of a thread the profiler does not record have no
    twin and take no part."""
    ours: dict[str, list] = {}
    for s in spans:
        ours.setdefault(s.name, []).append(s.start_ns / 1e3)
    theirs: dict[str, list] = {}
    for e in events:
        if e.name in ours and not tr._is_device(e):
            theirs.setdefault(e.name, []).append(e.time_range.start)
    if not theirs:
        return None
    ours = {n: np.sort(np.asarray(ours[n])) for n in theirs}
    theirs = {n: np.asarray(t) for n, t in theirs.items()}
    diffs = []
    for name, t in theirs.items():
        pick = t[np.linspace(0, len(t) - 1,
                             min(OFFSET_SAMPLE, len(t))).astype(int)]
        diffs.append((pick[:, None] - ours[name][None, :]).ravel())
    d = np.sort(np.concatenate(diffs))
    dense = (np.searchsorted(d, d + OFFSET_BIN_US, side="right")
             - np.arange(len(d)))
    shift = d[dense.argmax()] + OFFSET_BIN_US / 2
    pairs = []
    for name, t in theirs.items():
        s = ours[name]
        want = t - shift
        hi = np.clip(np.searchsorted(s, want), 0, len(s) - 1)
        lo = np.clip(hi - 1, 0, len(s) - 1)
        near = np.where(np.abs(s[lo] - want) < np.abs(s[hi] - want), lo, hi)
        keep = np.abs(s[near] - want) <= OFFSET_MATCH_US
        pairs.append(t[keep] - s[near][keep])
    pairs = np.concatenate(pairs)
    return float(np.median(pairs)) if len(pairs) else None


def _overlap(intervals, starts, lo, hi) -> float:
    """Length of ``[lo, hi]``'s overlap with sorted disjoint
    ``intervals`` (their starts in ``starts``)."""
    i = max(bisect.bisect_right(starts, lo) - 1, 0)
    out = 0.0
    while i < len(intervals) and intervals[i][0] < hi:
        s, e = intervals[i]
        out += max(min(e, hi) - max(s, lo), 0.0)
        i += 1
    return out


def read(events, host_spans) -> ProgramTrace | None:
    """The window's program spans from a profiler's ``events()`` and a
    collector's ``host_spans``; None without a window, device work, host
    spans or a clock offset."""
    if not host_spans:
        return None
    win = [e for e in events if e.name == tr.WINDOW and not tr._is_device(e)]
    if not win:
        return None
    offset = profiler_offset_us(events, host_spans)
    if offset is None:
        return None
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    ours = {s.name for s in host_spans}
    # the device-side copies of the program's ranges are annotations, not
    # work (as the benchmark's own are to the reduction)
    events = [e for e in events if not (tr._is_device(e) and e.name in ours)]
    device = []
    for e in events:
        if tr._is_device(e) and not e.name.startswith("cardbench."):
            s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
            if t > s:
                device.append((s, t))
    if not device:
        return None
    busy = tr._merge(device)
    idle, prev = [], w0
    for s, t in busy + [[w1, w1]]:
        if s > prev:
            idle.append((prev, s))
        prev = max(prev, t)
    idle_starts = [s for s, _ in idle]
    drain = [(s.start_ns / 1e3 + offset, s.end_ns / 1e3 + offset, s)
             for s in host_spans if s.name in DRAIN_SPANS + NESTED]
    out = ProgramTrace(
        offset_us=offset, window_s=(w1 - w0) * 1e-6,
        idle_s=sum(t - s for s, t in idle) * 1e-6,
    )
    in_window = set()
    for lo, hi, s in drain:
        if s.name == "serve.dispatch" and w0 <= lo < w1:
            in_window.add(s.batch)
        a, b = max(lo, w0), min(hi, w1)
        if b > a:
            out.drain_s[s.name] = out.drain_s.get(s.name, 0.0) + (b - a) * 1e-6
            out.idle_by_span[s.name] = out.idle_by_span.get(s.name, 0.0) + (
                _overlap(idle, idle_starts, a, b) * 1e-6)
    out.batches = len(in_window)
    out.host_s = sum((hi - lo) * 1e-6 for lo, hi, s in drain
                     if s.name in HOST_WORK and s.batch in in_window)
    # the drain thread is the one that dispatched in the window; what its
    # leaf spans leave uncovered is filed under the pair around it
    threads = [s.thread for lo, _, s in drain
               if s.name == "serve.dispatch" and w0 <= lo < w1]
    loop = sorted((x for x in drain if x[2].name in DRAIN_SPANS
                   and threads and x[2].thread == max(set(threads),
                                                      key=threads.count)),
                  key=lambda x: x[0])
    for (_, hi, a), (lo, _, b) in zip(loop, loop[1:]):
        g0, g1 = max(hi, w0), min(lo, w1)
        if g1 > g0:
            key = f"{a.name}>{b.name}"
            out.glue_s[key] = out.glue_s.get(key, 0.0) + (g1 - g0) * 1e-6
            out.idle_in_glue_s[key] = out.idle_in_glue_s.get(key, 0.0) + (
                _overlap(idle, idle_starts, g0, g1) * 1e-6)
    out.queue_wait_ms = [
        (s.dispatch_ns - s.start_ns) * 1e-6 for s in host_spans
        if s.name == "serve.request" and s.dispatch_ns is not None
        and w0 <= s.dispatch_ns / 1e3 + offset < w1]
    # the drain thread's leaf spans join the host's top-level operations as
    # the candidates for an idle gap's second label
    extra = [SimpleNamespace(name=s.name, device_type="DeviceType.CPU",
                             cpu_parent=None,
                             time_range=SimpleNamespace(start=lo, end=hi))
             for lo, hi, s in drain if s.name in DRAIN_SPANS]
    out.trace = tr.reduce(events + extra)
    return out


def _program(run):
    return getattr(run, "program", None)


def host_ms_per_batch(run):
    """The drain thread's host work a batch dispatched in the window, ms."""
    p = _program(run)
    if p is None or not p.batches:
        return None
    return 1e3 * p.host_s / p.batches


def idle_under_host_work(run):
    """The share of the window the device idles while the drain thread
    does host work, %."""
    p = _program(run)
    if p is None or not p.window_s:
        return None
    return 100.0 * p.idle_under_host_s / p.window_s
