"""Shared wall-clock statistics helpers.

The port of the reference's ``repro.obs.stats``: one definition of "p95"
(linear interpolation between closest ranks, the numpy default) for the
benchmark rows and the serving summary.

Import-light on purpose: stdlib only.  :func:`timed_stats_ms` ends the
warm-up and every timed call with ``torch.cuda.synchronize()`` when the
process has put work on a CUDA device (PyTorch returns before the device
finishes, so a host clock without it would time the enqueue); it finds
``torch`` in ``sys.modules`` instead of importing it.
"""

from __future__ import annotations

import statistics
import sys
import time

__all__ = ["percentile", "timed_stats_ms"]


def percentile(values, q: float) -> float:
    """Linear-interpolated ``q``-th percentile of ``values`` (0 <= q <= 100).

    Matches ``np.percentile``'s default (linear interpolation between the
    two closest ranks) for any non-empty sequence of floats.  Raises
    ``ValueError`` on an empty sequence — callers decide what an absent
    sample means.
    """
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of empty sequence")
    idx = q / 100.0 * (len(xs) - 1)
    lo = int(idx)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (idx - lo)


def _sync() -> None:
    """Wait for the current CUDA device when this process has used one."""
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed_stats_ms(fn, reps: int = 5) -> dict:
    """Wall-clock stats over ``reps`` timed calls of ``fn``, after one
    untimed warm-up call that absorbs kernel builds and allocator growth —
    single-shot numbers are scheduler noise.  The warm-up and each timed
    call end in a device synchronize when CUDA is in use, so each time
    holds the call's device work.

    Returns ``{"p50_ms", "p95_ms", "reps"}``.
    """
    fn()  # warm-up: kernel builds, allocator
    _sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return {
        "p50_ms": statistics.median(times),
        "p95_ms": percentile(times, 95.0),
        "reps": reps,
    }
