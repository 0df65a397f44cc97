"""Arithmetic shared by the per-layer readers; each reader is one file
named after its metric."""

from cardbench import counts, peaks


def images(run):
    return sum(b["images"] for b in run.delta["buckets"].values())


def images_per_batch(run):
    n = sum(b["batches"] for b in run.delta["buckets"].values())
    return images(run) / n if n else None


def launches_per_image(run):
    n = images(run)
    return sum(run.delta["launches"].values()) / n if n else None


def _peak(run):
    return peaks.PEAK_FLOPS[run.cell.cfg["compute_dtype"]]


def forward_mfu(run):
    """FLOPs of the images answered in the window over its length."""
    if not run.completed_in_window:
        return None
    work = counts.flops_per_image(run.cell.cfg) * run.completed_in_window
    return 100.0 * work / run.seconds / _peak(run)


def conv_roofline(run):
    """The least time the conv layers of every launched row (padding
    included) need, at the peak rate or the HBM rate, whichever is slower,
    over the time of every device kernel in the window.  The denominator
    names no kernel, so it reads the same however the program splits,
    fuses or names its convs; the head's GEMMs and the copies count in it
    and not in the numerator."""
    if run.trace is None:
        return None
    kernel_s = run.trace.kernel_s()
    if not kernel_s:
        return None
    cfg = run.cell.cfg
    least = 0.0
    for bucket, b in run.delta["buckets"].items():
        ops = counts.conv_flops_per_image(cfg) * bucket / _peak(run)
        moved = counts.conv_min_bytes(cfg, bucket) / peaks.HBM_BYTES_PER_S
        least += b["batches"] * max(ops, moved)
    return 100.0 * least / kernel_s


def idle_share(run):
    if run.trace is None or not run.trace.window_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
