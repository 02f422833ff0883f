"""Shared by the roofline readers: the bound of every call of a kernel in
the traced window over the kernel's device time there, in percent."""

from benchmark.work import PEAK_FLOPS, bound_s


def share(reading, needle, work_of, precision):
    """``work_of(lengths, padded) -> (flops, bytes)`` for one batch."""
    trace = reading.get("trace")
    if trace is None or not reading.get("work"):
        return None
    device_s = trace.kernel_seconds(needle)
    if device_s <= 0:
        return None
    bound = sum(_bound(work_of(lens, padded), precision)
                for lens, padded in reading["work"])
    return 100.0 * bound / device_s


def _bound(work, precision):
    flops, nbytes = work
    return bound_s(flops, PEAK_FLOPS[precision], nbytes)
