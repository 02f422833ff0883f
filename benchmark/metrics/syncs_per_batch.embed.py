"""Blocking CUDA runtime calls per call of the embed function: the
trace's host events ``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize`` and synchronous ``cudaMemcpy`` that start inside
a ``vpr.embed`` span of the port, over the number of those spans in the
window. Each one drains the batches dispatched ahead of the device."""

import bisect

from benchmark.metrics._program import named, window_spans

BLOCKING = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                      "cudaEventSynchronize", "cudaMemcpy"})


def read(reading):
    spans = window_spans(reading)
    calls = named(spans or [], "vpr.embed")
    if not calls:
        return None
    starts = [s.start_ns for s in calls]
    n = 0
    for name, s, _ in reading["trace"].host_ops:
        if name in BLOCKING:
            k = bisect.bisect_right(starts, s) - 1
            n += k >= 0 and s < calls[k].end_ns
    return n / len(calls)
