"""Mean host ms of one ECAPA-TDNN forward, the port's ``vpr.ecapa`` spans
in the window: the dispatch of the backbone's convs, BatchNorms and
elementwise ops (no span inside waits for the device, so the device
may still be working when one ends)."""

from benchmark.metrics._program import mean_ms, named, window_spans


def read(reading):
    calls = named(window_spans(reading) or [], "vpr.ecapa")
    return mean_ms(calls) if calls else None
