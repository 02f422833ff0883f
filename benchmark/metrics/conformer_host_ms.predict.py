"""Mean host ms of one MFA-Conformer forward, the port's
``vpr.conformer`` spans in the window: the dispatch of the subsampling,
the blocks' projections, attention, convolutions and elementwise ops,
and the pooling (no span inside waits for the device, so the device may
still be working when one ends)."""

from benchmark.metrics._program import mean_ms, named, window_spans


def read(reading):
    calls = named(window_spans(reading) or [], "vpr.conformer")
    return mean_ms(calls) if calls else None
