"""Mean ms of one batch's load on a loader thread (reads, decode, crop
and collate): the port's ``vpr.loader.load`` spans in the window."""

from benchmark.metrics._program import mean_ms, named, window_spans


def read(reading):
    loads = named(window_spans(reading) or [], "vpr.loader.load")
    return mean_ms(loads) if loads else None
