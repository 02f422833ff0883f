"""Host ms per ``Predictor.predict_batch`` call spent staging the clips
(bucketing, ``np.zeros`` and the fill) and copying them to the device:
the port's ``vpr.predict.stage`` and ``vpr.predict.copy_in`` spans in
the window, over its ``vpr.predict`` spans."""

from benchmark.metrics._program import named, window_spans


def read(reading):
    spans = window_spans(reading)
    calls = named(spans or [], "vpr.predict")
    if not calls:
        return None
    host = sum(s.end_ns - s.start_ns for s in spans
               if s.name in ("vpr.predict.stage", "vpr.predict.copy_in"))
    return host / len(calls) / 1e6
