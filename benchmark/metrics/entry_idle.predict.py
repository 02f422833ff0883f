"""The share of the traced window, in percent, in which the device was
idle while the calling thread was in ``predict_batch``'s staging or
copies (the port's ``vpr.predict.stage``, ``vpr.predict.copy_in`` and
``vpr.predict.copy_out`` spans): the part of ``idle.predict`` that the
entry's host work leaves."""

from benchmark.metrics._program import idle_share

PARTS = ("vpr.predict.stage", "vpr.predict.copy_in", "vpr.predict.copy_out")


def read(reading):
    return idle_share(reading, "vpr.predict", lambda name: name in PARTS)
