"""The device's idle share of the traced window in the cells that call
``Predictor.predict_batch`` on numpy clips."""

from benchmark.metrics._idle import idle


def read(reading):
    return idle(reading)
