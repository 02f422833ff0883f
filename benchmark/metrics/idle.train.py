"""The device's idle share of the traced window in the train cells."""

from benchmark.metrics._idle import idle


def read(reading):
    return idle(reading)
