"""The device's idle share of the traced window in the serve cells."""

from benchmark.metrics._idle import idle


def read(reading):
    return idle(reading)
