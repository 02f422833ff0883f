"""The device's idle share of the traced window in the embed cells."""

from benchmark.metrics._idle import idle


def read(reading):
    return idle(reading)
