"""The whole model's share of the card's peak in the embed cells, where
the embed function runs on batches staged on the card (``_mfu``)."""

from benchmark.metrics._mfu import share


def read(reading):
    return share(reading)
