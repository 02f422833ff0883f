"""The whole model's share of the card's peak in the cells that call
``Predictor.predict_batch`` on numpy clips (``_mfu``)."""

from benchmark.metrics._mfu import share


def read(reading):
    return share(reading)
