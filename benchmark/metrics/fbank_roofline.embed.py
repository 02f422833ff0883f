"""The fbank kernel's share of its roofline in the embed cells: the fp32
bound of every batch's valid samples (``work.fbank_work``) over the
device time of ``fbank_kernel`` in the traced window."""

from benchmark.metrics._roofline import share
from benchmark.work import fbank_work


def read(reading):
    return share(reading, "fbank_kernel", lambda lens, padded: fbank_work(lens),
                 "fp32")
