"""The trunk kernel's share of its roofline: the bf16 bound of every
batch's valid trunk rows (``work.trunk_work``) over the device time of
``campplus_trunk_kernel`` in the traced window."""

from benchmark.metrics._roofline import share
from benchmark.work import trunk_rows, trunk_work


def read(reading):
    return share(reading, "campplus_trunk_kernel",
                 lambda lens, padded: trunk_work(trunk_rows(lens, padded)), "bf16")
