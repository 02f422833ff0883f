"""Bucketed batch lengths (copy of the JAX package's
``data_utils/collate.py`` ``bucket_length``).

Batches pad to a small set of lengths so that the embed path sees a
handful of shapes; the padding is masked on the device."""

import math

__all__ = ["bucket_length"]


def bucket_length(n, minimum=16000, factor=2.0):
    """Smallest bucket >= n from a x``factor`` progression starting at
    ``minimum``."""
    if n <= minimum:
        return minimum
    steps = math.ceil(math.log(n / minimum) / math.log(factor) - 1e-9)
    return int(round(minimum * factor ** steps))
