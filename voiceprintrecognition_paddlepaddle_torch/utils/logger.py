"""Console logger.

The reference uses ``loguru`` throughout (e.g. reference
``ppvector/trainer.py:10``); that package is not available here, so this is
a tiny stdlib shim exposing the same ``logger.info/warning/error`` surface
with a similar colored, timestamped format.
"""

import logging
import sys

_FMT = "%(asctime)s | %(levelname)-7s | %(module)s:%(lineno)d - %(message)s"

logger = logging.getLogger("tpuvector")
if not logger.handlers:
    _handler = logging.StreamHandler(sys.stderr)
    _handler.setFormatter(logging.Formatter(_FMT, datefmt="%Y-%m-%d %H:%M:%S"))
    logger.addHandler(_handler)
    logger.setLevel(logging.INFO)
    logger.propagate = False
