"""The share of the traced window, in percent, in which the device was
idle while the thread dispatching the MFA-Conformer forward was innermost
in one of its spans (``vpr.conformer`` and ``vpr.conformer.*``): the
launch gaps of the backbone's many small operations."""

from benchmark.metrics._program import idle_share


def read(reading):
    return idle_share(reading, "vpr.conformer",
                      lambda name: name == "vpr.conformer"
                      or name.startswith("vpr.conformer."))
