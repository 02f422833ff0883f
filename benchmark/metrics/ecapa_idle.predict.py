"""The share of the traced window, in percent, in which the device was
idle while the thread dispatching the ECAPA-TDNN forward was innermost in
one of its spans (``vpr.ecapa`` and ``vpr.ecapa.*``): the launch gaps of
the backbone, such as those of the Res2Net chain's small convs."""

from benchmark.metrics._program import idle_share


def read(reading):
    return idle_share(reading, "vpr.ecapa",
                      lambda name: name == "vpr.ecapa" or name.startswith("vpr.ecapa."))
